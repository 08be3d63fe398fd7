"""The sampler and the histogram at the dimensions whose CUDA routes were
redesigned after the first design (the sampler's paired route at 1D and
2D, its wide route at 9..32D, the grouped histogram at 9..32D): the plain
PyTorch versions against the JAX package's Pallas kernels in interpret
mode, as its own tests run them, on the same numpy inputs.

Each case takes a chunk of 256 cubes whose last 40 lie beyond the lattice,
uniforms given as words (the parity hook), a map fitted to a random grid
and a non-unit volume.  Past 16D the lattices are 2^20, 2^24 and 2^28
cubes of 2 samples (the wide route's NMAX 24 and 32 classes; the
reference's int32 cube ids hold no 2^32 lattice, so 32D is held by the
histogram alone), the fused mode at 20D and 28D and the emit mode with
bin ids at 24D and 28D: the reference's interpret-mode compile grows
with npg * ndim, 17-28 s a case there.  Tolerances are those of
tests/test_torch_vegas_kernels.py at 3D: bin ids EQUAL; the sums of fb
within rtol 2e-5 and of f2b within 2e-4, or for f2b within the rounding
of its f32 form, 8 eps npg sum f^2 (a cube's (sq - fb)(sq + fb) with
sq^2 = npg sum f^2 rounds at 4 eps sq^2 on each side: at 1D a cube is
1/300 of the axis, its two values nearly equal, and f2b some 10^5 times
below that scale); emitted f^2 within rtol 2e-4;
coordinates within 4 f32 ulps of the series' rounding scale
sum_i |c_i| + |lo|; weights within rtol 1e-5 (the recurrence is all
multiply-add, and 16 factors of q^2 multiply its roundings by 16, so the
weights at 9..16D are held to 16 ndim ulps instead); histograms rtol 1e-6
per bin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes.pallas_lookup import hist_pallas
from gpuintegration_tpu.mcubes.pallas_vegas import poly_sample_chunk
from gpuintegration_tpu.mcubes.poly_importance import fit_importance_poly
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.models import genz

EPS32 = np.finfo(np.float32).eps
CHUNK, A, NBINS, XJAC = 256, 1, 50, 0.37
# (ndim, ng, npg): ng^ndim cubes, npg samples a cube
SHAPES = {1: (1, 300, 2), 2: (2, 17, 2), 9: (9, 3, 2), 12: (12, 2, 3),
          16: (16, 2, 2), 20: (20, 2, 2), 24: (24, 2, 2), 28: (28, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the workers running side by side would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(ndim, npg):
    rng = np.random.default_rng(ndim)
    edges = np.sort(rng.uniform(0.05, 1.0, (ndim, NBINS - 1)), axis=1)
    xi = np.concatenate([np.zeros((ndim, 1)), edges, np.ones((ndim, 1))],
                        axis=1)
    p, q = fit_importance_poly(xi, 8)
    lo = rng.uniform(-1.0, 0.5, ndim)
    hi = lo + rng.uniform(0.5, 2.0, ndim)
    bits = rng.integers(0, 2 ** 32, (npg * ndim, CHUNK),
                        dtype=np.uint64).astype(np.uint32)
    return p.astype(np.float32), q.astype(np.float32), lo, hi, bits


def _reference(f_axes, shape, inputs, with_hist, emit_points):
    ndim, ng, npg = shape
    p32, q32, lo, hi, bits = inputs
    ncubes = ng ** ndim
    return poly_sample_chunk(
        f_axes, ndim, ng, npg, CHUNK, NBINS, with_hist, jnp.asarray(p32),
        jnp.asarray(q32), jnp.asarray(lo), jnp.asarray(hi - lo),
        jnp.asarray(XJAC), jnp.asarray(ncubes - CHUNK + 40, jnp.int32),
        jnp.asarray(ncubes, jnp.int32), None,
        jnp.asarray(bits.reshape(npg * ndim, CHUNK // (A * 128), 128)),
        tile_a=A, interpret=True, emit_points=emit_points)


def _port(integrand, shape, inputs, with_hist, emit_points):
    ndim, ng, npg = shape
    p32, q32, lo, hi, bits = inputs
    ncubes = ng ** ndim
    pmap = cuda_vegas.fold_map(torch.as_tensor(p32), torch.as_tensor(q32),
                               torch.as_tensor(lo), torch.as_tensor(hi - lo))
    return cuda_vegas.sample_chunk(
        pmap, integrand, ng, npg, CHUNK, NBINS, with_hist, XJAC,
        ncubes - CHUNK + 40, ncubes, 0, 1,
        bits=torch.as_tensor(bits.view(np.int32)), emit_points=emit_points)


def _flat(a, ndim, npg):
    """The reference's (tile, slot, A*128) sample order as
    n = cube * npg + slot; a leading dimension axis kept."""
    a = np.asarray(a)
    lead = (ndim,) if a.ndim == 2 and a.shape[0] == ndim else ()
    a = a.reshape(*lead, CHUNK // (A * 128), npg, A * 128)
    return np.moveaxis(a, -2, -1).reshape(*lead, -1)


def _valid(npg):
    return np.repeat(np.arange(CHUNK) < CHUNK - 40, npg)


@pytest.mark.parametrize("ndim", sorted(SHAPES))
def test_sampler_routes_are_the_ones_redesigned(ndim):
    """Every map here takes the route redesigned for its dimension."""
    inputs = _inputs(ndim, SHAPES[ndim][2])
    kp, kq = inputs[0].shape[1], inputs[1].shape[1]
    assert cuda_vegas.sampler_route(ndim, kp, kq) == (
        "paired" if ndim <= 2 else "wide")


@pytest.mark.parametrize("ndim", [d for d in sorted(SHAPES) if d != 24])
def test_fused_sampler_matches_pallas_interpret(ndim):
    shape = SHAPES[ndim]
    _, _, npg = shape
    inputs = _inputs(ndim, npg)
    g = genz.f4_gaussian(ndim, a=2.0, b=0.5)

    def f_axes(*xs):
        return jnp.exp(-sum(4.0 * (x - 0.5) ** 2 for x in xs))

    acc, ia_k, f2_k = _reference(f_axes, shape, inputs, True, False)
    sums, ia, f2 = _port(g, shape, inputs, True, False)
    acc = np.asarray(acc, np.float64)
    assert np.isclose(float(sums[0]), acc[:, 0, :].sum(), rtol=2e-5)
    f2_sum = float(np.asarray(f2_k, np.float64).sum())
    assert np.isclose(float(sums[1]), acc[:, 1, :].sum(), rtol=2e-4,
                      atol=8 * EPS32 * npg * f2_sum)
    valid = _valid(npg)
    assert tuple(ia.shape) == (ndim, CHUNK * npg)
    np.testing.assert_array_equal(ia.numpy()[:, valid],
                                  _flat(ia_k, ndim, npg)[:, valid])
    assert not ia.numpy()[:, ~valid].any()
    np.testing.assert_allclose(f2.numpy(), _flat(f2_k, ndim, npg),
                               rtol=2e-4, atol=1e-30)
    assert not f2.numpy()[~valid].any()
    sums2, none_ia, none_f2 = _port(g, shape, inputs, False, False)
    assert torch.equal(sums, sums2) and none_ia is None and none_f2 is None


@pytest.mark.parametrize("ndim,with_hist", [
    (ndim, with_hist) for ndim in sorted(SHAPES) for with_hist in (False, True)
    if ndim <= 16 or (with_hist and ndim != 20)])
def test_emit_sampler_matches_pallas_interpret(ndim, with_hist):
    shape = SHAPES[ndim]
    _, _, npg = shape
    inputs = _inputs(ndim, npg)
    p32, q32, lo, hi, _ = inputs
    outs = _reference(None, shape, inputs, with_hist, True)
    xs, wt, ia = _port(None, shape, inputs, with_hist, True)
    valid = _valid(npg)
    xs_ref = _flat(np.asarray(outs[0]).reshape(ndim, -1), ndim, npg)
    wt_ref = _flat(np.asarray(outs[1]).reshape(-1), ndim, npg)
    dx32 = (hi - lo).astype(np.float32)
    lo32 = lo.astype(np.float32)
    scale = np.abs(p32 * dx32[:, None]).sum(axis=1) + np.abs(lo32)
    err = np.abs(xs.numpy() - xs_ref)[:, valid]
    assert np.all(err <= 4 * EPS32 * scale[:, None])
    rtol = 1e-5 if ndim <= 8 else 16 * ndim * EPS32
    np.testing.assert_allclose(wt.numpy()[valid], wt_ref[valid], rtol=rtol)
    np.testing.assert_array_equal(
        xs.numpy()[:, ~valid],
        np.broadcast_to(lo32[:, None], (ndim, (~valid).sum())))
    assert not wt.numpy()[~valid].any()
    if with_hist:
        np.testing.assert_array_equal(
            ia.numpy()[:, valid], _flat(outs[2], ndim, npg)[:, valid])
    else:
        assert ia is None


@pytest.mark.parametrize("nbins", [50, 500])
@pytest.mark.parametrize("ndim", [9, 16, 32])
def test_hist_matches_pallas_interpret(ndim, nbins):
    """The histogram at the dimensions of the grouped route's second
    design, dims-major as the sampler emits it, values of a wide range."""
    rng = np.random.default_rng(ndim + nbins)
    n = 3001
    ia = rng.integers(0, nbins, (ndim, n)).astype(np.int32)
    f2 = (rng.random(n) ** 8).astype(np.float32)
    want = np.asarray(hist_pallas(jnp.asarray(ia), jnp.asarray(f2), nbins,
                                  interpret=True))
    got = cuda_lookup.hist(torch.as_tensor(ia), torch.as_tensor(f2), nbins)
    assert got.dtype == torch.float32 and tuple(got.shape) == (ndim, nbins)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert cuda_lookup.hist_route(ndim, nbins) == "grouped"
