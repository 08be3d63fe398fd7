"""The plain PyTorch versions of the four VEGAS kernels against the JAX
package's Pallas kernels (interpret mode on the CPU, as its own tests run
them) and its XLA functions, on the same numpy inputs; the generator; and a
rehearsal of the card's checks on CPU tensors.

Tolerances: bin ids, bin edges and their differences are EQUAL; ``rc``
within 2 ulp (the multiply-add's contraction differs between layouts in
the reference itself); histograms rtol 1e-6 per bin; the sampler's f32
sums of fb within rtol 2e-5 and of f2b within 2e-4, emitted f^2 within
2e-4, coordinates within 4 f32 ulps of the series' rounding scale
sum_i |c_i| and weights within rtol 1e-5 (the Chebyshev recurrence is all
multiply-add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.mcubes.pallas_lookup import (
    bin_resolve_pallas, edge_lookup_pallas, hist_pallas)
from gpuintegration_tpu.mcubes.pallas_vegas import poly_sample_chunk
from gpuintegration_tpu.mcubes.poly_importance import fit_importance_poly
from gpuintegration_torch.mcubes import (cuda_lookup, cuda_vegas,
                                         kernel_check, stream)
from gpuintegration_torch.models import genz

EPS32 = np.finfo(np.float32).eps


# ---------------------------------------------------------------------------
# B2: the sampler

NDIM, NG, NPG, NBINS = 3, 6, 2, 50
NCUBES = NG ** NDIM                     # 216 < chunk: exercises the mask
CHUNK, A = 256, 1                       # 2 tiles of 128 cubes
LO = np.array([0.1, -1.0, 0.0])
HI = np.array([0.9, 2.0, 1.0])
XJAC = 0.37


def _sampler_inputs():
    rng = np.random.default_rng(0)
    edges = np.sort(rng.uniform(0.05, 1.0, (NDIM, NBINS - 1)), axis=1)
    xi = np.concatenate([np.zeros((NDIM, 1)), edges, np.ones((NDIM, 1))],
                        axis=1)
    p, q = fit_importance_poly(xi, 8)
    bits = rng.integers(0, 2 ** 32, (NPG * NDIM, CHUNK),
                        dtype=np.uint64).astype(np.uint32)
    return p.astype(np.float32), q.astype(np.float32), bits


def _reference_chunk(f_axes, p32, q32, bits, with_hist, emit_points):
    n_tiles = CHUNK // (A * 128)
    return poly_sample_chunk(
        f_axes, NDIM, NG, NPG, CHUNK, NBINS, with_hist,
        jnp.asarray(p32), jnp.asarray(q32), jnp.asarray(LO),
        jnp.asarray(HI - LO), jnp.asarray(XJAC), jnp.asarray(0, jnp.int32),
        jnp.asarray(NCUBES, jnp.int32), None,
        jnp.asarray(bits.reshape(NPG * NDIM, n_tiles * A, 128)),
        tile_a=A, interpret=True, emit_points=emit_points)


def _to_flat_order(a):
    """The reference's (tile, slot, A*128) sample order as
    n = cube * npg + slot; leading axes kept."""
    a = np.asarray(a)
    lead = a.shape[:-1] if a.ndim == 2 and a.shape[0] == NDIM else ()
    a = a.reshape(*lead, CHUNK // (A * 128), NPG, A * 128)
    return np.moveaxis(a, -2, -1).reshape(*lead, -1)


def _port_chunk(integrand, p32, q32, bits, with_hist, emit_points):
    pmap = cuda_vegas.fold_map(torch.as_tensor(p32), torch.as_tensor(q32),
                               torch.as_tensor(LO), torch.as_tensor(HI - LO))
    return cuda_vegas.sample_chunk(
        pmap, integrand, NG, NPG, CHUNK, NBINS, with_hist, XJAC, 0, NCUBES,
        0, 1, bits=torch.as_tensor(bits.view(np.int32)),
        emit_points=emit_points)


def test_sampler_fused_matches_pallas_interpret():
    p32, q32, bits = _sampler_inputs()
    g = genz.f4_gaussian(NDIM, a=2.0, b=0.5)

    def f_axes(x, y, z):
        return jnp.exp(-(4.0 * (x - 0.5) ** 2 + 4.0 * (y - 0.5) ** 2
                         + 4.0 * (z - 0.5) ** 2))

    acc, ia_k, f2_k = _reference_chunk(f_axes, p32, q32, bits, True, False)
    sums, ia, f2 = _port_chunk(g, p32, q32, bits, True, False)
    acc = np.asarray(acc, np.float64)
    assert sums.dtype == torch.float64
    assert np.isclose(float(sums[0]), acc[:, 0, :].sum(), rtol=2e-5)
    assert np.isclose(float(sums[1]), acc[:, 1, :].sum(), rtol=2e-4)
    valid = np.repeat(np.arange(CHUNK) < NCUBES, NPG)
    ia_ref = _to_flat_order(ia_k)
    assert ia.dtype == torch.int32 and tuple(ia.shape) == (NDIM, CHUNK * NPG)
    np.testing.assert_array_equal(ia.numpy()[:, valid], ia_ref[:, valid])
    assert not ia.numpy()[:, ~valid].any()       # neutral beyond the lattice
    np.testing.assert_allclose(f2.numpy(), _to_flat_order(f2_k), rtol=2e-4,
                               atol=1e-30)
    assert not f2.numpy()[~valid].any()
    # without the histogram: the same sums, nothing else
    sums2, none_ia, none_f2 = _port_chunk(g, p32, q32, bits, False, False)
    assert torch.equal(sums, sums2) and none_ia is None and none_f2 is None


@pytest.mark.parametrize("with_hist", [False, True])
def test_sampler_emit_matches_pallas_interpret(with_hist):
    p32, q32, bits = _sampler_inputs()
    outs = _reference_chunk(None, p32, q32, bits, with_hist, True)
    xs, wt, ia = _port_chunk(None, p32, q32, bits, with_hist, True)
    valid = np.repeat(np.arange(CHUNK) < NCUBES, NPG)
    xs_ref = _to_flat_order(np.asarray(outs[0]).reshape(NDIM, -1))
    wt_ref = _to_flat_order(np.asarray(outs[1]).reshape(-1))
    dx32 = (HI - LO).astype(np.float32)
    scale = (np.abs(p32 * dx32[:, None]).sum(axis=1)
             + np.abs(LO.astype(np.float32)))
    err = np.abs(xs.numpy() - xs_ref)[:, valid]
    assert np.all(err <= 4 * EPS32 * scale[:, None])
    np.testing.assert_allclose(wt.numpy()[valid], wt_ref[valid], rtol=1e-5)
    lo32 = LO.astype(np.float32)
    assert np.all(xs.numpy() >= lo32[:, None])
    assert np.all(xs.numpy() <= (lo32 + dx32)[:, None])
    # beyond the lattice: the low corner with weight 0
    np.testing.assert_array_equal(
        xs.numpy()[:, ~valid],
        np.broadcast_to(lo32[:, None], (NDIM, (~valid).sum())))
    assert not wt.numpy()[~valid].any()
    if with_hist:
        np.testing.assert_array_equal(
            ia.numpy()[:, valid], _to_flat_order(outs[2])[:, valid])
    else:
        assert ia is None


def test_sampler_emitted_points_reproduce_fused_sums():
    """Re-evaluating the emitted (xs, wt) with the f32 integrand and the
    per-cube reduction reproduces the fused mode's sums."""
    p32, q32, bits = _sampler_inputs()
    g = genz.f4_gaussian(NDIM, a=2.0)
    sums, _, f2 = _port_chunk(g, p32, q32, bits, True, False)
    xs, wt, _ = _port_chunk(None, p32, q32, bits, False, True)
    fx = (g(xs.T) * (wt * XJAC)).view(CHUNK, NPG)
    np.testing.assert_allclose((fx * fx).reshape(-1).numpy(), f2.numpy(),
                               rtol=1e-6)
    assert float(fx.double().sum()) == pytest.approx(float(sums[0]),
                                                     rel=1e-6)


def test_sampler_stream_does_not_depend_on_chunking():
    """The Philox stream is keyed on the global cube id: one chunk of 216
    cubes and three chunks of 72 emit the same samples."""
    p32, q32, _ = _sampler_inputs()
    pmap = cuda_vegas.fold_map(torch.as_tensor(p32), torch.as_tensor(q32),
                               torch.as_tensor(LO), torch.as_tensor(HI - LO))

    def emit(chunk, cube0, iteration=4):
        return cuda_vegas.sample_chunk(
            pmap, None, NG, NPG, chunk, NBINS, True, XJAC, cube0, NCUBES, 7,
            iteration, emit_points=True)

    whole = emit(NCUBES, 0)
    parts = [emit(72, c) for c in (0, 72, 144)]
    for k in range(3):
        assert torch.equal(whole[k], torch.cat([p[k] for p in parts], dim=-1))
    assert not torch.equal(whole[0], emit(NCUBES, 0, iteration=5)[0])


def test_fold_map_packs_what_the_kernel_reads():
    """``fold_map`` packs what the kernel reads, in the order its header
    states, and the launch grid covers the chunk."""
    p32, q32, _ = _sampler_inputs()
    pmap = cuda_vegas.fold_map(torch.as_tensor(p32), torch.as_tensor(q32),
                               torch.as_tensor(LO), torch.as_tensor(HI - LO))
    pf, q, lo, hi = pmap.parts()
    assert (pmap.ndim, pmap.kp, pmap.kq) == (NDIM, 18, 9)
    assert pmap.table.dtype == torch.float32 and pmap.table.is_contiguous()
    dx32 = (HI - LO).astype(np.float32)
    want = p32 * dx32[:, None]
    want[:, 0] += LO.astype(np.float32)
    np.testing.assert_array_equal(pf.numpy(), want)
    np.testing.assert_array_equal(q.numpy(), q32)
    np.testing.assert_array_equal(lo.numpy(), LO.astype(np.float32))
    np.testing.assert_array_equal(hi.numpy(), LO.astype(np.float32) + dx32)
    assert cuda_vegas.n_blocks(1) == 1 and cuda_vegas.n_blocks(257) == 2
    assert cuda_vegas.n_blocks(1 << 30) == cuda_vegas.MAX_BLOCKS


# ---------------------------------------------------------------------------
# B3, B4, B5

def _random_grid(ndim, nbins, seed=0):
    return kernel_check.random_grid(ndim, nbins, seed).astype(np.float32)


@pytest.mark.parametrize("ndim,nbins", [(3, 500), (6, 500), (2, 37), (1, 50)])
def test_edge_lookup_equal(ndim, nbins):
    xi32 = _random_grid(ndim, nbins, seed=ndim)
    rng = np.random.default_rng(1)
    ia = rng.integers(1, nbins + 1, (7, 33, ndim)).astype(np.int32)
    lo, hi = cuda_lookup.edge_lookup(torch.as_tensor(xi32),
                                     torch.as_tensor(ia), nbins)
    lo_x, hi_x = JV._edge_lookup(jnp.asarray(xi32), jnp.asarray(ia), nbins)
    lo_k, hi_k = edge_lookup_pallas(jnp.asarray(xi32), jnp.asarray(ia), nbins,
                                    interpret=True)
    for got, xla, pallas in ((lo, lo_x, lo_k), (hi, hi_x, hi_k)):
        assert got.dtype == torch.float32 and tuple(got.shape) == ia.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("with_ia", [False, True])
@pytest.mark.parametrize("ndim,nbins", [(4, 500), (1, 11), (6, 50)])
def test_bin_resolve_matches_pallas_and_xla(ndim, nbins, with_ia):
    xi32 = _random_grid(ndim, nbins, seed=10 + ndim)
    rng = np.random.default_rng(2)
    n = 1234
    xn = (1.0 + rng.random((ndim, n)) * nbins).astype(np.float32)
    xn[:, 0] = 1.0
    rc, xo, ids = cuda_lookup.bin_resolve(
        torch.as_tensor(xi32), torch.as_tensor(xn), nbins, with_ia=with_ia)
    rc_k, xo_k, ids_k = bin_resolve_pallas(
        jnp.asarray(xi32), jnp.asarray(xn), nbins, with_ia=with_ia,
        interpret=True)
    # XLA-branch arithmetic, op for op (vegas chunk_body)
    xn_j = jnp.moveaxis(jnp.asarray(xn), 0, -1)[None]
    ia_j = jnp.clip(xn_j.astype(jnp.int32), 1, nbins)
    lo_j, hi_j = JV._edge_lookup(jnp.asarray(xi32), ia_j, nbins)
    xo_j = hi_j - lo_j
    rc_j = lo_j + (xn_j - ia_j.astype(jnp.float32)) * xo_j

    def dims_major(a):
        return np.moveaxis(np.asarray(a)[0], -1, 0)

    np.testing.assert_array_equal(xo.numpy(), np.asarray(xo_k))
    np.testing.assert_array_equal(xo.numpy(), dims_major(xo_j))
    np.testing.assert_array_max_ulp(rc.numpy(), np.asarray(rc_k), maxulp=2)
    np.testing.assert_array_max_ulp(rc.numpy(), dims_major(rc_j), maxulp=2)
    if with_ia:
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_k))
        np.testing.assert_array_equal(ids.numpy(), dims_major(ia_j))
    else:
        assert ids is None and ids_k is None


@pytest.mark.parametrize("layout", ["dims_major", "cube_major"])
@pytest.mark.parametrize("ndim,nbins", [(3, 500), (2, 37), (6, 128), (1, 50)])
def test_hist_matches_pallas_and_xla(ndim, nbins, layout):
    rng = np.random.default_rng(3 + ndim)
    C, npg = 11, 37
    ia_np = rng.integers(0, nbins, (C, npg, ndim)).astype(np.int32)
    f2_np = rng.random((C, npg)).astype(np.float32)
    ref = np.asarray(JV._onehot_hist(jnp.asarray(ia_np), jnp.asarray(f2_np),
                                     nbins))
    if layout == "dims_major":
        ia = np.moveaxis(ia_np, -1, 0).reshape(ndim, -1)
        f2 = f2_np.reshape(-1)
    else:
        ia, f2 = ia_np, f2_np
    pallas = np.asarray(hist_pallas(jnp.asarray(ia), jnp.asarray(f2), nbins,
                                    interpret=True))
    out = cuda_lookup.hist(torch.as_tensor(ia), torch.as_tensor(f2), nbins)
    assert out.dtype == torch.float32 and tuple(out.shape) == (ndim, nbins)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-6, atol=0.0)


def test_hist_clamps_at_cap_like_the_reference():
    """An inf and a value above the cap leave every bin finite, and equal
    to the reference's; accumulation across chunks saturates at the cap."""
    from gpuintegration_torch.mcubes import vegas as V
    rng = np.random.default_rng(0)
    ia = rng.integers(0, 20, (2, 300)).astype(np.int32)
    f2 = rng.random(300).astype(np.float32)
    f2[:3] = [np.inf, 1e38, 2.9e37]
    out = cuda_lookup.hist(torch.as_tensor(ia), torch.as_tensor(f2), 20)
    ref = np.asarray(JV._onehot_hist(jnp.asarray(ia), jnp.asarray(f2), 20))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    twice = V._hist_accum(V._hist_accum(torch.zeros_like(out), out), out)
    want = np.asarray(JV._hist_accum(
        JV._hist_accum(jnp.zeros((2, 20), jnp.float32), jnp.asarray(ia),
                       jnp.asarray(f2), 20), jnp.asarray(ia),
        jnp.asarray(f2), 20))
    np.testing.assert_allclose(twice.numpy(), want, rtol=1e-6)
    assert float(twice.max()) == np.float32(cuda_lookup.HIST_CAP)


def test_stratified_xn_matches_reference_expression():
    """xn = (kg - ran) * dxg + 1 as vegas.py:347-349 forms it, unfused, on
    the port's uniforms; the resolve of it neutral beyond the lattice."""
    ndim, ng, npg, nbins, chunk, ncubes = 3, 6, 2, 50, 256, 216
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2 ** 32, (npg * ndim, chunk),
                        dtype=np.uint64).astype(np.uint32)
    xn, valid = cuda_lookup.stratified_xn_plain(
        ndim, ng, npg, nbins, chunk, 0, ncubes, 0, 1, "cpu",
        bits=torch.as_tensor(bits.view(np.int32)))
    ran = ((bits >> np.uint32(8)).astype(np.float32)
           * np.float32(2.0 ** -24)).reshape(npg, ndim, chunk)
    ran = jnp.asarray(np.moveaxis(ran, -1, 0))                   # (C, npg, ndim)
    kg = JV._decode_cube(jnp.arange(chunk, dtype=jnp.int64), ng, ndim)
    dxg32 = jnp.asarray(float(nbins), jnp.float32) / ng
    xn_ref = ((kg.T[:, :, None].astype(jnp.float32)
               - jnp.moveaxis(ran, -1, 0)) * dxg32 + 1.0).reshape(ndim, -1)
    np.testing.assert_array_equal(xn.numpy(), np.asarray(xn_ref))
    np.testing.assert_array_equal(
        valid.numpy(), np.repeat(np.arange(chunk) < ncubes, npg))
    xi32 = torch.as_tensor(_random_grid(ndim, nbins, 1))
    rc, xo, ia = cuda_lookup.bin_resolve_stratified(
        xi32, nbins, ng, npg, chunk, 0, ncubes, 0, 1, with_ia=True,
        bits=torch.as_tensor(bits.view(np.int32)))
    assert not rc[:, ~valid].any() and not xo[:, ~valid].any()
    assert (ia[:, ~valid] == 1).all()
    rc_p, xo_p, ia_p = cuda_lookup.bin_resolve_plain(xi32, xn, nbins,
                                                     with_ia=True)
    assert torch.equal(rc[:, valid], rc_p[:, valid])
    assert torch.equal(ia[:, valid], ia_p[:, valid])


# ---------------------------------------------------------------------------
# the generator

# Philox4x32-10 known answers (Random123's kat_vectors): counter, key, out
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    c = [torch.tensor([w], dtype=torch.int64) for w in counter]
    got = tuple(int(w) for w in stream.philox4x32(*c, *key))
    assert got == want


def test_stream_words_are_pinned():
    """The stream's words for fixed (seed, iteration, cube, slot, dim): the
    kernel's twin is held to the same words on the card (through
    kernel_check.check_stream against this generator)."""
    cube = torch.tensor([0, 1, 47045880, 2 ** 40 + 5], dtype=torch.int64)
    bits = stream.stream_bits(0x1234567890ABCDEF, 7, cube, 2, 6)
    assert tuple(bits.shape) == (12, 4) and bits.dtype == torch.int64
    k0, k1 = stream.seed_key(0x1234567890ABCDEF)
    assert (k0, k1) == (0x90ABCDEF, 0x12345678)
    for col, cube_id in enumerate(cube.tolist()):
        for slot in range(2):
            for block in range(2):
                c = [torch.tensor([w], dtype=torch.int64) for w in (
                    cube_id & 0xFFFFFFFF, cube_id >> 32, 7, 4 * slot + block)]
                words = [int(w) for w in stream.philox4x32(*c, k0, k1)]
                for j in range(4 if block == 0 else 2):
                    assert int(bits[slot * 6 + 4 * block + j, col]) == words[j]
    assert [int(w) for w in bits[:3, 0]] == [2621088133, 3213367448,
                                             1205051463]
    assert [int(w) for w in bits[9:, 3]] == [2192744837, 637933186,
                                             3848236405]
    u = stream.bits_to_uniform(torch.tensor([0, 255, 256, 0xFFFFFFFF, -1],
                                            dtype=torch.int64))
    np.testing.assert_array_equal(
        u.numpy(), np.float32([0, 0, 2.0 ** -24, 1 - 2.0 ** -24,
                               1 - 2.0 ** -24]))


def test_stream_is_uniform():
    """2^20 draws: mean, variance and lag-1 correlation of a uniform, within
    5 standard errors; distinct counters and keys give distinct streams."""
    cube = torch.arange(1 << 16, dtype=torch.int64)
    u = stream.bits_to_uniform(stream.stream_bits(3, 1, cube, 4, 4))
    assert u.numel() == 1 << 20
    x = u.T.reshape(-1).double().numpy()        # per cube: slots, then dims
    n = x.size
    assert abs(x.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(x.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    lag1 = np.mean((x[:-1] - 0.5) * (x[1:] - 0.5)) * 12
    assert abs(lag1) < 5 / np.sqrt(n)
    assert 0.0 <= x.min() and x.max() < 1.0
    hist = np.histogram(x, bins=64, range=(0, 1))[0]
    assert abs(hist - n / 64).max() < 5 * np.sqrt(n / 64)
    base = stream.stream_bits(3, 1, cube[:1000], 2, 3)
    for other in (stream.stream_bits(4, 1, cube[:1000], 2, 3),
                  stream.stream_bits(3, 2, cube[:1000], 2, 3),
                  stream.stream_bits(3, 1, cube[:1000] + 1000, 2, 3),
                  stream.stream_bits(3 + 2 ** 32, 1, cube[:1000], 2, 3)):
        assert (base == other).float().mean() < 0.01
    assert not torch.equal(base[0], base[3])       # slots differ
    assert not torch.equal(base[0], base[1])       # dimensions differ


# ---------------------------------------------------------------------------
# the card's checks, rehearsed on CPU tensors (wrapper -> plain version)

@pytest.mark.parametrize("position", ["end", "middle"])
def test_kernel_checks_run_on_cpu(position):
    case = kernel_check.sampler_case(
        4, 5e4, 512, nbins=50, degree=8, seed=3, position=position,
        lows=[0.1, -1.0, 0.0, 0.2], highs=[0.9, 2.0, 1.0, 1.2], device="cpu")
    beyond = case["cube0"] + case["chunk_cubes"] - case["ncubes"]
    assert (beyond > 0) == (position == "end")
    for with_hist in (False, True):
        r = kernel_check.check_sampler(case, None, with_hist=with_hist,
                                       rng="input")
        assert r["x_ulps"] == 0.0 and r["w_ulps"] == 0.0
        for g in genz.genz_suite(4):
            r = kernel_check.check_sampler(case, g, with_hist=with_hist,
                                           rng="device")
            assert r["fb_ulps"] == 0.0 and r["f2b_ulps"] == 0.0
    assert kernel_check.check_stream(case)["uniforms"] == 4 * 512 * case["npg"]
    assert kernel_check.check_hist(3, 5000, 50, device="cpu")["max_rel"] == 0
    assert kernel_check.check_bin_resolve(3, 5000, 50,
                                          device="cpu")["rc_ulps"] == 0
    assert kernel_check.check_bin_resolve_stratified(
        3, 5e4, 512, 50, device="cpu")["rc_ulps"] == 0
    kernel_check.check_edge_lookup(3, 100, 2, 50, device="cpu")


@pytest.mark.parametrize("ndim,ncall,chunk", [(1, 2e4, 512), (16, 1e7, 16),
                                              (8, 5.2e10, 256)])
def test_kernel_checks_at_extreme_shapes(ndim, ncall, chunk):
    """One dimension; sixteen (ng 2, 152 samples a cube, four generator
    blocks a sample); cube ids beyond 2^32: the plain versions and the
    checks take them all."""
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=100,
                                     device="cpu")
    if ndim == 8:
        assert case["cube0"] > 2 ** 32
    if ndim == 16:
        assert (case["ng"], case["npg"]) == (2, 152)
    r = kernel_check.check_sampler(case, None, with_hist=True, rng="device")
    assert r["samples"] == case["chunk_cubes"] * case["npg"]
    kernel_check.check_sampler(case, genz.f5_c0_continuous(ndim),
                               with_hist=True, rng="device")
    kernel_check.check_stream(case)
    kernel_check.check_bin_resolve_stratified(ndim, ncall, chunk, 100,
                                              device="cpu")
    xs, wt, ia = cuda_vegas.sample_chunk(
        case["pmap"], None, case["ng"], case["npg"], case["chunk_cubes"],
        100, True, case["xjac"], case["cube0"], case["ncubes"], 1, 2,
        emit_points=True)
    assert torch.isfinite(xs).all() and (wt >= 0).all()
    assert 0 <= int(ia.min()) and int(ia.max()) < 100
    assert 0.0 <= float(xs.min()) and float(xs.max()) <= 1.0


def test_kernel_check_catches_a_wrong_sampler(monkeypatch):
    """A sampler that clips to the wrong bound, weights wrongly or bins
    wrongly fails the check."""
    case = kernel_check.sampler_case(3, 2e4, 256, nbins=50, degree=8,
                                     device="cpu")
    plain = cuda_vegas.sample_chunk_plain

    def wrong_x(*a, **kw):
        xs, wt, ia = plain(*a, **kw)
        return xs * (1 + 1e-4), wt, ia

    def wrong_ia(*a, **kw):
        xs, wt, ia = plain(*a, **kw)
        return xs, wt, torch.clamp(ia + 1, max=49)

    def wrong_sum(*a, **kw):
        sums, ia, f2 = plain(*a, **kw)
        return sums * (1 + 1e-3), ia, f2

    for fake, integrand, match in ((wrong_x, None, "x_ulps"),
                                   (wrong_ia, None, "bin ids differ"),
                                   (wrong_sum, genz.f1_oscillatory(3),
                                    "fb_ulps")):
        monkeypatch.setattr(cuda_vegas, "sample_chunk", fake)
        with pytest.raises(AssertionError, match=match):
            kernel_check.check_sampler(case, integrand, with_hist=True,
                                       rng="device")


def test_kernel_check_catches_a_wrong_lookup(monkeypatch):
    plain_hist = cuda_lookup.hist_plain
    calls = []

    def drifting_hist(ia, f2, nbins):
        calls.append(1)
        return plain_hist(ia, f2, nbins) * (1 + 1e-7 * len(calls))

    monkeypatch.setattr(cuda_lookup, "hist", drifting_hist)
    with pytest.raises(AssertionError, match="two launches"):
        kernel_check.check_hist(2, 2000, 20, device="cpu")

    def fused_rc(xi32, xn, nbins, *, with_ia=False):
        rc, xo, ia = cuda_lookup.bin_resolve_plain(xi32, xn, nbins,
                                                   with_ia=with_ia)
        return rc * (1 + 1e-6), xo, ia

    monkeypatch.setattr(cuda_lookup, "bin_resolve", fused_rc)
    with pytest.raises(AssertionError, match="rc .* ulps"):
        kernel_check.check_bin_resolve(2, 2000, 20, device="cpu")
