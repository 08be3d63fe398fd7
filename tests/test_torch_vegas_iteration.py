"""One whole VEGAS iteration of the port against the JAX package's, on the
same uniforms.

The reference draws its uniforms from ``jax.random``; the test patches
``jax.random.uniform`` (XLA chunk bodies) or ``jax.random.bits`` (the
Pallas kernel in interpret mode) to return numpy-seeded numbers and hands
the port the same words through ``bits=``.  Nothing in the JAX package
changes.  With the same uniforms the two compute the same samples:

* the plain chunk bodies (grid map; poly map with sampler 'torch' against
  the reference's 'xla') agree in ti and tsi to 1e-12 relative in f64 (the
  f32 sampling machinery is the same operation for operation; only the
  order of the f64 sums differs) and in the histogram to 1e-6.  That holds
  against the reference run eagerly (``jax.disable_jit``), each operation
  rounded on its own.  Its ``lax.fori_loop`` body is otherwise compiled
  even outside ``jit``, and XLA then contracts the f32 multiply-adds of
  the sampling machinery, which moves the sums by ~1e-8: the compiled
  reference is held to 1e-6;
* with the integrand evaluated in f32, to 1e-5 (exp differs by an ulp);
* samplers 'hybrid' and 'fused' against the reference's 'hybrid' and
  'pallas' kernels agree to 1e-5 and 2e-4: the Chebyshev recurrence may be
  contracted differently, which moves each coordinate by ulps.
"""
from unittest import mock

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.integrand import make_integrand as jax_make_integrand
from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.mcubes.poly_importance import fit_importance_poly
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz

NDIM, NG, NPG, NBINS = 3, 6, 2, 50
NCUBES = NG ** NDIM                      # 216 cubes in a chunk of 256
CHUNK = 256
LOWS = {"unit": np.zeros(NDIM), "non-unit": np.array([0.1, -0.5, 0.2])}
HIGHS = {"unit": np.ones(NDIM), "non-unit": np.array([0.9, 1.0, 1.4])}


def _setup(volume, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((NDIM, NBINS)) + 0.05
    xi = np.concatenate([np.zeros((NDIM, 1)), np.cumsum(w, axis=1)], axis=1)
    xi /= xi[:, -1:]
    bits = rng.integers(0, 2 ** 32, (NPG * NDIM, CHUNK),
                        dtype=np.uint64).astype(np.uint32)
    lo, hi = LOWS[volume], HIGHS[volume]
    xjac = float(np.prod(hi - lo)) / (NPG * NCUBES)
    return xi, bits, lo, hi - lo, xjac


def _integrands():
    fj, _ = jax_make_integrand(jax_genz.f4_gaussian(NDIM, a=3.0), NDIM)
    g = genz.f4_gaussian(NDIM, a=3.0)
    ft, _ = make_integrand(g, NDIM)
    return fj, ft, g


def _ran(bits):
    """The port's uniforms of ``bits`` as the reference's (C, npg, ndim)."""
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return jnp.asarray(np.moveaxis(u.reshape(NPG, NDIM, CHUNK), -1, 0))


def _assert_close(sums, d, ti, tsi, d_ref, rtol, with_hist):
    assert float(sums[0]) == pytest.approx(float(ti), rel=rtol)
    assert float(sums[1]) == pytest.approx(float(tsi), rel=rtol)
    d_ref = np.asarray(d_ref)
    assert d.dtype == torch.float32 and tuple(d.shape) == (NDIM, NBINS)
    if with_hist:
        assert d_ref.sum() > 0
        np.testing.assert_allclose(d.numpy(), d_ref, rtol=max(rtol, 1e-6),
                                   atol=1e-6 * d_ref.max())
    else:
        assert not d.numpy().any() and not d_ref.any()


REFERENCE_RUNS = {"eager": (jax.disable_jit, 1e-12),
                  "compiled": (contextlib.nullcontext, 1e-6)}


@pytest.mark.parametrize("reference", list(REFERENCE_RUNS))
@pytest.mark.parametrize("eval_dtype", [None, "float32"])
@pytest.mark.parametrize("volume", ["unit", "non-unit"])
@pytest.mark.parametrize("with_hist", [True, False])
def test_grid_iteration_matches_reference(with_hist, volume, eval_dtype,
                                          reference):
    how, rtol = REFERENCE_RUNS[reference]
    xi, bits, lo, dx, xjac = _setup(volume)
    fj, ft, _ = _integrands()
    with mock.patch("jax.random.uniform", return_value=_ran(bits)), \
            how():
        ti, tsi, d_ref = JV._vegas_iteration.__wrapped__(
            fj, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, "float64",
            jax.random.PRNGKey(0), jnp.asarray(xi), jnp.asarray(lo),
            jnp.asarray(dx), jnp.asarray(xjac), jnp.asarray(NCUBES, jnp.int64),
            eval_dtype_name=eval_dtype)
    sums, d = V._vegas_iteration(
        ft, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, torch.float64, 0, 1,
        torch.as_tensor(xi), torch.as_tensor(lo), torch.as_tensor(dx), xjac,
        NCUBES, eval_dtype=getattr(torch, eval_dtype) if eval_dtype else None,
        bits=torch.as_tensor(bits.view(np.int32)))
    _assert_close(sums, d, ti, tsi, d_ref, 1e-5 if eval_dtype else rtol,
                  with_hist)
    # the plain route computes the same bits as the dispatching one here
    sums_p, d_p = V._vegas_iteration(
        ft, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, torch.float64, 0, 1,
        torch.as_tensor(xi), torch.as_tensor(lo), torch.as_tensor(dx), xjac,
        NCUBES, eval_dtype=getattr(torch, eval_dtype) if eval_dtype else None,
        plain=True, bits=torch.as_tensor(bits.view(np.int32)))
    assert torch.equal(sums, sums_p) and torch.equal(d, d_p)


@pytest.mark.parametrize("reference", list(REFERENCE_RUNS))
@pytest.mark.parametrize("eval_dtype", [None, "float32"])
@pytest.mark.parametrize("volume", ["unit", "non-unit"])
@pytest.mark.parametrize("with_hist", [True, False])
def test_poly_iteration_matches_reference(with_hist, volume, eval_dtype,
                                          reference):
    how, rtol = REFERENCE_RUNS[reference]
    xi, bits, lo, dx, xjac = _setup(volume, seed=1)
    fj, ft, g = _integrands()
    p, q = fit_importance_poly(xi, 8)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    with mock.patch("jax.random.uniform", return_value=_ran(bits)), \
            how():
        ti, tsi, d_ref = JV._vegas_iteration_poly.__wrapped__(
            fj, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, "float64",
            jax.random.PRNGKey(0), jnp.asarray(p32), jnp.asarray(q32),
            jnp.asarray(lo), jnp.asarray(dx), jnp.asarray(xjac),
            jnp.asarray(NCUBES, jnp.int64), eval_dtype_name=eval_dtype)
    sums, d = V._vegas_iteration_poly(
        ft, g, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, torch.float64, 0, 1,
        torch.as_tensor(p32), torch.as_tensor(q32), torch.as_tensor(lo),
        torch.as_tensor(dx), xjac, NCUBES,
        eval_dtype=getattr(torch, eval_dtype) if eval_dtype else None,
        sampler="torch", bits=torch.as_tensor(bits.view(np.int32)))
    _assert_close(sums, d, ti, tsi, d_ref, 1e-5 if eval_dtype else rtol,
                  with_hist)


@pytest.mark.parametrize("sampler,ref_sampler,rtol", [
    ("hybrid", "hybrid", 1e-5), ("fused", "pallas", 2e-4)])
@pytest.mark.parametrize("with_hist", [True, False])
def test_kernel_samplers_match_reference_kernels(with_hist, sampler,
                                                 ref_sampler, rtol):
    """The port's 'hybrid' and 'fused' (plain versions on the CPU) against
    the Pallas kernel in interpret mode with the same words.  The fused
    integrand is the scalar-per-axis twin of the Genz family."""
    xi, bits, lo, dx, xjac = _setup("non-unit", seed=2)
    fj, ft, g = _integrands()
    p, q = fit_importance_poly(xi, 8)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)

    def f_axes(x, y, z):
        return jnp.exp(-(9.0 * (x - 0.5) ** 2 + 9.0 * (y - 0.5) ** 2
                         + 9.0 * (z - 0.5) ** 2))

    ref_bits = jnp.asarray(bits.reshape(NPG * NDIM, CHUNK // 128, 128))
    ed = "float32" if sampler == "fused" else None
    with mock.patch("jax.random.bits", return_value=ref_bits):
        ti, tsi, d_ref = JV._vegas_iteration_poly.__wrapped__(
            fj, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, "float64",
            jax.random.PRNGKey(0), jnp.asarray(p32), jnp.asarray(q32),
            jnp.asarray(lo), jnp.asarray(dx), jnp.asarray(xjac),
            jnp.asarray(NCUBES, jnp.int64), eval_dtype_name=ed,
            sampler=ref_sampler, f_axes=f_axes, tile_a=1)
    sums, d = V._vegas_iteration_poly(
        ft, g, NDIM, NG, NPG, CHUNK, 1, NBINS, with_hist, torch.float64, 0, 1,
        torch.as_tensor(p32), torch.as_tensor(q32), torch.as_tensor(lo),
        torch.as_tensor(dx), xjac, NCUBES,
        eval_dtype=torch.float32 if ed else None, sampler=sampler,
        bits=torch.as_tensor(bits.view(np.int32)))
    _assert_close(sums, d, ti, tsi, d_ref, rtol, with_hist)


def test_iteration_chunks_add_up():
    """An iteration cut into chunks draws the same stream as one chunk:
    the sums agree to the order of the f64 additions, for every route."""
    xi, _, lo, dx, xjac = _setup("non-unit", seed=3)
    _, ft, g = _integrands()
    p, q = fit_importance_poly(xi, 8)
    p32 = torch.as_tensor(p.astype(np.float32))
    q32 = torch.as_tensor(q.astype(np.float32))
    t = [torch.as_tensor(a) for a in (lo, dx)]

    def poly(sampler, chunk):
        return V._vegas_iteration_poly(
            ft, g, NDIM, NG, NPG, chunk, -(-NCUBES // chunk), NBINS, True,
            torch.float64, 5, 3, p32, q32, *t, xjac, NCUBES, sampler=sampler)

    def grid(chunk):
        return V._vegas_iteration(
            ft, NDIM, NG, NPG, chunk, -(-NCUBES // chunk), NBINS, True,
            torch.float64, 5, 3, torch.as_tensor(xi), *t, xjac, NCUBES)

    for run in (lambda c: poly("torch", c), lambda c: poly("hybrid", c),
                lambda c: poly("fused", c), grid):
        one, d_one = run(NCUBES)
        many, d_many = run(50)          # 5 chunks, the last one padded
        np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-13)
        np.testing.assert_allclose(d_many.numpy(), d_one.numpy(), rtol=1e-6)
