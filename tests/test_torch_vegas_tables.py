"""The port's VEGAS set-up arithmetic, grid maintenance and importance-map
fit against the JAX package's: the same numpy inputs through both.

Host-side tables (lattice sizes, schedules, the cube decode, grids, the
refinement, the fitted Chebyshev coefficients, chi2_prob) must be EQUAL bit
for bit.  The f32 map evaluation ``eval_map_and_weight`` is held to the
series' rounding scale: each coordinate within 4 f32 ulps of sum_i |p_i|
(the two frameworks may contract the recurrence's multiply-adds
differently), the weight within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes import grid as jax_grid
from gpuintegration_tpu.mcubes import poly_importance as jax_poly
from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.utils import stats as jax_stats
from gpuintegration_torch.mcubes import cuda_lookup, grid, poly_importance
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.utils import stats


def _grid(ndim, nbins, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((ndim, nbins)) + 0.05
    xi = np.concatenate([np.zeros((ndim, 1)), np.cumsum(w, axis=1)], axis=1)
    return xi / xi[:, -1:]


@pytest.mark.parametrize("ncall", [2e4, 1e5, 1e6, 1e8, 1e9, 3.7e10])
@pytest.mark.parametrize("ndim", [1, 2, 3, 5, 6, 8, 16])
def test_lattice_sizes_equal(ncall, ndim):
    assert V.compute_ncubes(ncall, ndim) == JV.compute_ncubes(ncall, ndim)
    _, ncubes = V.compute_ncubes(ncall, ndim)
    assert V.samples_per_cube(ncall, ncubes) == JV.samples_per_cube(
        ncall, ncubes)


@pytest.mark.parametrize("ncall,iters", [(1e6, 15), (2e9, 15), (9e9, 15),
                                         (9e9, 100), (8e9, 99), (1e9, 15)])
def test_adjust_params_equal(ncall, iters):
    assert V.adjust_params(ncall, iters) == JV.adjust_params(ncall, iters)


@pytest.mark.parametrize("args", [
    (1.0, 1e-9, 3, 1e-3, 1e-12), (1.0, 1e-9, 5, 1e-3, 1e-12),
    (1.0, 0.5, 7, 1e-3, 1e-12), (0.0, 1e-13, 6, 1e-3, 1e-12),
    (0.0, 1e-3, 6, 1e-3, 1e-12), (-2.0, 1e-3, 9, 1e-3, 0.0)])
def test_get_status_equal(args):
    assert V.get_status(*args) == JV.get_status(*args)


@pytest.mark.parametrize("ng,ndim", [(7, 3), (19, 6), (1024, 4), (3, 16)])
def test_decode_cube_equal(ng, ndim):
    """int64 ids up to ng^ndim = 2^40, first, last and random cubes."""
    ncubes = ng ** ndim
    rng = np.random.default_rng(ng)
    ids = np.concatenate([np.arange(min(ncubes, 300)),
                          rng.integers(0, ncubes, 500),
                          [ncubes - 1]]).astype(np.int64)
    got = V._decode_cube(torch.as_tensor(ids), ng, ndim).numpy()
    want = np.asarray(JV._decode_cube(jnp.asarray(ids), ng, ndim))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.min() >= 1 and got.max() <= ng


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndim,nbins", [(1, 2), (3, 10), (6, 500), (2, 37)])
def test_uniform_grid_equal(ndim, nbins, dtype):
    got = grid.uniform_grid(ndim, nbins, getattr(torch, dtype), "cpu")
    want = np.asarray(jax_grid.uniform_grid(ndim, nbins, jnp.dtype(dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_constants_equal():
    assert (grid.NDMX, grid.ALPH, grid.TINY) == (
        jax_grid.NDMX, jax_grid.ALPH, jax_grid.TINY)
    from gpuintegration_tpu.mcubes.pallas_lookup import HIST_CAP
    assert cuda_lookup.HIST_CAP == HIST_CAP == V._HIST_CAP
    assert poly_importance.DEFAULT_DEGREE == jax_poly.DEFAULT_DEGREE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rebin_row_equal(seed):
    rng = np.random.default_rng(seed)
    nb = 37 + 100 * seed
    xi = np.concatenate([[0.0], np.sort(rng.random(nb - 1)), [1.0]])
    r = rng.random(nb) + 1e-3
    r[rng.integers(0, nb, 3)] = 0.0
    np.testing.assert_array_equal(grid.rebin_row(xi, r),
                                  jax_grid.rebin_row(xi, r))


def _histograms():
    rng = np.random.default_rng(5)
    plain = rng.random((4, 60)) ** 6
    zero_dim = plain.copy()
    zero_dim[1] = 0.0
    peak = np.zeros((4, 60))
    peak[:, 20:23] = 1.0
    saturated = plain.astype(np.float32)
    saturated[0, 5:9] = cuda_lookup.HIST_CAP
    saturated[2, :] = cuda_lookup.HIST_CAP
    poisoned = plain.astype(np.float32)
    poisoned[3, 7] = np.inf
    poisoned[0, 1] = np.nan
    return {"random": plain, "zero-mass dimension": zero_dim, "peak": peak,
            "saturated at HIST_CAP": saturated, "inf and nan": poisoned}


@pytest.mark.parametrize("name", list(_histograms()))
def test_smooth_and_refine_equal(name):
    d = _histograms()[name]
    xi = _grid(4, 60, 11)
    want = jax_grid.smooth_and_refine(xi, d)
    np.testing.assert_array_equal(grid.smooth_and_refine(xi, d), want)
    # tensors in, as the integrator holds them
    got = grid.smooth_and_refine(torch.as_tensor(xi), torch.as_tensor(d))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    if name == "zero-mass dimension":
        np.testing.assert_array_equal(got[1], xi[1])


def test_smooth_and_refine_two_steps_equal():
    """Refinement feeds on itself: two steps stay equal."""
    rng = np.random.default_rng(9)
    xi_t = xi_j = _grid(3, 500, 2)
    for _ in range(2):
        d = (rng.random((3, 500)) ** 10).astype(np.float32)
        xi_t = grid.smooth_and_refine(xi_t, d)
        xi_j = jax_grid.smooth_and_refine(xi_j, d)
    np.testing.assert_array_equal(xi_t, xi_j)


@pytest.mark.parametrize("degree", [8, 14])
@pytest.mark.parametrize("ndim,nbins", [(3, 50), (6, 500)])
def test_fit_importance_poly_equal(ndim, nbins, degree):
    xi = _grid(ndim, nbins, degree + ndim)
    p, q = poly_importance.fit_importance_poly(xi, degree)
    pj, qj = jax_poly.fit_importance_poly(xi, degree)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(q, qj)
    assert p.shape == (ndim, 2 * degree + 2) and q.shape == (ndim, degree + 1)


@pytest.mark.parametrize("chi2,dof", [(0.0, 3.0), (2.5, 4.0), (30.0, 9.0),
                                      (1.2, 1.0), (7.0, 0.0), (float("inf"), 3.0),
                                      (250.0, 14.0)])
def test_chi2_prob_equal(chi2, dof):
    assert stats.chi2_prob(chi2, dof) == jax_stats.chi2_prob(chi2, dof)
    if dof > 0 and np.isfinite(chi2) and chi2 > 0:
        assert stats.gammainc_lower(0.5 * dof, 0.5 * chi2) == (
            jax_stats.gammainc_lower(0.5 * dof, 0.5 * chi2))


@pytest.mark.parametrize("degree", [8, 14])
def test_eval_map_and_weight_matches_jax(degree):
    """Scale: each coordinate's series has rounding scale sum_i |p_i|;
    4 ulps of it.  The weight, a product of squares, to rtol 1e-5."""
    ndim, nbins = 4, 200
    p, q = poly_importance.fit_importance_poly(_grid(ndim, nbins, degree),
                                               degree)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    rng = np.random.default_rng(degree)
    s = rng.random((3000, 2, ndim), dtype=np.float32)
    s[0, 0] = 0.0
    s[0, 1] = 1.0
    xj, wj = jax_poly.eval_map_and_weight(jnp.asarray(p32), jnp.asarray(q32),
                                          jnp.asarray(s))
    xt, wt = poly_importance.eval_map_and_weight(
        torch.as_tensor(p32), torch.as_tensor(q32), torch.as_tensor(s))
    assert xt.dtype == torch.float32 and tuple(xt.shape) == s.shape
    scale = np.abs(p32).sum(axis=1)                              # (ndim,)
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(xt.numpy() - np.asarray(xj)) <= 4 * eps * scale)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5)
    assert xt.min() >= 0.0 and xt.max() <= 1.0


def test_clenshaw_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.standard_normal(12)
    t = rng.uniform(-1.0, 1.0, 200)
    got = poly_importance.clenshaw(torch.as_tensor(c), 12, torch.as_tensor(t))
    want = jax_poly.clenshaw(jnp.asarray(c), 12, jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(
        got.numpy(), np.polynomial.chebyshev.chebval(t, c), atol=1e-13)
