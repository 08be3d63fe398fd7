"""PAGANI's VEGAS-assisted hybrid (gpuintegration_torch/pagani/
vegas_assisted.py) on the CPU against the JAX package's
(gpuintegration_tpu/pagani/vegas_assisted.py and tests/
test_workspace_features.py::TestVegasAssisted).

One pass over regions given the same uniforms (``jax.random.uniform``
patched in the reference) is held to roundoff; whole runs, whose draws
are the port's Philox stream and not the reference's Threefry, are held
statistically.  The port runs with ``torch.set_flush_denormal(True)``, as
XLA on the CPU flushes subnormals."""
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.pagani import vegas_assisted as JA
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.pagani import vegas_assisted as TA

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _pool(ndim, R, seed):
    """R random sub-regions of the unit cube, dims-major (ndim, R)."""
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(0.05, 0.5, (ndim, R))
    lows = rng.random((ndim, R)) * (1.0 - lengths)
    return lows, lengths


def _pass_both(g_t, g_j, ndim, R, spp, nbins, seed, *, lo=None, rng_=None):
    """One pass of each package on the same pool, grids and uniforms."""
    rng = np.random.default_rng(seed)
    lows, lengths = _pool(ndim, R, seed)
    grids = np.sort(rng.random((R, ndim, nbins + 1)), axis=-1).astype(
        np.float32)
    grids[..., 0], grids[..., -1] = 0.0, 1.0
    u_bin = rng.random((R, spp, ndim)).astype(np.float32)
    u_pos = rng.random((R, spp, ndim)).astype(np.float32)
    glo = np.zeros(ndim) if lo is None else np.asarray(lo)
    grange = np.ones(ndim) if rng_ is None else np.asarray(rng_)
    draws = iter([jnp.asarray(u_bin), jnp.asarray(u_pos)])
    with mock.patch("jax.random.uniform",
                    side_effect=lambda *a, **k: next(draws)):
        ref = JA._sample_regions_pass(
            g_j, jax.random.PRNGKey(0), jnp.asarray(grids),
            jnp.asarray(lows), jnp.asarray(lengths), jnp.asarray(glo),
            jnp.asarray(grange), nbins, spp, jnp.float64)
    got = TA._sample_regions_pass(
        g_t, (torch.as_tensor(u_bin), torch.as_tensor(u_pos)),
        torch.as_tensor(grids), torch.as_tensor(lows),
        torch.as_tensor(lengths), torch.as_tensor(glo),
        torch.as_tensor(grange), nbins, torch.float64)
    return ([np.asarray(a) for a in ref], [t.numpy() for t in got],
            (grids, u_bin, u_pos))


CASES = {
    "F4 2D": (2, dict(a=5.0), None, None),
    "F4 3D in a volume": (3, dict(a=3.0), [0.1, -1.0, 0.5], [0.8, 2.0, 1.5]),
    "F2 4D": (4, dict(a=5.0), None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_regions_pass_matches_reference(case):
    ndim, params, lo, rng_ = CASES[case]
    family = "f2_product_peak" if case.startswith("F2") else "f4_gaussian"
    g_t = getattr(genz, family)(ndim, **params)
    from gpuintegration_tpu.models import genz as jax_genz
    g_j = getattr(jax_genz, family)(ndim, **params)
    (u_r, wf_r, grid_r), (u, wf, grids), (g0, _, _) = _pass_both(
        g_t, g_j, ndim, 24, 64, 20, 3, lo=lo, rng_=rng_)
    # the point inside its cell, lo + u_pos * width in f32: the same bits
    assert np.array_equal(u, u_r)
    # the importance-weighted values in f64 at the same points: the weight's
    # product and the integrand to roundoff (read: 4.3e-16)
    np.testing.assert_allclose(wf, wf_r, rtol=1e-14, atol=0)
    # the grids refined on this pass's histogram: the f^2 sums add in
    # another order (f32), and the rebin's weights follow them (read:
    # 1.5e-6, some 12 f32 ulps of an edge near 1)
    np.testing.assert_allclose(grids, grid_r, rtol=0, atol=1e-5)
    assert np.all(grids[..., 0] == 0) and np.all(grids[..., -1] == 1)
    assert not np.array_equal(grids, g0)


def test_region_hist_sums_f2_by_bin():
    rng = np.random.default_rng(5)
    bins = torch.as_tensor(rng.integers(0, 7, (5, 40, 3)), dtype=torch.int32)
    f2 = torch.as_tensor(rng.random((5, 40)), dtype=torch.float32)
    got = TA._region_hist(bins, f2, 7).numpy()
    want = np.zeros((5, 3, 7), np.float64)
    for r in range(5):
        for s in range(40):
            for d in range(3):
                want[r, d, int(bins[r, s, d])] += float(f2[r, s])
    np.testing.assert_allclose(got, want, rtol=4 * EPS32)
    assert np.array_equal(got, TA._region_hist(bins, f2, 7).numpy())


def test_huge_magnitude_pass_keeps_adaptation():
    """The per-region max-normalised histogram: a 2^73-scaled integrand
    refines the same grids, and its values scale exactly."""
    g = genz.f4_gaussian(2, a=5.0)
    s = 2.0 ** 73
    rng = np.random.default_rng(1)
    lows, lengths = (torch.as_tensor(a) for a in _pool(2, 16, 1))
    grids = TA.uniform_grids(16, 2, 100, "cpu")
    draws = tuple(torch.as_tensor(rng.random((16, 50, 2)), dtype=torch.float32)
                  for _ in range(2))
    args = (draws, grids, lows, lengths, torch.zeros(2, dtype=torch.float64),
            torch.ones(2, dtype=torch.float64), 100, torch.float64)
    _, wf1, g1 = TA._sample_regions_pass(g, *args)
    _, wf2, g2 = TA._sample_regions_pass(lambda x: s * g(x), *args)
    assert torch.equal(g1, g2) and torch.equal(wf2, s * wf1)
    assert torch.isfinite(g2).all()


def test_draws_repeat_and_do_not_depend_on_chunking():
    ids = torch.arange(100, dtype=torch.int64)
    a = TA.region_draws(3, 2, 1, ids, 16, 5)
    b = TA.region_draws(3, 2, 1, ids[40:60], 16, 5)
    assert torch.equal(a[0][40:60], b[0]) and torch.equal(a[1][40:60], b[1])
    assert all(t.dtype == torch.float32 and t.shape == (100, 16, 5)
               for t in a)
    u = torch.cat([a[0].reshape(-1), a[1].reshape(-1)])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    for other in (TA.region_draws(4, 2, 1, ids, 16, 5),
                  TA.region_draws(3, 3, 1, ids, 16, 5),
                  TA.region_draws(3, 2, 2, ids, 16, 5)):
        assert not torch.equal(a[0], other[0])
    assert not torch.equal(a[0], a[1])
    with pytest.raises(ValueError, match="pass"):
        TA.region_draws(3, 2, TA.max_passes(5), ids, 16, 5)


def test_estimates_match_reference_statistically():
    """Per-region estimates of a pool: the port's sum and the reference's
    within 5 combined standard errors of each other and of the truth; and
    the estimates do not depend on the chunk size."""
    g = genz.f4_gaussian(3, a=5.0)
    from gpuintegration_tpu.models import genz as jax_genz
    gj = jax_genz.f4_gaussian(3, a=5.0)
    # a partition of the unit cube into 4^3 cells
    edges = np.arange(4) / 4.0
    lows = np.stack(np.meshgrid(edges, edges, edges, indexing="ij")).reshape(
        3, -1)
    lengths = np.full_like(lows, 0.25)
    one = torch.ones(3, dtype=torch.float64)
    args = (3, 6, 128, 100, torch.float64, 7, 0, torch.as_tensor(lows),
            torch.as_tensor(lengths), torch.zeros(3, dtype=torch.float64),
            one)
    est, err = TA.vegas_assisted_estimates(g, *args, chunk=64)
    est2, err2 = TA.vegas_assisted_estimates(g, *args, chunk=10)
    assert torch.equal(est, est2) and torch.equal(err, err2)
    re, rr = (np.asarray(a) for a in JA.vegas_assisted_estimates(
        gj, 3, 6, 128, 100, "float64", jax.random.PRNGKey(7),
        jnp.asarray(lows), jnp.asarray(lengths), jnp.zeros(3), jnp.ones(3)))
    s, e = float(est.sum()), math.sqrt(float((err ** 2).sum()))
    rs, re_ = float(re.sum()), math.sqrt(float((rr ** 2).sum()))
    assert abs(s - g.true_value) < 5 * e
    assert abs(rs - g.true_value) < 5 * re_
    assert abs(s - rs) < 5 * math.hypot(e, re_)
    assert 0.5 < e / re_ < 2.0
    # slots outside ``ranges`` stay 0
    part, _ = TA.vegas_assisted_estimates(g, *args, chunk=64,
                                          ranges=[(3, 9)])
    assert torch.equal(part[3:9], est[3:9])
    assert float(part[:3].abs().sum() + part[9:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Workspace.integrate(vegas_assisted=True)
# (tests/test_workspace_features.py::TestVegasAssisted on the port)

KW = dict(epsrel=5e-3, epsabs=1e-40, vegas_assisted=True, max_iterations=8,
          vegas_passes=4, vegas_samples_per_pass=256, seed=3)


def test_hybrid_converges_statistically():
    g = genz.f4_gaussian(2, a=5.0)
    r = Workspace(2, chunk_size=1024, device="cpu").integrate(g, **KW)
    assert abs(r.estimate - g.true_value) < 5 * max(r.errorest, 1e-6)
    assert r.iters == 8 and r.neval > 0


def test_huge_magnitude_keeps_adaptation():
    g = genz.f4_gaussian(2, a=5.0)
    scale = 2.0 ** 73

    def gs(x, y):
        return scale * g(torch.stack([x, y], dim=-1))

    r1 = Workspace(2, chunk_size=1024, device="cpu").integrate(g, **KW)
    r2 = Workspace(2, chunk_size=1024, device="cpu").integrate(gs, **KW)
    assert math.isfinite(r2.estimate) and r2.estimate != 0.0
    assert r2.estimate / scale == pytest.approx(r1.estimate, rel=1e-12)
    assert r2.errorest / scale == pytest.approx(r1.errorest, rel=1e-9)


def test_hybrid_certifies_and_repeats():
    """A run that certifies: F4 3D (a = 5) at 1e-2 with the default passes,
    within 5 errorests of its closed form; the same seed repeats, another
    seed draws other samples."""
    g = genz.f4_gaussian(3, a=5.0)
    ws = Workspace(3, device="cpu")
    a = ws.integrate(g, 1e-2, 1e-40, vegas_assisted=True, seed=1)
    b = ws.integrate(g, 1e-2, 1e-40, vegas_assisted=True, seed=1)
    assert a.status == 0 and abs(a.estimate - g.true_value) < 5 * a.errorest
    assert (a.estimate, a.errorest, a.iters) == (b.estimate, b.errorest,
                                                 b.iters)
    c = ws.integrate(g, 1e-2, 1e-40, vegas_assisted=True, seed=2)
    assert c.estimate != a.estimate


def test_refusals():
    def vector(x, y):
        return torch.stack([x, y], dim=-1)

    with pytest.raises(ValueError, match="vegas_assisted"):
        Workspace(2, device="cpu").integrate(vector, vegas_assisted=True)
    with pytest.raises(ValueError, match="vegas_assisted"):
        Workspace(2, device="cpu").integrate(genz.f4_gaussian(2),
                                             vegas_assisted=True,
                                             crease_split=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Workspace(2, device="cpu", mesh=object())
