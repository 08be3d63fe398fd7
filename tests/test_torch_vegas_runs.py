"""Whole VEGAS runs of the port on the CPU against the JAX package's, and
the behaviour of the entry points.

The two packages draw different streams (Threefry there, the port's Philox
here), so whole runs are compared statistically, on the pattern of
tests/test_vegas.py: status 0, the truth within 4 errorest, errorest within
a factor 2 of the reference's, the same neval and iterations, chi-squared
probability in (0.001, 1].  Seeds are fixed, so every outcome is
deterministic.  State carried across (``convert``) must be equal bit for
bit; the continuation is again compared statistically.
"""
import functools
import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.mcubes.poly_importance import (
    fit_importance_poly as jax_fit)
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import Volume, convert, mcubes
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.mcubes import debug, grid, poly_importance
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz

CASES = {
    "gaussian 3D": (lambda m: m.f4_gaussian(3, a=5.0),
                    dict(epsrel=5e-3, ncall=5e4)),
    "product peak 5D": (lambda m: m.f2_product_peak(5, a=5.0),
                        dict(epsrel=5e-3, ncall=1e5)),
}
ROUTES = [("poly", "torch"), ("poly", "fused"), ("poly", "hybrid"),
          ("grid", None), ("grid", "torch")]
# every iteration run and accumulated from the third on: 6 of 8 counted
FIXED = dict(epsrel=1e-9, epsabs=1e-300, total_iters=8, adjust_iters=5,
             skip_iters=2, seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _reference(case, importance, fixed):
    make, kw = CASES[case]
    kw = dict(kw, **FIXED) if fixed else dict(kw, seed=1)
    return JV.integrate(make(jax_genz), importance=importance, **kw)


@pytest.mark.parametrize("importance,sampler", ROUTES)
@pytest.mark.parametrize("case", list(CASES))
def test_converging_run_matches_reference(case, importance, sampler):
    make, kw = CASES[case]
    g = make(genz)
    ref = _reference(case, importance, False)
    r = mcubes.integrate(g, importance=importance, sampler=sampler, seed=1,
                         device="cpu", **kw)
    assert r.status == ref.status == 0
    assert (r.iters, r.neval) == (ref.iters, ref.neval) and r.iters == 6
    assert abs(r.estimate - g.true_value) <= 4 * r.errorest
    assert r.errorest / abs(r.estimate) <= kw["epsrel"]
    assert 0.5 < r.errorest / ref.errorest < 2.0
    assert r.lastPhase == ref.lastPhase == 0 and r.nregions == 0


@pytest.mark.parametrize("importance,sampler", ROUTES)
@pytest.mark.parametrize("case", list(CASES))
def test_fixed_length_run_matches_reference(case, importance, sampler):
    make, kw = CASES[case]
    g = make(genz)
    ref = _reference(case, importance, True)
    r = mcubes.integrate(g, importance=importance, sampler=sampler,
                         device="cpu", **dict(kw, **FIXED))
    assert r.status == ref.status == 1
    assert (r.iters, r.neval, r.lastPhase) == (ref.iters, ref.neval, 1)
    assert abs(r.estimate - g.true_value) <= 4 * r.errorest
    assert abs(r.estimate - ref.estimate) <= 4 * math.hypot(r.errorest,
                                                            ref.errorest)
    assert 0.5 < r.errorest / ref.errorest < 2.0
    assert 0.001 < r.prob <= 1.0 and r.chi_sq > 0.0
    from gpuintegration_torch.utils.stats import chi2_prob
    assert r.prob == pytest.approx(chi2_prob(r.chi_sq * (6 - 0.9999), 5.0),
                                   abs=1e-12)


@pytest.mark.parametrize("importance,sampler", ROUTES)
def test_fixed_seed_repeats_bitwise(importance, sampler):
    g = genz.f4_gaussian(2, a=3.0)
    kw = dict(ncall=1e4, total_iters=6, adjust_iters=4, importance=importance,
              sampler=sampler, device="cpu")
    r1 = mcubes.integrate(g, seed=42, **kw)
    r2 = mcubes.integrate(g, seed=42, **kw)
    r3 = mcubes.integrate(g, seed=43, **kw)
    assert (r1.estimate, r1.errorest, r1.chi_sq) == (r2.estimate, r2.errorest,
                                                     r2.chi_sq)
    assert r3.estimate != r1.estimate


def test_estimate_does_not_depend_on_chunking_beyond_roundoff():
    """The stream is keyed on the cube, not on the chunk: another
    ``chunk_cubes`` changes only the order of the f64 sums."""
    g = genz.f4_gaussian(3, a=5.0)
    kw = dict(epsrel=5e-3, ncall=5e4, seed=1, device="cpu")
    whole = mcubes.integrate(g, **kw)
    cut = mcubes.integrate(g, chunk_cubes=5000, **kw)
    assert (cut.iters, cut.neval) == (whole.iters, whole.neval)
    assert cut.estimate == pytest.approx(whole.estimate, rel=1e-9)


def test_pull_is_calibrated_over_seeds():
    """|est - truth| rarely exceeds 3 sigma: both maps, ten seeds each."""
    g = genz.f4_gaussian(2, a=3.0)
    for importance in ("poly", "grid"):
        pulls = []
        for seed in range(10):
            r = mcubes.integrate(g, epsrel=1e-4, ncall=2e4, total_iters=8,
                                 adjust_iters=5, seed=seed, device="cpu",
                                 importance=importance)
            pulls.append((r.estimate - g.true_value) / r.errorest)
        assert np.max(np.abs(pulls)) < 4.0, (importance, pulls)
        assert abs(np.mean(pulls)) < 1.5, (importance, pulls)


def test_importance_sampling_beats_uniform():
    g = genz.f4_gaussian(2, a=25.0)
    flat = mcubes.integrate(g, epsrel=0.0, epsabs=0.0, ncall=1e5,
                            total_iters=4, adjust_iters=0, skip_iters=0,
                            seed=9, device="cpu")
    adapted = mcubes.integrate(g, epsrel=0.0, epsabs=0.0, ncall=1e5,
                               total_iters=12, adjust_iters=8, skip_iters=8,
                               seed=9, device="cpu")
    assert adapted.errorest < flat.errorest


def test_volume_transform_and_per_axis_integrand():
    def sin_sum(x, y):
        return torch.sin(x) + torch.sin(y)

    truth = 2.0 * 2.0 * (1.0 - math.cos(2.0))
    vol = Volume([0.0, 0.0], [2.0, 2.0])
    for importance in ("poly", "grid"):
        r = mcubes.integrate(sin_sum, epsrel=1e-3, ncall=5e4, vol=vol,
                             total_iters=10, adjust_iters=6, seed=3,
                             device="cpu", importance=importance)
        assert abs(r.estimate - truth) / truth < 2e-2
        assert abs(r.estimate - truth) <= 5 * r.errorest


def test_one_dimensional():
    def f(x):
        return torch.cos(x[..., 0])

    for importance in ("poly", "grid"):
        r = mcubes.integrate(f, ndim=1, epsrel=1e-3, ncall=2e4,
                             total_iters=10, adjust_iters=6, seed=5,
                             device="cpu", importance=importance)
        assert abs(r.estimate - math.sin(1.0)) / math.sin(1.0) < 1e-2


def test_f32_accumulators_and_eval_dtype():
    g = genz.f4_gaussian(3, a=3.0)
    kw = dict(epsrel=1e-3, ncall=5e4, seed=2, device="cpu")
    r64 = mcubes.integrate(g, **kw)
    r32e = mcubes.integrate(g, eval_dtype=torch.float32, **kw)
    assert r32e.estimate != r64.estimate
    assert r32e.estimate == pytest.approx(r64.estimate, rel=1e-5)
    r32 = mcubes.integrate(g, dtype=torch.float32, **kw)
    assert r32.status == 0
    assert abs(r32.estimate - g.true_value) <= 5 * r32.errorest


def test_huge_magnitude_keeps_the_grid_finite():
    """Per-sample f^2 beyond f32 (1e44+) saturates the histogram at
    HIST_CAP on both maps; grid and estimate stay finite."""
    def big(x):
        return 1e25 * torch.exp(-50.0 * torch.sum((x - 0.5) ** 2, dim=-1)) \
            + 1e22

    for importance in ("grid", "poly"):
        st = V.VegasState(xi=grid.uniform_grid(4, 500, device="cpu"))
        r = V.vegas(big, epsrel=1e-2, epsabs=0.0, ncall=2e4, ndim=4,
                    total_iters=8, adjust_iters=5, seed=3, state=st,
                    importance=importance, device="cpu")
        assert np.isfinite(r.estimate) and np.isfinite(r.errorest)
        assert r.estimate > 1e22
        assert torch.isfinite(st.xi).all()
        assert (torch.diff(st.xi, dim=1) >= 0).all()


# ---------------------------------------------------------------------------
# state

def _state(ndim, nbins=64):
    return V.VegasState(xi=grid.uniform_grid(ndim, nbins, device="cpu"))


def test_resume_draws_fresh_streams_and_counts_all_segments():
    g = genz.f4_gaussian(3, a=3.0)
    kw = dict(epsrel=0.0, epsabs=0.0, ncall=2e4, seed=9, adjust_iters=0,
              skip_iters=0, nbins=64, total_iters=4, device="cpu")
    st = _state(3)
    r1 = V.vegas(g, state=st, **kw)
    assert (st.it0, st.n_acc) == (r1.iters, 4)
    si1 = st.si
    r2 = V.vegas(g, state=st, **kw)
    assert (st.it0, st.n_acc) == (r1.iters + r2.iters, 8)
    # replayed streams would make the resumed si increment EXACTLY equal
    # the first run's (same grid, same stream)
    assert st.si - si1 != pytest.approx(si1, rel=1e-12)
    est, sd = st.si / st.swgt, (1.0 / st.swgt) ** 0.5
    assert abs(est - g.true_value) < 6 * sd
    assert (r2.estimate, r2.errorest) == (est, sd)
    # chi2/dof divides by the iterations accumulated across ALL segments
    expect = max((st.schi - st.si * est) / (8 - 0.9999), 0.0)
    assert r2.chi_sq == pytest.approx(expect, rel=1e-10)
    # a fresh run of eight iterations draws what the two segments drew
    whole = V.vegas(g, state=_state(3), **dict(kw, total_iters=8))
    assert whole.estimate == pytest.approx(r2.estimate, rel=1e-12)


def test_resume_is_deterministic_and_adapts_the_state_grid():
    g = genz.f4_gaussian(2, a=3.0)

    def two_segments():
        st = _state(2)
        kw = dict(epsrel=0.0, epsabs=0.0, ncall=1e4, seed=5, adjust_iters=3,
                  skip_iters=0, total_iters=3, nbins=64, device="cpu")
        V.vegas(g, state=st, **kw)
        V.vegas(g, state=st, **kw)
        return st

    a, b = two_segments(), two_segments()
    assert (a.si, a.swgt, a.schi) == (b.si, b.swgt, b.schi)
    assert torch.equal(a.xi, b.xi)
    assert a.xi.dtype == torch.float64 and tuple(a.xi.shape) == (2, 65)
    widths = torch.diff(a.xi, dim=1)
    mid = (a.xi[:, :-1] + widths / 2 - 0.5).abs() < 0.15
    assert widths[mid].mean() < widths[~mid].mean()


def test_state_carried_across_from_reference():
    """Adapt a grid for 5 iterations with the JAX package, carry the state
    across, and run 5 frozen iterations in each."""
    from gpuintegration_tpu.mcubes import grid as jax_grid
    make, _ = CASES["gaussian 3D"]
    kw = dict(epsrel=1e-9, epsabs=1e-300, ncall=5e4, seed=4, skip_iters=0)
    jst = JV.VegasState(xi=jax_grid.uniform_grid(3, 500))
    JV.vegas(make(jax_genz), total_iters=5, adjust_iters=5, state=jst, **kw)
    st = convert.vegas_state_from_reference(
        np.asarray(jst.xi), jst.si, jst.swgt, jst.schi, jst.it0, jst.n_acc,
        device="cpu")
    np.testing.assert_array_equal(st.xi.numpy(), np.asarray(jst.xi))
    assert (st.si, st.swgt, st.schi, st.it0, st.n_acc) == (
        float(jst.si), float(jst.swgt), float(jst.schi), 5, 5)
    # the map fitted to the carried grid is the reference's, bit for bit
    p, q = poly_importance.fit_importance_poly(st.xi.numpy(), 14)
    pj, qj = jax_fit(np.asarray(jst.xi), 14)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(q, qj)
    p32, q32 = convert.poly_from_reference(pj, qj, device="cpu")
    np.testing.assert_array_equal(p32.numpy(),
                                  np.asarray(jnp.asarray(pj, jnp.float32)))
    assert q32.dtype == torch.float32

    rj = JV.vegas(make(jax_genz), total_iters=5, adjust_iters=0, state=jst,
                  **kw)
    g = make(genz)
    r = V.vegas(g, total_iters=5, adjust_iters=0, state=st, device="cpu",
                **kw)
    assert (st.it0, st.n_acc) == (jst.it0, jst.n_acc) == (10, 10)
    assert (r.iters, r.neval) == (rj.iters, rj.neval)
    assert abs(r.estimate - rj.estimate) <= 4 * math.hypot(r.errorest,
                                                           rj.errorest)
    assert abs(r.estimate - g.true_value) <= 4 * r.errorest
    assert 0.5 < r.errorest / rj.errorest < 2.0
    # frozen iterations leave the grid alone
    np.testing.assert_array_equal(st.xi.numpy(), np.asarray(jst.xi))


# ---------------------------------------------------------------------------
# escalation and observability

def test_simple_integrate_escalates(monkeypatch):
    g = genz.f4_gaussian(3, a=5.0)
    calls = []
    real = V.vegas

    def spy(*a, **kw):
        calls.append((a[3], kw["total_iters"]))
        return real(*a, **kw)

    monkeypatch.setattr(V, "vegas", spy)
    r = mcubes.simple_integrate(g, epsrel=2e-3, ncall=2e3, total_iters=7,
                                seed=1, device="cpu")
    assert r.status == 0
    assert calls[0] == (2e3, 7) and len(calls) >= 2
    assert [c[0] for c in calls] == [2e3 * 10 ** k for k in range(len(calls))]
    assert abs(r.estimate - g.true_value) <= 5 * r.errorest


def test_debug_logger_records_every_iteration():
    g = genz.f4_gaussian(3, a=5.0)
    log = debug.VegasDebugLogger()
    r = mcubes.integrate(g, epsrel=1e-9, ncall=2e4, total_iters=6,
                         adjust_iters=4, skip_iters=2, seed=13, nbins=40,
                         debug_logger=log, device="cpu")
    assert [rec.it for rec in log.records] == [1, 2, 3, 4, 5, 6] and r.iters == 6
    assert [rec.d is not None for rec in log.records] == [True] * 4 + [False] * 2
    assert log.records[0].xi.shape == (3, 41) and log.records[0].d.shape == (3, 40)
    assert not np.array_equal(log.records[0].xi, log.records[3].xi)
    np.testing.assert_array_equal(log.records[4].xi, log.records[5].xi)
    assert (log.records[-1].tgral, log.records[-1].sd) == (r.estimate,
                                                           r.errorest)
    assert log.records[1].tgral == 0.0 and log.records[2].tgral != 0.0
    out = io.StringIO()
    log.dump_iters(out)
    log.dump_bin_bounds(out)
    log.dump_bin_contributions(out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("iter,estimate,errorest")
    assert len(lines) == (1 + 6) + (1 + 6 * 3 * 41) + (1 + 4 * 3 * 40)


def test_capture_samples_reproduces_the_iteration():
    """The captured samples are the ones iteration ``it`` evaluates: their
    sum is the iteration's ti."""
    g = genz.f4_gaussian(3, a=3.0)
    f, ndim = make_integrand(g, None)
    ng, ncubes = V.compute_ncubes(2e3, ndim)
    npg = V.samples_per_cube(2e3, ncubes)
    vol = Volume([0.0, 0.1, 0.2], [1.0, 0.9, 1.2])
    xjac = vol.jacobian / (npg * ncubes)
    xi = torch.as_tensor(
        grid.smooth_and_refine(grid.uniform_grid(3, 50, device="cpu"),
                               np.random.default_rng(0).random((3, 50))))
    lo = torch.as_tensor(vol.lows)
    dx = torch.as_tensor(vol.highs - vol.lows)
    cap = debug.capture_samples(f, ndim, ng, npg, 50, xi, lo, dx, xjac,
                                ncubes, seed=6, it=3)
    assert cap["points"].shape == (ncubes, npg, 3)
    assert cap["bins"].min() >= 1 and cap["bins"].max() <= 50
    assert (cap["points"] >= vol.lows).all() and (cap["points"] <= vol.highs).all()
    assert cap["randoms"].shape == (ncubes, npg, 3)
    sums, _ = V._vegas_iteration(f, ndim, ng, npg, ncubes, 1, 50, False,
                                 torch.float64, 6, 3, xi, lo, dx, xjac, ncubes)
    assert cap["values"].sum() == pytest.approx(float(sums[0]), rel=1e-12)
    with pytest.raises(ValueError, match="capture limited"):
        debug.capture_samples(f, ndim, ng, npg, 50, xi, lo, dx, xjac, ncubes,
                              max_samples=10)


# ---------------------------------------------------------------------------
# routes and refusals

def test_auto_sampler_choice():
    g = genz.f4_gaussian(3)
    f32, f64 = torch.float32, torch.float64
    pick = V._resolve_sampler
    assert pick(None, "poly", "cuda", f32, g) == "fused"
    assert pick(None, "poly", "cuda", f64, g) == "hybrid"
    assert pick(None, "poly", "cuda", f32, lambda x: x.sum(-1)) == "hybrid"
    assert pick(None, "poly", "cpu", f32, g) == "torch"
    assert pick(None, "grid", "cuda", f64, g) is None
    assert pick("torch", "grid", "cuda", f64, g) == "torch"
    for s in V.SAMPLERS:
        assert pick(s, "poly", "cuda", f64, g) == s
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        pick("fused", "poly", "cuda", f32, lambda x: x.sum(-1))
    # a scalar-per-axis callable that traces has a kernel twin
    assert pick(None, "poly", "cuda", f32, lambda x, y: x * y) == "fused"
    assert pick(None, "poly", "cuda", f32,
                lambda x, y: torch.sum(x) * y) == "hybrid"
    with pytest.raises(ValueError, match="needs importance='poly'"):
        pick("hybrid", "grid", "cuda", f64, g)
    with pytest.raises(ValueError, match="'torch', 'fused' or 'hybrid'"):
        pick("pallas", "poly", "cuda", f64, g)


def test_refusals(monkeypatch):
    g = genz.f4_gaussian(3, a=3.0)
    kw = dict(ncall=2e3, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcubes.integrate(g, mesh=object(), **kw)
    # refine='device' runs (the adjustment phase on the device)
    r = mcubes.integrate(g, refine="device", total_iters=6, **kw)
    assert r.status == 0 and abs(r.estimate - g.true_value) <= 5 * r.errorest
    with pytest.raises(ValueError, match="refine"):
        mcubes.integrate(g, refine="gpu", **kw)

    def vector(x):
        return torch.stack([x.sum(-1), x.prod(-1)], dim=-1)

    # a vector integrand runs (each component's closed form, 3/2 and 1/8),
    # but not in the sampler that evaluates a scalar inside the kernel
    r = mcubes.integrate(vector, ndim=3, total_iters=6, **kw)
    assert r.estimates.shape == r.errorests.shape == r.probs.shape == (2,)
    assert np.all(np.abs(r.estimates - [1.5, 0.125]) <= 5 * r.errorests)
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(vector, ndim=3, sampler="fused", **kw)
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(lambda x, y: torch.sum(x) * y, sampler="fused",
                         **kw)
    with pytest.raises(ValueError, match="nbins must be >= 2"):
        mcubes.integrate(g, nbins=1, **kw)
    with pytest.raises(ValueError, match="pass nbins=64"):
        mcubes.integrate(g, state=_state(3, 64), **kw)
    with pytest.raises(ValueError, match="importance"):
        mcubes.integrate(g, importance="table", **kw)
    with pytest.raises(ValueError, match="dtype"):
        mcubes.integrate(g, dtype=torch.float16, **kw)
    # eval_cost is accepted and changes nothing
    a = mcubes.integrate(g, total_iters=2, seed=1, **kw)
    b = mcubes.integrate(g, total_iters=2, seed=1, eval_cost=50.0, **kw)
    assert (a.estimate, a.neval) == (b.estimate, b.neval)
    # no card and no device: the Workspace's error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcubes.integrate(g, ncall=2e3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcubes.simple_integrate(g, ncall=2e3)


def test_package_surface():
    import gpuintegration_torch
    assert "mcubes" in gpuintegration_torch.__all__
    assert mcubes.__all__ == ["VegasState", "integrate", "simple_integrate",
                              "vegas"]
    assert mcubes.vegas.vegas is V.vegas and mcubes.integrate is V.integrate
    assert mcubes.VegasState is V.VegasState
