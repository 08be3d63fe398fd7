"""The port's scalar ``Workspace.integrate`` against the JAX package's host
loop (``fused=False``): the same status, iterations, region count and
neval, with estimate and error equal to roundoff (rtol 1e-10); and a run
the JAX package began, carried across with ``convert`` and finished by
both packages identically.

The port runs with ``torch.set_flush_denormal(True)``: XLA on the CPU
flushes subnormal results, and the comparison is of the algorithm."""
import math
import time

import numpy as np
import pytest
import torch

from gpuintegration_tpu import Volume as JaxVolume
from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import Volume, Workspace, convert
from gpuintegration_torch.models import genz

CHUNK = 1024   # pool-capacity floor on both sides: keeps pools small


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _assert_same_run(got, ref):
    assert (got.status, got.iters, got.nregions, got.neval,
            got.nFinishedRegions) == (ref.status, ref.iters, ref.nregions,
                                      ref.neval, ref.nFinishedRegions)
    assert math.isclose(got.estimate, ref.estimate, rel_tol=1e-10)
    assert math.isclose(got.errorest, ref.errorest, rel_tol=1e-10)


def _both(name, ndim, params, epsrel, ws_kw=None, vol=None, **kw):
    ws_kw = ws_kw or {}
    g_jax = getattr(jax_genz, name)(ndim, **params)
    ref = JaxWorkspace(ndim, chunk_size=CHUNK, **ws_kw).integrate(
        g_jax, epsrel=epsrel, epsabs=1e-40, fused=False,
        vol=None if vol is None else JaxVolume(*vol), **kw)
    g = convert.genz_from_reference(name, ndim, **params)
    got = Workspace(ndim, chunk_size=CHUNK, device="cpu", **ws_kw).integrate(
        g, epsrel=epsrel, epsabs=1e-40, fused=False,
        vol=None if vol is None else Volume(*vol), **kw)
    return got, ref, g


@pytest.mark.parametrize("epsrel", [1e-3, 1e-4])
@pytest.mark.parametrize("ndim", [3, 5])
@pytest.mark.parametrize("name", ["f2_product_peak", "f4_gaussian"])
def test_integrate_matches_jax(name, ndim, epsrel):
    got, ref, g = _both(name, ndim, {"a": 5.0}, epsrel)
    _assert_same_run(got, ref)
    assert got.status == 0
    assert abs(got.estimate - g.true_value) <= 10 * epsrel * g.true_value


def test_integrate_non_unit_volume():
    vol = ([-1.0, 0.0, 0.5], [1.0, 0.5, 2.0])
    got, ref, _ = _both("f4_gaussian", 3, {"a": 2.0, "b": 0.3}, 1e-4,
                        vol=vol)
    _assert_same_run(got, ref)
    assert got.status == 0


def test_integrate_with_classifier():
    """A small pool budget makes the heuristic classifier, the exact
    banked error and the rollback run inside the loop."""
    got, ref, _ = _both("f2_product_peak", 5, {"a": 5.0}, 1e-5,
                        ws_kw={"max_pool_regions": 8192})
    _assert_same_run(got, ref)


def test_max_iterations_and_ledger_exit():
    got, ref, _ = _both("f4_gaussian", 5, {"a": 5.0}, 1e-6,
                        max_iterations=3,
                        ledger=(0.5, 1e-3, 10, 2, 1000))
    _assert_same_run(got, ref)
    assert got.status == 1 and got.iters == 5


def test_finish_options_match_jax():
    """Volume-apportioned absolute retirement and a tightened per-region
    retirement scale, as integrate_to_convergence sets them."""
    got, ref, _ = _both("f4_gaussian", 3, {"a": 5.0}, 1e-5,
                        finish_abs_per_vol=1e-8, finish_epsrel_scale=0.5)
    _assert_same_run(got, ref)
    assert got.status == 0


def test_deadline_in_the_past():
    got, ref, _ = _both("f4_gaussian", 3, {"a": 5.0}, 1e-4,
                        deadline=time.monotonic() - 1.0)
    _assert_same_run(got, ref)
    assert got.status == 1 and got.iters == 0


def test_resume_from_jax_pool():
    """JAX runs k iterations; its final pool and ledger are carried across
    with convert.py, and both packages finish the run identically."""
    ndim, params = 5, {"a": 5.0}
    g_jax = jax_genz.f2_product_peak(ndim, **params)
    ws = JaxWorkspace(ndim, chunk_size=CHUNK)
    ws.integrate(g_jax, epsrel=1e-4, epsabs=1e-40, fused=False,
                 max_iterations=4)
    lows, lengths, n, blocked = ws.final_pool
    assert blocked
    ledger = ws._ledger_excl_pool
    ck = ws.make_checkpoint()
    ref = JaxWorkspace(ndim, chunk_size=CHUNK).integrate(
        g_jax, epsrel=1e-4, epsabs=1e-40, fused=False,
        initial_regions=(ck.lows, ck.lengths), ledger=ck.ledger)

    regions = convert.pool_from_reference(
        np.asarray(lows), np.asarray(lengths), n, blocked)
    np.testing.assert_array_equal(regions[0].numpy(), ck.lows)
    np.testing.assert_array_equal(regions[1].numpy(), ck.lengths)
    g = convert.genz_from_reference("f2_product_peak", ndim, **params)
    got = Workspace(ndim, chunk_size=CHUNK, device="cpu").integrate(
        g, epsrel=1e-4, epsabs=1e-40, fused=False, initial_regions=regions,
        ledger=convert.ledger_from_reference(ledger))
    _assert_same_run(got, ref)
    assert got.status == 0


def test_final_pool_and_errors():
    g = genz.f4_gaussian(3, a=5.0)
    ws = Workspace(3, chunk_size=CHUNK, device="cpu")
    res = ws.integrate(g, epsrel=1e-4, epsabs=1e-40, fused=False)
    lows, lengths, n, blocked = ws.final_pool
    est, refined = ws.final_pool_errors
    assert blocked and lows.shape == lengths.shape == (3, est.shape[0])
    assert n == res.nregions - res.nFinishedRegions
    assert ws._ledger_excl_pool[3] == res.iters - 1


def test_torch_rule_backend_is_the_plain_path():
    g = genz.f2_product_peak(3, a=5.0)
    a = Workspace(3, chunk_size=CHUNK, device="cpu").integrate(g, 1e-4)
    b = Workspace(3, chunk_size=CHUNK, device="cpu",
                  rule_backend="torch").integrate(g, 1e-4)
    assert (a.estimate, a.errorest, a.neval) == (b.estimate, b.errorest,
                                                 b.neval)


def test_scalar_per_axis_callable():
    def f(x, y):
        return torch.exp(-(x - 0.5) ** 2 - (y - 0.5) ** 2)

    res = Workspace(2, device="cpu").integrate(f, epsrel=1e-8, epsabs=1e-40)
    truth = (math.sqrt(math.pi) * math.erf(0.5)) ** 2
    assert res.status == 0 and abs(res.estimate - truth) < 1e-8 * truth


@pytest.mark.parametrize("option", ["fused", "predict_split",
                                    "vegas_assisted", "crease_split"])
def test_unported_options_raise(option):
    """Every option is ported and runs to the tolerance.  ``vegas_assisted``
    (per-region Monte Carlo estimates) runs F4 at a = 5 to 1e-2: at a = 25
    and 1e-3 its pool grows past what a CPU test can take."""
    ws = Workspace(3, device="cpu")
    g = genz.f4_gaussian(3)
    epsrel = 1e-3
    if option == "vegas_assisted":
        g, epsrel = genz.f4_gaussian(3, a=5.0), 1e-2
    r = ws.integrate(g, epsrel=epsrel, epsabs=1e-40, **{option: True})
    assert r.status == 0 and abs(r.estimate - g.true_value) <= max(
        r.errorest, epsrel * g.true_value)


def test_unported_paths_raise():
    with pytest.raises(TypeError, match="DeviceMesh"):
        Workspace(3, device="cpu", mesh=object())

    # a vector integrand runs (each component's closed form is 1/2), fused
    # or not; it refuses the scalar-only options with the reference's
    # reasons
    for fused in (False, True):
        r = Workspace(2, device="cpu").integrate(
            lambda x, y: torch.stack([x, y], dim=-1), epsrel=1e-6,
            fused=fused)
        assert r.status == 0 and r.estimates.shape == (2,)
        assert np.allclose(r.estimates, 0.5, rtol=1e-12)
    for option, error in (("vegas_assisted", ValueError),
                          ("predict_split", ValueError),
                          ("crease_split", ValueError)):
        with pytest.raises(error, match=option):
            Workspace(2, device="cpu").integrate(
                lambda x, y: torch.stack([x, y], dim=-1), **{option: True})
    with pytest.raises(ValueError, match="positional"):
        Workspace(2, device="cpu").integrate(lambda x, y, z: x)
    with pytest.raises(ValueError, match="rank-0"):
        Workspace(2, device="cpu").integrate(lambda x, y: torch.sum(x))
    with pytest.raises(ValueError, match="rule_backend"):
        Workspace(2, device="cpu", rule_backend="xla")
