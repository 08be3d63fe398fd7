"""VEGAS's device-resident phases on the card: the sampler and the bin
resolve reading the iteration word from a device counter (one launch
captured in a graph and replayed after the counter moves), a captured and
replayed frozen iteration against the host loop's bits and launch counts,
the form a phase chooses, ``refine='device'`` and
``Workspace.integrate(vegas_assisted=True)`` on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_vegas_phases.py

The same phases run eagerly on the CPU in
tests/test_torch_vegas_device_phases.py and tests/test_torch_vegas_assisted.py.
"""
import pytest
import torch

from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas, kernel_check
from gpuintegration_torch.mcubes import phases
from gpuintegration_torch.mcubes.debug import VegasDebugLogger
from gpuintegration_torch.models import genz


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["paired", "generic"])
@pytest.mark.parametrize("with_hist", [False, True])
def test_replayed_sampler_launch_follows_the_counter(route, with_hist):
    """Emit mode and every fused Genz family, 5D, on the lattice's last
    chunk: a launch captured on a counter and replayed at two iterations
    EQUAL to launches given them as host integers."""
    _card()
    case = kernel_check.sampler_case(5, 2e5, 4096, nbins=50, degree=8,
                                     seed=3, position="end")
    cuda_vegas.reset_launches()
    kernel_check.check_sampler_counter(case, None, with_hist=with_hist,
                                       route=route)
    for g in genz.genz_suite(5):
        kernel_check.check_sampler_counter(case, g, with_hist=with_hist,
                                           route=route)
    assert cuda_vegas.route_launches[route] == cuda_vegas.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("ndim", [2, 6, 9])
def test_replayed_resolve_launch_follows_the_counter(ndim):
    _card()
    cuda_lookup.reset_launches()
    for position in ("end", "middle"):
        kernel_check.check_resolve_counter(ndim, 2e5, 4096, 500,
                                           position=position)
    route = cuda_lookup.resolve_route(ndim, 500, 4096)
    assert cuda_lookup.resolve_route_launches[route] > 0
    kernel_check.check_resolve_counter(ndim, 2e5, 4096, 500,
                                       route="generic")
    assert cuda_lookup.resolve_route_launches["generic"] > 0


RUNS = {
    "hybrid f64": dict(epsrel=1e-3, ncall=2e5, adjust_iters=3),
    "fused f32": dict(epsrel=1e-3, ncall=2e5, eval_dtype=torch.float32,
                      adjust_iters=3),
    "grid": dict(epsrel=1e-3, ncall=2e5, importance="grid", adjust_iters=3),
    "fixed length": dict(epsrel=1e-9, epsabs=1e-300, ncall=1e5,
                         total_iters=9, adjust_iters=3, skip_iters=2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RUNS))
def test_replayed_frozen_phase_gives_host_loop_bits(name, monkeypatch):
    """The frozen phase captured and replayed on the card (``FORM``
    pinned): the host loop's iterations, neval and estimate bits and its
    launch counts (a capture counts nothing, a replay what it recorded);
    one eager iteration, then a replay and a read an iteration."""
    _card()
    g = genz.f4_gaussian(4, a=5.0)
    kw = dict(RUNS[name], seed=4)
    kw.setdefault("epsabs", 1e-40)
    counts = {}
    for form in ("graph", "host"):
        monkeypatch.setattr(phases, "FORM", form)
        phases.reset_stats()
        cuda_vegas.reset_launches()
        cuda_lookup.reset_launches()
        r = mcubes.integrate(g, **kw)
        counts[form] = (r, dict(phases.stats), phases._launch_counts())
    (a, st, ca), (b, _, cb) = counts["graph"], counts["host"]
    assert (a.status, a.iters, a.neval, a.estimate, a.errorest, a.chi_sq) \
        == (b.status, b.iters, b.neval, b.estimate, b.errorest, b.chi_sq)
    assert ca == cb
    frozen = a.iters - kw.get("adjust_iters", 15)
    assert st["phases"] == 1 and st["eager"] == 1
    assert st["captures"] == (frozen > 1)
    assert st["replays"] == frozen - 1 and st["reads"] == frozen


@pytest.mark.gpu
def test_short_phase_runs_eagerly_and_long_one_replays():
    """Unpinned, a phase that converges within a few iterations runs
    eagerly; one that is expected to run GRAPH_MIN_ITERS more replays."""
    _card()
    g = genz.f4_gaussian(4, a=5.0)
    phases.reset_stats()
    mcubes.integrate(g, **dict(RUNS["hybrid f64"], seed=4, epsabs=1e-40))
    assert phases.stats["captures"] == 0 and phases.stats["phases"] == 1
    n = phases.GRAPH_MIN_ITERS + 4
    phases.reset_stats()
    r = mcubes.integrate(g, epsrel=1e-9, epsabs=1e-300, ncall=1e5,
                         adjust_iters=3, total_iters=3 + n, seed=4)
    assert r.iters == 3 + n
    assert phases.stats["captures"] == 1
    assert phases.stats["replays"] == n - 1


@pytest.mark.gpu
def test_uncaptured_sampler_and_a_host_reading_integrand(monkeypatch):
    """sampler='torch' runs the phase eagerly with the same bits as its
    host loop; an integrand that reads the card from the host fails the
    capture with a RuntimeError naming sampler='torch', and runs with it."""
    _card()
    g = genz.f4_gaussian(3, a=5.0)
    kw = dict(epsrel=2e-3, ncall=1e5, seed=2, adjust_iters=4)
    monkeypatch.setattr(phases, "FORM", "graph")
    phases.reset_stats()
    a = mcubes.integrate(g, sampler="torch", **kw)
    assert phases.stats["captures"] == 0 and phases.stats["eager"] >= 2
    b = mcubes.integrate(g, sampler="torch", debug_logger=VegasDebugLogger(),
                         **kw)
    assert (a.iters, a.estimate) == (b.iters, b.estimate)

    def syncing(x):
        return g(x) * (float(x.sum().item()) * 0.0 + 1.0)

    syncing.ndim = 3
    with pytest.raises(RuntimeError, match="sampler='torch'"):
        mcubes.integrate(syncing, sampler="hybrid", **kw)
    r = mcubes.integrate(syncing, sampler="torch", **kw)
    assert r.status == 0
    assert mcubes.integrate(g, **kw).status == 0


@pytest.mark.gpu
@pytest.mark.parametrize("importance", ["poly", "grid"])
def test_device_refine_on_card(importance, monkeypatch):
    _card()
    g = genz.f4_gaussian(4, a=5.0)
    kw = dict(epsrel=1e-3, epsabs=1e-40, ncall=2e5, seed=1,
              importance=importance)
    monkeypatch.setattr(phases, "FORM", "graph")
    phases.reset_stats()
    rd = mcubes.integrate(g, refine="device", **kw)
    assert phases.stats["captures"] >= 1
    monkeypatch.setattr(phases, "FORM", None)
    rh = mcubes.integrate(g, refine="host", **kw)
    assert rd.status == 0
    assert abs(rd.estimate - g.true_value) <= 5 * rd.errorest
    assert abs(rd.estimate - rh.estimate) < 5 * max(rd.errorest, rh.errorest)
    again = mcubes.integrate(g, refine="device", **kw)
    assert (again.estimate, again.errorest) == (rd.estimate, rd.errorest)


@pytest.mark.gpu
def test_vegas_assisted_on_card():
    """The hybrid on the card: certifies, repeats bitwise, and its draws
    are the CPU's."""
    _card()
    from gpuintegration_torch.pagani import vegas_assisted as TA
    ids = torch.arange(300, dtype=torch.int64)
    on_card = TA.region_draws(5, 3, 2, ids.cuda(), 32, 4)
    on_cpu = TA.region_draws(5, 3, 2, ids, 32, 4)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    g = genz.f4_gaussian(3, a=5.0)
    a = Workspace(3).integrate(g, 1e-2, 1e-40, vegas_assisted=True, seed=1)
    b = Workspace(3).integrate(g, 1e-2, 1e-40, vegas_assisted=True, seed=1)
    assert a.status == 0 and abs(a.estimate - g.true_value) < 5 * a.errorest
    assert (a.estimate, a.errorest, a.iters) == (b.estimate, b.errorest,
                                                 b.iters)
