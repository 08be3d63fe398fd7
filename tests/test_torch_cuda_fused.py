"""PAGANI's fused phase on the card: one iteration captured as a CUDA
graph and replayed (``pagani/fused_loop.py``), against the eager body and
the host loop.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_fused.py
"""
import math

import pytest
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_rule, rule_eval
from gpuintegration_torch.pagani import fused_loop, region_pool


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _key(r):
    return (r.status, r.iters, r.nregions, r.nFinishedRegions, r.neval)


def _phase_and_pool(integrand, crease):
    """A Phase of a 3D run and a blocked pool of 1024 regions (the
    children of the 8^3 uniform split) in 4096 slots, parents of estimate
    1/512."""
    dev = _card()
    ndim, cap = 3, 4096
    ws = Workspace(ndim, chunk_size=1024)
    tables = rule_eval.rule_tables(ndim)
    gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
    gr = torch.ones(ndim, dtype=torch.float64, device=dev)
    phase = ws._fused_phase(integrand, tables, gl, gr, ncomp=1,
                            with_split_frac=crease,
                            relerr_classification=True, eps_work=1e-7,
                            epsrel=1e-7, epsabs=1e-40, abs_per_vol=None)
    lows, lengths, n0 = region_pool.uniform_split(
        ndim, 8, cap // 2, torch.float64, dev)
    lows, lengths, n = region_pool.split(
        lows, lengths, torch.zeros(cap // 2, dtype=torch.int32, device=dev),
        n0, out_capacity=cap)
    parent = torch.full((cap // 2,), 1.0 / 512, dtype=torch.float64,
                        device=dev)
    return phase, lows, lengths, n, parent


@pytest.mark.gpu
@pytest.mark.parametrize("crease", [False, True])
def test_graph_replay_equals_the_eager_body(crease):
    """One iteration replayed from its CUDA graph gives the eager body's
    carry bit for bit (pool, parents, split axes, fractions, ledger,
    status), from the same loaded state."""
    g = (genz.f5_c0_continuous(3, a=10.0, b=0.37) if crease
         else genz.f4_gaussian(3, a=5.0))
    phase, lows, lengths, n, parent = _phase_and_pool(g, crease)
    kw = dict(cum_est=0.0, cum_err=0.0, result_nregions=0, iters=1,
              neval=0, hist=[0.0, 0.0, 0.0], max_iters=50)
    c = phase.load(lows, lengths, n, parent, **kw)
    phase._step(c)
    eager = {k: v.clone() for k, v in c.items()}
    assert int(eager["iters"]) == 2
    fused_loop.reset_stats()
    c = phase.load(lows, lengths, n, parent, **kw)
    graph = phase._capture(lows.shape[1], c)
    assert fused_loop.stats["captures"] == 1
    graph.replay()
    torch.cuda.synchronize()
    for k, v in eager.items():
        assert torch.equal(c[k], v), k
    # a replay once the burst has stopped (the budget) changes nothing
    c["max_iters"].fill_(2)
    graph.replay()
    for k, v in eager.items():
        if k != "max_iters":
            assert torch.equal(c[k], v), k
    phase.close()


@pytest.mark.gpu
@pytest.mark.parametrize("replays", [1, 4])
def test_fused_run_on_card_matches_host_loop(replays, monkeypatch):
    """A fused run on the card (graphs captured and replayed, the packed
    vector read after every replay or every fourth) takes the host loop's
    decisions on the card; estimates within 1e-12."""
    _card()
    g = genz.f4_gaussian(3, a=5.0)
    kw = dict(epsrel=1e-8, epsabs=1e-40)
    monkeypatch.setattr(fused_loop, "REPLAYS", replays)
    fused_loop.reset_stats()
    got = Workspace(3, chunk_size=1024).integrate(g, **kw)
    stats = dict(fused_loop.stats)
    host = Workspace(3, chunk_size=1024).integrate(g, fused=False, **kw)
    assert _key(got) == _key(host) and got.status == 0
    assert math.isclose(got.estimate, host.estimate, rel_tol=1e-12)
    assert math.isclose(got.errorest, host.errorest, rel_tol=1e-9)
    assert stats["bursts"] >= 1


@pytest.mark.gpu
def test_crease_and_vector_fused_on_card():
    """A crease run and a vector run through the fused phase on the card,
    each against its host loop on the card."""
    _card()
    g = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    kw = dict(epsrel=1e-7, epsabs=1e-40, crease_split=True)
    cuda_rule.reset_launches()
    got = Workspace(3, chunk_size=1024).integrate(g, **kw)
    assert cuda_rule.split_frac_launches > 0
    host = Workspace(3, chunk_size=1024).integrate(g, fused=False, **kw)
    assert _key(got) == _key(host) and got.status == 0
    assert math.isclose(got.estimate, host.estimate, rel_tol=1e-12)
    members = [genz.f2_product_peak(3), genz.f4_gaussian(3, a=5.0)]

    def f(x):
        return torch.stack([m(x) for m in members], dim=-1)

    f.ndim = 3
    kw = dict(epsrel=1e-6, epsabs=1e-40)
    fused_loop.reset_stats()
    got = Workspace(3, chunk_size=1024).integrate(f, **kw)
    assert fused_loop.stats["bursts"] >= 1
    host = Workspace(3, chunk_size=1024).integrate(f, fused=False, **kw)
    assert _key(got) == _key(host) and got.status == 0
    for a, b in zip(got.estimates, host.estimates):
        assert math.isclose(a, b, rel_tol=1e-12)


@pytest.mark.gpu
def test_a_callable_that_reads_the_card_cannot_be_captured():
    """A callable that syncs the host fails the capture with a
    RuntimeError naming fused=False, and nothing falls back to eager
    replays; the card works on after it, and the host loop runs the same
    callable."""
    _card()

    g = genz.f2_product_peak(3)

    def syncing(x):
        scale = float(x.sum().item()) * 0.0 + 1.0
        return g(x) * scale

    syncing.ndim = 3
    # a pool budget at which a burst outlasts its first, eager iteration
    # (tests/test_torch_fused.py's "gate" case), so a capture is tried
    ws_kw = dict(chunk_size=1024, max_pool_regions=20000)
    fused_loop.reset_stats()
    with pytest.raises(RuntimeError, match="fused=False"):
        Workspace(3, **ws_kw).integrate(syncing, epsrel=1e-8, epsabs=1e-40)
    assert fused_loop.stats["replays"] == 0
    r = Workspace(3, **ws_kw).integrate(syncing, epsrel=1e-8, epsabs=1e-40,
                                        fused=False)
    assert r.status == 0
    fused_loop.reset_stats()
    r = Workspace(3, **ws_kw).integrate(g, epsrel=1e-8, epsabs=1e-40)
    assert fused_loop.stats["captures"] >= 1 and r.status == 0
    r2 = Workspace(3, chunk_size=1024).integrate(misc.sin_sum(3),
                                                 epsrel=1e-8, epsabs=1e-40)
    assert r2.status == 0
