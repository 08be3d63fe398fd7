"""The one-shot, the interpolators, Suave and 1-D quadrature on the card
against the same calls on the CPU.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_surface.py
"""
import math

import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz, physics
from gpuintegration_torch.ops import cuda_rule, interp, quad1d
from gpuintegration_torch.pagani import oneshot, suave, vegas_assisted

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(ndim, n, seed=1):
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(0.02, 0.4, (n, ndim))
    return rng.random((n, ndim)) * (1.0 - lengths), lengths


@pytest.mark.parametrize("kind", ["genz", "callable"])
def test_oneshot_routes_and_values(card, kind):
    """A Genz family takes the tile route, a callable the split route; the
    outputs agree with the CPU's to roundoff, split_dims EQUAL."""
    g = genz.f4_gaussian(5, a=5.0)
    f = g if kind == "genz" else (lambda x: g(x))
    lows, lengths = _pool(5, 3000)
    cuda_rule.reset_launches()
    _, est, err, sdim = oneshot.apply_cubature_rules(f, lows, lengths,
                                                     ndim=5, device=card)
    if kind == "genz":
        assert cuda_rule.route_launches["tile"] == cuda_rule.launches == 1
    else:
        assert cuda_rule.launches == 0
        assert cuda_rule.split_launches["points"] >= 1
    _, e, r, s = oneshot.apply_cubature_rules(f, lows, lengths, ndim=5,
                                              device="cpu")
    scale = float(torch.max(torch.abs(e)))
    assert torch.allclose(est.cpu(), e, rtol=1e-12, atol=1e-13 * scale)
    assert torch.allclose(err.cpu(), r, rtol=1e-10, atol=1e-13 * scale)
    assert torch.equal(sdim.cpu(), s)


def test_classify_on_card_equals_cpu(card):
    _, est, err, _ = oneshot.apply_cubature_rules(
        genz.f4_gaussian(4, a=5.0), *_pool(4, 5000), device=card)
    for hid in (0, 1, 2, 4, 7, 8, 9, 10):
        got = oneshot.classify_with_heuristic(hid, est, err, 1e-3, depth=2)
        want = oneshot.classify_with_heuristic(hid, est.cpu(), err.cpu(),
                                               1e-3, depth=2)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["Interp1D", "Interp2D", "Interp3D"])
def test_interpolators_card_equal_cpu(card, name):
    rng = np.random.default_rng(3)
    shape = {"Interp1D": (500,), "Interp2D": (40, 60),
             "Interp3D": (10, 12, 14)}[name]
    axes = [np.sort(rng.uniform(0.0, 1.0, n)) for n in shape[::-1]]
    vals = rng.normal(size=shape)
    on_card = getattr(interp, name)(*axes, vals, device=card)
    on_cpu = getattr(interp, name)(*axes, vals, device="cpu")
    q = [torch.as_tensor(rng.uniform(-0.1, 1.1, 1 << 16)) for _ in axes]
    assert torch.equal(on_card(*[t.to(card) for t in q]).cpu(), on_cpu(*q))
    with pytest.raises(ValueError, match="queried on cpu"):
        on_card(*q)


def test_physics_callable_captured_by_the_fused_phase(card):
    from gpuintegration_torch import Workspace
    model = physics.ClusterLikelihood(device=card)
    fused = Workspace(6).integrate(model, 1e-3, 1e-40)
    host = Workspace(6).integrate(model, 1e-3, 1e-40, fused=False)
    assert fused.status == host.status == 0
    assert (fused.iters, fused.neval) == (host.iters, host.neval)
    assert math.isclose(fused.estimate, host.estimate, rel_tol=1e-12)


def test_suave_cycle_card_against_cpu(card):
    ndim, cap, nnew, nbins = 3, 64, 512, 32
    g = genz.f4_gaussian(ndim, a=5.0)
    lows, lengths = (torch.as_tensor(np.ascontiguousarray(a.T))
                     for a in _pool(ndim, cap, 4))
    grids = suave.uniform_edges(nbins).expand(cap, ndim,
                                              nbins + 1).contiguous()
    lo_hi = (torch.zeros(ndim, dtype=torch.float64),
             torch.ones(ndim, dtype=torch.float64))

    def run(dev):
        ids = torch.arange(cap, device=dev)
        return suave._suave_cycle(
            g, ndim, 1, nnew, nbins, torch.float64, 16.0,
            lambda i: vegas_assisted.region_draws(
                3, 0, i, ids, nnew, ndim, stream_base=suave.SUAVE_STREAM),
            lows.to(dev), lengths.to(dev), grids.to(dev),
            *(t.to(dev) for t in lo_hi))

    for c, h in zip(run(card)[1:], run("cpu")[1:]):
        scale = float(torch.max(torch.abs(h)))
        assert torch.allclose(c.cpu(), h, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("method", ["qng", "qag", "cquad", "qawo", "qawf"])
def test_quad1d_card_decisions_equal_cpu(card, method):
    f = lambda x: torch.exp(-x) * torch.cos(3.0 * x)  # noqa: E731
    args = {"qng": (0.0, 1.0), "qag": (0.0, 1.0), "cquad": (0.0, 1.0),
            "qawo": (0.0, 2.0, 7.0), "qawf": (0.0, 2.0)}[method]
    on_card = getattr(quad1d, method)(f, *args, device=card)
    on_cpu = getattr(quad1d, method)(f, *args, device="cpu")
    assert (on_card.status, on_card.neval, on_card.nregions) == (
        on_cpu.status, on_cpu.neval, on_cpu.nregions)
    assert math.isclose(on_card.estimate, on_cpu.estimate, rel_tol=1e-12,
                        abs_tol=1e-15)
