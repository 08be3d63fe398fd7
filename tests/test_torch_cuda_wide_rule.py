"""The rule kernel's wide route (a Genz family at 17-24D,
csrc/rule_wide.cuh) on the card: against its plain version, a region's
bits in two pools, the fused phase against the host loop, and the
refusals past 16D.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_wide_rule.py
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval


def _card_pool(ndim, cap, dtype, seed=1):
    """Random sub-boxes of a non-unit volume [gl, gl + gr] inside the
    positive orthant (F3's pole 1 + sum a_i x_i = 0 stays outside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (
        rng.uniform(0.0, 0.5, (ndim, cap)), rng.uniform(0.01, 0.5, (ndim, cap)),
        rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [17, 20])
def test_wide_route_matches_plain_on_card(ndim, dtype):
    """Every family on a blocked pool with padding slots: the wide route
    against the plain version with kernel_check's limits (the plain
    version in chunks of 8 regions: 0.17 GB of points a region at 20D)."""
    cap, n = 48, 32
    t = _card_pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    assert cuda_rule.rule_route(ndim) == cuda_rule.WIDE
    cuda_rule.reset_launches()
    for g in genz.genz_suite(ndim):
        kernel_check.check_against_plain(g, tables, *t, n=n, blocked=True,
                                         min_agree=0.0, chunk=8,
                                         plain_chunk=8)
    assert cuda_rule.wide_launches == cuda_rule.launches == 6
    assert cuda_rule.route_launches == {"tile": 0, "generic": 0}


@pytest.mark.gpu
def test_wide_route_matches_plain_at_24d_on_card():
    """F4 in f64 at 24D (16,796,913 points a region) on a few regions, the
    plain version a region at a time (3.2 GB of points)."""
    ndim = 24
    t = _card_pool(ndim, 4, torch.float64, seed=2)
    kernel_check.check_against_plain(
        genz.f4_gaussian(ndim, a=1.0), rule_eval.rule_tables(ndim), *t,
        min_agree=0.0, chunk=1, plain_chunk=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_region_same_bits_in_two_pools_on_card(dtype):
    """A region's est, err and split_dim do not depend on its pool: the
    real regions of a blocked pool of 64 slots (n = 40) put into the first
    slots of a plain pool of 32 (n = 20), in reverse order, give the same
    bits."""
    ndim = 18
    lows, lengths, gl, gr = _card_pool(ndim, 64, dtype, seed=3)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    g = genz.f5_c0_continuous(ndim, a=2.0)
    a = cuda_rule.cuda_apply_rule(g, tables, lows, lengths, gl, gr, n=40,
                                  blocked=True)
    real = torch.cat([torch.arange(20), torch.arange(32, 52)]).flip(0)
    real = real.to(lows.device)
    lo2 = torch.zeros(ndim, 32, dtype=dtype, device=lows.device)
    ln2 = torch.ones_like(lo2)
    lo2[:, :20], ln2[:, :20] = lows[:, real[:20]], lengths[:, real[:20]]
    b = cuda_rule.cuda_apply_rule(g, tables, lo2.contiguous(),
                                  ln2.contiguous(), gl, gr, n=20)
    for x, y in zip(a, b):
        assert kernel_check.same_bits(x[real[:20]].contiguous(),
                                      y[:20].contiguous())


@pytest.mark.gpu
def test_wide_fused_phase_equals_host_loop_on_card():
    """17D F4 (a = 1) at 1e-3, which certifies: the fused phase (CUDA
    graphs) and the host loop take the same decisions and give the same
    bits, every launch on the wide route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = genz.f4_gaussian(17, a=1.0)
    runs = {}
    for fused in (False, True):
        cuda_rule.reset_launches()
        r = Workspace(17).integrate(g, 1e-3, 1e-40, fused=fused)
        assert cuda_rule.wide_launches == cuda_rule.launches > 0
        runs[fused] = r
    h, f = runs[False], runs[True]
    assert h.status == 0
    assert ((h.status, h.iters, h.nregions, h.neval)
            == (f.status, f.iters, f.nregions, f.neval))
    assert (float(h.estimate).hex(), float(h.errorest).hex()) == (
        float(f.estimate).hex(), float(f.errorest).hex())
    assert abs(h.estimate - g.true_value) <= h.errorest


@pytest.mark.gpu
def test_refusals_past_16d_on_card():
    """Past 16D the card runs the wide route and the split route (any
    other callable, tests/test_torch_cuda_split_wide.py): a traced callable
    (rule_backend='fused'), crease_split of a Genz family or a callable,
    and 25D raise ValueError naming rule_backend='torch' before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ", ".join(f"x{d}" for d in range(17))
    per_axis = eval(f"lambda {names}: x0 * x1")
    cases = [
        (Workspace(17), lambda x: torch.exp(-x.sum(-1)),
         {"crease_split": True}),
        (Workspace(25), lambda x: torch.exp(-x.sum(-1)), {}),
        (Workspace(17, rule_backend="fused"), per_axis, {}),
        (Workspace(17), genz.f4_gaussian(17), {"crease_split": True}),
        (Workspace(25), genz.f4_gaussian(25), {}),
    ]
    for ws, f, kw in cases:
        cuda_rule.reset_launches()
        with pytest.raises(ValueError, match="rule_backend='torch'"):
            ws.integrate(f, 1e-3, **kw)
        assert cuda_rule.launches == 0
        assert sum(cuda_rule.split_launches.values()) == 0
    with pytest.raises(ValueError, match="rule_backend='torch'"):
        rule_eval.apply_rule(
            genz.f4_gaussian(17), rule_eval.rule_tables(17),
            *_card_pool(17, 4, torch.float64), with_split_frac=True)
