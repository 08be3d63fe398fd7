"""The rule's split route (points kernel, the callable, contraction kernel)
against its plain version, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_split.py
"""
import math

import numpy as np
import pytest
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval


def _card_pool(ndim, cap, dtype, seed=1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (
        rng.uniform(0.0, 0.5, (ndim, cap)),
        rng.uniform(0.01, 0.5, (ndim, cap)),
        rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))]


def _gauss(x):
    return torch.exp(-torch.sum(25.0 * (x - 0.5) ** 2, dim=-1))


def _integrands(ndim):
    """A zoo integrand, a batched lambda and a per-axis one."""
    names = [f"x{d}" for d in range(ndim)]
    per_axis = eval(f"lambda {', '.join(names)}: "
                    f"torch.cos({' + '.join(names)})", {"torch": torch})
    return [misc.sin_sum(ndim), misc.g_function(ndim), _gauss, per_axis]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [2, 8, 9])
def test_split_route_matches_plain_on_card(ndim, dtype):
    """Points and values EQUAL to the plain version's, est/err/split_dim
    within kernel_check's limits, on plain and blocked pools, ragged last
    chunks and a chunk of one region; launches counted per kernel."""
    cap = 512
    t = _card_pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    for f in _integrands(ndim):
        for n, blocked, chunk in ((cap, False, 4096), (301, False, 100),
                                  (400, True, 96), (2, True, 1)):
            cuda_rule.reset_launches()
            r = kernel_check.check_split_against_plain(
                f, tables, *t, n=n, blocked=blocked, chunk_size=chunk,
                min_agree=0.0)
            chunks = len(cuda_rule.split_chunks(n, chunk))
            # the route once, and the check's own points launch a chunk
            assert cuda_rule.split_launches == {"points": 2 * chunks,
                                                "contract": chunks}
            assert cuda_rule.launches == 0
            assert r["regions"] == n and r["split_dim_equal"] == n


@pytest.mark.gpu
def test_split_route_takes_nan_regions_to_the_widest_axis_on_card():
    """A region with a NaN coordinate has NaN values, estimates and fourth
    differences: its split axis is the widest, as in the plain version."""
    ndim, cap = 5, 256
    lows, lengths, gl, gr = _card_pool(ndim, cap, torch.float64)
    lows[2, 7] = float("nan")
    lengths[:, 7] = torch.tensor([0.1, 0.3, 0.2, 0.25, 0.05],
                                 dtype=torch.float64, device="cuda")
    tables = rule_eval.rule_tables(ndim, "float64")
    f = misc.sin_sum(ndim)
    k = cuda_rule.cuda_apply_rule_split(f, tables, lows, lengths, gl, gr)
    p = rule_eval.apply_rule_plain(f, tables, lows, lengths, gl, gr)
    assert torch.isnan(k[0][7]) and torch.isnan(p[0][7])
    assert int(k[2][7]) == int(p[2][7]) == 1
    assert torch.equal(k[2], p[2])


@pytest.mark.gpu
def test_oscillatory_split_agrees_with_f1_tile_on_card():
    """cos(sum x) as a plain callable (split route) and as Genz F1 with
    unit coefficients (tile route): the same rule, to rounding."""
    ndim, cap = 8, 2048
    t = _card_pool(ndim, cap, torch.float64)
    tables = rule_eval.rule_tables(ndim, "float64")
    split = cuda_rule.cuda_apply_rule_split(misc.oscillatory(ndim), tables,
                                            *t, n=1500, blocked=True)
    tile = cuda_rule.cuda_apply_rule(genz.f1_oscillatory(ndim, np.ones(ndim)),
                                     tables, *t, n=1500, blocked=True)
    scale = float(tile[0].abs().max())
    assert float((split[0] - tile[0]).abs().max()) <= 1e-13 * scale
    assert float((split[1] - tile[1]).abs().max()) <= 1e-13 * scale


@pytest.mark.gpu
def test_workspace_takes_the_split_route_on_card():
    """Workspace.integrate of a plain callable on the card goes through the
    split kernels only, and gives the CPU run's iterations and regions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = misc.sin_sum(4)
    cuda_rule.reset_launches()
    on_card = Workspace(4, chunk_size=1024).integrate(g, 1e-7, 1e-40)
    assert cuda_rule.launches == 0
    assert cuda_rule.split_launches["points"] == cuda_rule.split_launches[
        "contract"] >= on_card.iters
    on_cpu = Workspace(4, chunk_size=1024, device="cpu").integrate(
        g, 1e-7, 1e-40)
    assert (on_card.status, on_card.iters, on_card.nregions,
            on_card.neval) == (on_cpu.status, on_cpu.iters, on_cpu.nregions,
                               on_cpu.neval)
    assert on_card.status == 0
    assert math.isclose(on_card.estimate, on_cpu.estimate, rel_tol=1e-12)
    assert abs(on_card.estimate - g.true_value) <= 1e-7 * abs(g.true_value)
