"""The rule's split route (points kernel, the callable, contraction kernel)
against its plain version, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_split.py
"""
import itertools
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
    on_card = Workspace(4, chunk_size=1024).integrate(g, 1e-7, 1e-40,
                                                      fused=False)
    assert cuda_rule.launches == 0
    assert cuda_rule.split_launches["points"] == cuda_rule.split_launches[
        "contract"] >= on_card.iters
    on_cpu = Workspace(4, chunk_size=1024, device="cpu").integrate(
        g, 1e-7, 1e-40, fused=False)
    assert (on_card.status, on_card.iters, on_card.nregions,
            on_card.neval) == (on_cpu.status, on_cpu.iters, on_cpu.nregions,
                               on_cpu.neval)
    assert on_card.status == 0
    assert math.isclose(on_card.estimate, on_cpu.estimate, rel_tol=1e-12)
    assert abs(on_card.estimate - g.true_value) <= 1e-7 * abs(g.true_value)


def _split_pool(ndim, cap, dtype):
    t = _card_pool(ndim, cap, dtype)
    return t, rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [8, 12])
def test_cluster_contraction_matches_plain_on_card(ndim, dtype):
    """The contraction's cluster route, forced, against the plain version:
    est/err within kernel_check's limits and split_dim EQUAL in every
    region, values as rows and as planes, on plain and blocked pools, ragged
    last groups and an odd last chunk; every launch counted on the cluster
    route.  The generic route on the same
    pools gives the same split_dim."""
    cap = 512
    t, tables = _split_pool(ndim, cap, dtype)
    # values as rows (a reduction over the axes) and as planes (per axis)
    fs = (_gauss if ndim == 8 else misc.sin_sum(ndim), _integrands(ndim)[-1])
    for f, (n, blocked, chunk) in itertools.product(fs, (
            (cap, False, 4096), (400, True, 96), (301, False, 100))):
        cuda_rule.reset_launches()
        r = kernel_check.check_split_against_plain(
            f, tables, *t, n=n, blocked=blocked, chunk_size=chunk,
            min_agree=0.0, route="cluster")
        chunks = len(cuda_rule.split_chunks(n, chunk))
        assert cuda_rule.contract_route_launches == {
            "cluster": chunks, "generic": 0, "components_cluster": 0,
            "components": 0}
        assert r["regions"] == n and r["split_dim_equal"] == n
        g = cuda_rule.cuda_apply_rule_split(f, tables, *t, n=n,
                                            blocked=blocked,
                                            chunk_size=chunk,
                                            route="generic")
        k = cuda_rule.cuda_apply_rule_split(f, tables, *t, n=n,
                                            blocked=blocked,
                                            chunk_size=chunk)
        assert torch.equal(g[2], k[2])


def _values(ndim, count, dtype, layout, seed=2):
    """Values (count, feval) laid out as a callable returns them: 'planes'
    (strides (1, count), a per-axis callable), 'rows' (strides (feval, 1),
    one that reduces over the axes), or 'strided' (every other element of a
    wider tensor: neither stride 1)."""
    feval = rule_eval.rule_tables(ndim).feval
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((count, feval)), dtype=dtype,
                        device="cuda")
    if layout == "planes":
        return v.T.contiguous().T
    if layout == "rows":
        return v
    wide = torch.zeros((count, 2 * feval), dtype=dtype, device="cuda")
    wide[:, ::2] = v
    return wide[:, ::2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("count", [1024, 1023])
def test_cluster_contraction_same_bits_twice_on_card(dtype, count):
    """Rows and planes, an even and an odd count (segments off their
    16-byte units): contract_route names the cluster route; two launches
    on the same values give the same bits, and the generic route the same
    split_dim; values of neither layout take the generic route."""
    ndim = 12
    _, tables = _split_pool(ndim, count, dtype)
    t = _card_pool(ndim, count, dtype)
    for layout in ("planes", "rows"):
        vals = _values(ndim, count, dtype, layout)
        assert cuda_rule.contract_route(dtype, ndim, count, tables.feval,
                                        vals.stride()) == "cluster"
        a, b = (cuda_rule.split_contract(vals, tables, *t, 0) for _ in range(2))
        g = cuda_rule.split_contract(vals, tables, *t, 0, route="generic")
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        assert torch.equal(g[2], a[2])
    strided = _values(ndim, count, dtype, "strided")
    assert cuda_rule.contract_route(dtype, ndim, count, tables.feval,
                                    strided.stride()) == "generic"


@pytest.mark.gpu
def test_cluster_contraction_refusals_raise_on_card(monkeypatch):
    """Forcing the cluster route on values it does not take raises
    ValueError before any launch; a cluster the card refuses (16 CTAs,
    not portable, not allowed) raises RuntimeError, never falls back."""
    ndim, count = 8, 256
    t, tables = _split_pool(ndim, count, torch.float64)
    cuda_rule.reset_launches()
    with pytest.raises(ValueError, match="contraction route 'cluster'"):
        cuda_rule.split_contract(
            _values(ndim, count, torch.float64, "strided"), tables, *t, 0,
            route="cluster")
    plan = cuda_rule.cluster_plan(torch.float64, ndim, count, tables.feval)
    monkeypatch.setattr(cuda_rule, "cluster_plan",
                        lambda *a: (16,) + tuple(plan[1:]))
    with pytest.raises(RuntimeError, match="cluster route"):
        cuda_rule.split_contract(_values(ndim, count, torch.float64, "rows"),
                                 tables, *t, 0)
    assert cuda_rule.contract_route_launches == {
        "cluster": 0, "generic": 0, "components_cluster": 0, "components": 0}
