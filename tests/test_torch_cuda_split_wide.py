"""The split route past 16D on the card (any callable and any vector at
17-24D: ``rule_points_wide_kernel`` and the contractions' wide instances
of csrc/rule_split.cu): the points EQUAL to the plain version's, the
contractions within kernel_check's limits, and whole runs through them.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_split_wide.py
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import (cuda_rule, genz_malik, kernel_check,
                                      rule_eval)
from gpuintegration_torch.pagani import fused_loop


def _card_pool(ndim, cap, dtype, seed=1):
    """Random sub-boxes of a non-unit volume [gl, gl + gr]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (
        rng.uniform(0.0, 0.5, (ndim, cap)), rng.uniform(0.01, 0.5, (ndim, cap)),
        rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))]


def _wrapped(ndim):
    """Genz F4 (a = 1) as a plain callable: no fused kernel knows it."""
    g = genz.f4_gaussian(ndim, a=1.0)
    return g, (lambda x: g(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,cap,chunk", [(17, 16, 5), (20, 8, 3)])
def test_split_route_matches_plain_past_16d_on_card(ndim, cap, chunk, dtype):
    """A blocked pool with padding slots, chunk by chunk: the points EQUAL
    to rule_points (bits and strides), the values EQUAL, est and err
    within kernel_check's limits on both scalar contraction routes, every
    launch counted."""
    t = _card_pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    _, f = _wrapped(ndim)
    for route in cuda_rule.CONTRACT_ROUTES:
        cuda_rule.reset_launches()
        kernel_check.check_split_against_plain(
            f, tables, *t, n=cap - 2, blocked=True, chunk_size=chunk,
            min_agree=0.0, route=route)
        chunks = len(cuda_rule.split_chunks(cap - 2, chunk))
        assert cuda_rule.split_launches == {"points": 2 * chunks,
                                            "contract": chunks}
        assert cuda_rule.contract_route_launches[route] == chunks
        assert cuda_rule.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,count", [(17, 6), (20, 2)])
def test_vector_contraction_past_16d_on_card(ndim, count, dtype):
    """Four components (wrapped F4, sin_sum, their product, a constant)
    stacked component-minor, on both vector routes: split_dim EQUAL, each
    component within kernel_check's limits of rule_outputs_vector."""
    lows, lengths, gl, gr = _card_pool(ndim, count, dtype, seed=4)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    g, _ = _wrapped(ndim)
    s = misc.sin_sum(ndim)

    def fvec(x):
        a, b = g(x), s(x)
        return torch.stack([a, b, a * b, torch.ones_like(a)], dim=-1)

    x, _, _ = rule_eval.rule_points(tables, lows, lengths, gl, gr)
    vals = fvec(x).to(dtype)
    del x
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)

    def component(k):
        return lambda y: fvec(y)[..., k]

    u = torch.stack([kernel_check.value_scales(
        component(k), tables, lows, lengths, gl, gr)[1] for k in range(4)],
        dim=-1)
    for route in cuda_rule.VECTOR_ROUTES:
        cuda_rule.reset_launches()
        got = cuda_rule.split_contract_components(
            vals, tables, lows, lengths, gl, gr, 0, route=route)
        torch.cuda.synchronize()
        kernel_check.check_components(got, plain, vals, u, tables, lengths,
                                      gr, name=f"{ndim}D {route}")
        assert cuda_rule.contract_route_launches[route] == 1


@pytest.mark.gpu
def test_points_past_2_31_elements_on_card():
    """A 17D f32 chunk of 1024 regions (2.41e9 coordinates, 9.6 GB): the
    first and last regions EQUAL to rule_points'."""
    ndim, count = 17, 1024
    lows, lengths, gl, gr = _card_pool(ndim, count, torch.float32, seed=5)
    tables = rule_eval.rule_tables(ndim, "float32")
    x = cuda_rule.split_points(tables, lows, lengths, gl, gr, 0, count)
    assert x.numel() > 2 ** 31
    ends = torch.tensor([0, count - 1], device=lows.device)
    want, _, _ = rule_eval.rule_points(tables, lows[:, ends],
                                       lengths[:, ends], gl, gr)
    got = x[ends]
    del x
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.gpu
def test_17d_callable_takes_the_wide_routes_decisions_on_card():
    """17D F4 (a = 1) at 1e-3 as a plain callable on the split route and
    as a Genz family on the wide route: the same status, iterations,
    regions and neval, the estimates within 1e-12; the callable's run
    launches only the split kernels, and with ``fused`` it runs the host
    loop (counted in fused_loop.stats) with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, f = _wrapped(17)
    cuda_rule.reset_launches()
    wide = Workspace(17).integrate(g, 1e-3, 1e-40, fused=False)
    cuda_rule.reset_launches()
    split = Workspace(17).integrate(f, 1e-3, 1e-40, fused=False)
    assert cuda_rule.launches == 0
    assert cuda_rule.split_launches["points"] == \
        cuda_rule.split_launches["contract"] == split.iters
    assert split.status == 0
    assert ((split.status, split.iters, split.nregions, split.neval)
            == (wide.status, wide.iters, wide.nregions, wide.neval))
    assert abs(split.estimate - wide.estimate) <= 1e-12 * abs(wide.estimate)
    fused_loop.reset_stats()
    again = Workspace(17).integrate(f, 1e-3, 1e-40)
    assert fused_loop.stats["split_past_16d"] == 1
    assert fused_loop.stats["bursts"] == 0
    assert (float(again.estimate).hex(), again.neval) == (
        float(split.estimate).hex(), split.neval)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim", [20, 24])
def test_callables_and_a_vector_run_past_16d_on_card(ndim):
    """A plain callable, a per-axis callable and a vector run
    ``Workspace(ndim)`` through the split kernels (two iterations: one
    region, then two), each with finite results and the neval of three
    regions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, f = _wrapped(ndim)
    names = [f"x{d}" for d in range(ndim)]
    # F4 (a = 1) in the per-axis form: a polynomial such as x0 * x1 + x2
    # is integrated exactly, and certifies in the first iteration
    per_axis = eval(f"lambda {', '.join(names)}: torch.exp(-("
                    + " + ".join(f"(x{d} - 0.5) ** 2" for d in range(ndim))
                    + "))", {"torch": torch})

    def fvec(x):
        return torch.stack([g(x), torch.cos(x.sum(-1))], dim=-1)

    fvec.ndim = ndim
    for h in (f, per_axis, fvec):
        cuda_rule.reset_launches()
        r = Workspace(ndim).integrate(h, 1e-3, 1e-40, max_iterations=2)
        assert cuda_rule.launches == 0
        assert cuda_rule.split_launches["contract"] >= r.iters == 2
        assert np.all(np.isfinite(np.atleast_1d(r.estimate)))
        assert r.neval == 3 * genz_malik.feval_per_region(ndim)


@pytest.mark.gpu
def test_refusals_past_the_split_route_on_card():
    """A callable at 25D, a crease run of a callable at 17D and a traced
    callable at 17D raise ValueError naming rule_backend='torch' before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ", ".join(f"x{d}" for d in range(17))
    per_axis = eval(f"lambda {names}: x0 * x1")
    cases = [(Workspace(25), lambda x: torch.exp(-x.sum(-1)), {}),
             (Workspace(17), lambda x: torch.exp(-x.sum(-1)),
              {"crease_split": True}),
             (Workspace(17, rule_backend="fused"), per_axis, {})]
    for ws, f, kw in cases:
        cuda_rule.reset_launches()
        with pytest.raises(ValueError, match="rule_backend='torch'"):
            ws.integrate(f, 1e-3, **kw)
        assert cuda_rule.launches == 0
        assert sum(cuda_rule.split_launches.values()) == 0
