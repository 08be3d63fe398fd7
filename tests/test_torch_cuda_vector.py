"""A vector integrand's contractions (csrc/rule_split.cu: the components
cluster route ``rule_contract_comp_cluster_kernel`` and the components
route ``rule_contract_comp_kernel``) and the vector main path, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_vector.py
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval
from gpuintegration_torch.pagani import region_pool


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(ndim, cap, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype, device=_card()) for a in (
        rng.uniform(0.0, 0.5, (ndim, cap)),
        rng.uniform(0.01, 0.5, (ndim, cap)),
        rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))]


def _values(count, feval, ncomp, dtype, layout, seed=2):
    """Values (count, feval, ncomp) on the grid k/8 in [0.5, 1.5), so that
    every orbit sum is exact in any order: component-minor (what
    torch.stack(..., -1) gives), component-major (a (ncomp, ...) tensor
    with its axis moved), strided (every other element of a wider tensor)
    or wide (component-minor rows of a wider tensor, from its second
    element: off a 16-byte unit)."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.integers(4, 12, (count, feval, ncomp)) / 8,
                        dtype=dtype, device=_card())
    if layout == "major":
        return v.movedim(-1, 0).contiguous().movedim(0, -1)
    if layout == "strided":
        wide = torch.zeros((count, feval, 2 * ncomp), dtype=dtype,
                           device=v.device)
        wide[..., ::2] = v
        return wide[..., ::2]
    if layout == "wide":
        wide = torch.zeros((count, feval * ncomp + 3), dtype=dtype,
                           device=v.device)
        wide[:, 1:1 + feval * ncomp] = v.reshape(count, -1)
        return wide[:, 1:1 + feval * ncomp].view(count, feval, ncomp)
    return v


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["minor", "major", "strided"])
@pytest.mark.parametrize("ncomp", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,count", [(3, 301), (8, 96), (12, 33)])
def test_components_kernel_matches_plain(ndim, count, dtype, ncomp, layout):
    """The components route (named; contract_route names it for every
    layout but component-minor): est/err of every component by
    kernel_check's limits against rule_outputs_vector, split_dim EQUAL,
    each component bit for bit the generic scalar route's on its plane,
    two launches the same bits."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths, gl, gr = _pool(ndim, count, dtype)
    vals = _values(count, tables.feval, ncomp, dtype, layout)
    assert cuda_rule.contract_route(
        dtype, ndim, count, tables.feval, vals.stride(), ncomp) == (
        "components_cluster" if layout == "minor" else "components")
    cuda_rule.reset_launches()
    a, b = (cuda_rule.split_contract_components(
        vals, tables, lows, lengths, gl, gr, 0, route="components")
        for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_rule.contract_route_launches == {
        "cluster": 0, "generic": 0, "components_cluster": 0,
        "components": 2}
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    r = kernel_check.check_components(a, plain, vals, vals.abs(), tables,
                                      lengths, gr)
    assert r["split_dim_equal"] == count
    for k in range(ncomp):
        e, rr, _ = cuda_rule.split_contract(vals[..., k], tables, lows,
                                            lengths, gl, gr, 0,
                                            route="generic")
        assert torch.equal(_bits(a[0][k]), _bits(e))
        assert torch.equal(_bits(a[1][k]), _bits(rr))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["minor", "wide"])
@pytest.mark.parametrize("ncomp", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,count", [(2, 65), (3, 301), (8, 96),
                                        (12, 33), (16, 40)])
def test_components_cluster_matches_plain(ndim, count, dtype, ncomp,
                                          layout):
    """The components cluster route, which contract_route names for
    component-minor values at any address and region stride: est/err of
    every component by kernel_check's limits against rule_outputs_vector,
    split_dim EQUAL, each component bit for bit the scalar cluster route's
    on its contiguous plane, two launches the same bits."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths, gl, gr = _pool(ndim, count, dtype)
    vals = _values(count, tables.feval, ncomp, dtype, layout)
    assert cuda_rule.contract_route(dtype, ndim, count, tables.feval,
                                    vals.stride(), ncomp) == \
        "components_cluster"
    cuda_rule.reset_launches()
    a, b = (cuda_rule.split_contract_components(
        vals, tables, lows, lengths, gl, gr, 0) for _ in range(2))
    torch.cuda.synchronize()
    assert cuda_rule.contract_route_launches == {
        "cluster": 0, "generic": 0, "components_cluster": 2,
        "components": 0}
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    r = kernel_check.check_components(a, plain, vals, vals.abs(), tables,
                                      lengths, gr)
    assert r["split_dim_equal"] == count
    for k in range(ncomp):
        e, rr, _ = cuda_rule.split_contract(vals[..., k].contiguous(), tables,
                                            lows, lengths, gl, gr, 0,
                                            route="cluster")
        assert torch.equal(_bits(a[0][k]), _bits(e))
        assert torch.equal(_bits(a[1][k]), _bits(rr))


@pytest.mark.gpu
def test_components_cluster_refuses_other_layouts():
    """Named, the components cluster route refuses values that are not
    component-minor, and more than 8 components; a scalar route refuses a
    vector's values."""
    ndim, count = 3, 64
    tables = rule_eval.rule_tables(ndim)
    args = _pool(ndim, count, torch.float64)
    for vals in (_values(count, tables.feval, 3, torch.float64, "major"),
                 _values(count, tables.feval, 3, torch.float64, "strided"),
                 _values(count, tables.feval, 9, torch.float64, "minor")):
        with pytest.raises(ValueError, match="components_cluster"):
            cuda_rule.split_contract_components(vals, tables, *args, 0,
                                                route="components_cluster")
        with pytest.raises(ValueError, match="'cluster'"):
            cuda_rule.split_contract_components(vals, tables, *args, 0,
                                                route="cluster")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["components_cluster", "components"])
def test_components_nan_region_takes_the_widest_axis(route):
    ndim, count, ncomp = 8, 64, 3
    tables = rule_eval.rule_tables(ndim)
    lows, lengths, gl, gr = _pool(ndim, count, torch.float64)
    vals = _values(count, tables.feval, ncomp, torch.float64, "minor")
    vals[7, 2 + 2 * ndim, 1] = float("nan")      # an orbit-2 value
    k = cuda_rule.split_contract_components(vals, tables, lows, lengths, gl,
                                            gr, 0, route=route)
    p = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    widest = int(torch.argmax(lengths[:, 7]))
    assert int(k[2][7]) == int(p[2][7]) == widest
    assert torch.equal(k[2], p[2])
    assert torch.isnan(k[0][1][7]) and not torch.isnan(k[0][0][7])


@pytest.mark.gpu
def test_vector_split_route_on_pools():
    """A vector callable through the split route on a blocked pool with
    padding slots: zeros there, one components cluster launch a chunk (the
    callable stacks its components last), and the plain version's outputs
    on the same values."""
    ndim, cap, n, chunk = 5, 512, 400, 96
    dtype = torch.float64
    lows, lengths, gl, gr = _pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim)
    g = misc.sin_sum(ndim)

    def f(x):
        return torch.stack([g(x), torch.exp(-x.sum(-1)), g(x)], dim=-1)

    cuda_rule.reset_launches()
    k = cuda_rule.cuda_apply_rule_split(f, tables, lows, lengths, gl, gr,
                                        chunk_size=chunk, n=n, blocked=True,
                                        ncomp=3)
    torch.cuda.synchronize()
    chunks = len(cuda_rule.split_chunks(n, chunk))
    assert cuda_rule.contract_route_launches["components_cluster"] == chunks
    assert cuda_rule.split_launches == {"points": chunks, "contract": chunks}
    real = torch.nonzero(region_pool.block_mask(cap, n, True, lows.device))[:, 0]
    pad = torch.ones(cap, dtype=torch.bool, device=lows.device)
    pad[real] = False
    assert not k[0][:, pad].any() and not k[1][:, pad].any()
    # each component's values and rounding scales on the real regions
    lo, ln = lows[:, real], lengths[:, real]
    vals, u = zip(*(kernel_check.value_scales(c, tables, lo, ln, gl, gr)
                    for c in (g, lambda x: torch.exp(-x.sum(-1)), g)))
    vals, u = torch.stack(vals, -1), torch.stack(u, -1)
    plain = rule_eval.rule_outputs_vector(vals, tables, ln, gr)
    kernel_check.check_components([o[..., real] for o in k], plain, vals, u,
                                  tables, ln, gr)
    assert torch.equal(_bits(k[0][0]), _bits(k[0][2]))


@pytest.mark.gpu
def test_vector_workspace_on_card_matches_cpu():
    """Workspace(3) on a vector of Genz members: the card's run takes the
    components cluster route for every evaluation and the CPU run's
    decisions."""
    _card()
    members = [genz.f2_product_peak(3), genz.f4_gaussian(3, a=5.0)]

    def f(x):
        return torch.stack([m(x) for m in members], dim=-1)

    f.ndim = 3
    cuda_rule.reset_launches()
    on_card = Workspace(3, chunk_size=1024).integrate(f, 1e-6, 1e-40)
    launches = dict(cuda_rule.contract_route_launches)
    on_cpu = Workspace(3, chunk_size=1024, device="cpu").integrate(
        f, 1e-6, 1e-40)
    assert launches["components_cluster"] > 0 and launches["cluster"] == 0
    assert launches["components"] == 0
    assert (on_card.status, on_card.iters, on_card.nregions,
            on_card.neval) == (on_cpu.status, on_cpu.iters, on_cpu.nregions,
                               on_cpu.neval)
    np.testing.assert_allclose(on_card.estimates, on_cpu.estimates,
                               rtol=1e-12)


@pytest.mark.gpu
def test_vector_vegas_on_card():
    _card()
    g = genz.f4_gaussian(3, a=5.0)

    def f(x):
        return torch.stack([g(x), g(x)], dim=-1)

    f.ndim = 3
    r = mcubes.integrate(f, epsrel=1e-3, ncall=1e5, seed=3)
    s = mcubes.integrate(g, epsrel=1e-3, ncall=1e5, seed=3, sampler="hybrid")
    assert r.iters == s.iters and r.estimates[0] == r.estimates[1]
    assert abs(r.estimates[0] - s.estimate) <= 1e-12 * abs(s.estimate)
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(f, ncall=1e4, sampler="fused")
