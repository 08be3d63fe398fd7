"""The crease/jump-aware split fraction on the card: the standalone kernel
(``rule_split_frac_kernel``, csrc/split_frac.cu, through
``cuda_rule.split_frac``), the forms folded into the fused Genz kernels
(tile and generic) and into the split route's scalar contractions (cluster
and generic), and crease runs on both routes, against their plain versions.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_crease.py
"""
import math

import numpy as np
import pytest
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _callable(g):
    """The Genz member as a plain callable, which ``is_genz_family``
    rejects: its crease runs take the split route."""
    def f(x):
        return g(x)

    return f


def _split_counts_are_the_contraction(chunks=None):
    """Every fraction of the run came from a scalar contraction, one a
    chunk: no fused launch, no standalone launch."""
    counts = cuda_rule.frac_route_launches
    folded = counts["cluster"] + counts["contract_generic"]
    assert cuda_rule.launches == 0 and cuda_rule.split_frac_launches == 0
    assert counts["tile"] == counts["generic"] == 0
    assert folded == cuda_rule.split_launches["contract"] > 0
    if chunks is not None:
        assert folded == chunks


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows", "planes"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndim,count", [(3, 4093), (8, 4096), (12, 1024)])
def test_split_frac_kernel_equals_plain(ndim, count, dtype, layout):
    """Fraction and split_dim EQUAL to the plain version's on the same
    values, as rows (strides (feval, 1)) and as planes ((1, C)), with both
    detectors firing; one launch counted."""
    dev = _card()
    vals, sd = kernel_check.crease_stencils(ndim, count, dtype, seed=ndim)
    v = torch.as_tensor(vals, device=dev)
    if layout == "planes":
        v = v.T.contiguous().T
    cuda_rule.reset_launches()
    r = kernel_check.check_split_frac(v, torch.as_tensor(sd, device=dev),
                                      ndim)
    assert cuda_rule.split_frac_launches == 1
    assert r["cut"] > count // 10 and r["overrides"] > count // 20


@pytest.mark.gpu
def test_split_frac_kernel_edge_values():
    """NaN, infinite and all-equal stencils: the plain version's bits."""
    dev = _card()
    ndim = 4
    vals, sd = kernel_check.crease_stencils(ndim, 64, "float64", seed=3)
    vals[0, :] = np.nan
    vals[1, :] = np.inf
    vals[2, :] = 1.0
    vals[3, 5] = -np.inf
    vals[4, :] = 0.0
    kernel_check.check_split_frac(torch.as_tensor(vals, device=dev),
                                  torch.as_tensor(sd, device=dev), ndim)


@pytest.mark.gpu
@pytest.mark.parametrize("blocked", [False, True])
def test_crease_split_route_matches_plain(blocked):
    """The split route with the fraction over a CUDA pool (points kernel,
    the callable, the contraction with the fraction a chunk; the Genz
    member as a plain callable) against the plain rule on the same pool on
    the card: the points kernel's points are the plain version's, so the
    callable's values are too, and split_dim and the fraction must be
    EQUAL; the padding's fraction 0.5; every chunk's fraction computed by
    its contraction, no standalone launch."""
    dev = _card()
    ndim, cap = 3, 4096
    n = 3000 if blocked else 3001
    rng = np.random.default_rng(5)
    lows = torch.as_tensor(rng.uniform(0.0, 0.5, (ndim, cap)), device=dev)
    lengths = torch.as_tensor(rng.uniform(0.01, 0.5, (ndim, cap)),
                              device=dev)
    gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
    gr = torch.ones(ndim, dtype=torch.float64, device=dev)
    g = genz.f5_c0_continuous(ndim, a=10.0, b=0.37)
    tables = rule_eval.rule_tables(ndim)
    cuda_rule.reset_launches()
    got = rule_eval.apply_rule(_callable(g), tables, lows, lengths, gl, gr,
                               chunk_size=1024, n=n, blocked=blocked,
                               with_split_frac=True)
    _split_counts_are_the_contraction(len(cuda_rule.split_chunks(n, 1024)))
    plain = rule_eval.apply_rule_plain(g, tables, lows, lengths, gl, gr,
                                       chunk_size=1024, n=n, blocked=blocked,
                                       with_split_frac=True)
    assert torch.equal(got[2], plain[2]) and torch.equal(got[3], plain[3])
    assert torch.allclose(got[0], plain[0], rtol=1e-12, atol=0.0)
    assert (got[3] != 0.5).sum() > 0
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    mask[torch.as_tensor(cuda_rule.split_slots(cap, n, blocked, 0, n),
                         device=dev)] = True
    assert (got[3][~mask] == 0.5).all()


@pytest.mark.gpu
def test_crease_workspace_on_card_matches_cpu():
    """A crease run on the card of the Genz member as a plain callable
    takes the split route, the fraction in every chunk's contraction, with
    the CPU run's decisions at 1e-8; at 1e-9 (the reference's case) it
    needs fewer evaluations than the midpoint run.  (The card's and the
    CPU's exp differ in the last bit on some points, and a crease's
    fraction carries that into the regions' bounds: at 1e-9 the two runs
    part by one region of 144,223.)"""
    _card()
    g = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    kw = dict(epsrel=1e-8, epsabs=1e-40, crease_split=True, fused=False,
              max_iterations=80)
    cuda_rule.reset_launches()
    on_card = Workspace(3, chunk_size=1024).integrate(_callable(g), **kw)
    _split_counts_are_the_contraction()
    assert cuda_rule.split_launches["contract"] >= on_card.iters
    on_cpu = Workspace(3, chunk_size=1024, device="cpu").integrate(g, **kw)
    assert (on_card.status, on_card.iters, on_card.nregions,
            on_card.neval) == (on_cpu.status, on_cpu.iters, on_cpu.nregions,
                               on_cpu.neval)
    assert on_card.status == 0
    assert math.isclose(on_card.estimate, on_cpu.estimate, rel_tol=1e-12)
    deep = dict(kw, epsrel=1e-9)
    crease = Workspace(3, chunk_size=1024).integrate(_callable(g), **deep)
    mid = Workspace(3, chunk_size=1024).integrate(
        _callable(g), **dict(deep, crease_split=False))
    assert crease.status == mid.status == 0
    assert crease.neval < 0.8 * mid.neval


@pytest.mark.gpu
def test_split_frac_refuses_bad_values():
    dev = _card()
    v = torch.ones((8, rule_eval.rule_tables(3).feval), device=dev,
                   dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_rule.split_frac(v, torch.zeros(7, dtype=torch.int32,
                                            device=dev), 3)
    with pytest.raises(ValueError):
        cuda_rule.split_frac(v[:, :-1], torch.zeros(8, dtype=torch.int32,
                                                    device=dev), 3)


def _pool(ndim, cap, dtype, dev, seed):
    """Random sub-boxes of the unit cube, one of them NaN."""
    rng = np.random.default_rng(seed)
    lows = torch.as_tensor(rng.uniform(0.0, 0.6, (ndim, cap)), dtype=dtype,
                           device=dev)
    lengths = torch.as_tensor(rng.uniform(0.02, 0.4, (ndim, cap)),
                              dtype=dtype, device=dev)
    lows[:, 5] = float("nan")
    return lows, lengths


# (ndim, route, cap): both fused routes at 3D and 8D, the generic at 12D
FUSED_CASES = [(3, "tile", 4096), (3, "generic", 4096), (8, "tile", 1024),
               (8, "generic", 1024), (12, "generic", 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("family", [5, 6])
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,route,cap", FUSED_CASES)
def test_fused_kernels_fold_the_fraction(ndim, route, cap, dtype, blocked,
                                         family):
    """The fused kernels' crease form (``kernel_check.check_fused_frac``):
    est and err the bits of the launch without the fraction, fraction and
    split_dim EQUAL to ``rule_eval.split_fraction`` on the kernel's own
    collinear values from that launch's split axes, the padding's fraction
    0.5; a NaN region among them; one launch of each, counted by route."""
    dev = _card()
    g = (genz.f5_c0_continuous(ndim, a=10.0, b=0.37) if family == 5
         else genz.f6_discontinuous(ndim))
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths = _pool(ndim, cap, dtype, dev, seed=ndim + family)
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.ones(ndim, dtype=dtype, device=dev)
    n = cap - cap // 8 if blocked else cap - 3
    cuda_rule.reset_launches()
    r = kernel_check.check_fused_frac(g, tables, lows, lengths, gl, gr, n=n,
                                      blocked=blocked, route=route)
    assert cuda_rule.route_launches[route] == 2
    assert cuda_rule.frac_route_launches[route] == 1
    assert r["regions"] == n and r["cut"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["cluster", "generic"])
@pytest.mark.parametrize("layout", ["rows", "planes"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndim,count", [(3, 4093), (8, 4096), (12, 1024)])
def test_contractions_fold_the_fraction(ndim, count, dtype, layout, route):
    """Both scalar contractions' crease form
    (``kernel_check.check_contract_frac``) on values with planted kinks and
    jumps and a NaN region, as rows and as planes: est and err the bits of
    the launch without the fraction, fraction and split_dim EQUAL to the
    standalone kernel's and to ``rule_eval.split_fraction``."""
    dev = _card()
    vals, _ = kernel_check.crease_stencils(ndim, count, dtype, seed=ndim)
    vals[3, :] = np.nan
    v = torch.as_tensor(vals, device=dev)
    if layout == "planes":
        v = v.T.contiguous().T
    tdtype = getattr(torch, dtype)
    rng = np.random.default_rng(ndim)
    lows = torch.as_tensor(rng.uniform(0.0, 0.5, (ndim, count)),
                           dtype=tdtype, device=dev)
    lengths = torch.as_tensor(rng.uniform(0.01, 0.5, (ndim, count)),
                              dtype=tdtype, device=dev)
    gl = torch.zeros(ndim, dtype=tdtype, device=dev)
    gr = torch.ones(ndim, dtype=tdtype, device=dev)
    tables = rule_eval.rule_tables(ndim, dtype)
    cuda_rule.reset_launches()
    r = kernel_check.check_contract_frac(v, tables, lows, lengths, gl, gr,
                                         route=route)
    froute = cuda_rule.CONTRACT_FRAC_ROUTE[route]
    assert cuda_rule.frac_route_launches[froute] == 1
    assert cuda_rule.split_frac_launches == 1
    assert r["cut"] > count // 10 and r["overrides"] > count // 20


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_genz_crease_run_keeps_the_fused_route(fused):
    """A Genz crease run on the card (3D F5, the reference's case) takes
    the fused tile kernel with the fraction on every launch, no split and
    no standalone launch: status 0 within 1e-8 of the closed form at 1e-8,
    and at 1e-9 fewer than 0.8 of the midpoint run's evaluations."""
    _card()
    g = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    kw = dict(epsabs=1e-40, crease_split=True, fused=fused,
              max_iterations=80)
    cuda_rule.reset_launches()
    res = Workspace(3, chunk_size=1024).integrate(g, epsrel=1e-8, **kw)
    assert cuda_rule.launches > 0
    assert (cuda_rule.route_launches["tile"]
            == cuda_rule.frac_route_launches["tile"] == cuda_rule.launches)
    assert cuda_rule.split_frac_launches == 0
    assert sum(cuda_rule.split_launches.values()) == 0
    assert res.status == 0
    assert abs(res.estimate - g.true_value) <= 1e-8 * abs(g.true_value)
    crease = Workspace(3, chunk_size=1024).integrate(g, epsrel=1e-9, **kw)
    mid = Workspace(3, chunk_size=1024).integrate(
        g, epsrel=1e-9, **dict(kw, crease_split=False))
    assert crease.status == mid.status == 0
    assert crease.neval < 0.8 * mid.neval
