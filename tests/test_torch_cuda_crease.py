"""The split fraction kernel (``rule_split_frac_kernel``,
csrc/split_frac.cu, through ``cuda_rule.split_frac``) and a crease run's
split route on the card, against their plain versions.

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
    the callable, the contraction, the fraction kernel a chunk) against the
    plain rule on the same pool on the card: the points kernel's points are
    the plain version's, so the callable's values are too, and split_dim
    and the fraction must be EQUAL; the padding's fraction 0.5; every
    chunk's fraction launched once."""
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
    got = rule_eval.apply_rule(g, tables, lows, lengths, gl, gr,
                               chunk_size=1024, n=n, blocked=blocked,
                               with_split_frac=True)
    assert cuda_rule.launches == 0
    chunks = len(cuda_rule.split_chunks(n, 1024))
    assert cuda_rule.split_frac_launches == chunks
    assert cuda_rule.split_launches["contract"] == chunks
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
    """A crease run on the card takes the split route for a Genz family
    and launches the fraction kernel, with the CPU run's decisions at 1e-8;
    at 1e-9 (the reference's case) it needs fewer evaluations than the
    midpoint run.  (The card's and the CPU's exp differ in the last bit on
    some points, and a crease's fraction carries that into the regions'
    bounds: at 1e-9 the two runs part by one region of 144,223.)"""
    _card()
    g = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    kw = dict(epsrel=1e-8, epsabs=1e-40, crease_split=True, fused=False,
              max_iterations=80)
    cuda_rule.reset_launches()
    on_card = Workspace(3, chunk_size=1024).integrate(g, **kw)
    assert cuda_rule.launches == 0
    assert cuda_rule.split_frac_launches == cuda_rule.split_launches[
        "contract"] >= on_card.iters
    on_cpu = Workspace(3, chunk_size=1024, device="cpu").integrate(g, **kw)
    assert (on_card.status, on_card.iters, on_card.nregions,
            on_card.neval) == (on_cpu.status, on_cpu.iters, on_cpu.nregions,
                               on_cpu.neval)
    assert on_card.status == 0
    assert math.isclose(on_card.estimate, on_cpu.estimate, rel_tol=1e-12)
    deep = dict(kw, epsrel=1e-9)
    crease = Workspace(3, chunk_size=1024).integrate(g, **deep)
    mid = Workspace(3, chunk_size=1024).integrate(
        g, **dict(deep, crease_split=False))
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
