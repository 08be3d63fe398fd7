"""The rule kernel's wide route past 16D (a Genz family at 17-24D,
csrc/rule_wide.cuh) on the CPU, where the plain version runs:

* a 17D PAGANI run against the JAX package's (the host loop): the same
  decisions, the estimate to roundoff;
* the route's host-side layouts: its orbit table decoded as the kernel
  decodes it (the rule's own points bitwise), its corners from the point
  index (the generic route's convention, and the kernel's split of an
  index into a thread's bits and a loop's), ``rule_route``'s choices and
  refusals, the parameters at width 24.

The card's tests are tests/test_torch_cuda_wide_rule.py."""
import math

import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import (cuda_rule, genz_malik, integrand_gen,
                                      rule_eval)

WIDE_THREADS = 32 * cuda_rule.WIDE_WARPS     # a block's, one a corner bit
LOW_AXES = WIDE_THREADS.bit_length() - 1     # the corner axes a thread fixes


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def test_17d_run_matches_reference():
    """Workspace(17), Genz F4 (a = 1) at 1e-3, four iterations of the host
    loop in both packages: the same status, 16 regions, neval 2,074,215,
    the estimate and errorest to roundoff."""
    kw = dict(epsrel=1e-3, max_iterations=4, fused=False)
    ref = JaxWorkspace(17, chunk_size=64).integrate(
        jax_genz.f4_gaussian(17, a=1.0), **kw)
    got = Workspace(17, chunk_size=64, device="cpu").integrate(
        genz.f4_gaussian(17, a=1.0), **kw)
    assert (got.status, got.iters, got.nregions, got.neval) == (
        ref.status, ref.iters, ref.nregions, ref.neval)
    assert (got.nregions, got.neval) == (16, 2_074_215)
    assert math.isclose(got.estimate, ref.estimate, rel_tol=1e-12)
    assert math.isclose(got.errorest, ref.errorest, rel_tol=1e-10)


def _decode_like_kernel(words: np.ndarray, ndim: int,
                        itemsize: int) -> np.ndarray:
    """(k8, ndim) codes of the orbit table as rule_wide_kernel reads it: a
    point's three pairs give (axis, byte offset code * itemsize); axis d
    takes the OR of the offsets of the pairs naming it (0, the centre,
    where none does), then the offset indexes the axis' row."""
    w = words.astype(np.int64)
    axes, offs = [], []
    for i in range(cuda_rule.WIDE_PAIRS):
        pair = w >> (cuda_rule.WIDE_PAIR_BITS * i)
        axes.append(pair & ((1 << cuda_rule.WIDE_AXIS_BITS) - 1))
        offs.append(((pair >> cuda_rule.WIDE_AXIS_BITS) & 15) * itemsize)
    off = np.zeros((w.size, ndim), dtype=np.int64)
    for d in range(ndim):
        for a, o in zip(axes, offs):
            off[:, d] |= np.where(a == d, o, 0)
    return off // itemsize


@pytest.mark.parametrize("ndim", [17, 20, 24])
def test_wide_orbit_table(ndim):
    """The table of orbits 0-7 decoded as the kernel decodes it (f64 and
    f32 offsets) gives the rule's points bitwise: ``rule_tables(ndim).gen``
    at 17D and 20D; at 24D, where the whole table is 3.2 GB on the host,
    the rows ``genz_malik.orbit_head`` makes for it (the same function
    makes them at every ndim: held equal at 17D and 20D).  Every point has
    at most three nonzero axes, and orbit 7's all three."""
    k5, k6, k7, k8, feval = cuda_rule.generic_orbit_bounds(ndim)[1:]
    assert feval == genz_malik.feval_per_region(ndim)
    words = cuda_rule.wide_orbit_codes(ndim)
    assert words.dtype == np.uint32 and words.shape == (k8,)
    head, _ = genz_malik.orbit_head(ndim)
    if ndim <= 20:
        gen = rule_eval.rule_tables(ndim).gen
        assert np.array_equal(head.view(np.uint64),
                              gen[:k8].view(np.uint64))
    lam = cuda_rule.generator_lam()
    for itemsize in (8, 4):
        codes = _decode_like_kernel(words, ndim, itemsize)
        assert np.array_equal(lam[codes].view(np.uint64),
                              head.view(np.uint64))
    assert np.array_equal(cuda_rule.wide_point_codes(ndim, np.arange(k8)),
                          codes)
    nonzero = (codes != 0).sum(axis=1)
    assert nonzero.max() == cuda_rule.WIDE_PAIRS == 3
    assert (nonzero[k7:] == 3).all() and (nonzero[:k7] <= 2).all()
    assert k8 - k7 == 4 * ndim * (ndim - 1) * (ndim - 2) // 3


@pytest.mark.parametrize("ndim", [17, 18])
def test_wide_corners_follow_generic_convention(ndim):
    """Corner k: axis d at -lambda_5 (code 10) where bit n-1-d of k is set,
    as ``generic_point_codes`` decodes the generic route's corners, and
    the rule's points bitwise.  The kernel's thread t takes corners k =
    it * 512 + t: its 9 low axes from t's bits, the others from ``it``
    shifted to the top of a 32-bit word (axis d at bit 31 - d)."""
    k8, feval = cuda_rule.generic_orbit_bounds(ndim)[4:]
    wide = cuda_rule.wide_point_codes(ndim, np.arange(k8, feval))
    if ndim == 17:
        generic = cuda_rule.generic_point_codes(ndim, nmax=ndim)[k8:]
        assert np.array_equal(wide, generic)
    gen = rule_eval.rule_tables(ndim).gen[k8:feval]
    assert np.array_equal(cuda_rule.generator_lam()[wide].view(np.uint64),
                          gen.view(np.uint64))
    high = ndim - LOW_AXES
    rng = np.random.default_rng(ndim)
    for it, tid in zip(rng.integers(0, 1 << high, 64),
                       rng.integers(0, WIDE_THREADS, 64)):
        u = (int(it) << (32 - high)) & 0xFFFFFFFF
        bits = [(u >> (31 - d)) & 1 for d in range(high)]
        bits += [(int(tid) >> (LOW_AXES - 1 - i)) & 1
                 for i in range(LOW_AXES)]
        k = int(it) * WIDE_THREADS + int(tid)
        assert list(wide[k]) == [10 if b else 5 for b in bits]


def test_rule_route_choices_and_refusals():
    """A Genz family: 'generic' at 16D, 'wide' at 17D and 24D, refused at
    25D; a callable and a vector: 'split' up to 24D, refused at 25D; a
    traced callable: 'generic' at 16D, refused at 17D.  Each refusal
    names rule_backend='torch'."""
    torch_backend = "rule_backend='torch'"
    g = genz.f4_gaussian
    assert cuda_rule.rule_route(16, g(16)) == "generic"
    assert cuda_rule.rule_route(17, g(17)) == cuda_rule.WIDE == "wide"
    assert cuda_rule.rule_route(24, g(24)) == "wide"
    assert cuda_rule.rule_route(17) == cuda_rule.rule_route(24) == "wide"
    assert cuda_rule.rule_route(8) == "tile"

    def plain(x):
        return torch.exp(-x.sum(-1))

    assert cuda_rule.rule_route(16, plain) == "split"
    assert cuda_rule.rule_route(16, g(16), ncomp=2) == "split"
    for ndim in (17, 24):
        assert cuda_rule.rule_route(ndim, plain) == "split"
        assert cuda_rule.rule_route(ndim, g(ndim), ncomp=2) == "split"
        assert cuda_rule.rule_route(ndim, None, ncomp=3) == "split"
    names16 = ", ".join(f"x{d}" for d in range(16))
    names17 = ", ".join(f"x{d}" for d in range(17))
    t16 = integrand_gen.traced(eval(f"lambda {names16}: x0 * x1"), 16)
    t17 = integrand_gen.traced(eval(f"lambda {names17}: x0 * x1"), 17)
    assert cuda_rule.rule_route(16, t16) == "generic"
    for args in ((25, g(25)), (25,), (25, plain), (25, g(25), 2),
                 (17, t17)):
        with pytest.raises(ValueError, match=torch_backend):
            cuda_rule.rule_route(*args)


def _meta_pool(ndim, cap=8):
    lows = torch.zeros(ndim, cap, dtype=torch.float64, device="meta")
    glo = torch.zeros(ndim, dtype=torch.float64, device="meta")
    return lows, lows.clone(), glo, glo.clone()


def _bare_tables(ndim):
    """RuleTables of ``ndim`` with its dimension and point count alone: the
    wrappers refuse the pools below before reading anything else (the 24D
    table's points are 3.2 GB)."""
    return rule_eval.RuleTables(
        ndim=ndim, feval=genz_malik.feval_per_region(ndim), feval_padded=0,
        gen=None, wts=None, orbit_wts=None, orbit_bounds=(), scale=None,
        norm=None, ratio=0.0)


def test_pool_past_16d_reaches_the_wide_wrapper():
    """A 17D Genz pool off the CPU goes to the wide route's launch, and a
    callable's and a vector's at 17D and 24D to the split route's (whose
    pool checks refuse a tensor that is not on the card, with no plain
    fallback); a crease run at 17D (a Genz family or a callable) and a
    callable at 25D are refused before, naming rule_backend='torch'."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rule_eval.apply_rule(genz.f4_gaussian(17), rule_eval.rule_tables(17),
                             *_meta_pool(17))
    for ndim in (17, 24):
        for kw in ({}, {"ncomp": 2}):
            with pytest.raises(ValueError,
                               match="cuda_apply_rule_split needs CUDA"):
                rule_eval.apply_rule(lambda x: x.sum(-1), _bare_tables(ndim),
                                     *_meta_pool(ndim), **kw)
    for f, ndim, kw in ((genz.f4_gaussian(17), 17, {"with_split_frac": True}),
                        (lambda x: x.sum(-1), 17, {"with_split_frac": True}),
                        (lambda x: x.sum(-1), 25, {}),
                        (lambda x: x.sum(-1), 25, {"ncomp": 2})):
        with pytest.raises(ValueError, match="rule_backend='torch'"):
            rule_eval.apply_rule(f, _bare_tables(ndim), *_meta_pool(ndim),
                                 **kw)
    with pytest.raises(ValueError, match="takes ndim 2..16, not 17"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(17),
                                  rule_eval.rule_tables(17), *_meta_pool(17),
                                  route="generic")
    with pytest.raises(ValueError, match="route 'wide' does not take"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(12),
                                  rule_eval.rule_tables(12), *_meta_pool(12),
                                  route="wide")


@pytest.mark.parametrize("name", list(genz.FAMILIES))
def test_kernel_params_at_width_24(name):
    """The wide route's 50 doubles: per-axis coefficients in [0, 24) and
    bounds in [24, 48), zero past ndim, the family's two scalars at 48 and
    49 (those of the 34 doubles at width 16 for the same family at 16D);
    width 16 refuses 20 per-axis coefficients."""
    g20 = genz.FAMILIES[name](20)
    kind, p = cuda_rule.kernel_params(g20, cuda_rule.WIDE_MAX_NDIM)
    assert kind == g20.kind and p.shape == (50,) and p.dtype == np.float64
    _, p16 = cuda_rule.kernel_params(genz.FAMILIES[name](16))
    assert np.array_equal(p[48:], p16[32:])
    if g20.kind in (1, 3, 6):
        assert np.array_equal(p[:20], g20.params["coeffs"])
        with pytest.raises(ValueError, match="per-axis coefficients"):
            cuda_rule.kernel_params(g20)
    else:
        assert not p[:48].any()
    assert not p[20:24].any() and not p[44:48].any()
    if g20.kind == 6:
        assert np.array_equal(p[24:44], g20.params["bounds"])


def test_wide_plan():
    """One block a region, at most WIDE_BLOCKS_PER_SM a SM, never 0."""
    assert cuda_rule.wide_plan(1, 132) == 1
    assert cuda_rule.wide_plan(100, 132) == 100
    assert cuda_rule.wide_plan(10 ** 6, 132) == (
        cuda_rule.WIDE_BLOCKS_PER_SM * 132)
    assert cuda_rule.wide_plan(0, 132) == 1
