"""Where a crease run's cut fraction is computed, on the CPU: the pieces of
the fold of ``rule_eval.split_fraction`` into the kernels that hold a
region's collinear values (csrc/split_frac.cuh, the fused Genz kernels and
the split route's scalar contractions).

The kernels themselves run only on the card (tests/test_torch_cuda_crease.py).
Here: the fraction reads only the collinear prefix of the values (what the
fused kernels keep, and write out for the check), bit for bit at every
ndim; the check that holds a folded fraction against the plain version
passes on the plain version's outputs and fails on a flipped bit, and
the one that holds the kernel's kept values to the callable's fails on a
wrong slot order, side or value; the per-axis form's reduction over a group of lanes picks the sequential
loop's axis; the fused launch's crease arguments; the counters; and a 2D
crease run, the generic route's dimension on the card, against the JAX
package's at the reference's tolerance with the same discrete
outcomes."""
import math

import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _stencils(ndim, count, dtype, seed):
    """``kernel_check.crease_stencils`` with region 7 all NaN."""
    vals, sd = kernel_check.crease_stencils(ndim, count, dtype, seed)
    vals[7, :] = np.nan
    return torch.as_tensor(vals), torch.as_tensor(sd)


def _same_bits(a, b):
    return kernel_check.same_bits(a.contiguous(), b.contiguous())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndim", range(2, 17))
def test_split_fraction_reads_only_the_kept_prefix(ndim, dtype):
    """The fraction of every region is a function of its points 0 .. 4
    ndim alone: the values past them set to NaN and +-inf, or cut away
    (the (C, 4 ndim + 1) rows the fused kernels keep), give the same
    fraction and split axis bit for bit; the NaN region keeps 0.5 and its
    axis."""
    vals, sd = _stencils(ndim, 160, dtype, seed=40 + ndim)
    head = 4 * ndim + 1
    ref = rule_eval.split_fraction(vals, sd, ndim)
    poisoned = vals.clone()
    tail = poisoned[:, head:]
    tail[:, 0::3] = float("nan")
    tail[:, 1::3] = float("inf")
    tail[:, 2::3] = -float("inf")
    for v in (poisoned, vals[:, :head].clone()):
        got = rule_eval.split_fraction(v, sd, ndim)
        assert _same_bits(got[0], ref[0]) and _same_bits(got[1], ref[1])
    assert float(ref[0][7]) == 0.5 and int(ref[1][7]) == int(sd[7])
    assert (ref[0] != 0.5).sum() > 10


@pytest.mark.parametrize("what", ["frac", "split_dim"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_folded_fraction_check(dtype, what):
    """``kernel_check.check_folded_frac`` passes on the plain version's
    own outputs (read from the kept prefix) and fails on one flipped bit
    of the fraction or one moved split axis."""
    ndim = 8
    vals, sd = _stencils(ndim, 300, dtype, seed=3)
    kept = vals[:, :4 * ndim + 1].clone()
    frac, out_sd = rule_eval.split_fraction(vals, sd, ndim)
    r = kernel_check.check_folded_frac(frac, out_sd, kept, sd, ndim)
    assert r == {"regions": 300, "cut": int((frac != 0.5).sum()),
                 "overrides": int((out_sd != sd).sum()), "max_abs_err": 0.0}
    assert r["cut"] > 30 and r["overrides"] > 15
    i = int(torch.nonzero(frac != 0.5)[0, 0])
    if what == "frac":
        bits = frac.clone().view(torch.int64 if dtype == "float64"
                                 else torch.int32)
        bits[i] ^= 1
        frac = bits.view(frac.dtype)
    else:
        out_sd = out_sd.clone()
        out_sd[i] = (out_sd[i] + 1) % ndim
    with pytest.raises(AssertionError, match=what):
        kernel_check.check_folded_frac(frac, out_sd, kept, sd, ndim)


def _kept_pool(g, count, dtype, seed):
    """A pool of ``count`` random regions of type ``dtype`` (region 2 all
    NaN) and the callable's values at its rule points 0 .. 4 ndim, the
    prefix a fused kernel writes out as ``kept``."""
    ndim = g.ndim
    rng = np.random.default_rng(seed)
    tdtype = getattr(torch, dtype)
    lows = torch.as_tensor(rng.uniform(0.0, 0.5, (ndim, count)), dtype=tdtype)
    lengths = torch.as_tensor(rng.uniform(0.01, 0.5, (ndim, count)),
                              dtype=tdtype)
    lows[:, 2] = float("nan")
    gl, gr = torch.zeros(ndim, dtype=tdtype), torch.ones(ndim, dtype=tdtype)
    tables = rule_eval.rule_tables(ndim, dtype)
    vals = rule_eval.rule_values(g, tables, lows, lengths, gl, gr)
    return (vals[:, :4 * ndim + 1].clone(),
            (g, tables, lows, lengths, gl, gr))


@pytest.mark.parametrize("family", ["f5_c0", "f6_discontinuous"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kept_values_check_passes_on_the_callables_values(dtype, family):
    """``kernel_check.check_kept_values`` passes on the callable's own
    values at rule points 0 .. 4 ndim, the NaN region included."""
    g = genz.FAMILIES[family](8)
    kept, args = _kept_pool(g, 96, dtype, seed=11)
    r = kernel_check.check_kept_values(kept, *args)
    # the callable on the prefix alone may round a value's last bits
    # otherwise than on every point: within rtol, a few ulps apart
    assert r["value_rel"] <= 64 * torch.finfo(getattr(torch, dtype)).eps
    del r["value_rel"]
    assert r == {"values": 96 * 33, "value_ulps": 0.0, "discontinuities": 0}


@pytest.mark.parametrize("error", ["slot_order", "sign", "dropped"])
def test_kept_values_check_fails_on_a_wrong_prefix(error):
    """The check fails where the kernel's collinear prefix is not the
    rule's: two axes' slots exchanged, an orbit's point on the wrong side
    of the centre (its pair exchanged), or one value lost."""
    ndim = 8
    g = genz.f5_c0_continuous(ndim, a=10.0, b=0.37)
    kept, args = _kept_pool(g, 64, "float64", seed=12)
    if error == "slot_order":
        kept[:, [1, 2, 3, 4]] = kept[:, [3, 4, 1, 2]]
    elif error == "sign":
        kept[:, [1 + 2 * ndim, 2 + 2 * ndim]] = kept[:, [2 + 2 * ndim,
                                                         1 + 2 * ndim]]
    else:
        kept[5, 0] = 0.0
    with pytest.raises(AssertionError, match="kept values beyond"):
        kernel_check.check_kept_values(kept, *args)


def test_kept_values_check_allows_a_discontinuity_within_roundoff():
    """A centre exactly on F6's bound on axis 0 lies inside for the
    callable; a kernel whose coordinate rounds across it reads 0 there.
    The check holds that value to the callable at the point moved by the
    coordinate's rounding and counts it; a 0 at the region's point on
    axis 0 inside the bound, far from it, still fails."""
    ndim = 8
    g = genz.f6_discontinuous(ndim)
    kept, (_, tables, lows, lengths, gl, gr) = _kept_pool(g, 16, "float64",
                                                          seed=13)
    lows[:, 4], lengths[:, 4] = 0.0, 0.1
    lows[0, 4], lengths[0, 4] = 0.1, 0.2       # centre 0.2, the bound b_0
    args = (g, tables, lows, lengths, gl, gr)
    kept = rule_eval.rule_values(g, tables, lows, lengths, gl,
                                 gr)[:, :4 * ndim + 1].clone()
    assert float(kept[4, 0]) > 0.0
    kept[4, 0] = 0.0
    r = kernel_check.check_kept_values(kept, *args)
    assert r["discontinuities"] == 1 and r["value_ulps"] == 0.0
    # of the two points on axis 0 the one inside lies far from the bound
    far = 1 if float(kept[4, 1]) > 0.0 else 2
    assert float(kept[4, far]) > 0.0
    kept[4, far] = 0.0
    with pytest.raises(AssertionError, match="1 of"):
        kernel_check.check_kept_values(kept, *args)


def _group_frac(regions, ndim, group):
    """split_frac.cuh's group_frac on the 32 lanes of a warp in groups of
    ``group`` lanes, group g holding region g of ``regions`` (kink,
    strength, jump, sd), lane d of a group axis d: the xor butterfly over
    (strength, -index) within each group, then the kink cut of the
    group's lane sd or the jump cut of its winning lane.  Returns each
    group's (fraction, axis)."""
    def axis_value(values, lane, pad):
        g, d = divmod(lane, group)
        return values(regions[g])[d] if d < ndim else pad

    top = [axis_value(lambda r: r[1], lane, -1.0) for lane in range(32)]
    arg = list(range(32))
    off = group // 2
    while off:
        nt, na = top[:], arg[:]
        for lane in range(32):
            v, i = top[lane ^ off], arg[lane ^ off]
            if v > top[lane] or (v == top[lane] and i < arg[lane]):
                nt[lane], na[lane] = v, i
        top, arg = nt, na
        off //= 2
    out = []
    for g, (kink, _, jump, sd) in enumerate(regions):
        base = g * group
        assert len(set(top[base:base + group])) == 1
        assert len(set(arg[base:base + group])) == 1
        out.append((jump[arg[base] - base], arg[base] - base)
                   if top[base] > 0 else (kink[sd], sd))
    return out


def _region_frac(kink, strength, jump, sd, ndim):
    """split_frac.cuh's region_frac: the axes in order, the first strict
    maximum of the strengths."""
    best, jdim, jfrac = 0.0, 0, 0.5
    for d in range(ndim):
        if d == 0 or strength[d] > best:
            best, jdim, jfrac = strength[d], d, jump[d]
    return (jfrac, jdim) if best > 0 else (kink[sd], sd)


@pytest.mark.parametrize("ndim", range(2, 17))
def test_group_reduction_picks_the_sequential_axis(ndim):
    """The per-axis form's reduction gives the per-region loop's fraction
    and axis for each group's own region, ties (equal strengths, all zero)
    included: the first strongest axis, as torch.argmax takes it in the
    plain version; in groups of 4 and 8 lanes (the tile route's batches at
    3-4D and 5-8D) and of the whole warp (the generic route's, to 16D)."""
    rng = np.random.default_rng(ndim)
    for group in (g for g in (4, 8, 32) if g >= ndim):
        for _ in range(40):
            regions = [(rng.uniform(0.12, 0.88, ndim),
                        rng.choice([0.0, 0.0, 1.0, 2.0, 2.0, np.inf], ndim),
                        rng.choice([0.42, 0.58], ndim),
                        int(rng.integers(0, ndim)))
                       for _ in range(32 // group)]
            got = _group_frac(regions, ndim, group)
            for r, g in zip(regions, got):
                assert g == _region_frac(*r, ndim)
                if r[1].max() > 0:
                    assert g[1] == int(np.argmax(r[1]))


def test_fused_launch_crease_arguments():
    """The fused launch's crease arguments: without the fraction four null
    pointers, and no ``kept``; with it a new (cap,) fraction of the pool's
    type, the stencil's host arrays and ``kept`` only as a contiguous
    (cap, 4 ndim + 1) of the pool's type."""
    lows = torch.zeros((3, 16), dtype=torch.float64)
    assert cuda_rule._fused_frac_args(3, 16, lows, False, None) == (None,) * 5
    kept = torch.zeros((16, 13), dtype=torch.float64)
    with pytest.raises(ValueError, match="with_split_frac"):
        cuda_rule._fused_frac_args(3, 16, lows, False, kept)
    for bad in (torch.zeros((16, 12), dtype=torch.float64),
                torch.zeros((16, 13), dtype=torch.float32),
                torch.zeros((13, 16), dtype=torch.float64).T):
        with pytest.raises(ValueError, match="kept"):
            cuda_rule._fused_frac_args(3, 16, lows, True, bad)
    frac, fp, slots, consts, kp = cuda_rule._fused_frac_args(
        3, 16, lows, True, kept)
    assert frac.shape == (16,) and frac.dtype == torch.float64
    assert fp == frac.data_ptr() and kp == kept.data_ptr()
    s, c = cuda_rule._frac_tables(3, torch.float64)
    assert slots.value == s.ctypes.data and consts.value == c.ctypes.data
    assert cuda_rule._fused_frac_args(3, 16, lows, True, None)[4] is None


def test_counters_name_every_fraction_route():
    """Every kernel that folds the fraction in has a counter, the scalar
    contraction's routes map onto theirs, the standalone kernel has its
    own, and ``reset_launches`` zeroes them."""
    assert set(cuda_rule.FRAC_ROUTES) == (set(cuda_rule.ROUTES) | {
        "cluster", "contract_generic"})
    assert set(cuda_rule.CONTRACT_FRAC_ROUTE) == set(
        cuda_rule.CONTRACT_ROUTES)
    assert set(cuda_rule.CONTRACT_FRAC_ROUTE.values()) <= set(
        cuda_rule.FRAC_ROUTES)
    for k in cuda_rule.frac_route_launches:
        cuda_rule.frac_route_launches[k] = 3
    cuda_rule.split_frac_launches = 2
    cuda_rule.reset_launches()
    assert set(cuda_rule.frac_route_launches.values()) == {0}
    assert cuda_rule.split_frac_launches == 0


def test_route_bits_names_each_kernel():
    """``tools/route_bits.py`` spells out the template arguments of the
    kernels it compares between two trees, fill_padding's included, so
    the fraction's instantiations stand beside the parent's."""
    from gpuintegration_torch.tools.route_bits import kernel_name
    for mangled, name in (
            ("_Z16rule_tile_kernelILi4EdLi8ELb1EEv8RuleArgsIT0_E",
             "rule_tile_kernel<4, double, 8, true>"),
            ("_Z11rule_kernelILi5EfLb0EEv8RuleArgsIT0_E",
             "rule_kernel<5, float, false>"),
            ("_Z12fill_paddingIdLb0EEvPT_S1_PiS1_iii",
             "fill_padding<double, false>"),
            ("_Z12fill_paddingIfEvPT_S1_Piiii", "fill_padding<float>"),
            ("_Z20rule_contract_kernelIdLb1EEvv",
             "rule_contract_kernel<double, true>"),
            ("_Z22rule_split_frac_kernelIfEvv",
             "rule_split_frac_kernel<float>"),
            ("plain_name", "plain_name")):
        assert kernel_name(mangled) == name


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("epsrel", [1e-8, 1e-9])
def test_2d_crease_run_matches_jax(epsrel, fused):
    """A 2D crease run (2D takes the generic route on the card) of
    ``f5_c0_continuous(2, a=10, b=0.37)``, host loop and fused phase,
    against the JAX package's: the same status, iterations, regions,
    finished regions and neval, the estimate within 64 ulps and the
    reference's tolerance of the closed form; fewer evaluations than the
    midpoint run."""
    kw = dict(epsrel=epsrel, epsabs=1e-40, crease_split=True, fused=fused,
              max_iterations=80)
    ref = JaxWorkspace(2, chunk_size=1024).integrate(
        jax_genz.f5_c0_continuous(2, a=10.0, b=0.37), **kw)
    g = genz.f5_c0_continuous(2, a=10.0, b=0.37)
    got = Workspace(2, chunk_size=1024, device="cpu").integrate(g, **kw)
    assert (got.status, got.iters, got.nregions, got.nFinishedRegions,
            got.neval) == (ref.status, ref.iters, ref.nregions,
                           ref.nFinishedRegions, ref.neval)
    assert got.status == 0
    assert abs(got.estimate - ref.estimate) <= 64 * np.spacing(
        abs(ref.estimate))
    assert abs(got.estimate - g.true_value) <= epsrel * abs(g.true_value)
    mid = Workspace(2, chunk_size=1024, device="cpu").integrate(
        g, **dict(kw, crease_split=False))
    assert mid.status == 0 and got.neval < mid.neval
    assert math.isfinite(got.errorest)
