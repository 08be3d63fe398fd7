"""The crease/jump-aware split fraction of the port
(``rule_eval.split_fraction``, ``split_stencil``, the ``with_split_frac``
outputs of ``rule_outputs``/``apply_rule_plain``, ``cuda_rule.split_frac``
on CPU tensors) and the pool with fractions (``region_pool.split(frac=)``,
``compact(extra=)``) against the JAX package's ``rule_eval._split_fraction``
and ``region_pool``, on the CPU.

The fractions, split axes and pools are held BITWISE (a region's estimate
and errorest, which the packages' rule sums reassociate, within 64 ulps of
the estimate): the reference runs under
``jax.disable_jit()`` (XLA contracts multiply-adds in compiled bodies, the
port never does), on the same seeded numpy inputs.  The cases are the
reference's own (tests/test_crease_split.py: an inner-gap kink, four smooth
integrands, an outer-gap kink, the grid-aligned F5, jumps in both inner
gaps, a jump overriding the split axis, steep smooth exponentials, a jump
hidden at the top level and found a level down) and random stencils in f64
and f32."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_tpu.pagani import region_pool as jax_region_pool
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval
from gpuintegration_torch.pagani import region_pool


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


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


_F5 = genz.f5_c0_continuous(2)
_F5_JAX = jax_genz.f5_c0_continuous(2)
# (port integrand, reference integrand, lows, lengths, expected (sd, frac)
# or a check of frac) -- the reference's cases
CASES = {
    "inner_gap_kink": (
        lambda x: torch.exp(-6.0 * torch.abs(x[..., 0] - 0.37))
        * (1.0 + 0.2 * x[..., 1]),
        lambda x: jnp.exp(-6.0 * jnp.abs(x[..., 0] - 0.37))
        * (1.0 + 0.2 * x[..., 1]),
        None, lambda sd, fr: sd == 0 and 0.3 < fr < 0.48),
    "smooth_gaussian": (
        lambda x: torch.exp(-5.0 * torch.sum((x - 0.5) ** 2, dim=-1)),
        lambda x: jnp.exp(-5.0 * jnp.sum((x - 0.5) ** 2, axis=-1)),
        None, lambda sd, fr: fr == 0.5),
    "smooth_exponential": (
        lambda x: torch.exp(-3.0 * x[..., 0] - 2.0 * x[..., 1]),
        lambda x: jnp.exp(-3.0 * x[..., 0] - 2.0 * x[..., 1]),
        None, lambda sd, fr: fr == 0.5),
    "smooth_cosine": (
        lambda x: torch.cos(3.0 * x[..., 0] + 2.0 * x[..., 1]),
        lambda x: jnp.cos(3.0 * x[..., 0] + 2.0 * x[..., 1]),
        None, lambda sd, fr: fr == 0.5),
    "smooth_power": (
        lambda x: (1.0 + x[..., 0] + 2.0 * x[..., 1]) ** -3,
        lambda x: (1.0 + x[..., 0] + 2.0 * x[..., 1]) ** -3,
        None, lambda sd, fr: fr == 0.5),
    "outer_gap_kink": (
        lambda x: torch.exp(-6.0 * torch.abs(x[..., 0] - 0.1))
        * (1.0 + 0.2 * x[..., 1]),
        lambda x: jnp.exp(-6.0 * jnp.abs(x[..., 0] - 0.1))
        * (1.0 + 0.2 * x[..., 1]),
        None, lambda sd, fr: fr == 0.5),
    "grid_aligned_f5": (_F5, _F5_JAX, None, lambda sd, fr: fr == 0.5),
    "jump_left_gap": (
        lambda x: torch.where(x[..., 0] <= 0.4,
                              torch.exp(x[..., 0] + 0.2 * x[..., 1]),
                              torch.zeros_like(x[..., 0])),
        lambda x: jnp.where(x[..., 0] <= 0.4,
                            jnp.exp(x[..., 0] + 0.2 * x[..., 1]), 0.0),
        None, lambda sd, fr: (sd, fr) == (0, 0.58)),
    "jump_right_gap": (
        lambda x: torch.where(x[..., 0] <= 0.6,
                              torch.exp(x[..., 0] + 0.2 * x[..., 1]),
                              torch.zeros_like(x[..., 0])),
        lambda x: jnp.where(x[..., 0] <= 0.6,
                            jnp.exp(x[..., 0] + 0.2 * x[..., 1]), 0.0),
        None, lambda sd, fr: (sd, fr) == (0, 0.42)),
    "jump_overrides_axis": (
        lambda x: torch.exp(-30.0 * (x[..., 0] - 0.5) ** 2)
        * (x[..., 1] <= 0.6).to(x.dtype),
        lambda x: jnp.exp(-30.0 * (x[..., 0] - 0.5) ** 2)
        * jnp.where(x[..., 1] <= 0.6, 1.0, 0.0),
        None, lambda sd, fr: (sd, fr) == (1, 0.42)),
    "steep_decay_silent": (
        lambda x: torch.exp(-8.0 * x[..., 0] - 2.0 * x[..., 1]),
        lambda x: jnp.exp(-8.0 * x[..., 0] - 2.0 * x[..., 1]),
        None, lambda sd, fr: fr == 0.5),
    "steep_growth_silent": (
        lambda x: torch.exp(8.0 * x[..., 0] + 2.0 * x[..., 1]),
        lambda x: jnp.exp(8.0 * x[..., 0] + 2.0 * x[..., 1]),
        None, lambda sd, fr: fr == 0.5),
    "hidden_jump_top": (
        lambda x: torch.where(x[..., 0] <= 0.45,
                              torch.exp(10 * x[..., 0] + x[..., 1]),
                              torch.zeros_like(x[..., 0])),
        lambda x: jnp.where(x[..., 0] <= 0.45,
                            jnp.exp(10 * x[..., 0] + x[..., 1]), 0.0),
        None, lambda sd, fr: fr == 0.5),
    "hidden_jump_found_deeper": (
        lambda x: torch.where(x[..., 0] <= 0.45,
                              torch.exp(10 * x[..., 0] + x[..., 1]),
                              torch.zeros_like(x[..., 0])),
        lambda x: jnp.where(x[..., 0] <= 0.45,
                            jnp.exp(10 * x[..., 0] + x[..., 1]), 0.0),
        ([[0.375], [0.5]], [[0.25], [0.25]]), lambda sd, fr: fr == 0.58),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_cases_bitwise(name):
    """One 2D region through the whole rule with the fraction: the port's
    plain rule and the reference's give the same split axis and fraction,
    bit for bit (estimate and errorest to reassociation), and each the
    reference test's expected cut."""
    f, f_jax, region, expect = CASES[name]
    ndim = 2
    lo = np.zeros((ndim, 1)) if region is None else np.array(region[0])
    ln = np.ones((ndim, 1)) if region is None else np.array(region[1])
    tables_j = jax_rule_eval.rule_tables(ndim, "float64")
    with jax.disable_jit():
        ref = jax_rule_eval.apply_rule(
            f_jax, tables_j, jnp.asarray(lo), jnp.asarray(ln),
            jnp.zeros(ndim), jnp.ones(ndim), with_split_frac=True)
    got = rule_eval.apply_rule_plain(
        f, rule_eval.rule_tables(ndim), torch.as_tensor(lo),
        torch.as_tensor(ln), torch.zeros(ndim, dtype=torch.float64),
        torch.ones(ndim, dtype=torch.float64), with_split_frac=True)
    assert len(got) == 4
    _assert_rule_outputs(got, ref, np.ones(1, dtype=bool))
    assert expect(int(got[2][0]), float(got[3][0])), (name, got)


def _assert_rule_outputs(got, ref, real, frac_ulps=0):
    """split_dim EQUAL on the ``real`` slots, the fraction within
    ``frac_ulps`` of its own (0: EQUAL); estimate and errorest, which the
    two packages' rule sums reassociate, within 64 ulps of the
    estimate."""
    est = np.asarray(ref[0])[real]
    limit = 64 * np.spacing(np.abs(est)) + 1e-300
    for k in (0, 1):
        assert (np.abs(got[k].numpy()[real] - np.asarray(ref[k])[real])
                <= limit).all()
    assert _bits_equal(got[2].numpy()[real], np.asarray(ref[2])[real])
    fr, ref_fr = got[3].numpy()[real], np.asarray(ref[3])[real]
    if frac_ulps == 0:
        assert _bits_equal(fr, ref_fr)
    else:
        assert (np.abs(fr - ref_fr) <= frac_ulps * np.spacing(ref_fr)).all()


def _stencils(ndim, count, dtype, seed):
    return kernel_check.crease_stencils(ndim, count, dtype, seed)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ndim", [2, 3, 5, 8, 12])
def test_random_stencils_bitwise(ndim, dtype):
    """``split_fraction`` against ``_split_fraction`` on random stencils
    with planted kinks and jumps (``kernel_check.crease_stencils``, the
    card check's values): frac and split_dim EQUAL, and both detectors
    fire on a good share of the regions."""
    vals, sd = _stencils(ndim, 600, dtype, seed=ndim)
    with jax.disable_jit():
        ref_fr, ref_sd = jax_rule_eval._split_fraction(
            jax_rule_eval.rule_tables(ndim, dtype), jnp.asarray(vals),
            jnp.asarray(sd))
    fr, out_sd = rule_eval.split_fraction(torch.as_tensor(vals),
                                          torch.as_tensor(sd), ndim)
    assert _bits_equal(fr.numpy(), ref_fr)
    assert _bits_equal(out_sd.numpy(), ref_sd)
    fr = fr.numpy()
    assert ((fr != 0.5) & (fr != np.float32(0.58)) & (fr != np.float32(0.42))
            ).mean() > 0.05
    assert (out_sd.numpy() != sd).mean() > 0.05           # jumps override
    assert fr.min() >= np.asarray(0.12, dtype) and fr.max() <= np.asarray(
        0.88, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wrapper_on_cpu_is_the_plain_version_at_any_strides(dtype):
    """``cuda_rule.split_frac`` runs the plain version on CPU tensors; the
    values as rows (strides (feval, 1)) or as planes ((1, C)) give the same
    bits, as the kernel reads both."""
    vals, sd = _stencils(5, 300, dtype, seed=11)
    rows = torch.as_tensor(vals)
    planes = torch.as_tensor(np.ascontiguousarray(vals.T)).T
    assert planes.stride() == (1, 300)
    ref = rule_eval.split_fraction(rows, torch.as_tensor(sd), 5)
    for v in (rows, planes):
        got = cuda_rule.split_frac(v, torch.as_tensor(sd), 5)
        for g, r in zip(got, ref):
            assert torch.equal(g, r) and g.dtype == r.dtype


@pytest.mark.parametrize("ndim", [2, 8, 16])
def test_split_stencil_is_the_reference_positions(ndim):
    """The stencil's slots are orbit 1 and 2 of each axis sorted by their
    position -gen[slot, d]; the constants are those positions' differences
    in f64 of the pool type's table, the f32 table's rounded once."""
    for dtype in ("float64", "float32"):
        gen = jax_rule_eval.rule_tables(ndim, dtype).gen
        slots, consts = rule_eval.split_stencil(ndim, dtype)
        for d in range(ndim):
            pos = [-float(gen[s, d]) for s in slots[d]]
            assert pos == sorted(pos) and pos[1] < 0.0 < pos[2]
            assert sorted(slots[d]) == [1 + 2 * d, 2 + 2 * d,
                                        1 + 2 * ndim + 2 * d,
                                        2 + 2 * ndim + 2 * d]
            assert list(consts[d]) == [pos[1], pos[2], pos[1] - pos[0],
                                       0.0 - pos[1], pos[3] - pos[2]]


def test_rule_route_takes_split_for_a_crease_run(monkeypatch):
    """A crease run needs the values: every integrand takes the split
    route on the card then, a Genz family too, and the split wrapper is
    asked for the fraction (a meta pool stands in for the card)."""
    g = genz.f4_gaussian(8)
    assert cuda_rule.rule_route(8, g) == "tile"
    assert cuda_rule.rule_route(8, g, 1, True) == "split"
    assert cuda_rule.rule_route(12, g, 1, True) == "split"
    calls = []

    def fake_split(f, tables, lows, lengths, gl, gr, **kw):
        calls.append(kw)
        return "split"

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule_split", fake_split)
    pool = [torch.empty(s, device="meta", dtype=torch.float64)
            for s in ((3, 8), (3, 8), (3,), (3,))]
    assert rule_eval.apply_rule(genz.f3_corner_peak(3),
                                rule_eval.rule_tables(3), *pool,
                                chunk_size=4, n=6, blocked=True,
                                with_split_frac=True) == "split"
    assert calls == [dict(chunk_size=4, n=6, blocked=True, ncomp=1,
                          with_split_frac=True)]


def _pool(ndim, cap, dtype, seed):
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0.0, 0.5, (ndim, cap)).astype(dtype)
    lengths = rng.uniform(0.01, 0.5, (ndim, cap)).astype(dtype)
    return lows, lengths


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_with_fractions_bitwise(dtype, seed):
    """``split(frac=)`` is the reference's bit for bit; all-0.5 fractions
    give the midpoint split's bits."""
    ndim, cap, n = 4, 64, 40
    rng = np.random.default_rng(100 + seed)
    lows, lengths = _pool(ndim, cap, dtype, seed)
    sd = rng.integers(0, ndim, cap).astype(np.int32)
    frac = np.where(rng.uniform(size=cap) < 0.5, 0.5,
                    rng.uniform(0.12, 0.88, cap)).astype(dtype)
    with jax.disable_jit():
        ref = jax_region_pool.split(
            jnp.asarray(lows), jnp.asarray(lengths), jnp.asarray(sd),
            jnp.asarray(n), out_capacity=2 * cap, frac=jnp.asarray(frac))
    got = region_pool.split(torch.as_tensor(lows), torch.as_tensor(lengths),
                            torch.as_tensor(sd), n, out_capacity=2 * cap,
                            frac=torch.as_tensor(frac))
    assert _bits_equal(got[0].numpy(), ref[0])
    assert _bits_equal(got[1].numpy(), ref[1])
    assert got[2] == int(ref[2]) == 2 * n
    half = region_pool.split(torch.as_tensor(lows), torch.as_tensor(lengths),
                             torch.as_tensor(sd), n, out_capacity=2 * cap,
                             frac=torch.full((cap,), 0.5,
                                             dtype=getattr(torch, dtype)))
    mid = region_pool.split(torch.as_tensor(lows), torch.as_tensor(lengths),
                            torch.as_tensor(sd), n, out_capacity=2 * cap)
    assert torch.equal(half[0], mid[0]) and torch.equal(half[1], mid[1])


@pytest.mark.parametrize("out_cap", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_with_extra_bitwise(seed, out_cap):
    """``compact(extra=)``: the fraction row travels like split_dim, the
    real slots [0, n_active) the reference's bit for bit."""
    ndim, cap = 3, 64
    rng = np.random.default_rng(200 + seed)
    lows, lengths = _pool(ndim, cap, "float64", seed)
    active = (rng.uniform(size=cap) < 0.45).astype(np.float64)
    sd = rng.integers(0, ndim, cap).astype(np.int32)
    est, err = rng.normal(size=cap), rng.uniform(size=cap)
    extra = rng.uniform(0.12, 0.88, cap)
    with jax.disable_jit():
        ref = jax_region_pool.compact(
            *(jnp.asarray(a) for a in (active, lows, lengths, sd, est, err)),
            out_capacity=out_cap, extra=jnp.asarray(extra))
    got = region_pool.compact(
        *(torch.as_tensor(a) for a in (active, lows, lengths, sd, est, err)),
        out_capacity=out_cap, extra=torch.as_tensor(extra))
    m = int(ref[0])
    assert m == int(active.sum())
    assert len(got) == 6
    for g, r in zip(got, ref[1:]):
        assert _bits_equal(g[..., :m].numpy(), np.asarray(r)[..., :m])
    plain = region_pool.compact(
        *(torch.as_tensor(a) for a in (active, lows, lengths, sd, est, err)),
        out_capacity=out_cap)
    assert len(plain) == 5
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize("blocked", [False, True])
def test_plain_rule_pool_with_fractions_bitwise(blocked):
    """The whole pool through ``apply_rule_plain(with_split_frac=True)``
    against the reference's ``apply_rule`` (chunks, dynamic trip count):
    split_dim bit for bit on the real slots, the fraction within 64 of its
    ulps (the values differ where the packages' exp do), the padding's
    fraction 0.5."""
    ndim, cap, n, chunk = 3, 256, 200, 64
    g = genz.f5_c0_continuous(ndim, a=10.0, b=0.37)
    g_jax = jax_genz.f5_c0_continuous(ndim, a=10.0, b=0.37)
    lo, ln, _ = jax_region_pool.uniform_split(ndim, 4, cap, jnp.float64)
    lo = lo * 0.9 + 0.013
    ln = ln * 0.9
    with jax.disable_jit():
        ref = jax_rule_eval.apply_rule(
            g_jax, jax_rule_eval.rule_tables(ndim), lo, ln,
            jnp.zeros(ndim), jnp.ones(ndim), chunk_size=chunk,
            n=jnp.asarray(n), blocked=blocked, with_split_frac=True)
    got = rule_eval.apply_rule_plain(
        g, rule_eval.rule_tables(ndim), torch.as_tensor(np.asarray(lo)),
        torch.as_tensor(np.asarray(ln)),
        torch.zeros(ndim, dtype=torch.float64),
        torch.ones(ndim, dtype=torch.float64), chunk_size=chunk, n=n,
        blocked=blocked, with_split_frac=True)
    real = region_pool.block_mask(cap, n, blocked).numpy()
    # the packages' exp differ in the last bit on some points, and a
    # crease's secants carry that into the fraction
    _assert_rule_outputs(got, ref, real, frac_ulps=64)
    assert (got[3].numpy()[~real] == 0.5).all()
    assert (got[3].numpy()[real] != 0.5).any()
    with pytest.raises(ValueError, match="scalar-only"):
        rule_eval.apply_rule_plain(g, rule_eval.rule_tables(ndim),
                                   torch.as_tensor(np.asarray(lo)),
                                   torch.as_tensor(np.asarray(ln)),
                                   torch.zeros(ndim, dtype=torch.float64),
                                   torch.ones(ndim, dtype=torch.float64),
                                   ncomp=2, with_split_frac=True)
    assert math.isfinite(float(got[0].sum()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_constants_and_check_on_cpu(dtype):
    """The launch's host constants are the stencil's, rounded to the
    working type once (exactly representable in it, as the kernel takes
    them); ``kernel_check.check_split_frac`` reads the cut and the
    overridden axes (on CPU tensors the wrapper is the plain version)."""
    tdtype = getattr(torch, dtype)
    slots, consts = cuda_rule._frac_tables(8, tdtype)
    ref_slots, ref_consts = rule_eval.split_stencil(8, dtype)
    assert slots.dtype == np.int32 and np.array_equal(slots, ref_slots)
    assert consts.dtype == np.float64 and consts.flags["C_CONTIGUOUS"]
    assert np.array_equal(consts, ref_consts.astype(dtype).astype(
        np.float64))
    vals, sd = kernel_check.crease_stencils(8, 400, dtype, seed=4)
    r = kernel_check.check_split_frac(torch.as_tensor(vals),
                                      torch.as_tensor(sd), 8)
    fr, out_sd = rule_eval.split_fraction(torch.as_tensor(vals),
                                          torch.as_tensor(sd), 8)
    assert r == {"regions": 400, "cut": int((fr != 0.5).sum()),
                 "overrides": int((out_sd != torch.as_tensor(sd)).sum()),
                 "max_abs_err": 0.0}
    assert r["cut"] > 40 and r["overrides"] > 20
