"""Batched Genz-Malik rule application over a region pool (PyTorch port of
``gpuintegration_tpu/ops/rule_eval.py``).

For every region r and rule point p:

  x[r, p, d] = global_lo[d] + (center[r,d] - gen[p,d] * len[r,d]) * range[d]
  vals[r, p] = f(x[r, p, :])

then per-orbit sums of ``vals`` combined with the (9, 5) orbit-weight table
into the five embedded rule sums (times the jacobian prod(range)), the
fourth-difference bisection dimension (Sample.cuh:194-218) and the null-rule
error model (Sample.cuh:264-288).

``apply_rule`` dispatches on the pool's device: a CPU pool runs the plain
PyTorch version here (``apply_rule_plain``), a CUDA pool the hand-written
kernels (``ops/cuda_rule.py``) or raises.  On the card the integrand
chooses the route (``cuda_rule.rule_route``): a Genz family F1..F6
(``models.genz``) is fused into the tile or generic kernel, and from 17D
to 24D into the wide one; any other callable, and every vector-valued
one, takes the split route, a points kernel, the callable on the points
as torch operations, and a contraction kernel, chunk by chunk, up to 24D
(past 16D the kernels' wide instances, on chunks whose points fit
``cuda_rule.SPLIT_CHUNK_BYTES``).  What no kernel takes (a traced callable
or a crease run past 16D, anything past 24D) raises ValueError naming
``rule_backend='torch'``.  A crease run's cut fraction (``split_fraction``)
is computed by the route's kernel that holds the values, the fused kernel
or the contraction.  The split kernels' plain versions are
``rule_points`` and ``rule_outputs`` (``rule_outputs_vector`` for a
vector).  A
caller that wants the plain version on the card calls ``apply_rule_plain``
itself (``Workspace(rule_backend="torch")``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.ops.genz_malik import genz_malik_rule
from gpuintegration_torch.pagani.region_pool import block_mask

# Error-gate coefficients of the CUHRE error model (Sample.cuh:283).
_ERRCOEFF = (5.0, 1.0, 5.0)


@dataclasses.dataclass(frozen=True)
class RuleTables:
    """Constant host tables for one (ndim, dtype) pair (NumPy, bitwise
    equal to the JAX package's ``rule_eval.rule_tables``)."""

    ndim: int
    feval: int            # true number of rule points
    feval_padded: int     # padded to a multiple of 128 (reference layout)
    gen: np.ndarray       # (feval_padded, ndim) signed abscissae
    wts: np.ndarray       # (feval_padded, NRULES)
    orbit_wts: np.ndarray  # (NSETS, NRULES) per-orbit weights
    orbit_bounds: tuple   # NSETS+1 point-axis offsets of the orbit segments
    scale: np.ndarray     # (NSETS, NRULES)
    norm: np.ndarray      # (NSETS, NRULES)
    ratio: float


@functools.lru_cache(maxsize=None)
def rule_tables(ndim: int, dtype_name: str = "float64") -> RuleTables:
    dtype = np.dtype(dtype_name)
    rule = genz_malik_rule(ndim)
    pts, wts = rule.padded(128)
    return RuleTables(
        ndim=ndim,
        feval=rule.feval,
        feval_padded=pts.shape[0],
        gen=np.asarray(pts, dtype=dtype),
        wts=np.asarray(wts, dtype=dtype),
        orbit_wts=np.asarray(rule.orbit_weights, dtype=dtype),
        orbit_bounds=tuple(int(b) for b in
                           np.concatenate([[0], np.cumsum(rule.counts)])),
        scale=np.asarray(rule.scale, dtype=dtype),
        norm=np.asarray(rule.norm, dtype=dtype),
        ratio=float(rule.ratio),
    )


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def device_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """The tables as tensors on ``device``: gen (feval, ndim) without the
    padding rows, orbit_wts, scale and norm."""
    t = rule_tables(ndim, dtype_name(dtype))

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return put(t.gen[:t.feval]), put(t.orbit_wts), put(t.scale), put(t.norm)


def rule_points(tables: RuleTables, lows, lengths, global_lo, global_range):
    """Every rule point of a chunk of C regions in global space:
    (x (C, feval, ndim), center_g (ndim, C), len_g (ndim, C))."""
    gen, _, _, _ = device_tables(tables.ndim, lows.dtype, lows.device)
    # x = gl + ((.5+g)*lower + (.5-g)*upper) * range = gl + (center - g*len)*range
    # (Sample.cuh:126-131), pre-scaled into global space on the (ndim, C)
    # arrays so the (C, P) planes see one multiply and one subtract.
    len_g = lengths * global_range[:, None]                  # (ndim, C)
    center_g = global_lo[:, None] + (lows + 0.5 * lengths) * \
        global_range[:, None]                                # (ndim, C)
    x = center_g.T[:, None, :] - gen[None, :, :] * len_g.T[:, None, :]
    return x, center_g, len_g


def rule_values(f: Callable, tables: RuleTables, lows, lengths,
                global_lo, global_range) -> torch.Tensor:
    """Integrand values at every rule point of a chunk of C regions:
    (C, feval).  ``f`` is batched, (..., ndim) -> (...)."""
    x, _, _ = rule_points(tables, lows, lengths, global_lo, global_range)
    return f(x).to(lows.dtype)                               # (C, P)


def fourth_differences(vals: torch.Tensor, ndim: int, ratio: float):
    """|2(1-ratio) f0 + ratio (f1p+f1m) - (f2p+f2m)| per dimension, (C, ndim):
    the a1 orbit occupies points 1..2n (pairs per dim), a2 2n+1..4n."""
    f0 = vals[:, 0]
    orbit1 = vals[:, 1:1 + 2 * ndim].reshape(-1, ndim, 2).sum(-1)
    orbit2 = vals[:, 1 + 2 * ndim:1 + 4 * ndim].reshape(-1, ndim, 2).sum(-1)
    r = torch.full((), ratio, dtype=vals.dtype, device=vals.device)
    return torch.abs((2.0 * (1.0 - r)) * f0[:, None] + r * orbit1 - orbit2)


def orbit_sums(vals, tables: RuleTables):
    """The values' sum over each orbit of C regions: (C, NSETS)."""
    ob = tables.orbit_bounds
    return torch.stack(
        [vals[:, ob[s]:ob[s + 1]].sum(dim=1) for s in range(len(ob) - 1)],
        dim=1)


def rule_sums(vals, tables: RuleTables, global_range, by_orbit=None):
    """The five embedded rule sums of C regions, jacobian applied: (C, 5).
    Per-orbit segment sums (``orbit_sums``, or ``by_orbit`` where given: a
    kernel's, taken in another order), then the tiny (NSETS, NRULES) weight
    table: the rule is fully symmetric and the point list
    orbit-contiguous."""
    _, orbit_wts, _, _ = device_tables(tables.ndim, vals.dtype, vals.device)
    if by_orbit is None:
        by_orbit = orbit_sums(vals, tables)                  # (C, NSETS)
    sums = torch.sum(by_orbit[:, :, None] * orbit_wts[None, :, :], dim=1)
    return sums * torch.prod(global_range)                   # jacobian


def null_errors(sums, tables: RuleTables):
    """The null-rule error terms: for r in {1,2,3},
    e_r = max_s |S[r+1] + scale[s,r]*S[r]| * norm[s,r], (C, 3)."""
    _, _, scale, norm = device_tables(tables.ndim, sums.dtype, sums.device)
    s_r = sums[:, 1:4]
    s_r1 = sums[:, 2:5]
    sc = scale[:, 1:4]
    nm = norm[:, 1:4]
    return torch.amax(
        torch.abs(s_r1[:, None, :] + sc[None, :, :] * s_r[:, None, :])
        * nm[None, :, :], dim=1)


def gate_errors(errs):
    """The (5,1,5) gate (Sample.cuh:283): e1 where the terms fall fast
    enough (5 e1 <= e2 and 5 e2 <= e3), else 5 max(e1, e2, e3)."""
    e1, e2, e3 = errs[:, 0], errs[:, 1], errs[:, 2]
    return torch.where(
        (_ERRCOEFF[0] * e1 <= e2) & (_ERRCOEFF[0] * e2 <= e3),
        _ERRCOEFF[1] * e1,
        _ERRCOEFF[2] * torch.maximum(torch.maximum(e1, e2), e3))


def split_axis(fourth, lengths):
    """The bisection axis of C regions from their fourth differences (C,
    ndim): the reference's strict '>' scan from maxdiff=0 with fallback to
    the widest dimension, so when every diff is 0 (or the max is NaN) the
    widest dim is used; otherwise first-argmax wins (Sample.cuh:202-218)."""
    widest = torch.argmax(lengths, dim=0).to(torch.int32)
    best = torch.argmax(fourth, dim=1).to(torch.int32)
    any_positive = torch.amax(fourth, dim=1) > 0
    return torch.where(any_positive, best, widest)


def rule_outputs(vals, tables: RuleTables, lengths, global_range,
                 by_orbit=None, with_split_frac: bool = False):
    """(estimate, errorest, split_dim) of C regions from their rule values
    (and, where given, their orbit sums ``by_orbit`` taken in another
    order); with ``with_split_frac`` also the crease/jump-aware cut
    fraction (``split_fraction``), split_dim then the one it returns."""
    sums = rule_sums(vals, tables, global_range, by_orbit)
    split_dim = split_axis(
        fourth_differences(vals, tables.ndim, tables.ratio), lengths)
    gated = gate_errors(null_errors(sums, tables))
    vol = torch.prod(lengths, dim=0)                         # unit-space volume
    if with_split_frac:
        frac, split_dim = split_fraction(vals, split_dim, tables.ndim)
        return vol * sums[:, 0], vol * gated, split_dim, frac
    return vol * sums[:, 0], vol * gated, split_dim


# The cut's safety margin in length units (rule_eval._split_fraction of the
# JAX package: > the crease estimate's error + the rule's blind zone).
SPLIT_MARGIN = 0.08


@functools.lru_cache(maxsize=None)
def split_stencil(ndim: int, dtype_name: str = "float64"):
    """The collinear stencil of every axis, from the rule tables of the
    pool's type: (slots (ndim, 4) int32, consts (ndim, 5) float64).  Per
    axis d the slots of orbit 1 at +-a and orbit 2 at +-b sorted by their
    position -gen[slot, d] (length units from the region's centre), and
    the constants [xam, xap, xam - xbm, 0 - xam, xbp - xap] of those
    positions xbm < xam < 0 < xap < xbp, formed in f64 from the pool
    type's table as the reference forms them from Python floats; cast to
    the pool's type they are the secants' abscissae."""
    gen = rule_tables(ndim, dtype_name).gen
    slots = np.zeros((ndim, 4), dtype=np.int32)
    consts = np.zeros((ndim, 5), dtype=np.float64)
    for d in range(ndim):
        pts = sorted((-float(gen[s, d]), s)
                     for s in (1 + 2 * d, 2 + 2 * d, 1 + 2 * ndim + 2 * d,
                               2 + 2 * ndim + 2 * d))
        (xbm, _), (xam, _), (xap, _), (xbp, _) = pts
        slots[d] = [s for _, s in pts]
        consts[d] = [xam, xap, xam - xbm, 0.0 - xam, xbp - xap]
    return slots, consts


def split_fraction(vals, split_dim, ndim: int):
    """Crease- and jump-aware cut fraction of C regions along their split
    axis (the reference's ``rule_eval._split_fraction``, operation for
    operation): ``vals`` (C, feval) the ``ndim``-dimensional rule's
    values, ``split_dim`` (C,) int32 the fourth-difference axis.  Returns
    (frac (C,) of the values' type, split_dim (C,) int32).

    Two detectors share the 4 ndim + 1 collinear values of each axis (the
    centre, orbit 1 at +-a, orbit 2 at +-b).  A C0 kink between the inner
    samples bends the secants: the lines through the outer and the inner
    pair on either side meet at the crease, and the cut lands there less
    ``SPLIT_MARGIN`` toward the centre, within [0.12, 0.88]; four gates
    (slope break, far side straight, no slope growth away from the
    crease, opposite flank slopes) keep smooth integrands at 0.5.  A jump
    makes one inner gap's secant dominate every flank secant and break
    the slopes' geometric progression: the cut lands at that gap's centre
    edge plus the margin, 0.58 or 0.42, and split_dim becomes the axis of
    the strongest jump.  Exactly 0.5, split_dim unchanged, where neither
    fires (``region_pool.split`` with 0.5 is the midpoint's bits).

    Only the collinear prefix of the values, points 0 .. 4 ndim, is read:
    ``vals`` may hold just those ((C, 4 ndim + 1), what the fused kernels
    keep).  No product, quotient or sum is fused with another, so the
    card's kernels (csrc/split_frac.cuh, folded into the fused kernels and
    the contractions, and ``cuda_rule.split_frac``) give the same bits."""
    dtype = vals.dtype
    slots, consts = split_stencil(ndim, dtype_name(dtype))
    consts = consts.astype(np.float32 if dtype == torch.float32
                           else np.float64)
    margin = SPLIT_MARGIN
    f0 = vals[:, 0]
    zero = torch.zeros_like(f0)
    half = torch.full_like(f0, 0.5)

    def intersect(xl, vl, sl, xr, vr, sr):
        # line L through (xl, vl) of slope sl, line R through (xr, vr) of
        # slope sr: (x*, |sl - sr|, |sl| + |sr|)
        denom = sl - sr
        xstar = (vr - vl + sl * xl - sr * xr) / torch.where(
            denom == 0.0, torch.ones_like(denom), denom)
        return xstar, torch.abs(denom), torch.abs(sl) + torch.abs(sr)

    # the secants' denominators as tensors: PyTorch on the card divides by
    # a host scalar as a product with its reciprocal, a quotient rounded
    # twice
    dens = torch.as_tensor(consts[:, 1:], device=vals.device)
    fr_d, jfr_d, jstr_d = [], [], []
    for d in range(ndim):
        sbm, sam, sap, sbp = (int(s) for s in slots[d])
        xam, xap = float(consts[d, 0]), float(consts[d, 1])
        vbm, vam = vals[:, sbm], vals[:, sam]
        vap, vbp = vals[:, sap], vals[:, sbp]
        g1 = (vam - vbm) / dens[d, 1]          # (-b, -a) secant
        g2 = (f0 - vam) / dens[d, 2]           # (-a, 0) secant
        g3 = (vap - f0) / dens[d, 0]           # (0, +a) secant
        g4 = (vbp - vap) / dens[d, 3]          # (+a, +b) secant

        # H1: kink in (-a, 0): the outer-left line anchored at (-a, vam),
        # the (0, +a) line anchored at (0, f0); the far side straight, no
        # slope growth away from the crease, opposite flank slopes
        x1, dn1, sc1 = intersect(xam, vam, g1, 0.0, f0, g3)
        ok1 = ((dn1 > 0.5 * sc1) & (sc1 > 0.0)
               & (torch.abs(g4 - g3) < 0.5 * dn1)
               & (torch.abs(g3) >= 0.9 * torch.abs(g4))
               & (g1 * g3 < 0.0) & (x1 > xam) & (x1 < 0.0))
        # H2: kink in (0, +a), mirrored
        x2, dn2, sc2 = intersect(0.0, f0, g2, xap, vap, g4)
        ok2 = ((dn2 > 0.5 * sc2) & (sc2 > 0.0)
               & (torch.abs(g2 - g1) < 0.5 * dn2)
               & (torch.abs(g2) >= 0.9 * torch.abs(g1))
               & (g2 * g4 < 0.0) & (x2 > 0.0) & (x2 < xap))
        # the hypothesis with the stronger relative slope break
        one = torch.ones_like(sc1)
        rel1 = torch.where(ok1, dn1 / torch.where(sc1 == 0.0, one, sc1),
                           -one)
        rel2 = torch.where(ok2, dn2 / torch.where(sc2 == 0.0, one, sc2),
                           -one)
        xstar = torch.where(rel1 >= rel2, x1, x2)
        ok = ok1 | ok2
        # the margin cut: the kink stays inside the other child, visible
        # to its samples (an exact cut parks it in the blind zone)
        xcut = xstar - torch.where(xstar >= 0.0,
                                   torch.full_like(xstar, margin),
                                   torch.full_like(xstar, -margin))
        fr_d.append(torch.where(ok, torch.clamp(0.5 + xcut, 0.12, 0.88),
                                half))

        # jumps: the inner gap's secant dominates (2x) every flank secant,
        # breaks the geometric slope progression, the far flank straight
        a1, a2 = torch.abs(g1), torch.abs(g2)
        a3, a4 = torch.abs(g3), torch.abs(g4)
        mag1 = torch.maximum(torch.maximum(a1, a3), a4)
        j1 = ((a2 > 2.0 * mag1) & (a2 > 0.0)
              & (a2 * a2 > 16.0 * a1 * a3)
              & (torch.abs(g4 - g3) < 0.5 * a2))
        mag2 = torch.maximum(torch.maximum(a1, a2), a4)
        j2 = ((a3 > 2.0 * mag2) & (a3 > 0.0)
              & (a3 * a3 > 16.0 * a2 * a4)
              & (torch.abs(g1 - g2) < 0.5 * a3))
        jfr_d.append(torch.where(
            j1, torch.full_like(f0, 0.5 + margin),
            torch.where(j2, torch.full_like(f0, 0.5 - margin), half)))
        jstr_d.append(torch.where(j1, a2, torch.where(j2, a3, zero)))
    sd = split_dim.to(torch.int64)[:, None]
    # one term of each row is the chosen axis's: a gather is the
    # reference's one-hot sum exactly
    frac_kink = torch.stack(fr_d, dim=1).gather(1, sd)[:, 0]
    jstr = torch.stack(jstr_d, dim=1)
    has_jump = torch.amax(jstr, dim=1) > 0.0
    jdim = torch.argmax(jstr, dim=1)
    frac_jump = torch.stack(jfr_d, dim=1).gather(1, jdim[:, None])[:, 0]
    frac = torch.where(has_jump, frac_jump, frac_kink)
    split_out = torch.where(has_jump, jdim.to(torch.int32),
                            split_dim.to(torch.int32))
    return frac, split_out



def rule_outputs_vector(vals, tables: RuleTables, lengths, global_range):
    """The vector-valued twin of ``rule_outputs`` (the reference's
    ``_eval_chunk_vector``): ``vals`` (C, feval, ncomp), the ncomp
    components of one point set.  Per component exactly ``rule_outputs``'
    arithmetic; the bisection axis from the component-wise maximum of the
    fourth differences, a NaN in any component propagating (torch.amax),
    so that it then falls back to the widest axis.

    Returns (estimate (ncomp, C), errorest (ncomp, C), split_dim (C,))."""
    # component-major once, each component's (C, feval) plane contiguous
    # as a scalar integrand's values are
    planes = vals.movedim(-1, 0).contiguous()
    ests, errs, fourth = [], [], []
    for v in planes:
        sums = rule_sums(v, tables, global_range)
        ests.append(sums[:, 0])
        errs.append(gate_errors(null_errors(sums, tables)))
        fourth.append(fourth_differences(v, tables.ndim, tables.ratio))
    split_dim = split_axis(torch.amax(torch.stack(fourth), dim=0), lengths)
    vol = torch.prod(lengths, dim=0)
    return vol * torch.stack(ests), vol * torch.stack(errs), split_dim


def _eval_chunk(f, tables, lows, lengths, global_lo, global_range, ncomp=1,
                with_split_frac=False):
    vals = rule_values(f, tables, lows, lengths, global_lo, global_range)
    if ncomp == 1:
        return rule_outputs(vals, tables, lengths, global_range,
                            with_split_frac=with_split_frac)
    return rule_outputs_vector(vals, tables, lengths, global_range)


def apply_rule_plain(f: Callable, tables: RuleTables, lows, lengths,
                     global_lo, global_range, *, chunk_size: int | None = None,
                     n: int | None = None, blocked: bool = False,
                     ncomp: int = 1, with_split_frac: bool = False):
    """The plain PyTorch rule evaluation over a dims-major pool.

    ``lows``/``lengths``: (ndim, cap).  ``n``: number of real regions
    (None: every slot is real); ``blocked`` selects the post-split layout
    (region_pool.block_mask).  Only the real slots are evaluated, in
    chunks of at most ``chunk_size`` regions to bound the (chunk, feval,
    ndim) intermediate; padding slots get est = err = 0 and split_dim 0.
    ``f`` is the user integrand (any form make_integrand accepts);
    ``ncomp`` > 1: it returns (..., ncomp) (``rule_outputs_vector``).

    Returns (estimate, errorest, split_dim (cap,) int32): estimate and
    errorest (cap,), or component-major (ncomp, cap) for a vector; with
    ``with_split_frac`` (a scalar integrand only) also the cut fraction
    (cap,) of ``split_fraction``, 0.5 in the padding slots, and split_dim
    the one it returns."""
    if with_split_frac and ncomp != 1:
        raise ValueError("with_split_frac is scalar-only")
    batched, _ = make_integrand(f, tables.ndim)
    cap = lows.shape[1]
    if n is None or n >= cap:
        idx = None
        m = cap
    else:
        idx = torch.nonzero(block_mask(cap, n, blocked, lows.device))[:, 0]
        m = int(n)
    step = m if chunk_size is None else max(int(chunk_size), 1)
    outs = []
    for start in range(0, m, step):
        if idx is None:
            lo, ln = lows[:, start:start + step], lengths[:, start:start + step]
        else:
            sel = idx[start:start + step]
            lo, ln = lows[:, sel], lengths[:, sel]
        outs.append(_eval_chunk(batched, tables, lo, ln, global_lo,
                                global_range, ncomp, with_split_frac))
    eshape = (cap,) if ncomp == 1 else (ncomp, cap)
    full = [torch.zeros(eshape, dtype=lows.dtype, device=lows.device),
            torch.zeros(eshape, dtype=lows.dtype, device=lows.device),
            torch.zeros(cap, dtype=torch.int32, device=lows.device)]
    if with_split_frac:
        full.append(torch.full((cap,), 0.5, dtype=lows.dtype,
                               device=lows.device))
    if not outs:
        return tuple(t[..., :0] for t in full) if idx is None else tuple(full)
    got = [torch.cat(o, dim=-1) for o in zip(*outs)]
    if idx is None:
        return tuple(got)
    for t, g in zip(full, got):
        t[..., idx] = g
    return tuple(full)


def apply_rule(f: Callable, tables: RuleTables, lows, lengths,
               global_lo, global_range, *, chunk_size: int | None = None,
               n: int | None = None, blocked: bool = False, ncomp: int = 1,
               with_split_frac: bool = False):
    """Rule evaluation over the pool: the plain version for a CPU pool; for
    any other pool the CUDA kernels of the route ``cuda_rule.rule_route``
    gives the integrand (the split route walks the pool ``chunk_size``
    regions at a time; a vector integrand always takes it).  With
    ``with_split_frac`` the route's kernel that holds the values, fused or
    contraction, also computes the cut fraction.  Arguments and outputs as
    ``apply_rule_plain``."""
    if lows.device.type == "cpu":
        return apply_rule_plain(f, tables, lows, lengths, global_lo,
                                global_range, chunk_size=chunk_size, n=n,
                                blocked=blocked, ncomp=ncomp,
                                with_split_frac=with_split_frac)
    from gpuintegration_torch.ops import cuda_rule
    crease = {"with_split_frac": True} if with_split_frac else {}
    if cuda_rule.rule_route(tables.ndim, f, ncomp) == "split":
        return cuda_rule.cuda_apply_rule_split(
            f, tables, lows, lengths, global_lo, global_range,
            chunk_size=chunk_size, n=n, blocked=blocked, ncomp=ncomp,
            **crease)
    return cuda_rule.cuda_apply_rule(f, tables, lows, lengths, global_lo,
                                     global_range, n=n, blocked=blocked,
                                     **crease)
