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
(``models.genz``) is fused into the tile or generic kernel; any other
callable takes the split route, a points kernel, the callable on the
points as torch operations, and a contraction kernel, chunk by chunk.  The
split kernels' plain versions are ``rule_points`` and ``rule_outputs``.  A
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
    r = torch.as_tensor(ratio, dtype=vals.dtype, device=vals.device)
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


def rule_outputs(vals, tables: RuleTables, lengths, global_range,
                 by_orbit=None):
    """(estimate, errorest, split_dim) of C regions from their rule values
    (and, where given, their orbit sums ``by_orbit`` taken in another
    order)."""
    sums = rule_sums(vals, tables, global_range, by_orbit)

    # Reference semantics: strict '>' scan from maxdiff=0 with fallback to
    # the widest dimension, so when every diff is 0 (or the max is NaN)
    # the widest dim is used; otherwise first-argmax wins
    # (Sample.cuh:202-218).
    fourth = fourth_differences(vals, tables.ndim, tables.ratio)
    widest = torch.argmax(lengths, dim=0).to(torch.int32)
    best = torch.argmax(fourth, dim=1).to(torch.int32)
    any_positive = torch.amax(fourth, dim=1) > 0
    split_dim = torch.where(any_positive, best, widest)

    gated = gate_errors(null_errors(sums, tables))
    vol = torch.prod(lengths, dim=0)                         # unit-space volume
    return vol * sums[:, 0], vol * gated, split_dim


def _eval_chunk(f, tables, lows, lengths, global_lo, global_range):
    vals = rule_values(f, tables, lows, lengths, global_lo, global_range)
    return rule_outputs(vals, tables, lengths, global_range)


def apply_rule_plain(f: Callable, tables: RuleTables, lows, lengths,
                     global_lo, global_range, *, chunk_size: int | None = None,
                     n: int | None = None, blocked: bool = False):
    """The plain PyTorch rule evaluation over a dims-major pool.

    ``lows``/``lengths``: (ndim, cap).  ``n``: number of real regions
    (None: every slot is real); ``blocked`` selects the post-split layout
    (region_pool.block_mask).  Only the real slots are evaluated, in
    chunks of at most ``chunk_size`` regions to bound the (chunk, feval,
    ndim) intermediate; padding slots get est = err = 0 and split_dim 0.
    ``f`` is the user integrand (any form make_integrand accepts).

    Returns (estimate (cap,), errorest (cap,), split_dim (cap,) int32)."""
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
                                global_range))
    if not outs:
        est = err = torch.zeros(0, dtype=lows.dtype, device=lows.device)
        sdim = torch.zeros(0, dtype=torch.int32, device=lows.device)
    else:
        est, err, sdim = (torch.cat(o) for o in zip(*outs))
    if idx is None:
        return est, err, sdim
    full = (torch.zeros(cap, dtype=lows.dtype, device=lows.device),
            torch.zeros(cap, dtype=lows.dtype, device=lows.device),
            torch.zeros(cap, dtype=torch.int32, device=lows.device))
    full[0][idx] = est
    full[1][idx] = err
    full[2][idx] = sdim
    return full


def apply_rule(f: Callable, tables: RuleTables, lows, lengths,
               global_lo, global_range, *, chunk_size: int | None = None,
               n: int | None = None, blocked: bool = False):
    """Rule evaluation over the pool: the plain version for a CPU pool; for
    any other pool the CUDA kernels of the route ``cuda_rule.rule_route``
    gives the integrand (the split route walks the pool ``chunk_size``
    regions at a time).  Arguments and outputs as ``apply_rule_plain``."""
    if lows.device.type == "cpu":
        return apply_rule_plain(f, tables, lows, lengths, global_lo,
                                global_range, chunk_size=chunk_size, n=n,
                                blocked=blocked)
    from gpuintegration_torch.ops import cuda_rule
    if cuda_rule.rule_route(tables.ndim, f) == "split":
        return cuda_rule.cuda_apply_rule_split(
            f, tables, lows, lengths, global_lo, global_range,
            chunk_size=chunk_size, n=n, blocked=blocked)
    return cuda_rule.cuda_apply_rule(f, tables, lows, lengths, global_lo,
                                     global_range, n=n, blocked=blocked)
