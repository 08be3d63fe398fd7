"""Padded region pool and its pipeline stages (PyTorch port of
``gpuintegration_tpu/pagani/region_pool.py``).

The pool lives in power-of-two "bucket" capacities with padding slots
after the real regions, and it is DIMS-MAJOR: coordinates are (ndim, cap).

Layout contract (load-bearing for the two-level error estimate, and kept
so that the port's pools compare slot for slot with the reference's): a
pool of capacity ``cap`` produced by ``split`` is BLOCKED at the static
half -- the left children of the (compacted, out_capacity = cap/2)
parents occupy slots [0, cap/2) and the right children [cap/2, cap), with
real children filling [0, n/2) of each block.  A child's sibling is at a
static offset of cap/2 and its parent index is ``slot % (cap/2)``.
Validity masks come from ``block_mask``.  Padding slots always hold
finite bounds, so evaluating them stays finite.
"""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def uniform_split(ndim: int, partitions_per_axis: int, capacity: int,
                  dtype=torch.float64, device=None):
    """Initial uniform n-ary partition of the unit cube.

    Region ``i`` gets per-dim interval id ``(i // div**dim) % div``
    (Sub_regions.cuh:11-36).  Padding slots replicate region 0.

    Returns (lows (ndim, capacity), lengths (ndim, capacity), n_regions).
    """
    div = partitions_per_axis
    n_regions = div ** ndim
    if capacity < n_regions:
        raise ValueError(f"capacity {capacity} < {n_regions} initial regions")
    length = 1.0 / div
    idx = torch.arange(capacity, dtype=torch.int64, device=device)
    idx = torch.where(idx < n_regions, idx, torch.zeros_like(idx))
    strides = div ** torch.arange(ndim, dtype=torch.int64, device=device)
    interval_id = (idx[None, :] // strides[:, None]) % div
    lows = interval_id.to(dtype) * torch.tensor(length, dtype=dtype,
                                                device=device)
    lengths = torch.full((ndim, capacity), length, dtype=dtype, device=device)
    return lows, lengths, n_regions


def region_mask(capacity: int, n: int, device=None) -> torch.Tensor:
    """Boolean mask of the first ``n`` slots of a capacity-sized axis."""
    return torch.arange(capacity, device=device) < n


def block_mask(capacity: int, n, blocked: bool,
               device=None) -> torch.Tensor:
    """Validity mask of a pool holding ``n`` real regions (a host integer
    or a device scalar): [0, n) for a contiguous pool, the first n/2 of
    each static half for a ``split`` pool (see the module layout
    contract)."""
    if not blocked:
        return region_mask(capacity, n, device)
    half = capacity // 2
    return (torch.arange(capacity, device=device) % half) < (n // 2)


def compact(active, lows, lengths, split_dim, estimates, errorests, *,
            out_capacity: int, extra=None):
    """Order-preserving compaction of the active regions to the front of a
    new pool of ``out_capacity`` slots (Sub_region_filter.cuh:8-47).

    Each active slot goes to its rank among the actives (an exclusive
    cumsum of the flags); no host sync is needed.  Padding slots
    [n_active, out_capacity) replicate the input pool's slot 0, so they
    hold finite bounds.  The surviving regions' estimates become the next
    iteration's parents (alignRegions:39-40).  ``estimates`` and
    ``errorests`` are (cap,), or a vector integrand's (ncomp, cap),
    moved component-major alike.  ``extra``: an optional (cap,) row that
    travels like split_dim (a crease run's cut fractions).

    Returns (new_lows, new_lengths, new_split_dim, parent_estimates,
    parent_errorests), and the compacted ``extra`` after them where one
    is given."""
    ndim, cap = lows.shape
    keep = active > 0
    flags = keep.to(torch.int64)
    rank = torch.cumsum(flags, 0) - flags
    # inactive slots (and, if the caller under-sized the pool, actives past
    # out_capacity) land in a dump slot that is cut off below
    dest = torch.where(keep & (rank < out_capacity), rank,
                       torch.full_like(rank, out_capacity))

    def move(rows):
        out = rows[:, :1].expand(rows.shape[0], out_capacity + 1).clone()
        out[:, dest] = rows
        return out[:, :out_capacity]

    new_lows = move(lows)
    new_lengths = move(lengths)
    new_split = move(split_dim[None])[0]
    if estimates.dim() == 2:
        parent_est, parent_err = move(estimates), move(errorests)
    else:
        parent_est = move(estimates[None])[0]
        parent_err = move(errorests[None])[0]
    out = (new_lows, new_lengths, new_split, parent_est, parent_err)
    if extra is not None:
        out += (move(extra[None])[0],)
    return out


def split(lows, lengths, split_dim, n, *, out_capacity: int, frac=None):
    """Bisect each region along its chosen dimension.

    The whole (compacted, padding included) input pool's left children
    land in slots [0, cap) and the right children in [cap, 2*cap); real
    children occupy the first n of each block.  ``n`` is a host integer
    or a device scalar (the fused phase's), returned doubled alike.

    ``frac``: an optional (cap,) cut point as a fraction of the chosen
    dimension's length (crease/jump-aware splitting,
    ``rule_eval.split_fraction``): the left child keeps lengths * frac,
    the right the rest.  0.5 gives the midpoint's bits (0.5 len and
    len - 0.5 len are the same float).

    Returns (child_lows, child_lengths, n_children)."""
    ndim, cap = lows.shape
    if out_capacity != 2 * cap:
        raise ValueError(
            f"split: out_capacity {out_capacity} != 2*cap {2 * cap}; the "
            "blocked child layout requires the output to be exactly twice "
            "the (compacted) input pool -- compact to out_capacity//2 first")
    dim_ids = torch.arange(ndim, device=lows.device)[:, None]
    sel = dim_ids == split_dim[None, :].to(torch.int64)
    if frac is None:
        cut = lengths * 0.5
        rest = cut
    else:
        cut = lengths * frac[None, :].to(lengths.dtype)
        rest = lengths - cut
    left_len = torch.where(sel, cut, lengths)
    right_len = torch.where(sel, rest, lengths)
    right_lows = torch.where(sel, lows + cut, lows)
    lo2 = torch.cat([lows, right_lows], dim=1)
    ln2 = torch.cat([left_len, right_len], dim=1)
    return lo2, ln2, 2 * n
