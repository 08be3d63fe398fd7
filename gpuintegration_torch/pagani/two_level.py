"""Two-level error refinement and finished/active classification (PyTorch
port of ``gpuintegration_tpu/pagani/two_level.py``; RefineError,
Phases.cuh:219-268).  Each child's raw null-rule error is inflated by the
discrepancy between (self + sibling) and the parent estimate:

    diff = |(self + sibling - parent) / 4|
    err' = err * (1 + 2*diff/(self_err + sibl_err)) + diff

and a region is finished (inactive) when err' < max(epsrel*|est|, floor),
optionally also below ``abs_per_vol * vol_region`` (volume-apportioned
absolute retirement; its banked error is bounded by ``abs_per_vol``).
"""
from __future__ import annotations

import torch

from gpuintegration_torch.pagani.region_pool import block_mask


def refine_error(
    estimates: torch.Tensor,      # (cap,) child integral estimates
    errorests: torch.Tensor,      # (cap,) child raw errors
    parent_estimates: torch.Tensor,  # (cap_parent >= cap//2,) compacted parents
    n: int,                       # number of real children (= 2*parents)
    epsrel,
    relerr_classification: bool = True,
    volumes=None,                 # (cap,) unit-space region volumes
    abs_per_vol=None,             # scalar absolute error budget per unit volume
):
    """Returns (refined_errorests (cap,), active (cap,) float 0/1 masked to n).

    Child layout: BLOCKED at the static pool half (region_pool.split) --
    parent i's left child is slot i, its right child slot i + cap/2."""
    cap = estimates.shape[0]
    half = cap // 2

    def other_block(a):
        return torch.cat([a[half:], a[:half]])

    self_err = errorests
    self_res = estimates
    sibl_err = other_block(errorests)
    sibl_res = other_block(estimates)
    par_res = parent_estimates[:half].repeat(2)

    diff = torch.abs(0.25 * (sibl_res + self_res - par_res))
    err_sum = self_err + sibl_err
    inflated = torch.where(
        err_sum > 0.0, self_err * (1.0 + 2.0 * diff / err_sum), self_err)
    refined = inflated + diff

    mask = block_mask(cap, n, True, estimates.device)
    refined = torch.where(mask, refined, torch.zeros_like(refined))

    if relerr_classification:
        # floor representable in the pool dtype: the reference's 1e-200
        # literal (hybrid.cuh) underflows to 0 in f32, where a
        # zero-estimate region could then never finish
        floor = max(1e-200, float(torch.finfo(estimates.dtype).tiny))
        max_err = torch.clamp(epsrel * torch.abs(self_res), min=floor)
        if abs_per_vol is not None:
            # padded slots may be marked finished here; `active` is gated
            # on `mask` below, so never bank off `finished` alone
            max_err = torch.maximum(max_err, abs_per_vol * volumes)
        finished = refined < max_err
    else:
        finished = torch.zeros_like(mask)
    active = (mask & ~finished).to(estimates.dtype)
    return refined, active
