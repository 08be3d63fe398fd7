"""Two-level error refinement and finished/active classification (PyTorch
port of ``gpuintegration_tpu/pagani/two_level.py``; RefineError,
Phases.cuh:219-268).  Each child's raw null-rule error is inflated by the
discrepancy between (self + sibling) and the parent estimate:

    diff = |(self + sibling - parent) / 4|
    err' = err * (1 + 2*diff/(self_err + sibl_err)) + diff

and a region is finished (inactive) when err' < max(epsrel*|est|, floor),
optionally also below ``abs_per_vol * vol_region`` (volume-apportioned
absolute retirement; its banked error is bounded by ``abs_per_vol``).
``refine_error_vector`` is the twin for a vector integrand's (ncomp, cap)
arrays: the inflation per component, and a region finished only when every
component meets its tolerance.
"""
from __future__ import annotations

import torch

from gpuintegration_torch.pagani.region_pool import block_mask


def refine_error(
    estimates: torch.Tensor,      # (cap,) child integral estimates
    errorests: torch.Tensor,      # (cap,) child raw errors
    parent_estimates: torch.Tensor,  # (cap_parent >= cap//2,) compacted parents
    n,                            # real children (= 2*parents): an int
                                  # or the fused phase's device scalar
    epsrel,
    relerr_classification: bool = True,
    volumes=None,                 # (cap,) unit-space region volumes
    abs_per_vol=None,             # scalar absolute error budget per unit volume
):
    """Returns (refined_errorests (cap,), active (cap,) float 0/1 masked to n).

    Child layout: BLOCKED at the static pool half (region_pool.split) --
    parent i's left child is slot i, its right child slot i + cap/2.  The
    one-component case of ``refine_error_vector``, whose arithmetic is the
    same element by element."""
    refined, active = refine_error_vector(
        estimates[None], errorests[None], parent_estimates[None], n, epsrel,
        relerr_classification=relerr_classification, volumes=volumes,
        abs_per_vol=abs_per_vol)
    return refined[0], active


def refine_error_vector(
    estimates: torch.Tensor,      # (ncomp, cap) child integral estimates
    errorests: torch.Tensor,      # (ncomp, cap) child raw errors
    parent_estimates: torch.Tensor,  # (ncomp, cap_parent >= cap//2)
    n,
    epsrel,
    relerr_classification: bool = True,
    volumes=None,                 # (cap,) unit-space region volumes
    abs_per_vol=None,             # scalar, shared by all components
):
    """The inflation of the module docstring per component on
    component-major arrays (the reference's ``refine_error_vector``), and a
    region finished only when EVERY component's refined error meets its own
    tolerance (CUBA's all-components convergence,
    cubacpp/integrand_traits.hh:81-93); the floor below which a relative
    test cannot finish a region is representable in the pool type (the
    reference's 1e-200 literal, hybrid.cuh, underflows to 0 in f32, where a
    zero-estimate region could then never finish).

    Returns (refined (ncomp, cap), active (cap,) float 0/1 masked to n)."""
    cap = estimates.shape[1]
    half = cap // 2

    def other_block(a):
        return torch.cat([a[:, half:], a[:, :half]], dim=1)

    self_err = errorests
    self_res = estimates
    sibl_err = other_block(errorests)
    sibl_res = other_block(estimates)
    par_res = parent_estimates[:, :half].repeat(1, 2)

    diff = torch.abs(0.25 * (sibl_res + self_res - par_res))
    err_sum = self_err + sibl_err
    inflated = torch.where(
        err_sum > 0.0, self_err * (1.0 + 2.0 * diff / err_sum), self_err)
    refined = inflated + diff

    mask = block_mask(cap, n, True, estimates.device)
    refined = torch.where(mask[None, :], refined, torch.zeros_like(refined))

    if relerr_classification:
        floor = max(1e-200, float(torch.finfo(estimates.dtype).tiny))
        max_err = torch.clamp(epsrel * torch.abs(self_res), min=floor)
        if abs_per_vol is not None:
            # padded slots may be marked finished here; `active` is gated
            # on `mask` below, so never bank off `finished` alone
            max_err = torch.maximum(max_err, (abs_per_vol * volumes)[None, :])
        finished = torch.all(refined < max_err, dim=0)
    else:
        finished = torch.zeros_like(mask)
    active = (mask & ~finished).to(estimates.dtype)
    return refined, active
