"""Region-termination heuristic policies (PyTorch port of
``gpuintegration_tpu/pagani/heuristics.py``).

Re-expression of quad::ApplyHeuristic (reference:
cuda/pagani/quad/GPUquad/Phases.cuh:71-155), the pre-Workspace code
path's switch of region-termination policies (heuristicID 0-10).  The
Workspace pipeline classifies by the two-level relative-error test and
the memory-pressure classifier; these policies are kept for parity and
for experiments, as an elementwise classifier over region batches.
"""
from __future__ import annotations

import torch


def _t(v, like):
    """``v`` as a tensor in ``like``'s dtype and device (a Python number
    becomes a 0-d tensor made on the device, no host copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    if isinstance(v, bool):
        return torch.full((), v, dtype=torch.bool, device=like.device)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def apply_heuristic(
    heuristic_id: int,
    leaves_estimate,
    finished_estimate,
    queued_estimate,
    finished_errorest,
    queued_errorest,
    curr_iter_regions,
    total_nregions,
    min_iter_reached,
    par_res,
    par_err,
    depth,
    self_res,
    self_err,
    epsrel,
    epsabs,
):
    """Elementwise over per-region tensors (self_res/self_err/par_*); the
    other arguments are Python numbers or tensors that broadcast with
    them.  Returns a boolean 'finished' verdict per region.

    Policy semantics follow Phases.cuh:110-153: ids 0/1 never finish a
    region on heuristic grounds, 2/4 finish error-dominated cheap regions,
    7 budget-caps, 8/9 are or/and small-contribution tests, 10 is the
    depth-scaled test."""
    if heuristic_id not in (0, 1, 2, 4, 7, 8, 9, 10):
        raise ValueError(f"unknown heuristic id {heuristic_id}")
    self_res = torch.as_tensor(self_res)
    self_err = _t(self_err, self_res)
    par_res, par_err = _t(par_res, self_res), _t(par_err, self_res)
    leaves, fin_est, q_est, fin_err, q_err, curr, total, depth = (
        _t(v, self_res) for v in (
            leaves_estimate, finished_estimate, queued_estimate,
            finished_errorest, queued_errorest, curr_iter_regions,
            total_nregions, depth))
    global_err_target = torch.abs(leaves) * epsrel
    remain_room = global_err_target - fin_err - q_err

    err_bigger_case = (
        (self_err > torch.abs(self_res))
        & (self_err / torch.abs(self_res) >= 0.9 * par_err / torch.abs(
            par_res))
        & (self_err < remain_room / curr))

    if heuristic_id in (0, 1):
        good = torch.zeros_like(self_res, dtype=torch.bool)
    elif heuristic_id == 2:
        good = err_bigger_case | (
            (self_res < (leaves * epsrel * depth) / total)
            & (self_err * curr < remain_room))
    elif heuristic_id == 4:
        good = err_bigger_case | (
            (torch.abs(self_res)
             < (torch.abs(leaves) * epsrel * depth) / total)
            & (self_err * curr < global_err_target))
    elif heuristic_id == 7:
        good = ((self_res * curr + q_est + fin_est < leaves)
                & (self_err * curr < global_err_target))
    elif heuristic_id == 8:
        good = ((self_res < leaves / total)
                | (self_err < epsrel * leaves / total))
    elif heuristic_id == 9:
        good = ((self_res < leaves / total)
                & (self_err < epsrel * leaves / total))
    else:
        scale = 2.0 ** depth
        good = ((torch.abs(self_res) < 2 * leaves / scale)
                & (self_err < 2 * leaves * epsrel / scale))

    min_iter = _t(min_iter_reached, self_res).to(torch.bool)
    zero_done = (self_res == 0.0) & (self_err <= epsabs)
    return (good & min_iter) | (zero_done & min_iter)
