"""PAGANI adaptive cubature (PyTorch port of the scalar host loop of
``gpuintegration_tpu/pagani/workspace.py``; Workspace.cuh:148-358):

  for it < 700 while regions remain:
      rule application over the whole pool          (ops.rule_eval)
      two-level error refinement + reductions       (iteration_math)
      accuracy check                                (host, one scalar sync)
      error-budget-overflow rollback                (Workspace.cuh:121-146)
      memory-pressure heuristic classification      (classifier.py)
      order-preserving compaction of active regions (region_pool.compact)
      bisection split into the freed slots          (region_pool.split)

The pool lives in power-of-two bucket capacities, floored at ``chunk_size``,
with the same capacity rules as the reference, so that the two packages'
pools compare slot for slot.  On the card the rule evaluation is the CUDA
kernel of ops/cuda_rule.py; everything else is plain PyTorch.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import deduce_ncomp, make_integrand
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import region_pool, two_level
from gpuintegration_torch.pagani.classifier import HeuristicClassifier
from gpuintegration_torch.types import IntegrationResult, Volume
from gpuintegration_torch.utils.checkpoint import PaganiCheckpoint

MAX_ITERATIONS = 700  # (Workspace.cuh:182)


def default_partitions_per_axis(ndim: int) -> int:
    """(Workspace.cuh:379-386)."""
    if ndim < 5:
        return 4
    if ndim <= 10:
        return 2
    return 1


def accuracy_reached(epsrel, epsabs, estimate, errorest) -> bool:
    """(PaganiUtils.cuh:387-394)."""
    if abs(estimate) > 0 and errorest / abs(estimate) <= epsrel:
        return True
    return errorest <= epsabs


def iteration_math(
    relerr_classification: bool,
    blocked: bool,        # pool layout: blocked halves (post-split) or [0,n)
    est, err, n: int,
    parent_estimates,
    use_refine: bool,     # parents valid?
    epsrel,
    lengths=None,         # (ndim, cap) -- only needed with abs_per_vol
    abs_per_vol=None,     # scalar: volume-apportioned retirement budget
):
    """Masking, two-level refinement, classification and the
    iteration/finished reductions of one sweep.

    Returns (est, refined, active, scalars) with ``scalars`` one f64
    tensor [iter_est, iter_err, finished_est, finished_err, n_active], so
    the host reads every per-iteration number in one transfer."""
    cap = est.shape[0]
    mask = region_pool.block_mask(cap, n, blocked, est.device)
    zero = torch.zeros_like(est)
    est = torch.where(mask, est, zero)
    err = torch.where(mask, err, zero)
    if use_refine:
        volumes = (torch.prod(lengths, dim=0)
                   if abs_per_vol is not None else None)
        refined, active = two_level.refine_error(
            est, err, parent_estimates, n, epsrel,
            relerr_classification=relerr_classification,
            volumes=volumes, abs_per_vol=abs_per_vol)
    else:
        refined, active = err, mask.to(est.dtype)

    iter_est = torch.sum(est)
    iter_err = torch.sum(refined)
    finished_est = iter_est - torch.sum(active * est)
    finished_err = iter_err - torch.sum(active * refined)
    # count in f64: an f32 sum of 0/1 flags is even-rounded above 2^24
    # regions, which would corrupt the pool-bound arithmetic downstream
    n_active = torch.sum(active.to(torch.float64))
    scalars = torch.stack([iter_est.to(torch.float64),
                           iter_err.to(torch.float64),
                           finished_est.to(torch.float64),
                           finished_err.to(torch.float64), n_active])
    return est, refined, active, scalars


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Workspace runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


class Workspace:
    """Adaptive multidimensional integrator (PAGANI), single device.

    Parameters
    ----------
    ndim:             number of integration variables (>= 2).
    dtype:            accumulation dtype (torch.float64 or torch.float32).
    device:           None or "cuda" runs on the card and raises if there is
                      none; "cpu" runs the plain PyTorch rule evaluation.
    max_pool_regions: region-pool budget (the reference's free-device-memory
                      model, heuristic_classifier.cuh:89-145), by default
                      derived from ``pool_bytes_budget``.
    chunk_size:       pool-capacity floor, and the chunk of the plain rule
                      evaluation (bounds its (chunk, feval, ndim) tensor).
    chunk_budget_bytes: memory budget that sets the default chunk.
    rule_backend:     "cuda" (default): rule evaluation dispatched on the
                      pool's device -- the CUDA kernel on the card, the
                      plain version on the CPU.  "torch": the plain
                      PyTorch version on any device, for integrands the
                      kernel lacks.
    mesh:             not ported yet (raises NotImplementedError).
    """

    def __init__(self, ndim: int, *, dtype=torch.float64, device=None,
                 max_pool_regions: int | None = None,
                 pool_bytes_budget: int = 6 * 1024 ** 3,
                 chunk_size: int | None = None,
                 chunk_budget_bytes: int = 256 * 1024 * 1024,
                 mesh=None,
                 rule_backend: str = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the sharded (mesh) Workspace is not ported to "
                "gpuintegration_torch yet")
        if rule_backend not in ("cuda", "torch"):
            raise ValueError(f"rule_backend {rule_backend!r}")
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"dtype {dtype} (float64 or float32)")
        self.ndim = ndim
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.rule_backend = rule_backend
        itemsize = torch.finfo(dtype).bits // 8
        if max_pool_regions is None:
            # the loop keeps ~10 region-sized arrays live per dim slot
            per_region = itemsize * (4 * ndim + 12)
            max_pool_regions = min(
                1 << (pool_bytes_budget // per_region).bit_length() - 1,
                16 * 1024 * 1024)
        self.max_pool_regions = max_pool_regions
        tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
        if chunk_size is None:
            per_region = tables.feval_padded * itemsize * 4
            chunk_size = max(min(
                region_pool.next_pow2(chunk_budget_bytes // per_region) // 2,
                16384), 1024)
        # pool capacities are powers of two: keep the chunk one as well
        self.chunk_size = region_pool.next_pow2(chunk_size)
        self.final_pool = None
        self.final_pool_errors = None
        self.peak_capacity = 0

    def _eval_pool(self, integrand, tables, lows, lengths, global_lo,
                   global_range, n: int, blocked: bool):
        apply = (rule_eval.apply_rule_plain if self.rule_backend == "torch"
                 else rule_eval.apply_rule)
        return apply(integrand, tables, lows, lengths, global_lo,
                     global_range, chunk_size=self.chunk_size, n=n,
                     blocked=blocked)

    def integrate(
        self,
        integrand: Callable,
        epsrel: float = 1e-3,
        epsabs: float = 1e-12,
        vol: Volume | None = None,
        *,
        partitions_per_axis: int | None = None,
        relerr_classification: bool = True,
        max_iterations: int = MAX_ITERATIONS,
        initial_regions: tuple | None = None,
        predict_split: bool = False,
        vegas_assisted: bool = False,
        fused: bool = False,
        ledger: tuple | None = None,
        finish_epsrel_scale: float = 1.0,
        finish_abs_per_vol: float = 0.0,
        crease_split: bool = False,
        deadline: float | None = None,
    ) -> IntegrationResult:
        """Integrate ``integrand`` to the requested tolerances; the
        reference's ``fused=False`` host loop, iteration for iteration.

        ``initial_regions``: (lows, lengths) region-major (n, ndim) arrays
        to start from instead of the uniform split (resume).
        ``ledger``: (estimate, errorest, nregions, iters, neval) seed of the
        cumulative ledger; ``max_iterations`` then counts on top of it.
        ``deadline``: ``time.monotonic()`` stamp; the loop stops between
        iterations once it passes (status 1).
        ``finish_epsrel_scale``: per-region retirement and the classifier
        budget run at ``epsrel * scale``; the global test stays at epsrel.
        ``finish_abs_per_vol``: also retire a region once its refined error
        is below ``finish_abs_per_vol * vol_region`` (0 = off).

        After a run, ``final_pool`` = (lows, lengths, n, blocked) is the
        last evaluated pool, ``final_pool_errors`` its (est, refined),
        ``_ledger_excl_pool`` the ledger without that sweep (resuming from
        the pool re-evaluates it), and ``peak_capacity`` the largest pool
        capacity the run evaluated.

        ``fused``, ``predict_split``, ``vegas_assisted`` and
        ``crease_split`` are not ported yet and raise NotImplementedError.
        """
        for name, on in (("fused", fused), ("predict_split", predict_split),
                         ("vegas_assisted", vegas_assisted),
                         ("crease_split", crease_split)):
            if on:
                raise NotImplementedError(
                    f"{name}=True is not ported to gpuintegration_torch yet")
        if not (0.0 < finish_epsrel_scale <= 1.0):
            raise ValueError("finish_epsrel_scale must be in (0, 1]")
        if finish_abs_per_vol < 0.0:
            raise ValueError("finish_abs_per_vol must be >= 0")
        eps_work = epsrel * finish_epsrel_scale
        ndim, dtype, device = self.ndim, self.dtype, self.device
        self.final_pool = None
        self.final_pool_errors = None
        self.peak_capacity = 0
        f, f_ndim = make_integrand(integrand, ndim)
        if f_ndim != ndim:
            raise ValueError(f"integrand ndim {f_ndim} != workspace {ndim}")
        deduce_ncomp(f, ndim, dtype, device)  # raises for vector integrands
        if vol is None:
            vol = Volume(ndim=ndim)
        global_lo = torch.as_tensor(vol.lows, dtype=dtype, device=device)
        global_range = torch.as_tensor(vol.highs - vol.lows, dtype=dtype,
                                       device=device)
        tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))

        # -- initial pool (capacity floored at chunk_size) -------------------
        min_cap = self.chunk_size
        if initial_regions is not None:
            lows0 = torch.as_tensor(initial_regions[0], dtype=dtype,
                                    device=device).T.contiguous()
            lengths0 = torch.as_tensor(initial_regions[1], dtype=dtype,
                                       device=device).T.contiguous()
            n = int(lows0.shape[1])
            cap = max(region_pool.next_pow2(n), min_cap)
            pad = cap - n
            lows = torch.cat([lows0, lows0[:, :1].expand(ndim, pad)], dim=1)
            lengths = torch.cat([lengths0, lengths0[:, :1].expand(ndim, pad)],
                                dim=1)
        else:
            parts = partitions_per_axis or default_partitions_per_axis(ndim)
            n = parts ** ndim
            cap = max(region_pool.next_pow2(n), min_cap)
            lows, lengths, n = region_pool.uniform_split(
                ndim, parts, cap, dtype, device)

        parent_est = torch.zeros((max(cap // 2, 1),), dtype=dtype,
                                 device=device)
        use_refine = False
        apv = finish_abs_per_vol if finish_abs_per_vol > 0.0 else None

        classifier = HeuristicClassifier(eps_work, epsabs,
                                         self.max_pool_regions)
        feval = tables.feval

        cum = IntegrationResult(status=1)
        result_nregions = 0
        if ledger is not None:
            (cum.estimate, cum.errorest, result_nregions, cum.iters,
             cum.neval) = ledger
            cum.nFinishedRegions = result_nregions
            max_iterations = max_iterations + cum.iters
        blocked = False   # pool layout: [0,n) contiguous until first split
        inflight_est = inflight_err = 0.0
        exhausted = False

        it = cum.iters
        while True:
            if it >= max_iterations or (
                    deadline is not None and time.monotonic() >= deadline):
                exhausted = True
                break
            if n <= 0:
                break

            self.peak_capacity = max(self.peak_capacity, cap)
            est_raw, err_raw, sdim = self._eval_pool(
                integrand, tables, lows, lengths, global_lo, global_range,
                n, blocked)
            est, refined, active, scalars_d = iteration_math(
                relerr_classification, blocked, est_raw, err_raw, n,
                parent_est, use_refine, eps_work,
                lengths=None if apv is None else lengths, abs_per_vol=apv)
            self.final_pool = (lows, lengths, n, blocked)
            self.final_pool_errors = (est, refined)
            # cumulative ledger EXCLUDING this sweep: resuming from
            # final_pool re-evaluates the pool
            self._ledger_excl_pool = (cum.estimate, cum.errorest,
                                      result_nregions, cum.iters, cum.neval)
            # the one host sync of the iteration
            scalars = scalars_d.cpu().numpy()
            iter_est, iter_err, finished_est, finished_err = (
                float(scalars[0]), float(scalars[1]),
                float(scalars[2]), float(scalars[3]))
            n_active = int(scalars[4])
            cum.iters += 1
            cum.neval += n * feval

            # -- accuracy termination (Workspace.cuh:251-262) ---------------
            if accuracy_reached(epsrel, epsabs,
                                abs(cum.estimate + iter_est),
                                cum.errorest + iter_err):
                cum.estimate += iter_est
                cum.errorest += iter_err
                cum.status = 0
                cum.nregions = result_nregions + n
                return cum

            classifier.store_estimate(cum.estimate + iter_est)

            # -- error-budget-overflow rollback (Workspace.cuh:121-146) -----
            # budget max(epsrel*|est|, epsabs), the accuracy_reached test
            leaves_est = cum.estimate + iter_est
            leaves_fin_err = cum.errorest + finished_err
            if leaves_fin_err > max(abs(leaves_est) * epsrel, epsabs):
                active = region_pool.block_mask(cap, n, blocked,
                                                device).to(dtype)
                finished_est = 0.0
                finished_err = 0.0
                n_active = n

            # -- memory-pressure heuristic classify (Workspace.cuh:76-118) --
            classification_necessary = not classifier.split_fits(n)
            if classifier.classification_criteria_met(n):
                hs = classifier.classify_ladder(
                    refined, region_pool.block_mask(cap, n, blocked, device),
                    n, iter_err, finished_err, cum.errorest)
                success = hs.pass_mem and hs.pass_errorest_budget
                if success:
                    active = hs.active_flags
                    kept = torch.stack([torch.sum(active * est),
                                        torch.sum(active * refined)]).cpu()
                    finished_est = iter_est - float(kept[0])
                    # EXACT banked error: the refined error of every region
                    # the new flags drop (the reference's formula
                    # double-subtracts relative-finished regions; the
                    # threshold decision keeps it, only the ledger is exact)
                    finished_err = iter_err - float(kept[1])
                    n_active = hs.num_active
                # terminate only when classification is BOTH necessary and
                # failed; success with zero survivors exits below
                must_terminate = not success and classification_necessary
            else:
                must_terminate = classification_necessary

            if must_terminate:
                cum.estimate += iter_est
                cum.errorest += iter_err
                cum.nregions = result_nregions + n
                return cum

            cum.estimate += finished_est
            cum.errorest += finished_err
            # in-flight contribution, added on a max-iterations exit so the
            # estimate reflects the latest full sweep (status stays 1)
            inflight_est = iter_est - finished_est
            inflight_err = iter_err - finished_err

            # -- compaction + split ------------------------------------------
            result_nregions += n - n_active
            cum.nFinishedRegions += n - n_active
            if n_active == 0:
                cum.nregions = result_nregions
                return cum

            child_cap = max(region_pool.next_pow2(2 * n_active),
                            self.chunk_size)
            c_lows, c_lengths, c_sdim, parent_est, _ = region_pool.compact(
                active, lows, lengths, sdim, est, refined,
                out_capacity=child_cap // 2)
            lows, lengths, n = region_pool.split(
                c_lows, c_lengths, c_sdim, n_active, out_capacity=child_cap)
            cap = child_cap
            use_refine = True
            blocked = True
            it += 1

        if exhausted and cum.iters > 0:
            cum.estimate += inflight_est
            cum.errorest += inflight_err

        cum.nregions = result_nregions + n
        return cum

    def make_checkpoint(self):
        """The last run's live pool and ledger as a resumable
        ``utils.checkpoint.PaganiCheckpoint`` (NumPy, region-major).

        The stored ledger EXCLUDES the final pool's own sweep: every exit
        of ``integrate`` folds that sweep into its result, and resuming
        re-evaluates the same pool.  Resume with ``integrate(...,
        initial_regions=(ck.lows, ck.lengths), ledger=ck.ledger)`` and add
        ``ck.estimate``/``ck.errorest`` to the resumed result for the
        complete integral.  ``region_estimates``/``region_errorests`` are
        the pool's sweep per region (estimates and two-level refined
        errors), in pool order."""
        if self.final_pool is None:
            raise ValueError("no resumable pool: run integrate() first")
        est, err, nregions, iters, neval = self._ledger_excl_pool
        lows, lengths, n, blocked = self.final_pool
        keep = region_pool.block_mask(lows.shape[1], n, blocked,
                                      lows.device).nonzero()[:, 0]

        def host(a):
            return np.ascontiguousarray(a[..., keep].cpu().numpy().T)

        reg_est, reg_err = self.final_pool_errors
        return PaganiCheckpoint(
            lows=host(lows), lengths=host(lengths), estimate=est,
            errorest=err, nregions=nregions, iters=iters, neval=neval,
            region_estimates=host(reg_est), region_errorests=host(reg_err))
