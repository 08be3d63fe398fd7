"""PAGANI adaptive cubature (PyTorch port of the host loops of
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
kernels of ops/cuda_rule.py; everything else is plain PyTorch.

A vector-valued integrand, f: (..., ndim) -> (..., ncomp), runs the
reference's vector host loop (``_integrate_vector``): one point set and one
region tree, a region finished only when every component meets its
tolerance, the bisection axis from all components' fourth differences,
classification and rollback keyed on the worst component.

Below the classifier's gate the loop runs device-resident bursts of whole
iterations (``pagani/fused_loop.py``; on the card CUDA graphs), the
reference's ``fused=True`` default.  ``crease_split`` cuts regions at a
detected kink or jump (``rule_eval.split_fraction``), ``predict_split``
holds classification back for the first 15 iterations, ``vegas_assisted``
overwrites each region's rule estimate with an in-region VEGAS estimate
(``pagani/vegas_assisted.py``).

``integrate_to_convergence`` carries deep tolerances past one run's pool
wall: checkpoint-resume rounds, then a partitioned continuation over
hottest-first slices of the survivors (reference
``gpuintegration_tpu/pagani/workspace.py:1909-2367``), scalar or vector.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import deduce_ncomp, make_integrand
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import (fused_loop, region_pool, two_level,
                                         vegas_assisted as assisted)
from gpuintegration_torch.pagani.classifier import HeuristicClassifier
from gpuintegration_torch.types import IntegrationResult, Volume
from gpuintegration_torch.utils.checkpoint import (
    ContinuationState, PaganiCheckpoint, npz_path)

MAX_ITERATIONS = 700  # (Workspace.cuh:182)
_CREASE_SCALAR_ONLY = ("crease_split runs on the scalar path; vegas_assisted "
                       "and vector runs keep midpoint splits")


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
    est, err, n,          # n: host int, or the fused phase's device scalar
    parent_estimates,
    use_refine: bool,     # parents valid?
    epsrel,
    lengths=None,         # (ndim, cap) -- only needed with abs_per_vol
    abs_per_vol=None,     # scalar: volume-apportioned retirement budget
):
    """Masking, two-level refinement, classification and the
    iteration/finished reductions of one sweep: the host loop's, and the
    fused phase's body (``pagani/fused_loop.py``) calls it as it is.

    Returns (est, refined, active, scalars) with ``scalars`` one f64
    tensor [iter_est, iter_err, finished_est, finished_err, n_active], so
    the host reads every per-iteration number in one transfer: the
    one-component case of ``iteration_math_vector``."""
    est, refined, active, scalars = iteration_math_vector(
        relerr_classification, blocked, est[None], err[None], n,
        parent_estimates[None], use_refine, epsrel, lengths=lengths,
        abs_per_vol=abs_per_vol)
    return est[0], refined[0], active, scalars


def iteration_math_vector(
    relerr_classification: bool,
    blocked: bool,
    est, err, n,          # est/err: (ncomp, cap) component-major
    parent_estimates,     # (ncomp, cap_parent)
    use_refine: bool,
    epsrel,
    lengths=None,
    abs_per_vol=None,
):
    """The vector twin of ``iteration_math``: per-component masking,
    two-level refinement (all-components finished semantics) and the
    iteration/finished reductions.

    Returns (est, refined, active, scalars) with ``scalars`` one f64
    tensor [iter_est (ncomp), iter_err (ncomp), finished_est (ncomp),
    finished_err (ncomp), n_active], the host's one transfer a sweep."""
    cap = est.shape[1]
    mask = region_pool.block_mask(cap, n, blocked, est.device)
    zero = torch.zeros_like(est)
    est = torch.where(mask[None], est, zero)
    err = torch.where(mask[None], err, zero)
    if use_refine:
        volumes = (torch.prod(lengths, dim=0)
                   if abs_per_vol is not None else None)
        refined, active = two_level.refine_error_vector(
            est, err, parent_estimates, n, epsrel,
            relerr_classification=relerr_classification,
            volumes=volumes, abs_per_vol=abs_per_vol)
    else:
        refined, active = err, mask.to(est.dtype)
    # each component reduced as iteration_math reduces a scalar run's
    # (cap,) arrays, so that [f, f] gives f's numbers bit for bit
    iter_est = torch.stack([torch.sum(e) for e in est])
    iter_err = torch.stack([torch.sum(r) for r in refined])
    finished_est = iter_est - torch.stack([torch.sum(active * e) for e in est])
    finished_err = iter_err - torch.stack([torch.sum(active * r)
                                           for r in refined])
    n_active = torch.sum(active.to(torch.float64))   # see iteration_math
    f64 = torch.float64
    scalars = torch.cat([iter_est.to(f64), iter_err.to(f64),
                         finished_est.to(f64), finished_err.to(f64),
                         n_active[None]])
    return est, refined, active, scalars


def _max_over_components(refined):
    """Per-region worst-component error profile for the classifier."""
    return torch.amax(refined, dim=0)


def _arr(x) -> np.ndarray:
    """A ledger value, scalar or (ncomp,), as a (ncomp,) f64 array."""
    return np.atleast_1d(np.asarray(x, np.float64))


def _ests(res) -> np.ndarray:
    """A result's estimates as a (ncomp,) array (ncomp = 1: a scalar's)."""
    return _arr(res.estimate if res.estimates is None else res.estimates)


def _errs(res) -> np.ndarray:
    return _arr(res.errorest if res.errorests is None else res.errorests)


def _worst_err(res) -> float:
    """The no-progress guard's error: a vector's worst component."""
    return float(np.max(_errs(res)))


def _resolve_device(device, what: str = "Workspace") -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the CUDA card by default and none is "
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
                      pool's device -- on the card the CUDA kernels (a Genz
                      family of models.genz fused into the tile or generic
                      kernel; any other callable through the split route's
                      points and contraction kernels), on the CPU the plain
                      version.  "torch": the plain PyTorch version on any
                      device.
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
                "gpuintegration_torch yet (ROADMAP A16)")
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
                   global_range, n, blocked: bool, ncomp: int = 1,
                   with_split_frac: bool = False):
        apply = (rule_eval.apply_rule_plain if self.rule_backend == "torch"
                 else rule_eval.apply_rule)
        return apply(integrand, tables, lows, lengths, global_lo,
                     global_range, chunk_size=self.chunk_size, n=n,
                     blocked=blocked, ncomp=ncomp,
                     with_split_frac=with_split_frac)

    def _fused_phase(self, integrand, tables, global_lo, global_range, *,
                     ncomp, with_split_frac, **kw):
        """A ``fused_loop.Phase`` for one run: its evaluation walks the real
        regions of a CPU pool and, on the card, the whole bucket (the
        region count lives on the card there; the padding is masked)."""
        def evaluate(lows, lengths, n):
            if lows.device.type == "cpu":
                return self._eval_pool(integrand, tables, lows, lengths,
                                       global_lo, global_range, int(n), True,
                                       ncomp, with_split_frac)
            return self._eval_pool(integrand, tables, lows, lengths,
                                   global_lo, global_range, None, False,
                                   ncomp, with_split_frac)

        return fused_loop.Phase(
            evaluate, iteration_math if ncomp == 1 else iteration_math_vector,
            ncomp=None if ncomp == 1 else ncomp,
            with_split_frac=with_split_frac, feval=tables.feval,
            gate=int(0.1 * self.max_pool_regions), **kw)

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
        vegas_passes: int = 10,
        vegas_samples_per_pass: int = 320,
        seed: int = 0,
        fused: bool = True,
        ledger: tuple | None = None,
        finish_epsrel_scale: float = 1.0,
        finish_abs_per_vol: float = 0.0,
        crease_split: bool = False,
        deadline: float | None = None,
    ) -> IntegrationResult:
        """Integrate ``integrand`` to the requested tolerances: the
        reference's host loop, iteration for iteration, with its
        device-resident bursts where the reference takes them.

        ``initial_regions``: (lows, lengths) region-major (n, ndim) arrays
        to start from instead of the uniform split (resume).
        ``ledger``: (estimate, errorest, nregions, iters, neval) seed of the
        cumulative ledger; ``max_iterations`` then counts on top of it.  A
        vector integrand (..., ncomp) needs a vector ledger, (ncomp,)
        estimate and errorest, and its result carries ``estimates`` and
        ``errorests`` (ncomp,), ``estimate``/``errorest`` mirroring
        component 0 (``_integrate_vector``).
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

        ``fused`` (default True, the reference's): whenever the pool is
        blocked and 2 n <= 0.1 ``max_pool_regions`` (below the classifier's
        gate), run bursts of whole iterations with no host decision between
        them (``pagani/fused_loop.py``; on the card a CUDA graph of one
        iteration a bucket capacity, replayed); the host loop handles the
        rest.  A callable that cannot be captured into a graph (one that
        reads the card from the host) raises RuntimeError: pass
        ``fused=False`` for the host loop throughout.  After a fused exit
        ``final_pool_errors`` is None (the continuation then slices the
        pool in its order).

        ``crease_split``: split where the rule's collinear samples along
        the split axis show a C0 kink (at the crease, less a margin) or a
        jump (at the gap's edge, the axis the jump's), elsewhere at the
        midpoint with the midpoint's bits (``rule_eval.split_fraction``;
        the reference splits at midpoints only, Sub_region_splitter.cuh).
        Scalar integrands only, host loop and fused phase alike; on the
        card every integrand then takes the split route, whose values the
        split fraction kernel reads.

        ``predict_split``: the reference's split prediction
        (Workspace.cuh:206-211, 244-248): no finished-region classification
        for the first 15 iterations while the pool holds at most 15M
        regions and nothing has finished, and the pool at iteration 15 kept
        in ``last_snapshot`` = (lows, lengths, n, blocked).  It runs the
        host loop throughout.  Scalar integrands only.

        ``vegas_assisted``: the reference's PAGANI+VEGAS hybrid
        (Phases.cuh:479-518, Sample.cuh:292-729): each iteration keeps the
        rule's bisection dimension but overwrites every region's estimate
        and error with an in-region adaptive Monte Carlo result,
        ``vegas_passes`` passes of ``vegas_samples_per_pass`` samples on a
        per-region grid of 100 bins a dimension
        (``vegas_assisted.vegas_assisted_estimates``), the draws keyed on
        (``seed``, iteration, pass, region slot).  Regions are sampled
        ``chunk_size`` at a time, the real slots only.  It runs the host
        loop throughout.  Scalar integrands only; it refuses
        ``crease_split``.
        """
        if crease_split and vegas_assisted:
            raise ValueError(_CREASE_SCALAR_ONLY)
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
        ncomp = deduce_ncomp(f, ndim, dtype, device)
        if crease_split and ncomp > 1:
            raise ValueError(_CREASE_SCALAR_ONLY)
        if ncomp > 1 and vegas_assisted:
            raise ValueError(
                "vector-valued integrands refuse vegas_assisted (a scalar "
                "per-region Monte Carlo overwrite, Phases.cuh:479-518)")
        if ncomp > 1 and predict_split:
            raise ValueError(
                "vector-valued integrands refuse predict_split (a scalar "
                "snapshot heuristic, Workspace.cuh:206-211)")
        if ncomp > 1 and ledger is not None and np.ndim(ledger[0]) != 1:
            raise ValueError(
                "vector runs need a vector ledger: ((ncomp,) est, (ncomp,) "
                "err, nregions, iters, neval)")
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

        apv = finish_abs_per_vol if finish_abs_per_vol > 0.0 else None
        phase = None
        assist = None
        if vegas_assisted:
            def assist(lows, lengths, n, blocked, it):
                """The rule's estimates of the pool's real slots overwritten
                by the in-region VEGAS estimates of iteration ``it``."""
                cap = lows.shape[1]
                ranges = ([(0, n // 2), (cap // 2, cap // 2 + n // 2)]
                          if blocked else [(0, n)])
                return assisted.vegas_assisted_estimates(
                    f, ndim, vegas_passes, vegas_samples_per_pass,
                    assisted.NBINS, dtype, seed, it, lows, lengths,
                    global_lo, global_range, chunk=self.chunk_size,
                    ranges=ranges)
        if fused and not predict_split and not vegas_assisted:
            phase = self._fused_phase(
                integrand, tables, global_lo, global_range, ncomp=ncomp,
                with_split_frac=crease_split,
                relerr_classification=relerr_classification,
                eps_work=eps_work, epsrel=epsrel, epsabs=epsabs,
                abs_per_vol=apv)
        try:
            if ncomp > 1:
                return self._integrate_vector(
                    integrand, ncomp, epsrel, epsabs, eps_work, apv,
                    global_lo, global_range, tables, lows, lengths, n, cap,
                    relerr_classification, max_iterations, ledger, deadline,
                    phase)
            return self._integrate_scalar(
                integrand, epsrel, epsabs, eps_work, apv, global_lo,
                global_range, tables, lows, lengths, n, cap,
                relerr_classification, max_iterations, ledger, deadline,
                phase, crease_split, predict_split, assist)
        finally:
            if phase is not None:
                phase.close()

    def _integrate_scalar(
        self, integrand, epsrel, epsabs, eps_work, apv, global_lo,
        global_range, tables, lows, lengths, n, cap, relerr_classification,
        max_iterations, ledger, deadline, phase, crease_split, predict_split,
        assist=None,
    ) -> IntegrationResult:
        """The adaptive loop of a scalar integrand from its initial pool:
        the reference's host loop (Workspace.cuh:148-358), with the fused
        phase's bursts (``phase``, None for none) where the pool is
        blocked and under the gate."""
        dtype, device = self.dtype, self.device
        parent_est = torch.zeros((max(cap // 2, 1),), dtype=dtype,
                                 device=device)
        use_refine = False

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
        lay = {k: i for i, k in enumerate(fused_loop.SCALAR_LAYOUT)}

        it = cum.iters
        while True:
            if it >= max_iterations or (
                    deadline is not None and time.monotonic() >= deadline):
                exhausted = True
                break
            if n <= 0:
                break

            if phase is not None and blocked and 2 * n <= phase.gate:
                self.peak_capacity = max(self.peak_capacity, cap)
                lows, lengths, parent_est, sdim_f, frac_f, packed = phase.run(
                    lows, lengths, n, parent_est, cum_est=cum.estimate,
                    cum_err=cum.errorest, result_nregions=result_nregions,
                    iters=cum.iters, neval=cum.neval,
                    hist=classifier._estimates, max_iters=max_iterations)
                n = int(packed[lay["n"]])
                status = int(packed[lay["status"]])
                fused_iters = int(packed[lay["iters"]]) - cum.iters
                cum.estimate = float(packed[lay["cum_est"]])
                cum.errorest = float(packed[lay["cum_err"]])
                result_nregions = int(packed[lay["result_nregions"]])
                cum.nFinishedRegions = result_nregions
                cum.iters = int(packed[lay["iters"]])
                cum.neval = int(packed[lay["neval"]])
                classifier._estimates = [float(packed[lay[f"hist{i}"]])
                                         for i in range(3)]
                classifier._iters_collected += fused_iters
                inflight_est = float(packed[lay["last_inflight_est"]])
                inflight_err = float(packed[lay["last_inflight_err"]])
                it = cum.iters
                if status == 1:
                    # bucket overflow: the burst applied the sweep and
                    # handed back the n compacted survivors; split them
                    # into the doubled bucket, evaluating nothing again
                    lows, lengths, n = region_pool.split(
                        lows, lengths, sdim_f, n, out_capacity=2 * cap,
                        frac=frac_f)
                    cap = 2 * cap
                    use_refine = True
                    blocked = True
                # a fused exit keeps no per-region errors: a continuation
                # slices the pool in its order
                self.final_pool = (lows, lengths, n, True)
                self.final_pool_errors = None
                if status in (0, 2):
                    # the pool is unchanged and swept: the resumable ledger
                    # excludes that sweep
                    self._ledger_excl_pool = (
                        float(packed[lay["prev_est"]]),
                        float(packed[lay["prev_err"]]),
                        int(packed[lay["prev_nregions"]]),
                        int(packed[lay["prev_iters"]]),
                        int(packed[lay["prev_neval"]]))
                else:
                    # post-split and not yet evaluated: the ledger as it is
                    self._ledger_excl_pool = (cum.estimate, cum.errorest,
                                              result_nregions, cum.iters,
                                              cum.neval)
                if status == 0:
                    cum.status = 0
                    cum.nregions = result_nregions + n
                    return cum
                if status == 2:
                    cum.nregions = result_nregions
                    return cum
                if it >= max_iterations:
                    exhausted = True
                    break
                if status == 1:
                    continue
                # the gate (status -1): one host iteration with the
                # classifier, then the loop may come back

            effective_relerr = relerr_classification
            if (predict_split and n <= 15_000_000 and it < 15
                    and result_nregions == 0):
                effective_relerr = False          # (Workspace.cuh:206-211)
            self.peak_capacity = max(self.peak_capacity, cap)
            eval_out = self._eval_pool(
                integrand, tables, lows, lengths, global_lo, global_range,
                n, blocked, 1, crease_split)
            est_raw, err_raw, sdim = eval_out[:3]
            sfrac = eval_out[3] if crease_split else None
            if assist is not None:
                # the hybrid: the rule's split axes, the in-region VEGAS
                # estimates (reference: Sample.cuh:726-727)
                est_raw, err_raw = assist(lows, lengths, n, blocked, it)
            est, refined, active, scalars_d = iteration_math(
                effective_relerr, blocked, est_raw, err_raw, n,
                parent_est, use_refine, eps_work,
                lengths=None if apv is None else lengths, abs_per_vol=apv)
            if predict_split and result_nregions == 0 and it == 15:
                # the pool snapshot (Workspace.cuh:244-248), with its layout
                self.last_snapshot = (lows, lengths, n, blocked)
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
            cres = region_pool.compact(
                active, lows, lengths, sdim, est, refined,
                out_capacity=child_cap // 2, extra=sfrac)
            c_lows, c_lengths, c_sdim, parent_est = cres[:4]
            lows, lengths, n = region_pool.split(
                c_lows, c_lengths, c_sdim, n_active, out_capacity=child_cap,
                frac=cres[5] if crease_split else None)
            cap = child_cap
            use_refine = True
            blocked = True
            it += 1

        if exhausted and cum.iters > 0:
            cum.estimate += inflight_est
            cum.errorest += inflight_err

        cum.nregions = result_nregions + n
        return cum

    def _integrate_vector(
        self, integrand, ncomp, epsrel, epsabs, eps_work, apv, global_lo,
        global_range, tables, lows, lengths, n, cap, relerr_classification,
        max_iterations, ledger, deadline, phase=None,
    ) -> IntegrationResult:
        """The adaptive loop of a vector-valued integrand, f: (..., ndim) ->
        (..., ncomp) (the reference's ``_integrate_vector`` host loop,
        Workspace.cuh:148-358 generalised): every component shares one
        point set and one region tree; a region is finished only when
        EVERY component meets its tolerance; the bisection axis takes the
        largest fourth difference over the components; the run converges
        when every component's cumulative error passes (cubacpp's
        all-components semantics, integrand_traits.hh:81-93).  The
        classifier and the error-budget rollback key on the WORST
        component.  Called by ``integrate`` on its initial pool; ``phase``
        (a ``fused_loop.Phase`` or None) runs the reference's
        ``fused_adaptive_phase_vector`` bursts: the same exits, every
        component's accuracy, any component's rollback, the worst
        component's estimate history."""
        dtype, device = self.dtype, self.device
        parent_est = torch.zeros((ncomp, max(cap // 2, 1)), dtype=dtype,
                                 device=device)
        use_refine = False
        classifier = HeuristicClassifier(eps_work, epsabs,
                                         self.max_pool_regions)
        feval = tables.feval

        cum = IntegrationResult(status=1)
        cum_est = np.zeros(ncomp)
        cum_err = np.zeros(ncomp)
        result_nregions = 0
        if ledger is not None:
            est_seed, err_seed, result_nregions, it_seed, nev_seed = ledger
            cum_est = np.asarray(est_seed, np.float64).copy()
            cum_err = np.asarray(err_seed, np.float64).copy()
            if cum_est.shape != (ncomp,) or cum_err.shape != (ncomp,):
                raise ValueError(
                    f"vector ledger est/err must have shape ({ncomp},)")
            cum.iters = int(it_seed)
            cum.neval = int(nev_seed)
            cum.nFinishedRegions = result_nregions
            max_iterations = max_iterations + cum.iters
        blocked = False
        inflight_est = np.zeros(ncomp)
        inflight_err = np.zeros(ncomp)
        exhausted = False

        def all_accuracy(ests, errs):
            return all(accuracy_reached(epsrel, epsabs, abs(e), r)
                       for e, r in zip(ests, errs))

        lay = {k: i for i, k in enumerate(fused_loop.vector_layout(ncomp))}

        def comps(name):
            return np.array([packed[lay[f"{name}{k}"]]
                             for k in range(ncomp)], dtype=np.float64)

        it = cum.iters
        while True:
            if it >= max_iterations or (
                    deadline is not None and time.monotonic() >= deadline):
                exhausted = True
                break
            if n <= 0:
                break

            if phase is not None and blocked and 2 * n <= phase.gate:
                self.peak_capacity = max(self.peak_capacity, cap)
                lows, lengths, parent_est, sdim_f, _, packed = phase.run(
                    lows, lengths, n, parent_est, cum_est=cum_est,
                    cum_err=cum_err, result_nregions=result_nregions,
                    iters=cum.iters, neval=cum.neval,
                    hist=classifier._estimates, max_iters=max_iterations)
                n = int(packed[lay["n"]])
                status = int(packed[lay["status"]])
                fused_iters = int(packed[lay["iters"]]) - cum.iters
                result_nregions = int(packed[lay["result_nregions"]])
                cum.nFinishedRegions = result_nregions
                cum.iters = int(packed[lay["iters"]])
                cum.neval = int(packed[lay["neval"]])
                classifier._estimates = [float(packed[lay[f"hist{i}"]])
                                         for i in range(3)]
                classifier._iters_collected += fused_iters
                cum_est, cum_err = comps("cum_est"), comps("cum_err")
                inflight_est = comps("last_inflight_est")
                inflight_err = comps("last_inflight_err")
                it = cum.iters
                if status == 1:
                    # split the compacted survivors into the doubled bucket
                    lows, lengths, n = region_pool.split(
                        lows, lengths, sdim_f, n, out_capacity=2 * cap)
                    cap = 2 * cap
                    use_refine = True
                    blocked = True
                self.final_pool = (lows, lengths, n, True)
                self.final_pool_errors = None
                if status in (0, 2):
                    self._ledger_excl_pool = (
                        comps("prev_est"), comps("prev_err"),
                        int(packed[lay["prev_nregions"]]),
                        int(packed[lay["prev_iters"]]),
                        int(packed[lay["prev_neval"]]))
                else:
                    self._ledger_excl_pool = (cum_est.copy(), cum_err.copy(),
                                              result_nregions, cum.iters,
                                              cum.neval)
                if status == 0:          # every component converged
                    cum.status = 0
                    cum.nregions = result_nregions + n
                    break
                if status == 2:          # every region finished
                    cum.nregions = result_nregions
                    break
                if it >= max_iterations:
                    exhausted = True
                    break
                if status == 1:
                    continue

            self.peak_capacity = max(self.peak_capacity, cap)
            est_raw, err_raw, sdim = self._eval_pool(
                integrand, tables, lows, lengths, global_lo, global_range,
                n, blocked, ncomp)
            est, refined, active, scalars_d = iteration_math_vector(
                relerr_classification, blocked, est_raw, err_raw, n,
                parent_est, use_refine, eps_work,
                lengths=None if apv is None else lengths, abs_per_vol=apv)
            # the live pool and this sweep's per-region component arrays,
            # for checkpoints; the ledger EXCLUDES this sweep
            self.final_pool = (lows, lengths, n, blocked)
            self.final_pool_errors = (est, refined)
            self._ledger_excl_pool = (cum_est.copy(), cum_err.copy(),
                                      result_nregions, cum.iters, cum.neval)
            scalars = scalars_d.cpu().numpy()      # one transfer a sweep
            iter_est = scalars[0:ncomp]
            iter_err = scalars[ncomp:2 * ncomp]
            finished_est = scalars[2 * ncomp:3 * ncomp]
            finished_err = scalars[3 * ncomp:4 * ncomp]
            n_active = int(scalars[4 * ncomp])
            cum.iters += 1
            cum.neval += n * feval

            if all_accuracy(cum_est + iter_est, cum_err + iter_err):
                cum_est = cum_est + iter_est
                cum_err = cum_err + iter_err
                cum.status = 0
                cum.nregions = result_nregions + n
                break

            # the worst component (largest relative error) drives the
            # classification: its estimate sets the ladder's budget scale
            w = int(np.argmax((cum_err + iter_err)
                              / np.maximum(np.abs(cum_est + iter_est),
                                           1e-300)))
            classifier.store_estimate(float(cum_est[w] + iter_est[w]))

            # rollback when ANY component's banked error would overflow its
            # budget max(epsrel*|est|, epsabs) (Workspace.cuh:121-146)
            if any(ce + fe > max(abs(le) * epsrel, epsabs)
                   for ce, fe, le in zip(cum_err, finished_err,
                                         cum_est + iter_est)):
                active = region_pool.block_mask(cap, n, blocked,
                                                device).to(dtype)
                finished_est = np.zeros(ncomp)
                finished_err = np.zeros(ncomp)
                n_active = n

            classification_necessary = not classifier.split_fits(n)
            if classifier.classification_criteria_met(n):
                hs = classifier.classify_ladder(
                    _max_over_components(refined),
                    region_pool.block_mask(cap, n, blocked, device), n,
                    float(iter_err[w]), float(finished_err[w]),
                    float(cum_err[w]))
                success = hs.pass_mem and hs.pass_errorest_budget
                if success:
                    flags = hs.active_flags
                    kept = torch.stack(
                        [torch.sum(flags * e) for e in est]
                        + [torch.sum(flags * r) for r in refined]
                    ).to(torch.float64).cpu().numpy()
                    cand_est = iter_est - kept[:ncomp]
                    cand_err = iter_err - kept[ncomp:]
                    # per-component budget guard: the ladder's budget test
                    # keys on the worst component only; every component's
                    # banked error must stay inside its own
                    # max(eps_work*|est|, epsabs), as a scalar run's does
                    targets = np.maximum(
                        np.abs(cum_est + iter_est) * eps_work, epsabs)
                    if np.all(cum_err + cand_err <= targets):
                        active = flags
                        finished_est = cand_est
                        finished_err = cand_err
                        n_active = hs.num_active
                    else:
                        success = False
                must_terminate = not success and classification_necessary
            else:
                must_terminate = classification_necessary

            if must_terminate:
                cum_est = cum_est + iter_est
                cum_err = cum_err + iter_err
                cum.nregions = result_nregions + n
                break

            cum_est = cum_est + finished_est
            cum_err = cum_err + finished_err
            inflight_est = iter_est - finished_est
            inflight_err = iter_err - finished_err

            result_nregions += n - n_active
            cum.nFinishedRegions += n - n_active
            if n_active == 0:
                cum.nregions = result_nregions
                break

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
            cum_est = cum_est + inflight_est
            cum_err = cum_err + inflight_err
            cum.nregions = result_nregions + n
        elif cum.nregions == 0:
            cum.nregions = result_nregions + max(n, 0)
        cum.estimates = cum_est
        cum.errorests = cum_err
        cum.estimate = float(cum_est[0])
        cum.errorest = float(cum_err[0])
        return cum

    def integrate_to_convergence(
        self,
        integrand: Callable,
        epsrel: float = 1e-3,
        epsabs: float = 1e-12,
        vol: Volume | None = None,
        *,
        max_rounds: int = 16,
        min_err_reduction: float = 0.99,
        max_wall_s: float | None = None,
        stage_timer=None,
        state_path: str | None = None,
        **kw,
    ) -> IntegrationResult:
        """``integrate`` with checkpoint-resume continuation (the
        reference's, on one device).

        A single ``integrate`` ends with status 1 at the pool wall or the
        iteration budget.  Each further round resumes the surviving
        regions with the cumulative ledger seeded (``ledger=``): fresh
        parents, a fresh classifier budget against the true cumulative
        estimate, a fresh iteration budget.  When the survivors are too
        many to split twice inside ``max_pool_regions`` (4 x survivors >
        max_pool_regions), it switches to ``_partitioned_continuation``:
        hottest-first slices of ``max_pool_regions // 16`` regions, each a
        fresh adaptive run, with a global certificate over the banked
        totals plus the untouched queue's stored errors.

        Stops on convergence, ``max_rounds``, ``max_wall_s`` seconds of
        wall clock (passed into every round and slice as ``deadline=``), an
        empty pool, or when a round fails to bring the error below
        ``min_err_reduction`` times the previous round's (no-progress
        guard).

        ``stage_timer``: a ``utils.profiling.StageTimer``; records "round1",
        "resume_roundN" and "slices" (summed).  ``state_path``: where an
        unconverged exit with surviving regions saves a
        ``utils.checkpoint.ContinuationState`` (atomically); a later call
        with the same path resumes its queue exactly, and certification
        removes the file.  ``kw`` goes to ``integrate`` (``fused``,
        ``crease_split``, ``predict_split`` and ``vegas_assisted`` with it,
        into every round and slice).  A vector integrand
        continues the same way on (ncomp,)
        ledgers and (n, ncomp) stashes: slices sorted by each region's
        worst component, every component banked and certified, the
        no-progress guard on the worst component.
        """
        deadline = (time.monotonic() + max_wall_s
                    if max_wall_s is not None else None)

        if state_path is not None and os.path.exists(npz_path(state_path)):
            state = ContinuationState.load(state_path)
            if not (state.epsrel == epsrel and state.epsabs == epsabs):
                raise ValueError(
                    f"state at {state_path} was built for "
                    f"(epsrel={state.epsrel:g}, epsabs={state.epsabs:g}), "
                    f"not ({epsrel:g}, {epsabs:g})")
            kw.pop("initial_regions", None)
            kw.pop("ledger", None)
            return self._partitioned_continuation(
                integrand, epsrel, epsabs, vol, None, None, max_rounds,
                deadline, min_err_reduction=min_err_reduction,
                stage_timer=stage_timer, state_path=state_path,
                resume_state=state, **kw)

        def stage(name):
            return (stage_timer.stage(name) if stage_timer is not None
                    else contextlib.nullcontext())

        with stage("round1"):
            res = self.integrate(integrand, epsrel, epsabs, vol,
                                 deadline=deadline, **kw)
        # round 1 consumed a caller's initial_regions/ledger seed; later
        # rounds and slices bring their own
        kw.pop("initial_regions", None)
        kw.pop("ledger", None)
        rounds = 1
        while (res.status == 1 and rounds < max_rounds
               and res.nregions > res.nFinishedRegions
               and (deadline is None or time.monotonic() < deadline)):
            if self.final_pool is None:
                break
            ckpt = self.make_checkpoint()
            if ckpt.lows.shape[0] == 0:
                break
            # the checkpoint is on the host: free the final pool on the
            # card (2 x 16M x 8 x 8 B = 2 GB at the 8D wall) before the
            # resumed round allocates its own
            self.final_pool = None
            self.final_pool_errors = None
            if 4 * ckpt.lows.shape[0] > self.max_pool_regions:
                return self._partitioned_continuation(
                    integrand, epsrel, epsabs, vol, ckpt, res,
                    max_rounds - rounds, deadline,
                    min_err_reduction=min_err_reduction,
                    stage_timer=stage_timer, state_path=state_path, **kw)
            prev_err = _worst_err(res)
            with stage(f"resume_round{rounds + 1}"):
                res = self.integrate(
                    integrand, epsrel, epsabs, vol,
                    initial_regions=(ckpt.lows, ckpt.lengths),
                    ledger=ckpt.ledger, deadline=deadline, **kw)
            rounds += 1
            if (res.status == 1
                    and _worst_err(res) > min_err_reduction * prev_err):
                break   # no meaningful progress
        if (state_path is not None and res.status == 1
                and self.final_pool is not None):
            # unconverged in the whole-pool phase: save the survivors as a
            # fresh slice queue, for a later process to resume
            ckpt = self.make_checkpoint()
            if ckpt.lows.shape[0]:
                self.final_pool = None
                self.final_pool_errors = None
                work = self._make_slices(
                    ckpt.lows, ckpt.lengths, ckpt.region_estimates,
                    ckpt.region_errorests,
                    _ests(res) - _arr(ckpt.estimate),
                    _errs(res) - _arr(ckpt.errorest), self._slice_cap(), 0)
                ContinuationState.from_queue(
                    work, _arr(ckpt.estimate), _arr(ckpt.errorest),
                    ckpt.iters, ckpt.neval, ckpt.nregions, ckpt.nregions,
                    np.ndim(ckpt.estimate) == 1, epsrel,
                    epsabs).save(state_path)
        return res

    def _slice_cap(self) -> int:
        """Regions of a continuation slice: four doublings of headroom."""
        return max(self.max_pool_regions // 16, 2 * self.chunk_size)

    @staticmethod
    def _make_slices(lows, lengths, reg_est, reg_err, tot_est, tot_err, cap,
                     depth):
        """Cut survivors into slices of <= cap regions, COLDEST FIRST so
        ``work.pop()`` takes the hottest: (lows, lengths, s_est, s_err,
        depth, exact).  With per-region arrays the survivors are sorted by
        refined error (``np.argsort``, as the reference sorts; a vector
        stash (n, ncomp) by each region's worst component) and each slice
        carries its exact stored sums, (ncomp,) arrays for a vector;
        without them the pool order is kept and the in-flight totals are
        apportioned by region count, flagged inexact so the global
        certificate never fires off them."""
        n = lows.shape[0]
        if n == 0:
            return []
        if reg_err is not None:
            key = reg_err if reg_err.ndim == 1 else reg_err.max(axis=1)
            order = np.argsort(key)                # ascending: hot at end
            lows, lengths = lows[order], lengths[order]
            reg_est, reg_err = reg_est[order], reg_err[order]

            def total(a, i):
                t = a[i:i + cap].sum(axis=0)
                return float(t) if np.ndim(t) == 0 else t

            return [(lows[i:i + cap], lengths[i:i + cap], total(reg_est, i),
                     total(reg_err, i), depth, True)
                    for i in range(0, n, cap)]
        return [(lows[i:i + cap], lengths[i:i + cap],
                 tot_est * min(cap, n - i) / n,
                 tot_err * min(cap, n - i) / n, depth, False)
                for i in range(0, n, cap)]

    def _partitioned_continuation(
        self, integrand, epsrel, epsabs, vol, ckpt, last_res,
        rounds_left, deadline=None, min_err_reduction=0.99,
        stage_timer=None, state_path=None, resume_state=None, **kw,
    ) -> IntegrationResult:
        """Divide-and-conquer continuation for split-starved pools (the
        reference's, scalar or vector).

        The survivors (``ckpt``, or the queue of ``resume_state``) are
        sorted by refined error and sliced (``_make_slices``); slices run
        hottest first, each a fresh adaptive integration at the same
        tolerances, or at a tightened share of the remaining budget where
        the projected natural exits cannot meet it (then with a volume-
        apportioned retirement, ``finish_abs_per_vol``).  A slice that
        stops at its own wall banks its finished ledger and re-queues its
        survivors while it reduced its stored error (depth <= 12); else
        its result is banked as it is.  Before every slice the global test
        runs on the banked totals plus the queue's stored sums, so the
        loop stops at the earliest certifiable moment; it also stops when
        the bank alone exceeds the best budget any refinement could reach,
        after ``max(64 * rounds_left, 4 * slices)`` slice runs, or at the
        deadline.  The result folds in the untouched queue's stored sums,
        so its estimate is the whole integral either way.

        The ledger arithmetic runs on (ncomp,) f64 arrays, ncomp = 1 for a
        scalar integrand: a vector slice takes its tolerances from the
        worst component (largest relative error) while every component is
        banked and certified."""

        def stage(name):
            return (stage_timer.stage(name) if stage_timer is not None
                    else contextlib.nullcontext())

        slice_cap = self._slice_cap()
        max_depth = 12
        if resume_state is not None:
            vec = resume_state.vec
            work = resume_state.to_queue()
            fin_est = resume_state.fin_est.copy()
            fin_err = resume_state.fin_err.copy()
            iters, neval = resume_state.iters, resume_state.neval
            nregions = resume_state.nregions
            nfinished = resume_state.nfinished
        else:
            vec = np.ndim(ckpt.estimate) == 1
            fin_est = _arr(ckpt.estimate).copy()
            fin_err = _arr(ckpt.errorest).copy()
            iters, neval = ckpt.iters, ckpt.neval
            nregions = nfinished = ckpt.nregions
            work = self._make_slices(
                ckpt.lows, ckpt.lengths, ckpt.region_estimates,
                ckpt.region_errorests, _ests(last_res) - fin_est,
                _errs(last_res) - fin_err, slice_cap, 0)

        def qsum(col):
            return sum((_arr(w[col]) for w in work), np.zeros_like(fin_est))

        max_runs = max(64 * rounds_left, 4 * len(work))
        runs = 0
        status = 1
        while True:
            q_est, q_err = qsum(2), qsum(3)
            budget = np.maximum(epsrel * np.abs(fin_est + q_est), epsabs)
            if all(w[5] for w in work) and np.all(fin_err + q_err <= budget):
                status = 0               # certified: banked + exact queue
                break
            if not work or runs >= max_runs or (
                    deadline is not None and time.monotonic() >= deadline):
                break
            # what the slices' natural exits would bank, and the best
            # budget any refinement of the queue could reach
            projected = fin_err + sum(
                (np.minimum(_arr(w[3]),
                            np.maximum(epsrel * np.abs(_arr(w[2])), epsabs))
                 for w in work), np.zeros_like(fin_est))
            best_budget = np.maximum(
                epsrel * (np.abs(fin_est + q_est) + q_err), epsabs)
            if np.any(fin_err > best_budget):
                break                    # the bank alone is uncertifiable
            lows_i, lengths_i, s_est_w, s_err_w, depth, exact = work.pop()
            s_est_i, s_err_i = _arr(s_est_w), _arr(s_err_w)
            # the worst component sets this slice's tolerances
            wc = int(np.argmax((fin_err + q_err)
                               / np.maximum(np.abs(fin_est + q_est), 1e-300)))
            needed = budget[wc] - fin_err[wc]
            eps_rel_i, eps_abs_i, kw_i = epsrel, epsabs, kw
            if np.any(projected > budget) and needed > 0 \
                    and q_err[wc] > 0 and s_err_i[wc] > 0:
                # this slice's share of the remaining budget; an inexact
                # slice's stored estimate is a uniform share, so it gets a
                # purely absolute target
                share = 0.8 * (needed / q_err[wc]) * s_err_i[wc]
                vol_i = float(np.prod(lengths_i, axis=1).sum())
                eps_rel_i = (min(epsrel,
                                 share / max(abs(s_est_i[wc]), 1e-300))
                             if exact else 0.0)
                eps_abs_i = share
                kw_i = dict(kw)
                if vol_i > 0.0:
                    kw_i["finish_abs_per_vol"] = 0.5 * share / vol_i
            with stage("slices"):
                r_i = self.integrate(
                    integrand, eps_rel_i, eps_abs_i, vol,
                    initial_regions=(lows_i, lengths_i), deadline=deadline,
                    **kw_i)
            if r_i.iters == 0:
                # the deadline passed before the slice's first sweep: it
                # goes back to the queue untouched
                work.append((lows_i, lengths_i, s_est_w, s_err_w, depth,
                             exact))
                break
            runs += 1
            iters += r_i.iters
            neval += r_i.neval
            requeued = 0
            if r_i.status == 1 and depth < max_depth:
                ck_i = self.make_checkpoint()
                self.final_pool = None
                self.final_pool_errors = None
                new_err = _arr(ck_i.errorest) + (
                    _arr(ck_i.region_errorests.sum(axis=0))
                    if ck_i.region_errorests is not None
                    else _errs(r_i) - _arr(ck_i.errorest))
                if ck_i.lows.shape[0] > 0 and \
                        np.max(new_err) < min_err_reduction * np.max(s_err_i):
                    # progress: bank the finished ledger and re-queue the
                    # survivors one level deeper.  ck_i.nregions counts the
                    # regions retired before the final sweep, whose pool
                    # is re-queued whole
                    fin_est += _arr(ck_i.estimate)
                    fin_err += _arr(ck_i.errorest)
                    nregions += ck_i.nregions
                    nfinished += ck_i.nregions
                    sub = self._make_slices(
                        ck_i.lows, ck_i.lengths, ck_i.region_estimates,
                        ck_i.region_errorests,
                        _ests(r_i) - _arr(ck_i.estimate),
                        _errs(r_i) - _arr(ck_i.errorest), slice_cap,
                        depth + 1)
                    work.extend(sub)
                    # hottest at the end
                    work.sort(key=lambda w: float(np.max(w[3])))
                    requeued = len(sub)
            if not requeued:
                fin_est += _ests(r_i)
                fin_err += _errs(r_i)
                nregions += r_i.nregions
                nfinished += r_i.nFinishedRegions
        if state_path is not None:
            path = npz_path(state_path)
            if status == 0 or not work:
                if os.path.exists(path):
                    os.remove(path)      # certified or drained: spent
            else:
                ContinuationState.from_queue(
                    work, fin_est, fin_err, iters, neval, nregions,
                    nfinished, vec, epsrel, epsabs).save(state_path)
        # the untouched queue's stored sums make the estimate the whole
        # integral either way
        total_est, total_err = fin_est + qsum(2), fin_err + qsum(3)
        res = IntegrationResult(
            estimate=float(total_est[0]), errorest=float(total_err[0]),
            status=status, iters=iters, neval=neval,
            nregions=nregions + sum(w[0].shape[0] for w in work),
            nFinishedRegions=nfinished)
        if vec:
            res.estimates, res.errorests = total_est, total_err
        return res

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
        errors), in pool order; None after a fused exit, which keeps
        none (``_make_slices`` then keeps the pool's order)."""
        if self.final_pool is None:
            raise ValueError("no resumable pool: run integrate() first")
        est, err, nregions, iters, neval = self._ledger_excl_pool
        lows, lengths, n, blocked = self.final_pool
        keep = region_pool.block_mask(lows.shape[1], n, blocked,
                                      lows.device).nonzero()[:, 0]

        def host(a):
            return np.ascontiguousarray(a[..., keep].cpu().numpy().T)

        reg_est = reg_err = None
        if self.final_pool_errors is not None:
            reg_est, reg_err = (host(a) for a in self.final_pool_errors)
        return PaganiCheckpoint(
            lows=host(lows), lengths=host(lengths), estimate=est,
            errorest=err, nregions=nregions, iters=iters, neval=neval,
            region_estimates=reg_est, region_errorests=reg_err)
