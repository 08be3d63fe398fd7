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

``Workspace(ndim, mesh=m)`` (``parallel.mesh.make_mesh``; the reference's
``_integrate_mesh``, ``workspace.py:1401-1869``) runs the same loops on D
ranks, each on its own blocked shard of per-shard capacity ``cap_s``: the
initial regions dealt contiguously (``parallel.mesh.deal``), evaluation,
refinement, compaction and split local to the shard, and every decision
taken on all-reduced values: the iteration's f64 scalars, the classifier's
ladder over the global pool (``HeuristicClassifier.classify_ladder(...,
mesh=)``), the kept sums, the hottest shard's survivors choosing the next
per-shard bucket, a deadline.  Every rank returns the same result.  A
checkpoint gathers the shards' rows in rank order; the continuation re-deals
its survivors error-evenly across the shards at each resume
(``_rebalance_checkpoint_for_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import (_positional_arity, deduce_ncomp,
                                            make_integrand)
from gpuintegration_torch.ops import (cuda_rule, genz_malik, integrand_gen,
                                      rule_eval)
from gpuintegration_torch.pagani import (fused_loop, region_pool, two_level,
                                         vegas_assisted as assisted)
from gpuintegration_torch.pagani.classifier import HeuristicClassifier
from gpuintegration_torch.parallel import mesh as pmesh
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


def rebalance_checkpoint(ckpt: PaganiCheckpoint, d: int) -> PaganiCheckpoint:
    """A checkpoint's survivors reordered so that a mesh resume's contiguous
    deal over ``d`` shards gives every shard an even hot/cold mix (the
    reference's ``_rebalance_checkpoint_for_mesh``, ``workspace.py:
    1871-1907``): sorted by stored refined error, hottest first (a vector's
    worst component; the pool order when a fused exit kept none), then
    dealt round-robin, so that resume block k receives sorted regions k,
    k + d, k + 2d, ... and the blocks' sizes are the contiguous deal's."""
    n = ckpt.lows.shape[0]
    if n == 0:
        return ckpt
    if ckpt.region_errorests is not None:
        err = np.asarray(ckpt.region_errorests)
        if err.ndim == 2:
            err = err.max(axis=1)
        order = np.argsort(-err)
    else:
        order = np.arange(n)
    dealt = np.concatenate([order[k::d] for k in range(d)])

    def take(a):
        return None if a is None else np.asarray(a)[dealt]

    return dataclasses.replace(
        ckpt, lows=ckpt.lows[dealt], lengths=ckpt.lengths[dealt],
        region_estimates=take(ckpt.region_estimates),
        region_errorests=take(ckpt.region_errorests))


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
                      kernel, past 16D into the wide one up to 24D; any
                      other callable through the split route's points and
                      contraction kernels, up to 16D), on the CPU the plain
                      version.  Past 16D on the card, any other callable,
                      a traced one, ``crease_split`` and more than 24D
                      raise ValueError before the first launch.  "torch": the plain PyTorch version on any
                      device.  "fused" (the reference's "pallas"): a
                      scalar-per-axis callable f(x0, ..., x{n-1}) traced
                      into the fused tile or generic kernel
                      (ops/integrand_gen.py; the library built for it at
                      first use), on the CPU the plain rule with the traced
                      program as its integrand.  It refuses what the
                      reference's Pallas backend refuses at ``integrate``:
                      a callable that is not per-axis or does not trace, a
                      vector integrand, ``crease_split`` and a mesh.
                      Unlike the reference's it takes float64 as well as
                      float32: Mosaic has no f64 on the TPU, the card's
                      fused kernels do.
    mesh:             a 1-D ``torch.distributed`` mesh
                      (``parallel.mesh.make_mesh``): every rank builds the
                      same Workspace and makes the same calls, holds its
                      shard of the pool on its device (``device`` must be
                      that device or None) and returns the same result.
                      ``max_pool_regions`` and the classifier's gate count
                      the global pool.
    """

    def __init__(self, ndim: int, *, dtype=torch.float64, device=None,
                 max_pool_regions: int | None = None,
                 pool_bytes_budget: int = 6 * 1024 ** 3,
                 chunk_size: int | None = None,
                 chunk_budget_bytes: int = 256 * 1024 * 1024,
                 mesh=None,
                 rule_backend: str = "cuda"):
        self.mesh = pmesh.check_mesh(mesh)
        if rule_backend not in ("cuda", "torch", "fused"):
            raise ValueError(f"rule_backend {rule_backend!r}")
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"dtype {dtype} (float64 or float32)")
        self.ndim = ndim
        self.dtype = dtype
        if self.mesh is None:
            self.device = _resolve_device(device)
        else:
            self.device = pmesh.mesh_device(self.mesh)
            asked = None if device is None else torch.device(device)
            if asked is not None and (
                    asked.type != self.device.type or asked.index not in (
                        None, self.device.index)):
                raise ValueError(
                    f"device={asked} but this rank's mesh device is "
                    f"{self.device}; pass device=None with a mesh")
        self.rule_backend = rule_backend
        itemsize = torch.finfo(dtype).bits // 8
        if max_pool_regions is None:
            # the loop keeps ~10 region-sized arrays live per dim slot
            per_region = itemsize * (4 * ndim + 12)
            max_pool_regions = min(
                1 << (pool_bytes_budget // per_region).bit_length() - 1,
                16 * 1024 * 1024)
        self.max_pool_regions = max_pool_regions
        if chunk_size is None:
            # the tables' padded point count, without building them (their
            # 2^n corners take 3.2 GB at 24D)
            feval_padded = -(-genz_malik.feval_per_region(ndim) // 128) * 128
            per_region = feval_padded * itemsize * 4
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
            gate=int(0.1 * self.max_pool_regions), mesh=self.mesh, **kw)

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
        recorder=None,
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
        pool in its order).  On the card a callable or a vector past 16D
        (the split route, chunk by chunk) runs the host loop throughout:
        the phase's graph would evaluate the whole bucket at once, 1024
        regions of points or more (174 GB at 20D in f64); the host loop
        gives the same bits, and ``fused_loop.stats["split_past_16d"]``
        counts such runs.

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

        ``recorder``: a ``utils.recorder.IterationRecorder`` that receives
        one row an iteration of the host loop (the reference's points:
        scalar, vector and mesh loops; on a mesh every rank records the
        same rows from the all-reduced sums).  It turns the fused phase off,
        as in the reference: every iteration then runs through the host
        loop.
        """
        if crease_split and vegas_assisted:
            raise ValueError(_CREASE_SCALAR_ONLY)
        if self.mesh is not None and (vegas_assisted or predict_split):
            # the reference's refusal (workspace.py:699-705)
            raise ValueError("mesh mode does not support vegas_assisted/"
                             "predict_split; run them single-chip")
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
        if self.rule_backend == "fused":
            # the reference's Pallas refusals (workspace.py:640-705)
            if _positional_arity(integrand) != ndim:
                raise ValueError(
                    "rule_backend='fused' needs a scalar-per-axis integrand "
                    f"f(x0, ..., x{ndim - 1}) (cubacpp convention); "
                    "rule_backend='cuda' takes any callable")
            if ncomp > 1:
                raise ValueError("rule_backend='fused' is scalar-only: a "
                                 "vector integrand runs on rule_backend="
                                 "'cuda'")
            if crease_split:
                raise ValueError("crease_split needs rule_backend='cuda'")
            if self.mesh is not None:
                raise ValueError("mesh mode requires rule_backend='cuda'")
            if ndim > integrand_gen.RULE_MAX_NDIM:
                raise ValueError(cuda_rule.past_16d(
                    "rule_backend='fused' (a traced callable's kernels)",
                    ndim))
            integrand = integrand_gen.traced(
                integrand, ndim, max_ndim=integrand_gen.RULE_MAX_NDIM)
        if crease_split and ncomp > 1:
            raise ValueError(_CREASE_SCALAR_ONLY)
        split_past_16d = False
        if (self.rule_backend == "cuda" and device.type == "cuda"
                and ndim > cuda_rule.MAX_NDIM):
            # past 16D the card runs the wide route (a Genz family) and the
            # split route (any other callable, a vector) up to 24D: what
            # neither takes is refused here, before the first launch
            if crease_split:
                raise ValueError(cuda_rule.past_16d("crease_split", ndim))
            split_past_16d = cuda_rule.rule_route(
                ndim, integrand, ncomp) == "split"
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
        ns = None
        if self.mesh is not None:
            lows, lengths, n, cap, ns = self._shard_pool(
                initial_regions, partitions_per_axis)
        elif initial_regions is not None:
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
        if fused and split_past_16d:
            # the fused phase would evaluate the whole bucket, >= 1024
            # regions of points an iteration (174 GB at 20D in f64)
            fused_loop.stats["split_past_16d"] += 1
        elif (fused and not predict_split and not vegas_assisted
                and recorder is None):
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
                    phase, ns, recorder)
            return self._integrate_scalar(
                integrand, epsrel, epsabs, eps_work, apv, global_lo,
                global_range, tables, lows, lengths, n, cap,
                relerr_classification, max_iterations, ledger, deadline,
                phase, crease_split, predict_split, assist, ns, recorder)
        finally:
            if phase is not None:
                phase.close()

    def _shard_pool(self, initial_regions, partitions_per_axis):
        """This rank's initial shard (reference ``workspace.py:1446-1475``):
        the regions (``initial_regions``, or the uniform split) dealt
        contiguously in order, shard k taking ``deal(n, D)[k]`` of them
        into a capacity ``cap_s = max(next_pow2(max(counts)),
        chunk_size)``, padded with region 0.  Returns (lows, lengths, n,
        cap_s, counts)."""
        ndim, dtype, device = self.ndim, self.dtype, self.device
        if initial_regions is not None:
            lows0 = torch.as_tensor(initial_regions[0], dtype=dtype,
                                    device=device).T
            lengths0 = torch.as_tensor(initial_regions[1], dtype=dtype,
                                       device=device).T
        else:
            parts = partitions_per_axis or default_partitions_per_axis(ndim)
            lows0, lengths0, _ = region_pool.uniform_split(
                ndim, parts, parts ** ndim, dtype, device)
        n = int(lows0.shape[1])
        counts = pmesh.deal(n, self.mesh.size())
        cap_s = max(region_pool.next_pow2(max(counts)), self.chunk_size)
        k = self.mesh.get_local_rank()
        start, c = sum(counts[:k]), counts[k]

        def shard(a):
            return torch.cat([a[:, start:start + c],
                              a[:, :1].expand(ndim, cap_s - c)], dim=1)

        return shard(lows0), shard(lengths0), n, cap_s, counts

    def _past(self, deadline) -> bool:
        """Whether ``deadline`` has passed; on a mesh whether it has on any
        rank (a MAX all-reduce), so that every rank stops together."""
        if deadline is None:
            return False
        past = time.monotonic() >= deadline
        if self.mesh is None:
            return past
        flag = torch.tensor([float(past)], dtype=torch.float64,
                            device=self.device)
        return bool(pmesh.all_reduce_max(self.mesh, flag)[0] > 0)

    def _pool_record(self, lows, lengths, n_loc, blocked, cap):
        """``final_pool``: (lows, lengths, n, blocked) on one device; on a
        mesh ("mesh", lows, lengths, n, cap_s, blocked), the rank's shard
        and count (``make_checkpoint`` gathers the shards)."""
        if self.mesh is None:
            return (lows, lengths, n_loc, blocked)
        return ("mesh", lows, lengths, n_loc, cap, blocked)

    def _survivors(self, active, n_active: int) -> tuple[int, int]:
        """(this shard's survivors, the next per-shard capacity): on one
        device the survivors' own; on a mesh from the hottest shard's count
        (reference ``workspace.py:1842-1853``), gathered as every shard's."""
        if self.mesh is None:
            n_loc = hottest = n_active
        else:
            n_loc = int((active > 0).sum())
            hottest = int(pmesh.gather_counts(self.mesh, n_loc,
                                              self.device).max())
        return n_loc, max(region_pool.next_pow2(2 * hottest),
                          self.chunk_size)

    def _integrate_scalar(
        self, integrand, epsrel, epsabs, eps_work, apv, global_lo,
        global_range, tables, lows, lengths, n, cap, relerr_classification,
        max_iterations, ledger, deadline, phase, crease_split, predict_split,
        assist=None, ns=None, recorder=None,
    ) -> IntegrationResult:
        """The adaptive loop of a scalar integrand from its initial pool:
        the reference's host loop (Workspace.cuh:148-358), with the fused
        phase's bursts (``phase``, None for none) where the pool is
        blocked and under the gate.  On a mesh ``n`` is the global count,
        ``ns`` the shards' and the pool this rank's shard (``n_loc``)."""
        dtype, device, mesh = self.dtype, self.device, self.mesh
        n_loc = n if ns is None else int(ns[mesh.get_local_rank()])
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
        lay = ({} if phase is None
               else {k: i for i, k in enumerate(phase.layout())})

        it = cum.iters
        while True:
            if it >= max_iterations or self._past(deadline):
                exhausted = True
                break
            if n <= 0:
                break

            if phase is not None and blocked and 2 * n <= phase.gate:
                self.peak_capacity = max(self.peak_capacity, cap)
                lows, lengths, parent_est, sdim_f, frac_f, packed = phase.run(
                    lows, lengths, n_loc, parent_est, cum_est=cum.estimate,
                    cum_err=cum.errorest, result_nregions=result_nregions,
                    iters=cum.iters, neval=cum.neval,
                    hist=classifier._estimates, max_iters=max_iterations,
                    n_glob=n)
                n = int(packed[lay["n"]])
                n_loc = n if mesh is None else int(packed[lay["n_local"]])
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
                    lows, lengths, n_loc = region_pool.split(
                        lows, lengths, sdim_f, n_loc, out_capacity=2 * cap,
                        frac=frac_f)
                    n = 2 * n
                    cap = 2 * cap
                    use_refine = True
                    blocked = True
                # a fused exit keeps no per-region errors: a continuation
                # slices the pool in its order
                self.final_pool = self._pool_record(lows, lengths, n_loc,
                                                    True, cap)
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

            t_iter = time.perf_counter()
            effective_relerr = relerr_classification
            if (predict_split and n <= 15_000_000 and it < 15
                    and result_nregions == 0):
                effective_relerr = False          # (Workspace.cuh:206-211)
            self.peak_capacity = max(self.peak_capacity, cap)
            eval_out = self._eval_pool(
                integrand, tables, lows, lengths, global_lo, global_range,
                n_loc, blocked, 1, crease_split)
            est_raw, err_raw, sdim = eval_out[:3]
            sfrac = eval_out[3] if crease_split else None
            if assist is not None:
                # the hybrid: the rule's split axes, the in-region VEGAS
                # estimates (reference: Sample.cuh:726-727)
                est_raw, err_raw = assist(lows, lengths, n, blocked, it)
            est, refined, active, scalars_d = iteration_math(
                effective_relerr, blocked, est_raw, err_raw, n_loc,
                parent_est, use_refine, eps_work,
                lengths=None if apv is None else lengths, abs_per_vol=apv)
            if predict_split and result_nregions == 0 and it == 15:
                # the pool snapshot (Workspace.cuh:244-248), with its layout
                self.last_snapshot = (lows, lengths, n, blocked)
            self.final_pool = self._pool_record(lows, lengths, n_loc,
                                                blocked, cap)
            self.final_pool_errors = (est, refined)
            # cumulative ledger EXCLUDING this sweep: resuming from
            # final_pool re-evaluates the pool
            self._ledger_excl_pool = (cum.estimate, cum.errorest,
                                      result_nregions, cum.iters, cum.neval)
            # the one host sync of the iteration (on a mesh, of the sums
            # over the shards)
            if mesh is not None:
                scalars_d = pmesh.all_reduce_sum(mesh, scalars_d)
            scalars = scalars_d.cpu().numpy()
            iter_est, iter_err, finished_est, finished_err = (
                float(scalars[0]), float(scalars[1]),
                float(scalars[2]), float(scalars[3]))
            n_active = int(scalars[4])
            cum.iters += 1
            cum.neval += n * feval
            if recorder is not None:
                recorder.record(
                    it=it, estimate=cum.estimate + iter_est,
                    errorest=cum.errorest + iter_err,
                    festimate=cum.estimate, ferrorest=cum.errorest,
                    nregions=n, fnregions=cum.nFinishedRegions,
                    time_ms=(time.perf_counter() - t_iter) * 1e3)

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
                active = region_pool.block_mask(cap, n_loc, blocked,
                                                device).to(dtype)
                finished_est = 0.0
                finished_err = 0.0
                n_active = n

            # -- memory-pressure heuristic classify (Workspace.cuh:76-118) --
            classification_necessary = not classifier.split_fits(n)
            if classifier.classification_criteria_met(n):
                hs = classifier.classify_ladder(
                    refined, region_pool.block_mask(cap, n_loc, blocked,
                                                    device),
                    n, iter_err, finished_err, cum.errorest, mesh=mesh)
                success = hs.pass_mem and hs.pass_errorest_budget
                if success:
                    active = hs.active_flags
                    kept = torch.stack([torch.sum(active * est),
                                        torch.sum(active * refined)])
                    if mesh is not None:
                        kept = pmesh.all_reduce_sum(mesh, kept)
                    kept = kept.cpu()
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

            n_act_loc, child_cap = self._survivors(active, n_active)
            cres = region_pool.compact(
                active, lows, lengths, sdim, est, refined,
                out_capacity=child_cap // 2, extra=sfrac)
            c_lows, c_lengths, c_sdim, parent_est = cres[:4]
            lows, lengths, n_loc = region_pool.split(
                c_lows, c_lengths, c_sdim, n_act_loc, out_capacity=child_cap,
                frac=cres[5] if crease_split else None)
            n = 2 * n_active
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
        max_iterations, ledger, deadline, phase=None, ns=None, recorder=None,
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
        component's estimate history.  On a mesh as ``_integrate_scalar``:
        ``n`` global, ``ns`` the shards' counts, this rank's shard."""
        dtype, device, mesh = self.dtype, self.device, self.mesh
        n_loc = n if ns is None else int(ns[mesh.get_local_rank()])
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

        lay = ({} if phase is None
               else {k: i for i, k in enumerate(phase.layout())})

        def comps(name):
            return np.array([packed[lay[f"{name}{k}"]]
                             for k in range(ncomp)], dtype=np.float64)

        it = cum.iters
        while True:
            if it >= max_iterations or self._past(deadline):
                exhausted = True
                break
            if n <= 0:
                break

            if phase is not None and blocked and 2 * n <= phase.gate:
                self.peak_capacity = max(self.peak_capacity, cap)
                lows, lengths, parent_est, sdim_f, _, packed = phase.run(
                    lows, lengths, n_loc, parent_est, cum_est=cum_est,
                    cum_err=cum_err, result_nregions=result_nregions,
                    iters=cum.iters, neval=cum.neval,
                    hist=classifier._estimates, max_iters=max_iterations,
                    n_glob=n)
                n = int(packed[lay["n"]])
                n_loc = n if mesh is None else int(packed[lay["n_local"]])
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
                    lows, lengths, n_loc = region_pool.split(
                        lows, lengths, sdim_f, n_loc, out_capacity=2 * cap)
                    n = 2 * n
                    cap = 2 * cap
                    use_refine = True
                    blocked = True
                self.final_pool = self._pool_record(lows, lengths, n_loc,
                                                    True, cap)
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

            t_iter = time.perf_counter()
            self.peak_capacity = max(self.peak_capacity, cap)
            est_raw, err_raw, sdim = self._eval_pool(
                integrand, tables, lows, lengths, global_lo, global_range,
                n_loc, blocked, ncomp)
            est, refined, active, scalars_d = iteration_math_vector(
                relerr_classification, blocked, est_raw, err_raw, n_loc,
                parent_est, use_refine, eps_work,
                lengths=None if apv is None else lengths, abs_per_vol=apv)
            # the live pool and this sweep's per-region component arrays,
            # for checkpoints; the ledger EXCLUDES this sweep
            self.final_pool = self._pool_record(lows, lengths, n_loc,
                                                blocked, cap)
            self.final_pool_errors = (est, refined)
            self._ledger_excl_pool = (cum_est.copy(), cum_err.copy(),
                                      result_nregions, cum.iters, cum.neval)
            if mesh is not None:
                scalars_d = pmesh.all_reduce_sum(mesh, scalars_d)
            scalars = scalars_d.cpu().numpy()      # one transfer a sweep
            iter_est = scalars[0:ncomp]
            iter_err = scalars[ncomp:2 * ncomp]
            finished_est = scalars[2 * ncomp:3 * ncomp]
            finished_err = scalars[3 * ncomp:4 * ncomp]
            n_active = int(scalars[4 * ncomp])
            cum.iters += 1
            cum.neval += n * feval
            if recorder is not None:
                recorder.record(
                    it=it, estimate=float(cum_est[0] + iter_est[0]),
                    errorest=float(cum_err[0] + iter_err[0]),
                    festimate=float(cum_est[0]), ferrorest=float(cum_err[0]),
                    nregions=n, fnregions=cum.nFinishedRegions,
                    time_ms=(time.perf_counter() - t_iter) * 1e3)

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
                active = region_pool.block_mask(cap, n_loc, blocked,
                                                device).to(dtype)
                finished_est = np.zeros(ncomp)
                finished_err = np.zeros(ncomp)
                n_active = n

            classification_necessary = not classifier.split_fits(n)
            if classifier.classification_criteria_met(n):
                hs = classifier.classify_ladder(
                    _max_over_components(refined),
                    region_pool.block_mask(cap, n_loc, blocked, device), n,
                    float(iter_err[w]), float(finished_err[w]),
                    float(cum_err[w]), mesh=mesh)
                success = hs.pass_mem and hs.pass_errorest_budget
                if success:
                    flags = hs.active_flags
                    kept = torch.stack(
                        [torch.sum(flags * e) for e in est]
                        + [torch.sum(flags * r) for r in refined]
                    ).to(torch.float64)
                    if mesh is not None:
                        kept = pmesh.all_reduce_sum(mesh, kept)
                    kept = kept.cpu().numpy()
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

            n_act_loc, child_cap = self._survivors(active, n_active)
            c_lows, c_lengths, c_sdim, parent_est, _ = region_pool.compact(
                active, lows, lengths, sdim, est, refined,
                out_capacity=child_cap // 2)
            lows, lengths, n_loc = region_pool.split(
                c_lows, c_lengths, c_sdim, n_act_loc, out_capacity=child_cap)
            n = 2 * n_active
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
               and not self._past(deadline)):
            if self.final_pool is None:
                break
            ckpt = self.make_checkpoint()
            if ckpt.lows.shape[0] == 0:
                break
            if self.mesh is not None:
                # the continuation boundary: survivors dealt hot/cold
                # evenly across the shards
                ckpt = self._rebalance_checkpoint_for_mesh(ckpt)
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
                self._write_state(state_path, ContinuationState.from_queue(
                    work, _arr(ckpt.estimate), _arr(ckpt.errorest),
                    ckpt.iters, ckpt.neval, ckpt.nregions, ckpt.nregions,
                    np.ndim(ckpt.estimate) == 1, epsrel, epsabs))
        return res

    def _write_state(self, state_path, state=None):
        """Save ``state`` at ``state_path``, or remove the file when None.
        On a mesh rank 0 writes and every rank waits for it (an
        all-reduce), so that no rank reads the path before it is written."""
        if self.mesh is None or self.mesh.get_local_rank() == 0:
            path = npz_path(state_path)
            if state is not None:
                state.save(state_path)
            elif os.path.exists(path):
                os.remove(path)
        if self.mesh is not None:
            pmesh.all_reduce_sum(self.mesh, torch.zeros(
                1, dtype=torch.float64, device=self.device))

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
        banked and certified.

        With ``GPUINT_TPU_CONTINUATION_LOG`` set in the environment (the
        JAX package's variable, so that one setting logs both), each slice
        prints one line to stderr, the reference's."""
        log = os.environ.get("GPUINT_TPU_CONTINUATION_LOG")

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
            if not work or runs >= max_runs or self._past(deadline):
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
            if log:
                q_now = qsum(3)
                budget_now = np.maximum(epsrel * np.abs(fin_est + qsum(2)),
                                        epsabs)
                print(f"[continuation] slice {runs}/{max_runs}: "
                      f"n_in={lows_i.shape[0]} depth={depth} "
                      f"status={r_i.status} est={r_i.estimate:.6e} "
                      f"err={r_i.errorest:.3e} stored={s_err_i[wc]:.3e} "
                      f"requeued={requeued} queued={len(work)} "
                      f"banked_err={fin_err[wc]:.3e} "
                      f"total_err={float((fin_err + q_now)[wc]):.3e} "
                      f"budget={float(budget_now[wc]):.3e}",
                      file=sys.stderr, flush=True)
        if state_path is not None:
            # certified or drained: the file is spent
            self._write_state(state_path, None if status == 0 or not work
                              else ContinuationState.from_queue(
                                  work, fin_est, fin_err, iters, neval,
                                  nregions, nfinished, vec, epsrel, epsabs))
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
        if self.final_pool[0] == "mesh":
            lows, lengths, reg_est, reg_err = self._gather_pool()
        else:
            lows, lengths, n, blocked = self.final_pool
            keep = region_pool.block_mask(lows.shape[1], n, blocked,
                                          lows.device).nonzero()[:, 0]

            def host(a):
                return np.ascontiguousarray(a[..., keep].cpu().numpy().T)

            lows, lengths = host(lows), host(lengths)
            reg_est = reg_err = None
            if self.final_pool_errors is not None:
                reg_est, reg_err = (host(a) for a in self.final_pool_errors)
        return PaganiCheckpoint(
            lows=lows, lengths=lengths, estimate=est,
            errorest=err, nregions=nregions, iters=iters, neval=neval,
            region_estimates=reg_est, region_errorests=reg_err)

    def _gather_pool(self):
        """The mesh layout of ``make_checkpoint`` (reference
        ``workspace.py:2384-2412``): every shard's real regions, in rank
        order and each shard's two blocked halves in turn (the reference's
        global order), region-major on every rank.  Each rank writes its
        rows at its offset into a zero-filled (n_total, width) f64 buffer,
        which one SUM all-reduce completes (adding zeros is exact; every
        pool type widens to f64 exactly).  Returns (lows, lengths,
        region estimates, region errorests), the last two None where the
        run kept no per-region sweep."""
        mesh = self.mesh
        _, lows, lengths, n_loc, cap_s, blocked = self.final_pool
        ns = pmesh.gather_counts(mesh, n_loc, self.device)
        keep = region_pool.block_mask(cap_s, n_loc, blocked,
                                      lows.device).nonzero()[:, 0]
        parts = [lows, lengths]
        if self.final_pool_errors is not None:
            parts += [a if a.dim() == 2 else a[None]
                      for a in self.final_pool_errors]
        rows = torch.cat([a[:, keep] for a in parts]).T.to(torch.float64)
        offset = int(ns[:mesh.get_local_rank()].sum())
        buf = torch.zeros((int(ns.sum()), rows.shape[1]),
                          dtype=torch.float64, device=lows.device)
        buf[offset:offset + n_loc] = rows
        buf = pmesh.all_reduce_sum(mesh, buf).cpu().numpy()
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        ndim = self.ndim
        out = [np.ascontiguousarray(buf[:, :ndim].astype(np_dtype)),
               np.ascontiguousarray(buf[:, ndim:2 * ndim].astype(np_dtype))]
        if self.final_pool_errors is None:
            return out + [None, None]
        est = self.final_pool_errors[0]
        nc = 1 if est.dim() == 1 else est.shape[0]
        for k in range(2):
            a = buf[:, 2 * ndim + k * nc:2 * ndim + (k + 1) * nc]
            out.append(np.ascontiguousarray(
                (a[:, 0] if est.dim() == 1 else a).astype(np_dtype)))
        return out

    def _rebalance_checkpoint_for_mesh(self, ckpt):
        """``rebalance_checkpoint`` over this workspace's mesh (the
        checkpoint as it is on one device)."""
        if self.mesh is None:
            return ckpt
        return rebalance_checkpoint(ckpt, self.mesh.size())
