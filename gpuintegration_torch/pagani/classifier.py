"""Memory-pressure heuristic classifier (PyTorch port of
``gpuintegration_tpu/pagani/classifier.py``; Heuristic_classifier,
heuristic_classifier.cuh:147-452).

When the next 2x split would overflow the region-pool budget, search an
error threshold such that at most ``max_active_pct`` of regions stay
active and the error of the regions forcibly finished stays within
``max_budget_pct`` of the remaining error budget, relaxing both
percentages up to 0.7 when the search fails
(heuristic_classifier.cuh:392-438).  Also the estimate-convergence test by
significant-digit comparison of the last three iteration estimates
(heuristic_classifier.cuh:170-216).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class ClassificationResult:
    pass_mem: bool = False
    pass_errorest_budget: bool = False
    threshold: float = 0.0
    active_flags: torch.Tensor | None = None
    num_active: int = 0
    finished_errorest: float = 0.0


def _ladder_probe(errorests, mask, k: int) -> torch.Tensor:
    """A K-point geometric threshold ladder in one pass: for each candidate
    threshold, the active count and the error mass it would keep active.
    Returns a (3, K) f64 tensor [thresholds, counts, kept]."""
    dtype = errorests.dtype
    big = torch.tensor(float("inf"), dtype=dtype, device=errorests.device)
    # dtype-aware floors; lo spans POSITIVE errors only -- one exactly-zero
    # valid error would otherwise spread the rungs over ~300 decades
    tiny = float(torch.finfo(dtype).tiny)
    eps = float(torch.finfo(dtype).eps)
    pos = mask & (errorests > 0)
    lo_raw = torch.min(torch.where(pos, errorests, big))
    lo = torch.clamp(torch.where(torch.isfinite(lo_raw), lo_raw,
                                 torch.full_like(lo_raw, tiny)), min=tiny)
    hi = torch.maximum(torch.max(torch.where(mask, errorests, -big)),
                       lo * (1 + 8 * eps))
    log_lo = torch.log(lo * (1 - 8 * eps))
    log_hi = torch.log(hi)
    # jnp.linspace's arithmetic, so the rungs equal the reference's:
    # start*(1-t) + stop*t for t = i/(k-1), i < k-1, then stop itself
    t = torch.arange(k - 1, dtype=dtype, device=errorests.device) / (k - 1)
    rungs = torch.cat([log_lo * (1 - t) + log_hi * t, log_hi[None]])
    ts = torch.exp(rungs)
    active_k = (errorests[None, :] > ts[:, None]) & mask[None, :]
    # counts/masses in f64: an f32 count is even-rounded above 2^24
    counts = torch.sum(active_k, dim=1).to(torch.float64)
    err_masked = torch.where(mask, errorests,
                             torch.zeros_like(errorests)).to(torch.float64)
    kept = torch.sum(torch.where(active_k, err_masked[None, :],
                                 torch.zeros_like(err_masked)[None, :]), dim=1)
    return torch.stack([ts.to(torch.float64), counts, kept])


def _flags_for_threshold(errorests, mask, threshold):
    return ((errorests > threshold) & mask).to(errorests.dtype)


def _threshold_probe(errorests, mask, threshold):
    """flags = (err > threshold) & mask, plus their count
    (heuristic_classifier.cuh:61-87, 283-303)."""
    flags = _flags_for_threshold(errorests, mask, threshold)
    return flags, torch.sum(flags.to(torch.float64))


def _budget_probe(errorests, flags):
    """dot(flags, err): the error mass the threshold keeps active."""
    return torch.sum(errorests * flags)


class HeuristicClassifier:
    """Stateful threshold search: host logic over device probes."""

    def __init__(self, epsrel: float, epsabs: float,
                 max_pool_regions: int):
        self.epsrel = epsrel
        self.epsabs = epsabs
        self.max_pool_regions = max_pool_regions
        self.required_digits = math.ceil(math.log10(1.0 / epsrel)) \
            if epsrel > 0 else 15
        self._estimates = [0.0, 0.0, 0.0]
        self._iters_collected = 0
        self.min_iters_for_convergence = 1

    # -- estimate-convergence bookkeeping (heuristic_classifier.cuh:218-225)
    def store_estimate(self, estimate: float):
        self._estimates = [self._estimates[1], self._estimates[2],
                           float(estimate)]
        self._iters_collected += 1

    def sig_digits_same(self) -> bool:
        """Digit-string comparison of the last three estimates
        (heuristic_classifier.cuh:170-203)."""
        vals = [abs(v) for v in self._estimates]
        if any(not math.isfinite(v) for v in vals):
            return False  # NaN/inf estimates never count as converged
        strs = []
        for v in vals:
            while v != 0.0 and v < 1.0:
                v *= 10
            strs.append(f"{v:.15f}")
        min_len = min(len(s) for s in strs)
        current, last, second_to_last = strs[2], strs[1], strs[0]
        verdict = True
        sig = 0
        i = 0
        while (i < min(self.required_digits + 1, min_len)
               and sig < self.required_digits and verdict):
            verdict = (current[i] == last[i] == second_to_last[i])
            if verdict and current[i] != '.':
                sig += 1
            i += 1
        return verdict

    def estimate_converged(self) -> bool:
        if self._iters_collected - 1 < self.min_iters_for_convergence:
            return False
        return self.sig_digits_same()

    # -- memory model: pool capacity instead of raw bytes ------------------
    def split_fits(self, num_regions: int) -> bool:
        return 2 * num_regions <= self.max_pool_regions

    def classification_criteria_met(self, num_regions: int) -> bool:
        """(heuristic_classifier.cuh:348-360): classify when the split
        cannot fit, or when it is getting close (>10% of budget) and the
        estimate has converged."""
        ratio = (2.0 * num_regions) / self.max_pool_regions
        if ratio > 1.0:
            return True
        return ratio > 0.1 and self.estimate_converged()

    # -- the search (batched ladder; default) --------------------------------
    def classify_ladder(
        self,
        errorests: torch.Tensor,   # (cap,) refined two-level errors
        mask: torch.Tensor,        # (cap,) bool validity mask
        num_regions: int,
        iter_errorest: float,
        iter_finished_errorest: float,
        total_finished_errorest: float,
        k: int = 64,
    ) -> ClassificationResult:
        """The threshold search over a geometric ladder, one device pass
        and one host transfer.  Relaxation schedule as the reference
        (heuristic_classifier.cuh:425-437): error budget 0.25 -> 0.65 in
        0.1 steps first, then active share 0.5 -> 0.7."""
        table = _ladder_probe(errorests, mask, k).cpu().numpy()
        ts, counts, kept = table[0], table[1], table[2]
        # budget = max(epsrel*|est|, epsabs), matching accuracy_reached
        target_error = max(abs(self._estimates[2]) * self.epsrel, self.epsabs)
        error_budget = target_error - total_finished_errorest
        extra = iter_errorest - kept - iter_finished_errorest   # (K,)
        pct_active = counts / num_regions
        # HARD pool bound on top of the reference's percentage schedule:
        # the 2x split of the survivors must fit the region budget
        split_fits = 2.0 * counts <= self.max_pool_regions

        res = ClassificationResult()
        for active_pct in (0.5, 0.6, 0.7):
            for budget_pct in (0.25, 0.35, 0.45, 0.55, 0.65):
                ok = (pct_active <= active_pct) & split_fits & \
                     (extra <= budget_pct * error_budget) & (counts > 0)
                if ok.any():
                    # smallest qualifying threshold finishes the least error
                    i = int(np.argmax(ok))
                    res.pass_mem = True
                    res.pass_errorest_budget = True
                    res.threshold = float(ts[i])
                    res.num_active = int(counts[i])
                    res.finished_errorest = float(extra[i])
                    res.active_flags = _flags_for_threshold(
                        errorests, mask,
                        torch.tensor(ts[i], dtype=errorests.dtype,
                                     device=errorests.device))
                    return res
        res.pass_mem = bool((pct_active <= 0.7).any())
        res.pass_errorest_budget = False
        return res

    # -- the search (reference-style bisection) -----------------------------
    def classify(
        self,
        errorests: torch.Tensor,
        mask: torch.Tensor,
        num_regions: int,
        iter_errorest: float,
        iter_finished_errorest: float,
        total_finished_errorest: float,
    ) -> ClassificationResult:
        res = ClassificationResult()
        max_budget_pct = 0.25
        max_active_pct = 0.5   # (heuristic_classifier.cuh:156-157)

        masked = torch.where(mask, errorests,
                             torch.full_like(errorests, float("nan")))
        masked_np = masked.cpu().numpy()
        lo = float(np.nanmin(masked_np))
        hi = float(np.nanmax(masked_np))
        threshold = iter_errorest / num_regions
        rng_lo, rng_hi = lo, hi
        target_error = max(abs(self._estimates[2]) * self.epsrel, self.epsabs)

        num_inc = num_dec = 0
        best_flags = None
        while True:
            # grow threshold until the active share fits the pool
            # (get_larger_threshold_results, heuristic_classifier.cuh:327-346)
            attempts = 0
            pass_mem = False
            while not pass_mem and attempts < 20:
                flags, n_act = _threshold_probe(errorests, mask, threshold)
                n_act = float(n_act)
                pct = n_act / num_regions
                pass_mem = (pct <= max_active_pct
                            and 2.0 * n_act <= self.max_pool_regions)
                if not pass_mem:
                    rng_lo = threshold
                    threshold += abs(rng_hi - threshold) * 0.5
                attempts += 1
            num_inc += attempts

            if pass_mem:
                best_flags = flags
                res.num_active = int(n_act)
                # error-budget check (evaluate_error_budget,
                # heuristic_classifier.cuh:305-325)
                active_err = float(_budget_probe(errorests, flags))
                extra_f_err = (iter_errorest - active_err
                               - iter_finished_errorest)
                error_budget = target_error - total_finished_errorest
                pass_budget = extra_f_err <= max_budget_pct * error_budget
                res.finished_errorest = extra_f_err
                if pass_budget:
                    res.pass_mem = True
                    res.pass_errorest_budget = True
                    res.threshold = threshold
                    res.active_flags = flags
                    return res
                rng_hi = threshold
                threshold -= abs(threshold - rng_lo) * 0.5
                num_dec += 1

            exhausted = num_dec >= 20 or num_inc >= 20
            if exhausted and max_budget_pct < 0.7:
                max_budget_pct += 0.1
                num_inc = num_dec = 0
                rng_lo, rng_hi = lo, hi
                threshold = iter_errorest / num_regions
            elif exhausted and max_budget_pct >= 0.7 and max_active_pct <= 0.7:
                max_active_pct += 0.1
                num_inc = num_dec = 0
                rng_lo, rng_hi = lo, hi
                threshold = iter_errorest / num_regions
            elif exhausted:
                break

        res.pass_mem = False
        res.pass_errorest_budget = False
        res.active_flags = best_flags
        return res
