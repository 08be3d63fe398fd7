"""One-shot rule application over a caller-supplied region set (PyTorch
port of ``gpuintegration_tpu/pagani/oneshot.py``).

Re-expression of Cubature_rules::apply_cubature_integration_rules's public
overload (reference: cuda/pagani/quad/GPUquad/PaganiUtils.cuh:243-289):
apply the Genz-Malik rule once to every region and reduce -- the "forward
pass" of the reference's profiling path (call_cubature_rules,
new_time_and_call.cuh:30-70) and of callers who manage their own
subdivision.  The rule goes through ``rule_eval.apply_rule``: on the card
a Genz family takes the fused tile or generic kernel, any other callable
the split route's points and contraction kernels, a vector the components
contraction.

Also the per-evaluation capture of debug>=2 builds (quad::Func_Evals,
Func_Eval.cuh:8-64): points and integrand values for every (region,
rule-point) pair.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import _positional_arity, make_integrand
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.pagani.heuristics import apply_heuristic
from gpuintegration_torch.pagani.workspace import _resolve_device
from gpuintegration_torch.types import IntegrationResult, Volume

# The split route's chunk (and the plain version's) is sized as
# Workspace's default: ~256 MB of (chunk, feval) working values.
_CHUNK_BUDGET_BYTES = 256 * 1024 * 1024


def _default_chunk(tables, dtype) -> int:
    per_region = tables.feval_padded * (torch.finfo(dtype).bits // 8) * 4
    return max(min(region_pool.next_pow2(_CHUNK_BUDGET_BYTES // per_region)
                   // 2, 16384), 1024)


def _volume_tensors(vol: Volume, dtype, dev):
    gl = torch.as_tensor(np.asarray(vol.lows), dtype=dtype, device=dev)
    gr = torch.as_tensor(np.asarray(vol.highs) - np.asarray(vol.lows),
                         dtype=dtype, device=dev)
    return gl, gr


def apply_cubature_rules(
    integrand: Callable,
    lows,
    lengths,
    vol: Volume | None = None,
    *,
    ndim: int | None = None,
    dtype=torch.float64,
    compute_error: bool = True,
    device=None,
) -> tuple[IntegrationResult, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate the rule on regions (unit-space lows/lengths) mapped onto
    ``vol``; returns (result, per_region_estimates, per_region_errors,
    split_dims), the last three tensors on the device.  result.errorest is
    +inf when compute_error=False (PaganiUtils.cuh:280-288 parity).

    Accepts regions as (n, ndim) [user convention] or dims-major
    (ndim, n) [internal pool convention], told apart by the integrand's
    arity, its ``ndim`` attribute, or ``ndim``; a square array without
    them raises.  The split route and the plain version walk the regions
    in chunks of Workspace's default size."""
    dev = _resolve_device(device, "apply_cubature_rules")
    lows = torch.as_tensor(lows, dtype=dtype, device=dev)
    lengths = torch.as_tensor(lengths, dtype=dtype, device=dev)
    if ndim is None:
        # the integrand's arity is unambiguous; a shape heuristic like
        # min(shape) silently mis-orients e.g. 3 regions in 5-D
        arity = _positional_arity(integrand)
        if arity is not None and arity > 1:
            ndim = arity
        elif getattr(integrand, "ndim", None) is not None:
            ndim = int(integrand.ndim)
        elif lows.shape[0] == lows.shape[1]:
            raise ValueError("square region array: pass ndim explicitly")
        else:
            ndim = int(lows.shape[1])    # user convention: (n, ndim)
    if ndim not in lows.shape:
        raise ValueError(
            f"region array shape {tuple(lows.shape)} has no axis of "
            f"length ndim={ndim}")
    if lows.shape[0] != ndim:            # region-major input -> dims-major
        lows = lows.T
        lengths = lengths.T
    lows, lengths = lows.contiguous(), lengths.contiguous()
    n = lows.shape[1]
    _, ndim = make_integrand(integrand, ndim)
    if vol is None:
        vol = Volume(ndim=ndim)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    gl, gr = _volume_tensors(vol, dtype, dev)
    # the integrand itself, not its batched wrapper: the route on the card
    # is chosen by what it is (a Genz family takes the fused kernels)
    est, err, sdim = rule_eval.apply_rule(
        integrand, tables, lows, lengths, gl, gr,
        chunk_size=_default_chunk(tables, dtype))
    res = IntegrationResult(
        estimate=float(torch.sum(est)),
        errorest=float(torch.sum(err)) if compute_error else float("inf"),
        nregions=n,
        neval=n * tables.feval,
        status=-1,
    )
    return res, est, err, sdim


def classify_with_heuristic(
    heuristic_id: int,
    estimates,
    errorests,
    epsrel: float,
    epsabs: float = 1e-40,
    *,
    parent_estimates=None,
    parent_errorests=None,
    finished_estimate: float = 0.0,
    finished_errorest: float = 0.0,
    depth: int = 1,
    total_nregions: int | None = None,
    min_iter_reached: bool = True,
):
    """Phase-1 heuristic region classification over a one-shot evaluated
    pool: the caller runs ``apply_cubature_rules``, then this policy
    switch decides which regions terminate (the reference's
    quad::ApplyHeuristic placement, Phases.cuh:71-155).  Returns a boolean
    ``finished`` tensor on the estimates' device.

    ``parent_*`` default to the regions' own values (a root pool has no
    parents -- as the reference seeds parent arrays with the region's own
    result on the first pass)."""
    est = torch.as_tensor(estimates)
    err = torch.as_tensor(errorests, device=est.device)
    n = est.shape[0]
    sum_est = torch.sum(est)
    leaves = sum_est + finished_estimate
    queued_err = torch.sum(err)
    par_res = est if parent_estimates is None else torch.as_tensor(
        parent_estimates, device=est.device)
    par_err = err if parent_errorests is None else torch.as_tensor(
        parent_errorests, device=est.device)
    return apply_heuristic(
        heuristic_id, leaves, finished_estimate, sum_est,
        finished_errorest, queued_err, n,
        total_nregions if total_nregions is not None else n,
        bool(min_iter_reached), par_res, par_err, float(depth), est, err,
        epsrel, epsabs)


@dataclasses.dataclass
class FuncEvals:
    """Per-evaluation record battery (reference: Func_Eval.cuh:8-64 and
    the CSV printers in PaganiUtils.cuh:130-241), NumPy arrays."""

    points: np.ndarray       # (nregions, feval, ndim) evaluation points
    values: np.ndarray       # (nregions, feval) integrand values
    region_lows: np.ndarray  # (nregions, ndim) unit-space bounds
    region_lengths: np.ndarray

    def to_csv(self, outfile):
        nreg, feval, ndim = self.points.shape
        cols = ["reg", "fid"]
        cols += [f"dim{d}low" for d in range(ndim)]
        cols += [f"dim{d}high" for d in range(ndim)]
        cols += [f"dim{d}" for d in range(ndim)]
        cols += ["feval"]
        print(",".join(cols), file=outfile)
        for r in range(nreg):
            lo = self.region_lows[r]
            hi = lo + self.region_lengths[r]
            for p in range(feval):
                row = [str(r), str(p)]
                row += [f"{v:.17e}" for v in lo]
                row += [f"{v:.17e}" for v in hi]
                row += [f"{v:.17e}" for v in self.points[r, p]]
                row += [f"{self.values[r, p]:.17e}"]
                print(",".join(row), file=outfile)


def apply_cubature_rules_vector(
    integrand: Callable,
    lows,
    lengths,
    vol: Volume | None = None,
    *,
    ndim: int,
    ncomp: int,
    dtype=torch.float64,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vector-valued rule application: ``integrand`` maps (..., ndim) to
    (..., ncomp) and all components are integrated in one sweep over the
    shared point set (the cubacpp integrand_traits array<double,N> /
    vector<double> capability, integrand_traits.hh:81-93).  On the card
    the values take the components contraction of the split route.

    Returns (estimates (ncomp,), per-region estimates (R, ncomp)), NumPy."""
    dev = _resolve_device(device, "apply_cubature_rules_vector")
    lows = torch.as_tensor(lows, dtype=dtype, device=dev)
    lengths = torch.as_tensor(lengths, dtype=dtype, device=dev)
    if lows.shape[0] == ndim and lows.shape[1] != ndim:
        lows, lengths = lows.T, lengths.T    # accept dims-major pools
    if vol is None:
        vol = Volume(ndim=ndim)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    gl, gr = _volume_tensors(vol, dtype, dev)
    probe = integrand(torch.full((3, ndim), 0.5, dtype=dtype, device=dev))
    if probe.dim() != 2 or probe.shape[-1] != ncomp:
        raise ValueError(f"integrand returns {tuple(probe.shape)}, expected "
                         f"(..., {ncomp})")
    est, _, _ = rule_eval.apply_rule(
        integrand, tables, lows.T.contiguous(), lengths.T.contiguous(), gl,
        gr, ncomp=ncomp, chunk_size=_default_chunk(tables, dtype))  # (ncomp, R)
    per_region = est.T.cpu().numpy()                             # (R, ncomp)
    return per_region.sum(axis=0), per_region


def capture_func_evals(
    integrand: Callable,
    lows,
    lengths,
    vol: Volume | None = None,
    *,
    ndim: int | None = None,
    dtype=torch.float64,
    max_regions: int = 1024,
    device=None,
) -> FuncEvals:
    """Record every evaluation point and value for a (small) region set,
    (n, ndim) region-major -- the debug>=2 path of the reference
    (PaganiUtils.cuh:304-334 caps at 1024 regions too, :136).  The points
    are ``gl + (center - gen * len) * gr`` in f64, the reference's
    formula; the integrand runs on the device."""
    dev = _resolve_device(device, "capture_func_evals")
    lows = np.asarray(lows, np.float64)
    lengths = np.asarray(lengths, np.float64)
    n, nd = lows.shape
    if n > max_regions:
        raise ValueError(f"capture limited to {max_regions} regions")
    if ndim is None:
        ndim = nd
    f, ndim = make_integrand(integrand, ndim)
    if vol is None:
        vol = Volume(ndim=ndim)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    f64 = torch.float64
    gl, gr = _volume_tensors(vol, f64, dev)
    lo = torch.as_tensor(lows, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    gen = torch.as_tensor(tables.gen[:tables.feval], dtype=f64, device=dev)
    center = lo + 0.5 * ln
    x = gl + (center[:, None, :] - gen[None, :, :] * ln[:, None, :]) * gr
    vals = f(x.to(dtype))
    return FuncEvals(points=x.cpu().numpy(), values=vals.cpu().numpy(),
                     region_lows=lows, region_lengths=lengths)
