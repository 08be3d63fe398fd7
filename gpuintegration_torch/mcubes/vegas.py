"""mcubes: VEGAS (importance sampling + stratification) on one device
(PyTorch port of ``gpuintegration_tpu/mcubes/vegas.py``; reference:
cuda/mcubes/vegasT.cuh:644-1021 ``vegas``, kernels vegas_kernel:401-490 and
vegas_kernelF:492-619).

  CUDA thread = chunkSize stratified sub-cubes  -> one thread per sub-cube in
                                                   the sampler kernel
                                                   (mcubes/cuda_vegas.py)
  per-cube reseeded Custom_generator LCG        -> the Philox stream keyed on
                                                   (seed; cube, iteration,
                                                   slot) (mcubes/stream.py)
  atomicAdd histogram d[bin,dim]                -> the deterministic histogram
                                                   kernel (mcubes/cuda_lookup.py)
  atomicAdd of block-reduced fb/f2b             -> ordered f64 block sums
  host-side xi/d round trip + smoothing + rebin -> the same, in NumPy
                                                   (mcubes/grid.py), or on
                                                   the device in f32
                                                   (refine='device')

The cube axis is processed in chunks of ``chunk_cubes`` cubes by a Python
loop, so device memory is bounded by the chunk size whatever ``ncall`` is.
An iteration of the host loop accumulates (ti, tsi) and the histogram on
the device and is read by the host once, in one transfer.

The frozen iterations, and under ``refine='device'`` the adjusting ones
too, run as the reference's device-resident phases (``_frozen_phase``,
``_adjust_phase``; mcubes/phases.py): the iteration-weighted combination
and the convergence test stay on the device, and on the card a phase
expected to run long replays one iteration as a CUDA graph.  A frozen
phase gives the host loop's iterations, neval and estimate bits; with a
``debug_logger`` (as in the reference) every iteration runs through the
host loop.

A vector-valued integrand, f: (..., ndim) -> (..., ncomp), runs on both
maps and the 'torch' and 'hybrid' samplers: (ncomp,) accumulators, the grid
adapted to component 0 (CUBA's multi-component VEGAS), status 0 only when
every component passes.

``mesh=`` (``parallel.mesh.make_mesh``; the reference's ``_mesh_iteration``,
``vegas.py:668-716``, and the mesh forms of its phases) runs the same
driver on D ranks: rank i samples the global chunks [i num_chunks, (i + 1)
num_chunks) of a lattice cut into ``ceil(ncubes / D)`` cubes a rank, and
ti, tsi and the f32 histogram are SUM-all-reduced each iteration, in the
host loop and inside the phases alike.  Every rank then refines its own
copy of the grid (or re-fits the map) from the same reduced values, so the
grids stay replicated bit for bit.  The draws are keyed on the global cube
id, so a mesh run draws the single-device run's samples when the chunks
match.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import (_positional_arity, deduce_ncomp,
                                            make_integrand)
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import grid as vgrid
from gpuintegration_torch.mcubes import phases, stream
from gpuintegration_torch.mcubes.cuda_lookup import HIST_CAP as _HIST_CAP
from gpuintegration_torch.mcubes.poly_importance import (
    eval_map_and_weight, fit_importance_poly, fit_importance_poly_device)
from gpuintegration_torch.ops import cuda_rule, integrand_gen
from gpuintegration_torch.parallel import mesh as pmesh
from gpuintegration_torch.types import IntegrationResult, Volume
from gpuintegration_torch.utils.stats import chi2_prob

SAMPLERS = ("torch", "fused", "hybrid")
# activations of one chunk, (chunk, npg, ndim) values in a few copies
CHUNK_BYTES_BUDGET = 1024 * 1024 * 1024
DEFAULT_MAX_CHUNK = 1 << 20


def compute_ncubes(ncall: float, ndim: int) -> tuple[int, int]:
    """(ng, ncubes): stratification intervals per axis and total sub-cubes
    (reference: vegasT.cuh:708-720, vegas_utils.cuh:180-190)."""
    ng = max(int((ncall / 2.0 + 0.25) ** (1.0 / ndim)), 1)
    return ng, ng ** ndim


def samples_per_cube(ncall: float, ncubes: int) -> int:
    """(vegas_utils.cuh:192-197)."""
    return max(int(ncall / ncubes), 2)


def get_status(estimate, errorest, iteration, epsrel, epsabs) -> int:
    """0 = converged (needs >= 5 iterations), 1 = not
    (vegas_utils.cuh:225-248).  A zero estimate (e.g. a peak so narrow
    every f64 sample underflows) can only converge through epsabs."""
    if estimate == 0.0:
        ok = errorest <= epsabs
    else:
        ok = (abs(errorest / estimate) <= epsrel) or (errorest <= epsabs)
    return 0 if (ok and iteration >= 5) else 1


def adjust_params(ncall: float, total_iters: int) -> tuple[float, int, bool]:
    """Escalation schedule for extended runs (vegas_utils.cuh:272-296)."""
    if ncall >= 8e9 and total_iters >= 100:
        return ncall, total_iters, False
    if ncall >= 8e9:
        return ncall, total_iters + 10, True
    if ncall >= 1e9:
        return ncall + 1e9, total_iters, True
    return ncall * 10.0, total_iters, True


_decode_cube = stream.decode_cube


def _hist_accum(d, chunk_hist):
    """Add one chunk's adaptation histogram, saturating at HIST_CAP
    (cuda_lookup.HIST_CAP note): the JAX package's ``_hist_accum``, which
    ``cuda_lookup.hist_accum`` and ``hist_accum_plain`` compute."""
    return torch.clamp(d + chunk_hist, max=_HIST_CAP)


def _cube_sums(fx, valid, npg: int):
    """[sum over cubes of fb, of f2b] for per-sample values fx (C, npg), or
    a vector integrand's component-major (ncomp, C, npg), in the
    accumulator type: fb = sum fx, and the per-cube variance proxy
    sqrt(sum f^2 * npg) -> (s-fb)(s+fb) = npg*sum(f^2) - fb^2 with TINY
    floor (vegasT.cuh:382-387).  ``valid`` (C,) masks the cubes beyond the
    lattice, or is None when the chunk has none.  Returns (sums (2,) or
    (2, ncomp), f2 of the histogram: component 0's for a vector, as CUBA
    adapts the grid to it)."""
    if valid is not None:
        fx = torch.where(valid[:, None], fx, torch.zeros_like(fx))
    f2 = fx * fx
    fb = torch.sum(fx, dim=-1)
    s = torch.sqrt(torch.sum(f2, dim=-1) * npg)
    f2b = (s - fb) * (s + fb)
    f2b = torch.where(f2b <= 0.0, torch.full_like(f2b, vgrid.TINY), f2b)
    if valid is not None:
        f2b = torch.where(valid, f2b, torch.zeros_like(f2b))
    return (torch.stack([torch.sum(fb, dim=-1), torch.sum(f2b, dim=-1)]),
            f2 if fx.dim() == 2 else f2[0])


def _component_major(raw, ncomp: int):
    """A vector integrand's values (..., ncomp) as a contiguous (ncomp,
    ...) copy, the layout the accumulators reduce and the histogram takes
    component 0 from; a scalar's as they are."""
    return raw if ncomp == 1 else raw.movedim(-1, 0).contiguous()


def _chunk_valid(c: int, chunk_cubes: int, ncubes: int, device):
    """(first global cube id, validity mask or None) of chunk ``c``."""
    cube0 = c * chunk_cubes
    if cube0 + chunk_cubes <= ncubes:
        return cube0, None
    ids = cube0 + torch.arange(chunk_cubes, dtype=torch.int64, device=device)
    return cube0, ids < ncubes


def _vegas_iteration(
    f,
    ndim: int,
    ng: int,
    npg: int,
    chunk_cubes: int,
    num_chunks: int,
    nbins: int,
    accumulate_hist: bool,
    dtype,
    seed: int,
    iteration: int,
    xi,           # (ndim, nbins+1) tensor
    regn_lo,      # (ndim,)
    dx,           # (ndim,)
    xjac: float,  # prod(dx)/calls
    ncubes: int,
    *,
    eval_dtype=None,
    plain: bool = False,
    bits=None,
    ncomp: int = 1,
    chunk0: int = 0,
):
    """One full VEGAS iteration with the grid map (importance='grid').

    Returns (sums, d): ``sums`` the (2,) tensor [ti, tsi_raw] in ``dtype``
    ((2, ncomp) for a vector integrand, ``ncomp`` > 1)
    (tsi_raw must still be scaled by dv2g on the host, vegasT.cuh:849-851)
    and ``d`` the (ndim, nbins) f32 f^2 histogram (zeros when
    ``accumulate_hist`` is False).

    The bin resolve and the histogram are the kernels of
    mcubes/cuda_lookup.py on a CUDA grid and their plain versions on a CPU
    grid; ``plain=True`` takes the plain versions on any device.  The
    sampling machinery is f32 as in the reference: the estimator is
    unbiased as long as coordinates and weight derive from the SAME table
    values.  ``eval_dtype``: type the integrand is EVALUATED in
    (accumulators stay in ``dtype``).  ``iteration`` is the absolute
    iteration index of the stream: a host integer, or a 0-d integer tensor
    on the grid's device (the device-resident phases' counter, which the
    kernels read on the card); ``bits`` ((npg*ndim, chunk_cubes) words,
    single-chunk iterations only) replaces the stream.  ``chunk0``: the
    first global chunk (a mesh rank's), of ``num_chunks``.
    """
    ed = eval_dtype or dtype
    f32 = torch.float32
    dev = xi.device
    xi32 = xi.to(f32).contiguous()
    xnd32 = torch.full((), float(nbins), dtype=f32, device=dev)
    sums = torch.zeros((2,) + ((ncomp,) if ncomp > 1 else ()), dtype=dtype,
                       device=dev)
    d = torch.zeros((ndim, nbins), dtype=f32, device=dev)
    lo_col, dx_col = regn_lo[:, None], dx[:, None]
    for c in range(chunk0, chunk0 + num_chunks):
        cube0, valid = _chunk_valid(c, chunk_cubes, ncubes, dev)
        # stratified + importance point (Setup_Integrand_Eval,
        # vegasT.cuh:188-235): xn in [1, nbins+1), bin ia, position inside
        resolve = (cuda_lookup.bin_resolve_stratified_plain if plain
                   else cuda_lookup.bin_resolve_stratified)
        rc, xo, ia = resolve(xi32, nbins, ng, npg, chunk_cubes, cube0,
                             ncubes, seed, iteration,
                             with_ia=accumulate_hist, bits=bits)
        if ed == dtype:
            x = lo_col + rc.to(dtype) * dx_col                  # (ndim, N)
            wgt = xjac * torch.prod((xo * xnd32).to(dtype), dim=0)
        else:
            # f32 eval path: point arithmetic and the importance-weight
            # product stay in f32 (rc is f32-granular either way); only
            # the per-cube/global accumulation below is in ``dtype``
            x = lo_col.to(ed) + rc.to(ed) * dx_col.to(ed)
            wgt = xjac * torch.prod(xo * xnd32, dim=0).to(dtype)
        fx = (_component_major(f(x.T).to(dtype), ncomp) * wgt).reshape(
            -1, chunk_cubes, npg)
        chunk_sums, f2 = _cube_sums(fx if ncomp > 1 else fx[0], valid, npg)
        sums = sums + chunk_sums
        if accumulate_hist:
            # deterministic replacement for atomicAdd(&d[bin,dim], f^2)
            # (vegasT.cuh:309-313); the histogram only steers grid
            # adaptation, so f32 suffices.  ia is 1-based.
            accum = (cuda_lookup.hist_accum_plain if plain
                     else cuda_lookup.hist_accum)
            d = accum(d, ia, f2, nbins, base=1)
    return sums, d


def _vegas_iteration_poly(
    f,
    integrand,
    ndim: int,
    ng: int,
    npg: int,
    chunk_cubes: int,
    num_chunks: int,
    nbins: int,
    accumulate_hist: bool,
    dtype,
    seed: int,
    iteration: int,
    p_coeffs,     # (ndim, kp) f32: importance map P per dim, Cheb series
    q_coeffs,     # (ndim, kq) f32: q per dim; P' = q^2
    regn_lo,      # (ndim,)
    dx,           # (ndim,)
    xjac: float,
    ncubes: int,
    *,
    eval_dtype=None,
    sampler: str = "torch",
    bits=None,
    ncomp: int = 1,
    chunk0: int = 0,
):
    """One full VEGAS iteration with the polynomial inverse-CDF map
    (mcubes.poly_importance).  Same stratification, accumulators,
    histogram and returns as ``_vegas_iteration``; coordinates and weights
    come from Chebyshev recurrences instead of grid lookups.

    ``sampler='torch'``: the plain PyTorch chunk body (the reference's
    'xla'): unit-space map in f32, then x = lo + P(s) dx in the evaluation
    type, histogram by ``hist_accum_plain``.  ``'fused'`` (the reference's
    'pallas'): the whole chunk body in the sampler kernel
    (cuda_vegas.sample_chunk), the integrand ``integrand`` being a Genz
    family or a traced per-axis callable evaluated in f32.  ``'hybrid'``:
    the kernel runs only the sampling machinery and emits f32 coordinates
    and weights; the batched callable ``f`` is evaluated here in the
    evaluation type with per-cube accumulation in ``dtype``.  On a CPU device 'fused' and 'hybrid' take
    the kernels' plain versions.  ``ncomp`` > 1: a vector integrand on
    'torch' or 'hybrid', (2, ncomp) sums, the histogram of component 0.
    ``chunk0``: the first global chunk, as ``_vegas_iteration``'s."""
    ed = eval_dtype or dtype
    f32 = torch.float32
    dev = p_coeffs.device
    sums = torch.zeros((2,) + ((ncomp,) if ncomp > 1 else ()), dtype=dtype,
                       device=dev)
    d = torch.zeros((ndim, nbins), dtype=f32, device=dev)
    pmap = (cuda_vegas.fold_map(p_coeffs, q_coeffs, regn_lo, dx)
            if sampler != "torch" else None)
    for c in range(chunk0, chunk0 + num_chunks):
        cube0, valid = _chunk_valid(c, chunk_cubes, ncubes, dev)
        if sampler == "fused":
            chunk_sums, ia, f2 = cuda_vegas.sample_chunk(
                pmap, integrand, ng, npg, chunk_cubes, nbins,
                accumulate_hist, xjac, cube0, ncubes, seed, iteration,
                bits=bits)
            sums = sums + chunk_sums.to(dtype)
            if accumulate_hist:
                d = cuda_lookup.hist_accum(d, ia, f2, nbins)
            continue
        if sampler == "hybrid":
            xs, wt, ia = cuda_vegas.sample_chunk(
                pmap, None, ng, npg, chunk_cubes, nbins, accumulate_hist,
                xjac, cube0, ncubes, seed, iteration, bits=bits,
                emit_points=True)
            # integrand evaluation in the evaluation type on the emitted
            # dims-major f32 coordinates
            fx = _component_major(f(xs.to(ed).T).to(dtype), ncomp) * (
                wt.to(dtype) * xjac)
            accum = cuda_lookup.hist_accum
        else:
            cube = cube0 + torch.arange(chunk_cubes, dtype=torch.int64,
                                        device=dev)
            kg = _decode_cube(cube, ng, ndim)                    # (C, ndim)
            if bits is None:
                words = stream.stream_bits(seed, iteration, cube, npg, ndim)
            else:
                words = bits
            ran = stream.bits_to_uniform(words).reshape(
                npg, ndim, chunk_cubes).permute(2, 0, 1)         # (C, npg, ndim)
            # stratified position in [0,1): s = (kg - ran)/ng
            s = (kg[:, None, :].to(f32) - ran) * (1.0 / ng)
            rc, wgt_imp = eval_map_and_weight(p_coeffs, q_coeffs, s)
            if ed == dtype:
                x = regn_lo + rc.to(dtype) * dx
            else:
                x = regn_lo.to(ed) + rc.to(ed) * dx.to(ed)
            fx = _component_major(f(x).to(dtype), ncomp) * (
                xjac * wgt_imp.to(dtype))
            if accumulate_hist:
                ia = torch.clamp((s * nbins).to(torch.int32), 0, nbins - 1)
            accum = cuda_lookup.hist_accum_plain
        fx = fx.reshape(-1, chunk_cubes, npg)
        chunk_sums, f2 = _cube_sums(fx if ncomp > 1 else fx[0], valid, npg)
        sums = sums + chunk_sums
        if accumulate_hist:
            d = accum(d, ia, f2, nbins)
    return sums, d


@dataclasses.dataclass
class VegasState:
    """Checkpointable integrator state: the grid plus the iteration-weighted
    accumulators (si, swgt, schi) -- the analogue of the reference's
    host-resident xi + si/swgt/schi scalars (vegasT.cuh:679-706).

    A vector integrand's run holds (ncomp,) arrays in si, swgt and schi.

    ``it0`` counts iterations already folded into the accumulators: a
    resumed run puts ``it0 + it`` into the stream's counter, so
    continuation iterations draw samples INDEPENDENT of the prior run's --
    replaying the same streams would re-add bit-identical (ti, tsi) pairs
    as if they were new information, halving the reported variance for
    free."""
    xi: torch.Tensor
    si: float | np.ndarray = 0.0
    swgt: float | np.ndarray = 0.0
    schi: float | np.ndarray = 0.0
    it0: int = 0
    # iterations actually ACCUMULATED into si/swgt/schi across segments
    # (skip windows excluded): the chi^2/dof denominator on resume
    n_acc: int = 0


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vegas runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


def _kernel_twin(integrand, ndim: int | None = None):
    """What the fused sampler evaluates for ``integrand``: a Genz family
    (models.genz) itself, a scalar-per-axis callable f(x0, ..., x{n-1})
    its trace (``integrand_gen.traced``, the reference's ``f_axes`` in its
    Pallas kernel).  ValueError naming sampler='hybrid' for any other
    callable, or a per-axis one that does not trace."""
    if cuda_rule.is_genz_family(integrand) or cuda_rule.is_generated(
            integrand):
        return integrand
    arity = _positional_arity(integrand)
    if arity is None or arity < 2:
        raise ValueError(
            "sampler='fused' evaluates the integrand inside the CUDA "
            "kernel: a Genz family (gpuintegration_torch.models.genz) or a "
            "scalar-per-axis callable f(x0, ..., x{n-1}) that traces "
            "(ops/integrand_gen.py); pass sampler='hybrid' for any other "
            "callable")
    return integrand_gen.traced(integrand, arity if ndim is None else ndim)


def _has_kernel_twin(integrand) -> bool:
    try:
        _kernel_twin(integrand)
    except ValueError:
        return False
    return True


def _resolve_sampler(sampler, importance: str, device_type: str, eval_dtype,
                     integrand, ncomp: int = 1):
    """The sampler a run takes (see ``vegas``): for the grid map None (the
    kernels on the card) or 'torch'; for the poly map one of SAMPLERS,
    AUTO choosing by device, evaluation type and integrand ('hybrid' for
    a vector integrand, or a callable that neither is a Genz family nor
    traces, on the card).  An explicit 'fused' on such a callable raises
    ValueError naming 'hybrid'."""
    if importance == "grid":
        if sampler not in (None, "torch"):
            raise ValueError(
                f"sampler={sampler!r} needs importance='poly'; the grid map "
                "takes None (the bin-resolve and histogram kernels on the "
                "card) or 'torch' (their plain versions)")
        return sampler
    if sampler is None:
        if device_type != "cuda":
            return "torch"
        if (eval_dtype == torch.float32 and ncomp == 1
                and _has_kernel_twin(integrand)):
            return "fused"
        return "hybrid"
    if sampler not in SAMPLERS:
        raise ValueError(
            f"sampler {sampler!r}: 'torch', 'fused' or 'hybrid'")
    if sampler == "fused" and ncomp > 1:
        raise ValueError(
            "sampler='fused' evaluates a scalar integrand inside the CUDA "
            f"kernel; a vector integrand ({ncomp} components) takes "
            "sampler='hybrid' (or 'torch')")
    if sampler == "fused":
        _kernel_twin(integrand)
    return sampler


def vegas(
    integrand: Callable,
    epsrel: float = 1e-3,
    epsabs: float = 1e-12,
    ncall: float = 1e6,
    vol: Volume | None = None,
    *,
    ndim: int | None = None,
    total_iters: int = 15,
    adjust_iters: int = 15,
    skip_iters: int = 5,
    seed: int = 0,
    dtype=torch.float64,
    chunk_cubes: int | None = None,
    state: VegasState | None = None,
    nbins: int = vgrid.NDMX,
    debug_logger=None,
    importance: str | None = None,
    poly_degree: int = 14,
    eval_dtype=None,
    refine: str = "host",
    mesh=None,
    sampler: str | None = None,
    eval_cost: float = 1.0,
    device=None,
) -> IntegrationResult:
    """Full m-CUBES run: ``adjust_iters`` grid-adjustment iterations followed
    by frozen-grid iterations up to ``total_iters`` (vegasT.cuh:789-1001),
    with the iteration-weighted combination and chi^2 consistency measure.

    ``device``: None or "cuda" runs on the card and raises if there is
    none; "cpu" runs every route through the kernels' plain versions.

    ``importance``: 'grid' evaluates the importance map by table lookup
    (reference parity); 'poly' uses the polynomial inverse-CDF
    (mcubes.poly_importance) -- identical statistics (unbiased for any
    monotone map), marginally less optimal variance on extremely peaked
    integrands.  Default (None) is 'poly', as in the reference.  On the
    card the grid map always goes through the bin-resolve and histogram
    kernels (unless ``sampler='torch'``).

    ``eval_dtype``: type the integrand is EVALUATED in (default: same as
    ``dtype``); accumulators and the weighted combination stay in
    ``dtype``.  Sample coordinates are f32-granular on every path.

    ``refine``: 'host' refines the grid in exact-f64 NumPy every adjustment
    iteration (vegasT.cuh:797-846 round trip).  'device' runs every
    adjustment iteration in the device-resident adjustment phase
    (mcubes/phases.py): the same streams, combination and convergence test,
    the grid rebinned in f32 on the device
    (``pagani.vegas_assisted._refine_grids``) and, for the poly map, p and
    q re-fitted there (``fit_importance_poly_device``); the grid evolves in
    f32, which moves variance only (any monotone map is unbiased).  The
    grid leaves the phase cast to ``dtype``; the frozen phase's map is
    fitted on the host from it.  It refuses ``debug_logger``.

    The frozen iterations run as the device-resident frozen phase
    (mcubes/phases.py), as the reference's do unless ``debug_logger`` is
    given, which runs every iteration through the host loop: one read an
    iteration either way, the host loop's iterations, neval and estimate
    bits.  On the card a phase expected to run ``phases.GRAPH_MIN_ITERS``
    more iterations after its first replays one iteration as a CUDA graph,
    the kernels reading the iteration from a counter on the card
    (``sampler='torch'`` never captures).  An integrand that a graph cannot
    hold (one that reads the card from the host) then raises RuntimeError;
    pass ``sampler='torch'``.

    ``sampler`` (importance='poly'), with the reference's names beside:
    'torch' = the reference's 'xla', the plain PyTorch chunk body;
    'fused' = 'pallas', the whole chunk body in the CUDA sampler kernel,
    integrand in f32 -- needs a Genz family (models.genz) or a
    scalar-per-axis callable f(x0, ..., x{n-1}) that traces into the
    kernel (ops/integrand_gen.py: elementwise arithmetic, exp, log, sin,
    cos, tan, tanh, sqrt, abs, expm1, log1p, minimum, maximum, where over
    comparisons, clamp, number and 0-d tensor constants), any other
    callable raises ValueError; 'hybrid' = 'hybrid', the kernel emits
    points and weights and the integrand, any batched torch callable, is
    evaluated in ``eval_dtype``.  Default (None) is AUTO: on the card
    'fused' when ``eval_dtype`` is float32 and the integrand has a kernel
    twin (a Genz family, or a per-axis callable that traces), else
    'hybrid'; on the CPU 'torch'.  The kernel loops
    over the samples of a cube at run time and carries cube ids in 64
    bits, so AUTO never leaves the kernels for a large npg or lattice.
    With importance='grid' only None and 'torch' are accepted.  All
    samplers and both maps draw the same Philox stream (mcubes/stream.py):
    a fixed seed repeats bitwise, on the card and on the CPU alike.

    ``eval_cost`` is accepted and ignored: the reference uses it to keep
    one device dispatch under a ceiling of its remote runtime, which has
    no counterpart here.

    A vector integrand (..., ncomp) integrates every component on one
    sample set, the grid adapted to component 0; the result carries
    ``estimates``, ``errorests`` and ``probs`` (ncomp,), ``estimate`` and
    ``errorest`` component 0's, ``chi_sq`` and ``prob`` the largest over
    the components, and status 0 only when every component passes.

    ``mesh``: a 1-D ``torch.distributed`` mesh (``parallel.mesh.make_mesh``);
    every rank makes the same call on its device (``device`` must be that
    device or None), samples its ``ceil(ncubes / D)`` cubes in chunks of
    ``chunk_cubes`` (by default sized against that share) and returns the
    same result.  On the card the phases capture a graph only when the
    group's backend is NCCL.
    """
    mesh = pmesh.check_mesh(mesh)
    if refine not in ("host", "device"):
        raise ValueError(f"refine {refine!r}: 'host' or 'device'")
    if refine == "device" and debug_logger is not None:
        raise ValueError("refine='device' fuses the adjustment phase; "
                         "per-iteration capture needs refine='host'")
    if mesh is None:
        dev = _resolve_device(device)
    else:
        dev = pmesh.mesh_device(mesh)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device} but this rank's mesh device "
                             f"is {dev}; pass device=None with a mesh")
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype {dtype} (float64 or float32)")
    f, ndim = make_integrand(integrand, ndim)
    if vol is None:
        vol = Volume(ndim=ndim)
    ed = eval_dtype if eval_dtype is not None else dtype
    ncomp = deduce_ncomp(f, ndim, dtype, dev)

    ng, ncubes = compute_ncubes(ncall, ndim)
    npg = samples_per_cube(ncall, ncubes)
    calls = float(npg) * float(ncubes)
    dv2g = (calls * (1.0 / ng) ** ndim) ** 2 / npg / npg / (npg - 1.0)
    xjac = (1.0 / calls) * vol.jacobian

    # the cubes a rank samples (reference vegas.py:1113-1124)
    n_dev = 1 if mesh is None else mesh.size()
    shard_cubes = -(-ncubes // n_dev)
    if chunk_cubes is None:
        # bound (chunk, npg, ndim) activations; a power of two
        per_cube = npg * ndim * torch.finfo(dtype).bits // 8 * 6
        budget = max(CHUNK_BYTES_BUDGET // per_cube, 1024)
        chunk_cubes = 1 << (int(budget).bit_length() - 1)
        chunk_cubes = int(min(chunk_cubes, DEFAULT_MAX_CHUNK))
        if chunk_cubes >= shard_cubes:
            chunk_cubes = shard_cubes  # single chunk: exact size, no padding
    num_chunks = -(-shard_cubes // chunk_cubes)     # a rank's
    chunk0 = 0 if mesh is None else mesh.get_local_rank() * num_chunks

    if nbins < 2:
        raise ValueError("nbins must be >= 2 (grid adjustment "
                         "redistributes mass between bins)")
    st = state or VegasState(xi=vgrid.uniform_grid(ndim, nbins, dtype, dev))
    if tuple(st.xi.shape) != (ndim, nbins + 1):
        raise ValueError(
            f"state grid has shape {tuple(st.xi.shape)}; expected ({ndim}, "
            f"{nbins + 1}) -- pass nbins={st.xi.shape[1] - 1} to match it")
    xi = vgrid.as_numpy(st.xi)          # refined on the host
    si, swgt, schi = st.si, st.swgt, st.schi
    if ncomp > 1 and np.ndim(si) == 0:
        si, swgt, schi = np.zeros(ncomp), np.zeros(ncomp), np.zeros(ncomp)
    it_offset = int(st.it0)
    acc_prior = int(st.n_acc)

    if importance is None:
        importance = "poly"
    if importance not in ("grid", "poly"):
        raise ValueError(f"importance {importance!r}: 'grid' or 'poly'")
    sampler = _resolve_sampler(sampler, importance, dev.type, ed, integrand,
                               ncomp)
    # the integrand the fused kernel evaluates: a Genz family, or a traced
    # per-axis callable
    twin = _kernel_twin(integrand, ndim) if sampler == "fused" else integrand

    regn_lo = torch.as_tensor(vol.lows, dtype=dtype, device=dev)
    dx = torch.as_tensor(vol.highs - vol.lows, dtype=dtype, device=dev)
    res = IntegrationResult(status=1)
    tgral = sd = chi2a = 0.0 if ncomp == 1 else np.zeros(ncomp)

    def iterate(word, accumulate_hist, xi_t, p_t, q_t):
        """One iteration on the stream of counter ``word`` (the phases')."""
        if importance == "poly":
            return _vegas_iteration_poly(
                f, twin, ndim, ng, npg, chunk_cubes, num_chunks, nbins,
                accumulate_hist, dtype, seed, word, p_t, q_t, regn_lo, dx,
                xjac, ncubes, eval_dtype=ed, sampler=sampler, ncomp=ncomp,
                chunk0=chunk0)
        return _vegas_iteration(
            f, ndim, ng, npg, chunk_cubes, num_chunks, nbins, accumulate_hist,
            dtype, seed, word, xi_t, regn_lo, dx, xjac, ncubes, eval_dtype=ed,
            plain=sampler == "torch", ncomp=ncomp, chunk0=chunk0)

    def refit(xi32):
        p, q = fit_importance_poly_device(xi32.to(torch.float64),
                                          poly_degree)
        return p.to(torch.float32), q.to(torch.float32)

    phase_kw = dict(capture=dev.type == "cuda" and sampler != "torch",
                    dv2g=dv2g, skip_iters=skip_iters, epsrel=epsrel,
                    epsabs=epsabs, mesh=mesh)

    def run_phase(phase, end_it, **maps):
        """A device-resident phase from iteration ``it``: the run's counts
        and accumulators advanced as the host loop's would be."""
        nonlocal it, si, swgt, schi, tgral, sd, chi2a
        it_next, si_a, swgt_a, schi_a, done, xi_out = phase.run(
            it, end_it, it_offset, si, swgt, schi, **maps)
        res.neval += int(calls) * (it_next - it)
        res.iters += it_next - it
        it = it_next
        if ncomp == 1:
            si, swgt, schi = float(si_a[0]), float(swgt_a[0]), float(
                schi_a[0])
        else:
            si, swgt, schi = si_a, swgt_a, schi_a
        if it - 1 > skip_iters:
            # the host loop's readout of its last accumulating iteration
            tgral = si / swgt
            chi2a = np.maximum(
                (schi - si * tgral)
                / max(acc_prior + it - 1 - skip_iters - 0.9999, 1e-4), 0.0)
            sd = np.sqrt(1.0 / swgt)
        res.status = 0 if done else 1
        return xi_out

    it = 1
    if refine == "device" and min(adjust_iters, total_iters) > 0:
        xi32 = run_phase(
            phases.Phase(iterate, adjust=True, label="adjustment",
                         refit=refit if importance == "poly" else None,
                         **phase_kw),
            min(adjust_iters, total_iters),
            xi=torch.as_tensor(xi, dtype=torch.float32, device=dev))
        xi = vgrid.as_numpy(xi32.to(dtype))

    while it <= total_iters and res.status == 1:
        adjusting = it <= adjust_iters
        if (not adjusting and debug_logger is None
                and phases.FORM != "host"):
            # the remaining iterations in the device-resident frozen phase
            if importance == "poly":
                p_np, q_np = fit_importance_poly(xi, poly_degree)
                maps = {"p": torch.as_tensor(p_np, dtype=torch.float32,
                                             device=dev),
                        "q": torch.as_tensor(q_np, dtype=torch.float32,
                                             device=dev)}
            else:
                maps = {"xi": torch.as_tensor(xi, dtype=dtype, device=dev)}
            run_phase(phases.Phase(iterate, adjust=False, **phase_kw),
                      total_iters, **maps)
            break
        stream_it = it_offset + it      # fresh streams on resume
        if dev.type == "cuda":
            # the kernels read the iteration word from a counter on the card
            stream_it = stream.counter(stream_it, dev)
        if importance == "poly":
            p_np, q_np = fit_importance_poly(xi, poly_degree)
            sums, d = _vegas_iteration_poly(
                f, twin, ndim, ng, npg, chunk_cubes, num_chunks, nbins,
                adjusting, dtype, seed, stream_it,
                torch.as_tensor(p_np, dtype=torch.float32, device=dev),
                torch.as_tensor(q_np, dtype=torch.float32, device=dev),
                regn_lo, dx, xjac, ncubes, eval_dtype=ed, sampler=sampler,
                ncomp=ncomp, chunk0=chunk0)
        else:
            sums, d = _vegas_iteration(
                f, ndim, ng, npg, chunk_cubes, num_chunks, nbins, adjusting,
                dtype, seed, stream_it,
                torch.as_tensor(xi, dtype=dtype, device=dev), regn_lo, dx,
                xjac, ncubes, eval_dtype=ed, plain=sampler == "torch",
                ncomp=ncomp, chunk0=chunk0)
        if mesh is not None:
            # the ranks' partial sums, and the f32 histogram in f32 as the
            # reference's psum adds it
            sums = pmesh.all_reduce_sum(mesh, sums)
            if adjusting:
                d = pmesh.all_reduce_sum(mesh, d)
        # one D2H read per iteration: [ti, tsi] and, while adjusting, the
        # histogram (f32 -> f64 is exact)
        f64 = torch.float64
        parts = [sums.to(f64).reshape(-1)] + (
            [d.to(f64).reshape(-1)] if adjusting else [])
        out = torch.cat(parts).cpu().numpy()
        if ncomp == 1:
            ti, tsi = float(out[0]), float(out[1])
        else:
            ti, tsi = out[:ncomp].copy(), out[ncomp:2 * ncomp].copy()
        d_np = out[2 * ncomp:].reshape(ndim, nbins) if adjusting else None
        if adjusting:
            # grid refinement on host in exact f64, like the reference's
            # per-iteration xi/d round trip (vegasT.cuh:797-927); ~32 KB
            xi = vgrid.smooth_and_refine(xi, d_np)
        tsi = tsi * dv2g
        res.neval += int(calls)

        if it > skip_iters:
            wgt = 1.0 / tsi
            si = si + wgt * ti
            schi = schi + wgt * ti * ti
            swgt = swgt + wgt
            tgral = si / swgt
            # dof excludes the skip window (vegasT.cuh:859 divides by
            # it - 0.9999 while accumulating only when it > skip)
            chi2a = np.maximum(
                (schi - si * tgral)
                / max(acc_prior + it - skip_iters - 0.9999, 1e-4), 0.0)
            sd = np.sqrt(1.0 / swgt)
            # every component must pass (CUBA's multi-component semantics)
            res.status = max(get_status(float(t), float(e), it, epsrel,
                                        epsabs)
                             for t, e in zip(np.atleast_1d(tgral),
                                             np.atleast_1d(sd)))
        if debug_logger is not None:
            # per-iteration capture (IterDataLogger parity,
            # verbose_utils.cuh:22-181)
            debug_logger.record(
                it=it, ti=ti, tsi=tsi, tgral=tgral, sd=sd, chi2a=chi2a,
                xi=np.array(xi, copy=True), d=d_np)
        res.iters += 1
        it += 1

    st.xi = torch.as_tensor(xi, dtype=dtype, device=dev)
    st.si, st.swgt, st.schi = si, swgt, schi
    st.it0 = it_offset + res.iters
    st.n_acc = acc_prior + max(res.iters - skip_iters, 0)
    # chi-squared probability (cubacpp integration_result::prob): the
    # stored chi2a is per-dof with the reference's (it - 0.9999) divisor
    # (vegasT.cuh:859), so the total is recovered with the SAME
    # (n_acc - 0.9999) factor; dof = n_acc - 1 is only the CDF's degrees
    # of freedom.
    dof = float(st.n_acc - 1)
    chi2_factor = max(float(st.n_acc) - 0.9999, 0.0)
    if ncomp == 1:
        res.estimate = float(tgral)
        res.errorest = float(sd)
        res.chi_sq = float(chi2a)
        res.prob = chi2_prob(res.chi_sq * chi2_factor, dof)
    else:
        res.estimates = np.asarray(tgral, float).copy()
        res.errorests = np.asarray(sd, float).copy()
        res.probs = np.asarray([chi2_prob(float(c) * chi2_factor, dof)
                                for c in np.atleast_1d(chi2a)], float)
        res.estimate = float(res.estimates[0])
        res.errorest = float(res.errorests[0])
        res.chi_sq = float(np.max(chi2a))
        res.prob = float(np.max(res.probs))
    res.lastPhase = 1 if it > adjust_iters else 0
    return res


def integrate(integrand, epsrel=1e-3, epsabs=1e-12, ncall=1e6, vol=None,
              total_iters=15, adjust_iters=15, skip_iters=5, **kw):
    """Parity wrapper for cuda_mcubes::integrate (vegasT.cuh:1023-1054)."""
    return vegas(integrand, epsrel, epsabs, ncall, vol,
                 total_iters=total_iters, adjust_iters=adjust_iters,
                 skip_iters=skip_iters, **kw)


def simple_integrate(integrand, epsrel=1e-3, epsabs=1e-12, ncall=1e6,
                     vol=None, total_iters=15, adjust_iters=15,
                     skip_iters=5, **kw):
    """Retry loop escalating ncall/iterations until convergence or the
    8e9-call / 100-iteration caps (vegasT.cuh:1100-1135,
    vegas_utils.cuh:272-296)."""
    while True:
        res = vegas(integrand, epsrel, epsabs, ncall, vol,
                    total_iters=total_iters, adjust_iters=adjust_iters,
                    skip_iters=skip_iters, **kw)
        if res.status == 0:
            return res
        ncall, total_iters, can_continue = adjust_params(ncall, total_iters)
        if not can_continue:
            return res
