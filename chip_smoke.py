"""Smoke run of gpuintegration_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources, holds each against its plain
PyTorch version, drives PAGANI's ``Workspace.integrate`` at 8D (a Genz
family through the fused rule kernel, a plain callable through the split
route), its ``integrate_to_convergence`` at 8D and 1e-5, the VEGAS
``mcubes.integrate`` at 6D and the differentiable estimates of
``gpuintegration_torch.diff`` at 6D through them, and times them.  Imports
no JAX.  Phases (any failure exits non-zero and prints no result line; each
prints its seconds):

The rule kernel, the sampler, the histogram, the bin resolve and the edge
lookup each have two routes, chosen by the shape: the one built for this
card ('tile', 'paired', 'grouped', 'sample', 'vector') and the generic one,
which is the earlier design.  The main paths must go through the first; the
generic routes are held against the first and the plain versions, and
timed beside the others in the same run.

1. the card's name and power limit; the nvcc builds (all sources started
   together), their seconds and ptxas's registers and spills; the
   instruction counts of the kernels' loops (tools/sass_report.py) where
   the toolkit has cuobjdump;
2. rule kernel vs plain version on the card
   (ops.kernel_check.check_against_plain, printed beside its limits):
   F1-F6 at 8D through the tile route, a pool of 2^16 regions (uniform
   split plus random sub-regions, blocked layout with padding slots), f64
   and f32, and the two routes against each other (split_dim EQUAL, each
   route twice the same bits); the generic route at 9D and 2D, which the
   tile route does not take;
3. the PAGANI main path: ``Workspace(8).integrate(f4_gaussian(8),
   epsrel=1e-3)`` in f64 (status 0 and |est - truth|/truth <= 1e-3
   required, every launch through the tile route; the kernel's share of
   the wall from CUDA events), then the same in f32 (reported only), each
   final pool held against the plain version, and a 3D run on the card
   against the same run on the CPU; the last pool timed on both routes;
4. rule kernel time at 8D on 2^21 regions, both routes, f64 and f32, best
   of 5 (CUDA events), beside the plain version's;
5. the VEGAS kernels vs their plain versions on the card
   (mcubes.kernel_check, printed beside its limits) at the shapes of the
   6D ncall = 1e8 run, one chunk of 2^20 cubes: the sampler (paired
   route, and the two routes against each other: bin ids EQUAL) in emit and
   fused mode, with and without histogram, uniforms from a tensor and
   from the stream, on the lattice's last chunk (its last cubes beyond
   the lattice) and on the chunk at the volume's centre; the generator
   word for word on both routes; the paired kernel and the plain version
   against an f64 evaluation where f^2 and the sum of f2b are hardest to
   read; the generic route at 9D, degree 8, which the paired route does
   not take; histogram, bin resolve and edge lookup at 500 and 50 bins;
   both routes of the histogram (each against the plain version, twice
   the same bits, the accumulating form from bins near the cap) and of the
   bin resolve (rc, xo, ia EQUAL between the routes, drawing xn at the
   centre and at the lattice's end, and given xn over a ragged row) and of
   the edge lookup (EQUAL to the plain version and to each other, on
   random ids, on ids off a 16-byte boundary and on a chunk's stratified
   ids);
6. the VEGAS main path, 6D Genz F4 (a = 25), epsabs 1e-40: (1) the
   default ``integrate(f, epsrel=1e-3, ncall=1e8)`` (f64, poly map,
   sampler 'hybrid'); (2) ``eval_dtype=float32, ncall=1e9, total_iters=10,
   adjust_iters=5`` (sampler 'fused'); (3) ``importance='grid',
   ncall=1e8``.  Each must end status 0 with |est - truth| <= 5 errorest
   and errorest/|est| <= epsrel, having launched its kernels (counts set
   to 0 before and read after each run), the sampler's all through the
   paired route, the histogram's through the grouped route, the bin
   resolve's through the sample route; run 1 repeated must give the same
   bits; run 3 repeated on the generic lookups says whether its estimate
   is the grouped run's and the one of the tree before the lookups' new
   routes (commit 756fd3a); run 2 repeated
   with CUDA events around every launch says what the events cost and what
   share of the wall the launches are; a 3D run on the card must agree with the same run on the
   CPU;
7. the VEGAS kernels' times at the main path's shapes, the sampler, the
   histogram (accumulating, as the main paths call it), the bin resolve
   (drawing xn, and given xn) and the edge lookup (a chunk's stratified ids
   and uniformly random ids) on both routes in turns, best of 5 series of
   launches back to back (``queued_ms``), beside the plain versions', a
   bound, and one PyTorch call computing the same function where there is
   one;
8. the diff path, 6D, 500 bins, gauss(x, a) = exp(-a sum (x - 1/2)^2) at
   a = 25: ``train_grid`` (ncall 1e7, 10 adjusting iterations, sampler and
   histogram by their card routes); ``frozen_grid_estimate`` on 2^24
   samples (within 5 errorests of the closed form), its ``torch.func.grad``
   (within 5 % of dI/da and 1e-5 of the common-random-number central
   difference), a ``vmap`` over 4 thetas (the loop's numbers within
   1e-12), the edge lookups counted (set to 0 before and read after; all
   by the vector route, one inside ``grad`` at least) and timed at this
   shape; ``fixed_mesh_integral`` on 6^6 regions (estimate within 1e-9 and
   gradient within 1e-7 of the closed forms: the JAX package reads
   2.0e-11 and 2.7e-9 there on the CPU); the checkpoint pipeline, a 3D
   ``Workspace`` run, ``make_checkpoint``, ``mesh_from_checkpoint``,
   ``fixed_mesh_integral``;
9. the rule's split route (any torch callable: the points kernel, the
   callable, the contraction kernel; csrc/rule_split.cu) against its plain
   version (ops.kernel_check.check_split_against_plain): 8D pools of 2^16
   regions, blocked with padding slots, f64 and f32, ``misc.sin_sum(8)``,
   ``misc.g_function(8)`` and Genz F4 as a plain batched and a per-axis
   callable; ``misc.gauss9d()`` at 9D and ``misc.diagonal_ridge_2d()``
   in their volumes.  Points EQUAL (bits and strides), values EQUAL,
   est/err/split_dim by kernel_check's limits; a NaN region takes the
   widest axis; ``misc.oscillatory(8)`` on the split route against
   ``f1_oscillatory(8, ones)`` on the tile route within 1e-12;
10. the two split kernels alone at the Workspace's 8D f64 chunk (4096
   regions), best of 5 series back to back (``queued_ms``), beside their
   bytes bounds, their plain versions, ``torch.addcmul`` (the points) and
   ``torch.matmul`` against the TPU kernel's column matrix (the rule sums
   only);
11. PAGANI's main path with Genz F4 as a plain callable
   (``Workspace(8).integrate(f4_plain, 1e-3)``, f64): status 0 within 1e-3
   of the truth, every rule evaluation through the split kernels (counts
   set to 0 before and read after), beside phase 3's run, with CUDA events
   around each launch and call for the shares of the points kernel, the
   callable, the contraction kernel and the rest; then ``misc.sin_sum(8)``
   at 1e-11;
12. the continuation, the reference's flagship:
   ``Workspace(8).integrate_to_convergence(f4_gaussian(8), 1e-5,
   max_wall_s=600)`` (status 0 within 1e-5 of the truth; wall, rounds,
   slices, stage times), which at the 16M-region pool budget certifies in
   round 1; the same at a budget of 2^22 regions (``CONT_POOL``), where
   round 1 walls and the partitioned continuation must carry the run; then
   that continuation stopped before its first slice, saved
   (``state_path``) and resumed from the file, which must give the
   uninterrupted run's estimate, errorest and neval;
13. the ``kernels`` JSON line, then the card line and the result line.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from gpuintegration_torch import Workspace, diff, mcubes
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import kernel_check as vegas_check
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import (cuda_build, cuda_rule, kernel_check,
                                      rule_eval)
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.tools import sass_report
from gpuintegration_torch.utils.profiling import StageTimer

NDIM = 8
# H100 SXM data sheet, dense, outside the tensor cores; HBM3 rate.
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def ops_per_point(kind: int, ndim: int) -> int:
    """Arithmetic operations per rule point, counted from the kernel's code
    (csrc/rule_eval.cu genz_value): 2 to form x_d, the family's per-axis
    work, its finish, and 1 to add the value into its orbit sum.  A
    transcendental (exp, cos) counts as ONE operation, so the bound built
    from this count is a lower bound."""
    per_axis = {1: 2, 2: 4, 3: 2, 4: 4, 5: 3, 6: 3}[kind]
    e = ndim + 1
    finish = {1: 2, 2: 1, 3: 2 + e.bit_length() + bin(e).count("1"),
              4: 2, 5: 2, 6: 1}[kind]
    return ndim * (2 + per_axis) + finish + 1


EPILOGUE_OPS = 250   # rule sums, fourth differences, error model, per region


def bound_ms(kind: int, ndim: int, n: int, dtype) -> tuple[float, str]:
    feval = rule_eval.rule_tables(ndim).feval
    ops = n * (feval * ops_per_point(kind, ndim) + EPILOGUE_OPS)
    item = torch.finfo(dtype).bits // 8
    nbytes = n * (2 * ndim * item + 2 * item + 4)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def f64_pipe_floor_ms(ndim: int, n: int, f64_per_point: float) -> float:
    """The least time the f64 pipe alone needs for a pool on the tile
    route, given the f64 instructions the machine code spends on a rule
    point (``tile_f64_per_point``): each occupies the pipe as a
    multiply-add does, two operations a lane at the peak rate that
    ``bound_ms`` uses.  The operation bound counts the exp as one operation
    and so lies below this floor."""
    feval = rule_eval.rule_tables(ndim).feval
    return 1e3 * n * feval * f64_per_point * 2 / PEAK_OPS[torch.float64]


TILE_POINTS_PER_PASS = 2     # rule_tile_kernel keeps two points in flight


def tile_f64_per_point(kernels) -> float | None:
    """f64 instructions per rule point in rule_tile_kernel<4, double, 8>,
    from this build's machine code (``sass_report.report``): those of its
    most deeply nested loop, the pass over two points of an orbit.  None
    where there is no report."""
    for name, _, found in kernels or ():
        if "rule_tile_kernel<4, double, 8>" in name and found:
            _, counts = max(found, key=lambda lc: lc[0])
            return counts["f64"] / TILE_POINTS_PER_PASS
    return None


def random_pool(ndim, cap, seed, dtype, dev):
    """``cap`` regions: random sub-boxes of the 2-per-axis uniform split."""
    parents_lo, parents_len, n0 = region_pool.uniform_split(
        ndim, 2, 2 ** ndim, torch.float64)
    rng = np.random.default_rng(seed)
    pick = np.arange(cap) % n0
    frac = rng.uniform(2.0 ** -6, 1.0, (ndim, cap))
    off = rng.uniform(0.0, 1.0, (ndim, cap)) * (1.0 - frac)
    plen = parents_len.numpy()[:, pick]
    lows = parents_lo.numpy()[:, pick] + off * plen
    return (torch.as_tensor(lows, dtype=dtype, device=dev).contiguous(),
            torch.as_tensor(frac * plen, dtype=dtype, device=dev).contiguous())


def time_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` single calls, CUDA events, after one warm call.
    The time from one event to the next holds the host's time to reach the
    launch: a kernel of less than a millisecond is timed by ``queued_ms``."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return "ptxas reported no register counts"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers per "
            f"thread, at most {max(spills, default=0)} spill bytes")


_blocker = []


def queued_ms(fn, reps: int, inner: int = 20) -> float:
    """Time of one call of ``fn`` on the device alone, for a kernel so
    short that the host takes longer to launch it than the card to run it:
    best of ``reps`` series of ``inner`` calls, CUDA events around a series.
    A matrix product of some milliseconds is enqueued first, so that the
    host has every call of the series in the queue before the card is free
    to begin, and the calls run back to back."""
    if not _blocker:
        _blocker.append(torch.zeros((6144, 6144), device="cuda"))
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(_blocker[0], _blocker[0])
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def compare_routes(label, *args, **kw):
    """kernel_check.check_routes, printed on one line; a disagreement
    fails the run."""
    try:
        r = kernel_check.check_routes(*args, **kw)
    except AssertionError as e:
        fail(str(e))
    print(f"{label}: tile vs generic route, {r['slots']} slots: split_dim "
          f"EQUAL, each route twice the same bits; max|d est| "
          f"{r['est_rel']:.3g}, max|d err| {r['err_rel']:.3g} of the pool's "
          f"largest", flush=True)


def compare(label, *args, **kw):
    """kernel_check.check_against_plain, printed on one line; a
    disagreement fails the run."""
    try:
        r = kernel_check.check_against_plain(*args, **kw)
    except AssertionError as e:
        fail(str(e))
    ties = (f", tie gaps max {r['tie_ulps_max']:.3g} median "
            f"{r['tie_ulps_median']:.3g} ulps, {r['exact_ties']} exact"
            if r["mismatches"] else "")
    print(f"{label}: {r['regions']} regions, max|d est| "
          f"{r['max_abs_est']:.3e}; beyond rtol, in ulps of the roundoff "
          f"scale (limits {kernel_check.ULPS['est']:g}/"
          f"{kernel_check.ULPS['err']:g}): est {r['est_ulps']:.3g}, err "
          f"{r['err_ulps']:.3g} ({r['err_ulps_without_gate_ties']:.3g} "
          f"before {r['gate_ties']} gate ties); plain err median "
          f"{r['err_resolved_ulps_median']:.3g} ulps of its scale; "
          f"split_dim agree {r['agree']:.6f} ({r['mismatches']} near-ties"
          f"{ties})", flush=True)
    return r


# ---------------------------------------------------------------------------
# VEGAS (phases 5-7)

VEGAS_NDIM = 6
VEGAS_CHUNK = 1 << 20
# VEGAS run 3's estimate as this script printed it on an NVIDIA H100 80GB
# HBM3 at commit 756fd3a, when the lookups had only their generic routes
GENERIC_RUN3_ESTIMATE = 1.2700805996066006e-07
GENZ_AXIS_OPS = {1: 2, 2: 4, 3: 2, 4: 4, 5: 3, 6: 3}


def sampler_bound_ms(kind: int, ndim: int, kp: int, kq: int, n: int,
                     with_hist: bool) -> tuple[float, str]:
    """Bound of one sampler launch over ``n`` samples; ``kind`` 0 is the
    emit mode, 1..6 the fused Genz family.  Operations per (sample,
    dimension), counted from csrc/vegas_sample.cu: the recurrence's
    multiply-adds (2 per term of P, 1 per term of q) at 2 operations each;
    10 for uniform, stratified position, t, clip, weight and bin id; 25 for
    the generator (10 rounds of 10 integer operations per 4 dimensions);
    the integrand's per-axis work.  exp and cos count as ONE operation, so
    this is a lower bound.  Bytes: what the mode writes."""
    per_dim = 2 * (2 * (kp - 2) + max(kq - 2, 0) + 2) + 10 + 25
    per_sample = ndim * (per_dim + GENZ_AXIS_OPS.get(kind, 0)) + 6
    per_sample_bytes = (4 * ndim if with_hist else 0) + (
        4 * (ndim + 1) if kind == 0 else (4 if with_hist else 0))
    t_ops = n * per_sample / PEAK_OPS[torch.float32]
    t_bytes = n * per_sample_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bytes_bound_ms(nbytes: int) -> float:
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def stratified_ids(nbins: int, dev):
    """The bin ids (C, npg, ndim) int32 of the chunk of 2^20 cubes around
    the centre of the 6D ncall = 1e8 lattice, as the grid map draws them."""
    case = vegas_check.sampler_case(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                    position="middle", device=dev)
    c, npg = case["chunk_cubes"], case["npg"]
    xn, _ = cuda_lookup.stratified_xn_plain(
        VEGAS_NDIM, case["ng"], npg, nbins, c, case["cube0"], case["ncubes"],
        0, 1, dev)
    ids = torch.clamp(xn.to(torch.int32), 1, nbins)
    return ids.T.reshape(c, npg, VEGAS_NDIM).contiguous()


def vegas_checks(dev):
    """Phase 5; returns the largest absolute difference read per kernel."""
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    err = {"vegas_sample": 0.0}
    for position in ("end", "middle"):
        case = vegas_check.sampler_case(VEGAS_NDIM, 1e8, VEGAS_CHUNK,
                                        position=position, device=dev)
        for with_hist in (False, True):
            for rng in ("input", "device"):
                for integrand in (None, g4):
                    try:
                        r = vegas_check.check_sampler(
                            case, integrand, with_hist=with_hist, rng=rng,
                            route="paired")
                        rr = vegas_check.check_sampler_routes(
                            case, integrand, with_hist=with_hist, rng=rng)
                    except AssertionError as e:
                        fail(str(e))
                    what = ("emit " if integrand is None else "fused F4 ")
                    readings = ", ".join(
                        f"{k[:-5]} {v:.3g} (limit "
                        f"{vegas_check.ULPS[k[:-5]]:g})"
                        for k, v in r.items() if k[:-5] in vegas_check.ULPS)
                    between = ", ".join(f"{k[:-5]} {v:.3g}"
                                        for k, v in rr.items()
                                        if k.endswith("_ulps"))
                    print(f"phase 5: sampler {what}hist={with_hist} rng={rng} "
                          f"chunk at the {position}: {r['samples']} samples"
                          f"{', bin ids equal' if with_hist else ''}; in ulps "
                          f"of the rounding scale: {readings}; paired vs "
                          f"generic route, ulps of the value: {between}",
                          flush=True)
                    err["vegas_sample"] = max(err["vegas_sample"],
                                              r.get("max_abs_x", 0.0))
        try:
            r = vegas_check.check_stream(case, route="paired")
            vegas_check.check_stream(case, route="generic")
        except AssertionError as e:
            fail(str(e))
        print(f"phase 5: generator, chunk at the {position}: "
              f"{r['uniforms']} uniforms equal to the plain generator's on "
              f"both routes", flush=True)
    # where f^2 and the sum of f2b are hardest to read: the paired kernel
    # and the plain version against an f64 evaluation (fx crossing zero
    # under F1; cubes at the variance floor under F3 and F5)
    for ndim, ncall, chunk, degree, position, g in (
            (6, 1e8, VEGAS_CHUNK, 14, "end", genz.f1_oscillatory(6)),
            (6, 1e8, 1 << 14, 14, "end", genz.f3_corner_peak(6)),
            (6, 1e8, 1 << 14, 14, "end", genz.f5_c0_continuous(6)),
            (8, 5.2e10, 4096, 8, "middle", genz.f3_corner_peak(8))):
        case = vegas_check.sampler_case(
            ndim, ncall, chunk, nbins=500 if degree == 14 else 100,
            degree=degree, position=position, device=dev)
        for rng in ("input", "device"):
            try:
                r = vegas_check.check_sampler(case, g, with_hist=True,
                                              rng=rng, route="paired")
            except AssertionError as e:
                fail(str(e))
            w = vegas_check.sampler_f64_witness(case, g, rng=rng,
                                                route="paired")
            print(f"phase 5: witness {ndim}D ncall {ncall:g} {g.name} "
                  f"rng={rng}, {r['samples']} samples: f2 {r['f2_ulps']:.3g} "
                  f"ulps kernel vs plain; vs the f64 evaluation kernel "
                  f"{w['kernel_f2_ulps']:.3g}, plain {w['plain_f2_ulps']:.3g}; "
                  f"sum f2b {r['sum_f2b']:.6e}: {r['f2b_ulps']:.3g} ulps after "
                  f"{r['f2b_floor_steps']} floors of {r['f2b_floor_ties']} "
                  f"tied cubes ({r['f2b_ulps_before_floor_ties']:.3g} before); "
                  f"above the f64 sum {w['sum_f2b_f64']:.6e} by TINY times "
                  f"kernel {w['kernel_f2b_floors']:.6f}, plain "
                  f"{w['plain_f2b_floors']:.6f}", flush=True)
            if not w["kernel_f2_ulps"] <= vegas_check.ULPS["f2"]:
                fail(f"witness: the kernel's f2 lies {w['kernel_f2_ulps']} "
                     "ulps from the f64 evaluation")
    # the generic route at a shape the paired one does not take
    case9 = vegas_check.sampler_case(9, 4e6, 1 << 18, nbins=100, degree=8,
                                     device=dev)
    if cuda_vegas.sampler_route(9, case9["pmap"].kp,
                                case9["pmap"].kq) != "generic":
        fail("a 9D map should take the sampler's generic route")
    for integrand in (None, genz.f4_gaussian(9)):
        try:
            r = vegas_check.check_sampler(case9, integrand, with_hist=True,
                                          rng="device")
        except AssertionError as e:
            fail(str(e))
        readings = ", ".join(f"{k[:-5]} {v:.3g}" for k, v in r.items()
                             if k.endswith("_ulps"))
        print(f"phase 5: generic route, 9D degree 8, "
              f"{'emit' if integrand is None else 'fused F4'}: "
              f"{r['samples']} samples, bin ids equal; ulps: {readings}",
              flush=True)
    n = VEGAS_CHUNK * 2
    for nbins in (500, 50):
        try:
            h = vegas_check.check_hist(VEGAS_NDIM, n, nbins, device=dev)
            b = vegas_check.check_bin_resolve(VEGAS_NDIM, n, nbins,
                                              device=dev)
            bs = vegas_check.check_bin_resolve_stratified(
                VEGAS_NDIM, 1e8, VEGAS_CHUNK, nbins, device=dev)
            # both edge-lookup routes: uniformly random ids, the same 1
            # element off a 16-byte boundary, a chunk's stratified ids
            e = [vegas_check.check_edge_routes(
                VEGAS_NDIM, VEGAS_CHUNK, 2, nbins, offset=offset, ia=ids,
                device=dev) for offset, ids in (
                    (0, None), (1, None), (0, stratified_ids(nbins, dev)))]
        except AssertionError as exc:
            fail(str(exc))
        if any(r["routes"] != ["vector", "generic"] for r in e):
            fail(f"nbins {nbins}: the edge lookup should take both routes, "
                 f"got {[r['routes'] for r in e]}")
        e = e[0]
        print(f"phase 5: nbins {nbins}, {n} samples: histogram max rel "
              f"{h['max_rel']:.3g} (limit {vegas_check.HIST_RTOL:g}), two "
              f"launches bitwise equal; bin resolve ia, xo equal, rc "
              f"{b['rc_ulps']} ulps given xn and {bs['rc_ulps']} drawing xn "
              f"(limit {vegas_check.RC_ULP}); edge lookup vector and generic "
              f"routes EQUAL to the plain version and to each other on "
              f"random ids, random ids 1 element off a 16-byte boundary and "
              f"the stratified ids of the chunk at the centre", flush=True)
        if nbins == 500:
            err.update(vegas_hist=h["max_abs"], vegas_bin_resolve=max(
                b["max_abs"], bs["max_abs"]), vegas_edge_lookup=e["max_abs"])
        # both routes of the histogram and the bin resolve
        try:
            hr = vegas_check.check_hist_routes(VEGAS_NDIM, n, nbins,
                                               device=dev)
            rr = vegas_check.check_resolve_routes(VEGAS_NDIM, 1e8,
                                                  VEGAS_CHUNK, nbins,
                                                  device=dev)
        except AssertionError as exc:
            fail(str(exc))
        if hr["routes"] != ["grouped", "generic"] or rr["routes"] != [
                "sample", "generic"]:
            fail(f"nbins {nbins}: the main path's shapes should take both "
                 f"routes, got {hr['routes']} and {rr['routes']}")
        print(f"phase 5: nbins {nbins}, {n} samples: histogram grouped "
              f"route max rel {hr['grouped']['max_rel']:.3g}, accumulating "
              f"from bins near the cap {hr['grouped']['accum_max_rel']:.3g}; "
              f"generic route {hr['generic']['max_rel']:.3g}, "
              f"{hr['generic']['accum_max_rel']:.3g} (limit "
              f"{vegas_check.HIST_RTOL:g}); between the routes "
              f"{hr['between_routes_max_rel']:.3g}; each route twice the "
              f"same bits, f2 in f64 as in f32, the accumulating form EQUAL "
              f"to min(d + its histogram, cap); bin resolve sample vs "
              f"generic route, drawing xn at the centre and the lattice's "
              f"end, given xn over {rr['samples']} and {rr['samples'] - 3} "
              f"samples: rc, xo, ia EQUAL, rc {rr['rc_ulps']} ulps from the "
              f"plain version", flush=True)
        if nbins == 500:
            err["vegas_hist"] = max(err["vegas_hist"],
                                    hr["grouped"]["max_abs"],
                                    hr["generic"]["max_abs"])
    return err


class LaunchCounts:
    """The launch counts of the VEGAS wrappers for one run: set to 0 on
    entry, read on exit.  (The kernels are too short for events around each
    launch to time them: phase 7 times each alone, and reckons from the
    counts what the card was busy with.)"""

    def __enter__(self):
        cuda_vegas.reset_launches()
        cuda_lookup.reset_launches()
        return self

    def __exit__(self, *exc):
        self.sampler_routes = dict(cuda_vegas.route_launches)
        self.hist_routes = dict(cuda_lookup.hist_route_launches)
        self.resolve_routes = dict(cuda_lookup.resolve_route_launches)
        self.launches = {"vegas_sample": cuda_vegas.launches,
                         "vegas_hist": cuda_lookup.hist_launches,
                         "vegas_bin_resolve": cuda_lookup.bin_resolve_launches,
                         "vegas_edge_lookup": cuda_lookup.edge_lookup_launches}
        return False


class LaunchEvents:
    """CUDA events around every launch of the VEGAS wrappers while it is
    entered: ``seconds`` is then the time between the events of all
    launches, the host's time to launch included.  The events cost the host
    time of their own, so a run's wall is read without them and this only
    says what share of a wall the launches are."""
    NAMES = ((cuda_vegas, "sample_chunk"), (cuda_lookup, "hist_accum"),
             (cuda_lookup, "bin_resolve_stratified"))

    def __enter__(self):
        self.events, self.kept = [], []
        for module, name in self.NAMES:
            fn = getattr(module, name)
            self.kept.append((module, name, fn))
            setattr(module, name, self._timed(fn))
        return self

    def _timed(self, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for module, name, fn in self.kept:
            setattr(module, name, fn)
        torch.cuda.synchronize()
        self.seconds = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        return False


class GenericLookups:
    """While entered, the histogram and the bin resolve take their generic
    routes (the first design's kernels, and around the histogram the
    first design's PyTorch steps) whatever the shape."""

    def __enter__(self):
        self.kept = (cuda_lookup.hist_route, cuda_lookup.resolve_route)
        cuda_lookup.hist_route = lambda *a: "generic"
        cuda_lookup.resolve_route = lambda *a: "generic"
        return self

    def __exit__(self, *exc):
        cuda_lookup.hist_route, cuda_lookup.resolve_route = self.kept
        return False


def vegas_run(label, g, expect, events=False, lookups="card", **kw):
    """One VEGAS run through the entry point; requires status 0, the truth
    within 5 errorest, errorest/|est| <= epsrel and a launch of every
    kernel in ``expect``, the sampler's all by the paired route and the
    lookups' all by the routes built for the card ('grouped', 'sample'),
    or with ``lookups='generic'`` all by their generic routes.  Returns
    (result, launches, wall seconds).  With ``events`` the launches run
    between CUDA events, and their share of that run's (longer) wall is
    printed."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock, (GenericLookups() if lookups == "generic"
                                   else contextlib.nullcontext()):
        if events:
            with LaunchEvents() as between:
                t0 = time.perf_counter()
                res = mcubes.integrate(g, epsabs=1e-40, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"phase 6: {label}: {len(between.events)} launches between "
                  f"CUDA events take {between.seconds:.4f} s of this run's "
                  f"{wall:.3f} s wall = {100 * between.seconds / wall:.1f}%",
                  flush=True)
        else:
            t0 = time.perf_counter()
            res = mcubes.integrate(g, epsabs=1e-40, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    pull = abs(res.estimate - g.true_value) / res.errorest
    print(f"phase 6: {label}: status {res.status} estimate {res.estimate!r} "
          f"errorest {res.errorest!r} truth {g.true_value!r} pull "
          f"{pull:.3f} chi_sq {res.chi_sq:.4f} prob {res.prob:.4f} iters "
          f"{res.iters} neval {res.neval} wall {wall:.3f} s samples/s "
          f"{res.neval / wall:.4e} launches {clock.launches} (by route: "
          f"sampler {clock.sampler_routes}, histogram {clock.hist_routes}, "
          f"bin resolve {clock.resolve_routes})", flush=True)
    if res.status != 0 or not pull <= 5.0 or not (
            res.errorest / abs(res.estimate) <= kw["epsrel"]):
        fail(f"{label}: status {res.status}, pull {pull}, errorest "
             f"{res.errorest}")
    for name in clock.launches:
        if (clock.launches[name] > 0) != (name in expect):
            fail(f"{label}: {name} launched {clock.launches[name]} times; "
                 f"the run should go through {sorted(expect)} only")
    if clock.sampler_routes["paired"] != clock.launches["vegas_sample"]:
        fail(f"{label}: the sampler's launches by route are "
             f"{clock.sampler_routes}; all should take the paired route")
    hist_route, resolve_route = (("generic", "generic") if lookups == "generic"
                                 else ("grouped", "sample"))
    if (clock.hist_routes[hist_route] != clock.launches["vegas_hist"]
            or clock.resolve_routes[resolve_route]
            != clock.launches["vegas_bin_resolve"]):
        fail(f"{label}: the lookups' launches by route are histogram "
             f"{clock.hist_routes}, bin resolve {clock.resolve_routes}; all "
             f"should take the {hist_route} and the {resolve_route} route")
    return res, clock.launches, wall


def vegas_main_path(dev):
    """Phase 6; returns the launch counts and the walls of runs 1-3."""
    g6 = genz.f4_gaussian(VEGAS_NDIM)
    sh = {"vegas_sample", "vegas_hist"}
    walls = {}
    r1, l1, walls["run1"] = vegas_run("run 1, f64 poly hybrid ncall 1e8", g6,
                                      sh, epsrel=1e-3, ncall=1e8)
    r1b, _, _ = vegas_run("run 1 again", g6, sh, epsrel=1e-3, ncall=1e8)
    if (r1.estimate, r1.errorest, r1.chi_sq) != (r1b.estimate, r1b.errorest,
                                                 r1b.chi_sq):
        fail("run 1 repeated with the same seed gives other bits")
    _, l2, walls["run2"] = vegas_run(
        "run 2, f32 poly fused ncall 1e9", g6, sh, epsrel=1e-3, ncall=1e9,
        eval_dtype=torch.float32, total_iters=10, adjust_iters=5)
    # the same run with events around each launch: what the events cost the
    # host, and the launches' share of a wall by measurement
    vegas_run("run 2 with an event pair around each launch", g6, sh,
              events=True, epsrel=1e-3, ncall=1e9, eval_dtype=torch.float32,
              total_iters=10, adjust_iters=5)
    r3, l3, walls["run3"] = vegas_run(
        "run 3, f64 grid ncall 1e8", g6, {"vegas_bin_resolve", "vegas_hist"},
        epsrel=1e-3, ncall=1e8, importance="grid")
    # the same run on the first design's lookups: the bin resolve's routes
    # agree bit for bit, so any other estimate comes from the histogram's
    # order of addition
    r3g, _, walls["run3_generic"] = vegas_run(
        "run 3 with both lookups forced to 'generic'", g6,
        {"vegas_bin_resolve", "vegas_hist"}, lookups="generic", epsrel=1e-3,
        ncall=1e8, importance="grid")
    same = (r3g.estimate, r3g.errorest) == (r3.estimate, r3.errorest)
    print(f"phase 6: run 3 on the generic lookups: estimate {r3g.estimate!r} "
          f"errorest {r3g.errorest!r}, {'EQUAL to' if same else 'not equal to'}"
          f" the grouped/sample run's; run 3 at commit 756fd3a (the same "
          f"generic lookups) gave {GENERIC_RUN3_ESTIMATE!r}: "
          f"{'equal' if r3g.estimate == GENERIC_RUN3_ESTIMATE else 'NOT equal'}",
          flush=True)

    g3 = genz.f4_gaussian(3, a=5.0)
    kw = dict(epsrel=1e-3, ncall=5e4, total_iters=10, adjust_iters=6, seed=2)
    for label, card_kw, cpu_kw in (
            ("poly hybrid", {}, {"sampler": "hybrid"}),
            ("poly fused", {"eval_dtype": torch.float32},
             {"eval_dtype": torch.float32, "sampler": "fused"}),
            ("grid", {"importance": "grid"}, {"importance": "grid"})):
        on_card = mcubes.integrate(g3, **kw, **card_kw)
        on_cpu = mcubes.integrate(g3, device="cpu", **kw, **cpu_kw)
        print(f"phase 6: 3D f4 {label} card vs cpu: {on_card.estimate!r} vs "
              f"{on_cpu.estimate!r}, iters {on_card.iters}/{on_cpu.iters}, "
              f"neval {on_card.neval}/{on_cpu.neval}", flush=True)
        if ((on_card.status, on_card.iters, on_card.neval)
                != (on_cpu.status, on_cpu.iters, on_cpu.neval)
                or not math.isclose(on_card.estimate, on_cpu.estimate,
                                    rel_tol=1e-6)):
            fail(f"3D {label} run on the card differs from the CPU's")
    return {"run1": l1, "run2": l2, "run3": l3}, walls


def vegas_times(dev, err, launches, walls):
    """Phase 7; returns the VEGAS entries of the ``kernels`` line."""
    g4 = genz.f4_gaussian(VEGAS_NDIM)
    ndim, nbins = VEGAS_NDIM, 500
    case = vegas_check.sampler_case(ndim, 1e8, VEGAS_CHUNK,
                                    position="middle", device=dev)
    pmap, npg = case["pmap"], case["npg"]
    n = case["chunk_cubes"] * npg
    tail = (case["xjac"], case["cube0"], case["ncubes"], 0, 1)

    def sample(fn, integrand, with_hist):
        return lambda: fn(pmap, integrand, case["ng"], npg,
                          case["chunk_cubes"], nbins, with_hist, *tail,
                          emit_points=integrand is None)

    entries = []
    sampler_ms = {}
    for label, integrand, with_hist in (
            ("emit+hist (run 1, adjusting)", None, True),
            ("emit (run 1, frozen)", None, False),
            ("fused F4+hist (run 2, adjusting)", g4, True),
            ("fused F4 (run 2, frozen)", g4, False)):
        def routed(route):
            return lambda: cuda_vegas.sample_chunk(
                pmap, integrand, case["ng"], npg, case["chunk_cubes"], nbins,
                with_hist, *tail, emit_points=integrand is None, route=route)

        # paired, generic, generic, paired: the two within one call
        t = [queued_ms(routed(r), 5)
             for r in ("paired", "generic", "generic", "paired")]
        ms, generic = min(t[0], t[3]), min(t[1], t[2])
        single = time_ms(routed("paired"), 5)
        plain = time_ms(sample(cuda_vegas.sample_chunk_plain, integrand,
                               with_hist), 2)
        b, by = sampler_bound_ms(0 if integrand is None else 4, ndim,
                                 pmap.kp, pmap.kq, n, with_hist)
        sampler_ms[label] = (ms, plain, b, by, generic)
        print(f"phase 7: sampler {label}, {n} samples: paired route "
              f"{ms:.4f} ms = {n / ms * 1e3:.4e} samples/s (two series "
              f"{t[0]:.4f}, {t[3]:.4f}), generic route {generic:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain:.2f} ms, bound "
              f"{b:.4f} ms ({by}, {100 * b / ms:.1f}% of it); one launch "
              f"between two events, the host's time to launch included: "
              f"{single:.4f} ms", flush=True)
    ms, plain, b, by, generic = sampler_ms["emit+hist (run 1, adjusting)"]
    entries.append({
        "name": "vegas_sample", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_sample.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_vegas.py:192",
        "launches": launches["run1"]["vegas_sample"],
        "launches_by_run": {r: c["vegas_sample"] for r, c in launches.items()},
        "max_abs_err": err["vegas_sample"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "generic_route_ms": generic,
        "modes_ms": {k: v[0] for k, v in sampler_ms.items()},
        "modes_generic_route_ms": {k: v[4] for k, v in sampler_ms.items()}})

    def both_routes(routed, first):
        """(first route's ms, generic route's ms, the four series): the two
        routes in turns, first, generic, generic, first, in this call."""
        t = [queued_ms(routed(r), 5)
             for r in (first, "generic", "generic", first)]
        return min(t[0], t[3]), min(t[1], t[2]), t

    # the histogram as the main path calls it: accumulating, on the ids and
    # f^2 the fused sampler emits (run 2), and on 1-based ids with f^2 in
    # f64 (runs 1 and 3 have f64 values; run 3 1-based ids)
    _, ia, f2 = cuda_vegas.sample_chunk(
        pmap, g4, case["ng"], npg, case["chunk_cubes"], nbins, True, *tail)
    ia1, f2_64 = ia + 1, f2.double()
    acc = torch.zeros((ndim, nbins), dtype=torch.float32, device=dev)
    hist_ms = {}
    for form, ids, vals, base in (("fused", ia, f2, 0),
                                  ("grid", ia1, f2_64, 1)):
        ms, generic, t = both_routes(
            lambda route: lambda: cuda_lookup.hist_accum(
                acc, ids, vals, nbins, base=base, route=route), "grouped")
        plain = time_ms(lambda: cuda_lookup.hist_accum_plain(
            acc, ids, vals, nbins, base=base), 2)
        ids64 = (ids - base).to(torch.int64)
        vals32 = vals.to(torch.float32)
        lib = queued_ms(lambda: torch.clamp(acc + torch.stack([
            torch.bincount(ids64[d], weights=vals32, minlength=nbins)
            for d in range(ndim)]), max=cuda_lookup.HIST_CAP), 5)
        b = bytes_bound_ms(n * (4 * ndim + vals.element_size())
                           + 2 * 4 * ndim * nbins)
        hist_ms[form] = (ms, generic, plain, lib, b)
        warps, clusters = cuda_lookup.hist_plan(n, ndim, nbins)
        print(f"phase 7: histogram accumulating, {form} form ({n} samples, "
              f"ids {base}-based, f2 {vals.dtype}): grouped route {ms:.4f} "
              f"ms (two series {t[0]:.4f}, {t[3]:.4f}), generic route "
              f"{generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}; its kernel, the sum "
              f"over blocks, the add and the clamp{', ids - 1 and f2 to f32' if base else ''}), "
              f"plain {plain:.3f} ms, torch.bincount per dimension + add + "
              f"clamp {lib:.4f} ms, bound {b:.4f} ms (bytes, "
              f"{100 * b / ms:.1f}% of it; generic {100 * b / generic:.1f}%); "
              f"grouped launch: {clusters} clusters of "
              f"{cuda_lookup.HIST_CLUSTER} blocks of {warps} warps",
              flush=True)
    # what a grouped launch costs whatever its size: zeroing the rows, the
    # reductions over warps, blocks and clusters
    small_ids, small_vals = ia[:, :4096].contiguous(), f2[:4096].contiguous()
    small = queued_ms(lambda: cuda_lookup.hist_accum(acc, small_ids,
                                                     small_vals, nbins), 5)
    print(f"phase 7: histogram accumulating, grouped route on 4096 samples "
          f"(a launch's cost whatever its size): {small:.4f} ms", flush=True)
    ms, generic, plain, lib, b = hist_ms["fused"]
    entries.append({
        "name": "vegas_hist", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:223",
        "launches": launches["run1"]["vegas_hist"],
        "launches_by_run": {r: c["vegas_hist"] for r, c in launches.items()},
        "max_abs_err": err["vegas_hist"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib,
        "generic_route_ms": generic,
        "grid_form_ms": hist_ms["grid"][0],
        "grid_form_generic_route_ms": hist_ms["grid"][1],
        "launch_of_4096_samples_ms": small})

    # the bin resolve as run 3 launches it: xn drawn in the kernel, ids out;
    # and given xn
    xi32 = torch.as_tensor(vegas_check.random_grid(ndim, nbins, 0),
                           dtype=torch.float32, device=dev)
    rargs = (xi32, nbins, case["ng"], npg, case["chunk_cubes"],
             case["cube0"], case["ncubes"], 0, 1)
    ms, generic, t = both_routes(
        lambda route: lambda: cuda_lookup.bin_resolve_stratified(
            *rargs, with_ia=True, route=route), "sample")
    plain = time_ms(lambda: cuda_lookup.bin_resolve_stratified_plain(
        *rargs, with_ia=True), 2)
    xn, _ = cuda_lookup.stratified_xn_plain(
        ndim, case["ng"], npg, nbins, case["chunk_cubes"], case["cube0"],
        case["ncubes"], 0, 1, dev)
    xn = xn.contiguous()
    given, given_generic, tg = both_routes(
        lambda route: lambda: cuda_lookup.bin_resolve(
            xi32, xn, nbins, with_ia=True, route=route), "sample")
    idx = torch.clamp(xn.to(torch.int64), 1, nbins)
    idx_lo = idx - 1
    lib = queued_ms(lambda: (torch.gather(xi32, 1, idx_lo),
                             torch.gather(xi32, 1, idx)), 5)
    resolve_ms = ms
    edges = 4 * ndim * (nbins + 1)
    b = bytes_bound_ms(n * ndim * 12 + edges)
    b_given = bytes_bound_ms(n * ndim * 16 + edges)
    print(f"phase 7: bin resolve drawing xn, {n} samples x {ndim}: sample "
          f"route {ms:.4f} ms (two series {t[0]:.4f}, {t[3]:.4f}), generic "
          f"route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
          f"{plain:.2f} ms, bound {b:.4f} ms (bytes, {100 * b / ms:.1f}% of "
          f"it; generic {100 * b / generic:.1f}%); given xn: sample route "
          f"{given:.4f} ms ({tg[0]:.4f}, {tg[3]:.4f}), generic route "
          f"{given_generic:.4f} ms ({tg[1]:.4f}, {tg[2]:.4f}), bound "
          f"{b_given:.4f} ms ({100 * b_given / given:.1f}%), two "
          f"torch.gather (the edges alone, no rc, xo or ia) {lib:.4f} ms",
          flush=True)
    entries.append({
        "name": "vegas_bin_resolve", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:152",
        "launches": launches["run3"]["vegas_bin_resolve"],
        "launches_by_run": {r: c["vegas_bin_resolve"]
                            for r, c in launches.items()},
        "max_abs_err": err["vegas_bin_resolve"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": None,
        "generic_route_ms": generic,
        "given_xn_ms": given, "given_xn_generic_route_ms": given_generic,
        "given_xn_library_ms_edges_only": lib})

    # the edge lookup, both routes in turns, on the chunk's stratified ids
    # and on uniformly random ones (more bank conflicts in the pair table)
    ids = idx.T.reshape(case["chunk_cubes"], npg, ndim).to(
        torch.int32).contiguous()
    rand_ids = vegas_check.edge_ids(case["chunk_cubes"], npg, ndim, nbins,
                                    device=dev)
    edge = {}
    for label, e_ids in (("stratified", ids), ("random", rand_ids)):
        edge[label] = both_routes(
            lambda route: lambda: cuda_lookup.edge_lookup(
                xi32, e_ids, nbins, route=route), "vector")
    ms, generic, t = edge["stratified"]
    plain = time_ms(lambda: cuda_lookup.edge_lookup_plain(xi32, ids, nbins),
                    2)
    b = bytes_bound_ms(n * ndim * 12 + edges)
    r_ms, r_generic, rt = edge["random"]
    print(f"phase 7: edge lookup, {n} samples x {ndim}, stratified ids: "
          f"vector route {ms:.4f} ms (two series {t[0]:.4f}, {t[3]:.4f}), "
          f"generic route {generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}); "
          f"uniformly random ids: vector {r_ms:.4f} ms ({rt[0]:.4f}, "
          f"{rt[3]:.4f}), generic {r_generic:.4f} ms ({rt[1]:.4f}, "
          f"{rt[2]:.4f}); plain {plain:.3f} ms, two torch.gather {lib:.4f} "
          f"ms, bound {b:.4f} ms (bytes; vector {100 * b / ms:.1f}% of it, "
          f"{100 * b / r_ms:.1f}% on random ids; generic "
          f"{100 * b / generic:.1f}%)", flush=True)
    entries.append({
        "name": "vegas_edge_lookup", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:86",
        "launches": None,     # set by the diff path's run (phase 8)
        "max_abs_err": err["vegas_edge_lookup"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib,
        "generic_route_ms": generic, "random_ids_ms": r_ms,
        "random_ids_generic_route_ms": r_generic})

    # what the card was busy with in each run: launches times the time of a
    # kernel alone, against the run's wall
    adj = {"run1": (sampler_ms["emit+hist (run 1, adjusting)"][0],
                    sampler_ms["emit (run 1, frozen)"][0], "grid"),
           "run2": (sampler_ms["fused F4+hist (run 2, adjusting)"][0],
                    sampler_ms["fused F4 (run 2, frozen)"][0], "fused"),
           "run3": (resolve_ms, resolve_ms, "grid")}
    for run, (with_hist_ms, bare_ms, form) in adj.items():
        c = launches[run]
        first = c["vegas_sample"] + c["vegas_bin_resolve"]
        busy = (c["vegas_hist"] * (with_hist_ms + hist_ms[form][0])
                + (first - c["vegas_hist"]) * bare_ms) / 1e3
        print(f"phase 7: {run}: its kernels alone would take {busy:.4f} s "
              f"({first} + {c['vegas_hist']} launches at the times above) of "
              f"the {walls[run]:.3f} s wall = {100 * busy / walls[run]:.1f}%",
              flush=True)
    return entries


# ---------------------------------------------------------------------------
# The diff path (phase 8)

DIFF_NDIM = 6
DIFF_A = 25.0            # gauss at a = 25 is Genz F4 at a = 5
DIFF_SEED = 7
DIFF_NCALL = 1 << 24


def gauss(x, a):
    """exp(-a sum((x - 1/2)^2)) on the unit cube."""
    return torch.exp(-a * torch.sum((x - 0.5) ** 2, dim=-1))


def gauss_truth(a: float, ndim: int) -> tuple[float, float]:
    """(I(a), dI/da) in closed form: I = c^ndim with
    c = sqrt(pi/a) erf(sqrt(a)/2), and dc/da = (exp(-a/4) - c) / (2a)."""
    c = math.sqrt(math.pi / a) * math.erf(math.sqrt(a) / 2.0)
    dc = (math.exp(-a / 4.0) - c) / (2 * a)
    return c ** ndim, ndim * c ** (ndim - 1) * dc


def timed(fn):
    """(fn's result, seconds of host clock until the card is done)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def diff_path(dev):
    """Phase 8: ``gpuintegration_torch.diff`` at full width on the card.
    Returns the edge lookup's launches and launches by route on the frozen
    estimate's run, its largest difference from the plain version on the
    path's ids, and its fields for the ``kernels`` line."""
    ndim, a0 = DIFF_NDIM, DIFF_A
    truth, dtruth = gauss_truth(a0, ndim)
    t_phase = time.perf_counter()

    # train the grid: VEGAS adjustment, the sampler in emit mode and the
    # histogram (no kernel twin for a callable: the 'hybrid' sampler)
    with LaunchCounts() as clock:
        xi, train_s = timed(lambda: diff.train_grid(
            gauss, ndim, theta=a0, ncall=1e7, adjust_iters=10))
    if (clock.launches["vegas_sample"] == 0 or clock.launches["vegas_hist"]
            == 0 or clock.sampler_routes["paired"]
            != clock.launches["vegas_sample"]
            or clock.hist_routes["grouped"] != clock.launches["vegas_hist"]):
        fail(f"train_grid: launches {clock.launches}, sampler by route "
             f"{clock.sampler_routes}, histogram {clock.hist_routes}; the "
             "sampler should take the paired route, the histogram the "
             "grouped one")
    print(f"phase 8: train_grid {ndim}D a={a0:g} ncall 1e7, 10 adjusting "
          f"iterations: {train_s:.3f} s, launches {clock.launches}",
          flush=True)

    est_fn = diff.frozen_grid_estimate(gauss, xi, ndim, ncall=DIFF_NCALL)
    a = torch.tensor(a0, dtype=torch.float64, device=dev)
    h = 1e-4
    thetas = torch.tensor([20.0, 25.0, 30.0, 35.0], dtype=torch.float64,
                          device=dev)
    # the first torch.func.grad of a process imports torch._dynamo and more:
    # taken once on a scalar, before anything is timed
    _, import_s = timed(lambda: torch.func.grad(lambda t: t * t)(a))
    cuda_lookup.reset_launches()
    t_path = time.perf_counter()
    (est, err), fwd_s = timed(lambda: est_fn(a, DIFF_SEED))
    counted = cuda_lookup.edge_route_launches["vector"]
    g, grad_s = timed(lambda: torch.func.grad(
        lambda t: est_fn(t, DIFF_SEED)[0])(a))
    in_grad = cuda_lookup.edge_route_launches["vector"] - counted
    fd = (float(est_fn(a + h, DIFF_SEED)[0])
          - float(est_fn(a - h, DIFF_SEED)[0])) / (2 * h)
    (scan, scan_err), scan_s = timed(lambda: torch.func.vmap(
        lambda t: est_fn(t, DIFF_SEED))(thetas))
    loop = [est_fn(t, DIFF_SEED) for t in thetas]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = cuda_lookup.edge_lookup_launches
    by_route = dict(cuda_lookup.edge_route_launches)
    est, err, g = float(est), float(err), float(g)
    pull = (est - truth) / err
    scan_rel = max(max(abs(float(scan[i]) / float(e) - 1),
                       abs(float(scan_err[i]) / float(r) - 1))
                   for i, (e, r) in enumerate(loop))
    print(f"phase 8: frozen_grid_estimate, {DIFF_NCALL} samples x {ndim}: "
          f"estimate {est!r} errorest {err!r} truth {truth!r} pull "
          f"{pull:.3f}; forward {fwd_s:.4f} s, torch.func.grad (forward and "
          f"backward) {grad_s:.4f} s (the first grad of the process, its "
          f"imports, took {import_s:.3f} s before): {g!r} against dI/da "
          f"{dtruth!r} "
          f"(rel {abs(g / dtruth - 1):.3e}, limit 0.05) and the common-"
          f"random-number central difference (h {h:g}) {fd!r} (rel "
          f"{abs(g / fd - 1):.3e}, limit 1e-5); vmap over {len(loop)} "
          f"thetas {scan_s:.4f} s, against the loop max rel {scan_rel:.3e} "
          f"(limit 1e-12); edge lookups {launches} (by route {by_route}), "
          f"{in_grad} inside torch.func.grad", flush=True)
    if abs(pull) > 5:
        fail(f"frozen estimate {est} is {pull:.2f} errorests from {truth}")
    if not abs(g / dtruth - 1) <= 0.05 or not abs(g / fd - 1) <= 1e-5:
        fail(f"frozen gradient {g}: dI/da {dtruth}, difference {fd}")
    if not scan_rel <= 1e-12:
        fail(f"vmap scan differs from the loop by {scan_rel}")
    if in_grad < 1 or by_route["vector"] != launches or launches < 1:
        fail(f"the edge lookup on the diff path: {launches} launches by "
             f"route {by_route}, {in_grad} inside torch.func.grad; all "
             "should take the vector route, one inside grad at least")

    # the draws alone, which the forward makes before the lookup: the same
    # seed, so the ids the path looked up; on them both routes EQUAL to the
    # plain version (launches after the counts were read, so uncounted),
    # then both alone in turns
    (ia, _), draws_s = timed(lambda: diff.frozen_draws(
        DIFF_SEED, DIFF_NCALL, ndim, xi.shape[1] - 1, dev))
    xi32 = xi.to(torch.float32).contiguous()
    nbins = xi.shape[1] - 1
    want = cuda_lookup.edge_lookup_plain(xi32, ia, nbins)
    path_err = 0.0
    for r in ("vector", "generic"):
        got = cuda_lookup.edge_lookup(xi32, ia, nbins, route=r)
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        d = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        path_err = max(path_err, d)
        print(f"phase 8: edge lookup {r} route on the path's {ia.numel()} "
              f"ids against the plain version: "
              f"{'EQUAL' if equal else 'DIFFERENT'} (max abs {d!r})",
              flush=True)
        if not equal:
            fail(f"edge lookup, {r} route, on the diff path's ids differs "
                 f"from the plain version by up to {d!r}")
    del want, got
    t = [queued_ms(lambda r=r: cuda_lookup.edge_lookup(xi32, ia, nbins,
                                                       route=r), 3, 5)
         for r in ("vector", "generic", "generic", "vector")]
    ms, generic = min(t[0], t[3]), min(t[1], t[2])
    b = bytes_bound_ms(ia.numel() * 12 + 4 * ndim * (nbins + 1))
    print(f"phase 8: the draws alone (Philox4x32-10 in plain PyTorch, "
          f"diff.frozen_draws): {draws_s:.4f} s of the {fwd_s:.4f} s forward",
          flush=True)
    print(f"phase 8: edge lookup at this shape ({ia.numel()} ids): vector "
          f"route {ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), generic "
          f"{generic:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), bound {b:.4f} ms "
          f"(bytes, {100 * b / ms:.1f}% of it); its {launches} launches "
          f"{launches * ms / 1e3:.4f} s of the estimate's {path_s:.3f} s "
          f"(forward, gradient, difference, scan, loop) = "
          f"{100 * launches * ms / 1e3 / path_s:.2f}%", flush=True)
    del ia

    # the fixed mesh: 6 partitions a dimension, the plain rule
    fm = diff.fixed_mesh_integral(gauss, ndim, partitions_per_axis=6)
    (m_est, m_err), m_s = timed(lambda: fm(a))
    m_g, m_grad_s = timed(lambda: torch.func.grad(lambda t: fm(t)[0])(a))
    m_est, m_err, m_g = float(m_est), float(m_err), float(m_g)
    m_rel, m_grel = abs(m_est / truth - 1), abs(m_g / dtruth - 1)
    print(f"phase 8: fixed_mesh_integral {ndim}D, 6 partitions "
          f"({6 ** ndim} regions x {rule_eval.rule_tables(ndim).feval} "
          f"points): estimate {m_est!r} errorest {m_err!r} (rel "
          f"{m_rel:.3e}, limit 1e-9), {m_s:.4f} s; gradient {m_g!r} (rel "
          f"{m_grel:.3e}, limit 1e-7), {m_grad_s:.4f} s", flush=True)
    if not (m_rel <= 1e-9 and m_grel <= 1e-7 and math.isfinite(m_err)):
        fail(f"fixed mesh: estimate {m_est} against {truth}, gradient {m_g} "
             f"against {dtruth}")

    # the checkpoint pipeline (tests/test_diff.py's): tolerances out of
    # reach, so that the checkpoint is a complete partition
    ws = Workspace(3, chunk_size=1024)
    ws.integrate(genz.f4_gaussian(3, a=5.0), epsrel=1e-12, epsabs=1e-200,
                 max_iterations=6)
    regions = diff.mesh_from_checkpoint(ws.make_checkpoint())
    fm3 = diff.fixed_mesh_integral(gauss, 3, regions=regions)
    c_est, c_err = (float(v) for v in fm3(a))
    c_g = float(torch.func.grad(lambda t: fm3(t)[0])(a))
    truth3, _ = gauss_truth(a0, 3)
    print(f"phase 8: checkpoint pipeline, 3D F4 a=5, 6 iterations -> "
          f"{regions[0].shape[0]} regions -> fixed_mesh_integral at a=25: "
          f"{c_est!r} errorest {c_err!r} truth {truth3!r}, gradient {c_g!r}",
          flush=True)
    if (abs(c_est - truth3) > max(3 * c_err, 1e-5 * truth3)
            or not math.isfinite(c_g)):
        fail(f"checkpoint mesh: {c_est} against {truth3}, gradient {c_g}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 8: the edge lookup's {launches} launches x {ms:.4f} ms = "
          f"{launches * ms / 1e3:.4f} s of this phase's {phase_s:.3f} s "
          f"({100 * launches * ms / 1e3 / phase_s:.3f}%; the first grad's "
          f"imports {import_s:.3f} s of it)", flush=True)
    return launches, by_route, path_err, {
        "diff_path_ms": ms, "diff_path_generic_route_ms": generic,
        "diff_path_bound_ms": b, "diff_path_max_abs_err": path_err}


# ---------------------------------------------------------------------------
# The rule's split route (phases 9-11) and the continuation (phase 12)

SPLIT_CHUNK = 4096        # Workspace(8)'s chunk in f64: 256 MB of points
SIN_SUM_EPSREL = 1e-11    # sin_sum(8) certifies there in 12 iterations


def f4_plain(x):
    """Genz F4 at 8D (a = 25, b = 1/2) as a plain batched callable: the
    expression of ``genz.f4_gaussian(8)`` without its family id, so it
    takes the split route."""
    return torch.exp(-torch.sum((25.0 * 25.0) * (x - 0.5) ** 2, dim=-1))


def f4_axes(x0, x1, x2, x3, x4, x5, x6, x7):
    """The same integrand in the scalar-per-axis form."""
    s = 0.0
    for u in (x0, x1, x2, x3, x4, x5, x6, x7):
        s = s + 625.0 * (u - 0.5) ** 2
    return torch.exp(-s)


def compare_split(label, *args, **kw):
    """kernel_check.check_split_against_plain, printed on one line; a
    disagreement fails the run."""
    try:
        r = kernel_check.check_split_against_plain(*args, **kw)
    except AssertionError as e:
        fail(str(e))
    print(f"{label}: {r['regions']} regions, points EQUAL (bits and "
          f"strides), values EQUAL; max|d est| {r['max_abs_est']:.3e}; "
          f"beyond rtol, in ulps of the roundoff scale (limits "
          f"{kernel_check.ULPS['est']:g}/{kernel_check.ULPS['err']:g}): est "
          f"{r['est_ulps']:.3g}, err {r['err_ulps']:.3g} "
          f"({r['err_ulps_without_gate_ties']:.3g} before {r['gate_ties']} "
          f"gate ties); split_dim EQUAL in {r['split_dim_equal']} of "
          f"{r['regions']}", flush=True)
    return r


def split_checks(dev):
    """Phase 9: the split route against its plain version.  Returns the
    largest |d est| read."""
    cap = 1 << 16
    n = cap - (cap >> 3)           # blocked pool with padding slots
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, cap, 1, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for label, f in (("sin_sum", misc.sin_sum(NDIM)),
                         ("g_function", misc.g_function(NDIM)),
                         ("F4 as a batched callable", f4_plain),
                         ("F4 as a per-axis callable", f4_axes)):
            r = compare_split(f"phase 9: {NDIM}D {label} {str(dtype)[6:]}", f,
                              tables, lows, lengths, gl, gr, n=n,
                              blocked=True, chunk_size=SPLIT_CHUNK)
            worst = max(worst, r["max_abs_est"])
    # other dimensions, in their volumes: the 9D Gaussian, the 2D ridge
    for (g, vol), small_cap in ((misc.gauss9d(), 1 << 12),
                                (misc.diagonal_ridge_2d(), 1 << 14)):
        tables = rule_eval.rule_tables(g.ndim, "float64")
        lows, lengths = random_pool(g.ndim, small_cap, 3, torch.float64, dev)
        gl = torch.as_tensor(vol.lows, device=dev)
        gr = torch.as_tensor(vol.highs - vol.lows, device=dev)
        r = compare_split(f"phase 9: {g.ndim}D {g.name} float64", g, tables,
                          lows, lengths, gl, gr,
                          n=small_cap - (small_cap >> 3), blocked=True,
                          chunk_size=SPLIT_CHUNK)
        worst = max(worst, r["max_abs_est"])

    # a NaN region takes the widest axis, as in the plain version
    tables = rule_eval.rule_tables(NDIM, "float64")
    lows, lengths = random_pool(NDIM, 256, 4, torch.float64, dev)
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    lows[2, 7] = float("nan")
    g = misc.sin_sum(NDIM)
    k = cuda_rule.cuda_apply_rule_split(g, tables, lows, lengths, gl, gr)
    p = rule_eval.apply_rule_plain(g, tables, lows, lengths, gl, gr)
    widest = int(torch.argmax(lengths[:, 7]))
    print(f"phase 9: NaN region: est {float(k[0][7])} (plain "
          f"{float(p[0][7])}), split_dim {int(k[2][7])} (plain "
          f"{int(p[2][7])}, widest axis {widest}); split_dim EQUAL in "
          f"{int((k[2] == p[2]).sum())} of 256", flush=True)
    if not (math.isnan(float(k[0][7])) and int(k[2][7]) == widest
            == int(p[2][7]) and torch.equal(k[2], p[2])):
        fail("the split route's NaN region does not take the widest axis")

    # cos(sum x): the split route against Genz F1 (unit coefficients) on
    # the tile route, the same rule to rounding
    lows, lengths = random_pool(NDIM, cap, 1, torch.float64, dev)
    split = cuda_rule.cuda_apply_rule_split(
        misc.oscillatory(NDIM), tables, lows, lengths, gl, gr, n=n,
        blocked=True, chunk_size=SPLIT_CHUNK)
    tile = cuda_rule.cuda_apply_rule(
        genz.f1_oscillatory(NDIM, np.ones(NDIM)), tables, lows, lengths, gl,
        gr, n=n, blocked=True)
    top = float(tile[0].abs().max())
    d_est = float((split[0] - tile[0]).abs().max()) / top
    d_err = float((split[1] - tile[1]).abs().max()) / top
    sd = int((split[2] == tile[2]).sum())
    print(f"phase 9: oscillatory(8) on the split route vs f1_oscillatory(8, "
          f"ones) on the tile route, {n} regions: max|d est| {d_est:.3g}, "
          f"max|d err| {d_err:.3g} of the largest |est| (limit 1e-12); "
          f"split_dim EQUAL in {sd}", flush=True)
    if not (d_est <= 1e-12 and d_err <= 1e-12):
        fail(f"oscillatory: split and tile routes differ by {d_est}, {d_err}")
    return worst


def split_times(dev):
    """Phase 10: the two split kernels alone at the Workspace's 8D f64
    chunk, beside their bytes bounds, their plain versions and a PyTorch
    call that computes the same (the points) or a part (the rule sums)."""
    ndim, c = NDIM, SPLIT_CHUNK
    tables = rule_eval.rule_tables(ndim, "float64")
    feval = tables.feval
    lows, lengths = random_pool(ndim, c, 5, torch.float64, dev)
    gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
    gr = torch.ones(ndim, dtype=torch.float64, device=dev)
    args = (tables, lows, lengths, gl, gr)
    x = cuda_rule.split_points(*args, 0, c)
    vals = f4_plain(x).to(torch.float64)
    out = cuda_rule.split_contract(vals, *args, 0)
    t = {}
    t["points"] = queued_ms(lambda: cuda_rule.split_points(*args, 0, c), 5, 10)
    t["contract"] = queued_ms(
        lambda: cuda_rule.split_contract(vals, *args, 0, out=out), 5)
    t["callable"] = queued_ms(lambda: f4_plain(x), 3, 5)
    t["plain_points"] = time_ms(lambda: rule_eval.rule_points(*args), 3)
    t["plain_contract"] = time_ms(
        lambda: rule_eval.rule_outputs(vals, tables, lengths, gr), 3)
    _, cen, ln = rule_eval.rule_points(*args)
    gen = rule_eval.device_tables(ndim, torch.float64, dev)[0]
    cen3, ln3 = cen.T[:, None, :], ln.T[:, None, :]
    t["addcmul"] = queued_ms(lambda: torch.addcmul(cen3, gen[None], ln3,
                                                   value=-1), 5, 10)
    # the TPU kernel's (P, 6 + 2n) contraction matrix: the five rule
    # weights, the centre, the single-axis pairs of orbits 1 and 2
    m = np.zeros((feval, 6 + 2 * ndim))
    m[:, :5] = tables.wts[:feval, :5]
    m[0, 5] = 1.0
    for d in range(ndim):
        m[1 + 2 * d:3 + 2 * d, 6 + d] = 1.0
        m[1 + 2 * ndim + 2 * d:3 + 2 * ndim + 2 * d, 6 + ndim + d] = 1.0
    mt = torch.as_tensor(m, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t["matmul"] = queued_ms(lambda: torch.matmul(vals, mt), 5)
    item = 8
    points_bytes = c * feval * ndim * item + 2 * ndim * c * item \
        + feval * ndim * item + 2 * ndim * item
    contract_bytes = c * feval * item + ndim * c * item + c * (2 * item + 4)
    b_points = bytes_bound_ms(points_bytes)
    b_contract = bytes_bound_ms(contract_bytes)
    print(f"phase 10: points kernel, {c} regions x {feval} points x {ndim} "
          f"(f64): {t['points']:.4f} ms, bound {b_points:.4f} ms "
          f"({points_bytes / 1e6:.1f} MB, bytes; "
          f"{100 * b_points / t['points']:.1f}"
          f"% of it); plain rule_points {t['plain_points']:.4f} ms; "
          f"torch.addcmul {t['addcmul']:.4f} ms", flush=True)
    print(f"phase 10: contraction kernel: {t['contract']:.4f} ms, bound "
          f"{b_contract:.4f} ms ({contract_bytes / 1e6:.1f} MB, bytes; "
          f"{100 * b_contract / t['contract']:.1f}% of it); plain "
          f"rule_outputs {t['plain_contract']:.4f} ms; the sums alone by "
          f"torch.matmul against the ({feval}, {6 + 2 * ndim}) column matrix "
          f"{t['matmul']:.4f} ms; the F4 callable on the chunk's points "
          f"{t['callable']:.4f} ms", flush=True)
    return t, b_points, b_contract


class SplitEvents:
    """CUDA events around every launch of the two split kernels and every
    call of the integrand (``f``, the integrand wrapped) while entered:
    ``seconds``, the time between the events of each part."""

    def __init__(self, integrand):
        self.integrand = integrand
        self.events = {"points": [], "callable": [], "contract": []}

    def _timed(self, what, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[what].append((start, end))
            return out
        return timed

    def __enter__(self):
        self.kept = (cuda_rule._points_launch, cuda_rule._contract_launch)
        cuda_rule._points_launch = self._timed("points", self.kept[0])
        cuda_rule._contract_launch = self._timed("contract", self.kept[1])
        self.f = self._timed("callable", self.integrand)
        return self

    def __exit__(self, *exc):
        cuda_rule._points_launch, cuda_rule._contract_launch = self.kept
        torch.cuda.synchronize()
        self.seconds = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3
                        for k, v in self.events.items()}
        return False


def split_main_path(dev, tile_run):
    """Phase 11: PAGANI's main path with its integrand as a plain callable,
    every rule evaluation through the split route, CUDA events around each
    kernel launch and each call of the callable; then a zoo integrand.
    Returns the split kernels' launches on the first run."""
    g4 = genz.f4_gaussian(NDIM)
    torch.cuda.synchronize()
    cuda_rule.reset_launches()
    with SplitEvents(f4_plain) as ev:
        t0 = time.perf_counter()
        res = Workspace(NDIM).integrate(ev.f, epsrel=1e-3, epsabs=1e-40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cuda_rule.split_launches)
    fused = cuda_rule.launches
    rel = abs(res.estimate - g4.true_value) / g4.true_value
    parts = ev.seconds
    rest = wall - sum(parts.values())
    print(f"phase 11: f64 8D F4 as a plain callable, epsrel 1e-3: status "
          f"{res.status} estimate {res.estimate!r} errorest {res.errorest!r} "
          f"rel.err {rel:.3e} iters {res.iters} nregions {res.nregions} neval "
          f"{res.neval} wall {wall:.3f} s evals/s {res.neval / wall:.4e}; "
          f"split kernels' launches {launches}, fused kernel's {fused}; "
          f"phase 3 (tile route, the same integrand): iters "
          f"{tile_run.iters} nregions {tile_run.nregions} neval "
          f"{tile_run.neval}", flush=True)
    print(f"phase 11: the wall by CUDA events around each launch and call "
          f"(they cost host time of their own): points kernel "
          f"{parts['points']:.4f} s, the callable {parts['callable']:.4f} s, "
          f"contraction kernel {parts['contract']:.4f} s, the rest (pool "
          f"stages, host) {rest:.4f} s = "
          f"{100 * parts['points'] / wall:.1f} / "
          f"{100 * parts['callable'] / wall:.1f} / "
          f"{100 * parts['contract'] / wall:.1f} / {100 * rest / wall:.1f} %",
          flush=True)
    if res.status != 0 or not rel <= 1e-3:
        fail(f"split main path: status {res.status}, rel.err {rel}")
    if fused or not launches["points"] or \
            launches["points"] != launches["contract"]:
        fail(f"split main path: launches {launches}, fused {fused}; every "
             "rule evaluation should take the split route")

    g = misc.sin_sum(NDIM)
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    res = Workspace(NDIM).integrate(g, epsrel=SIN_SUM_EPSREL, epsabs=1e-40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = abs(res.estimate - g.true_value) / abs(g.true_value)
    print(f"phase 11: f64 8D sin_sum (models.misc), epsrel "
          f"{SIN_SUM_EPSREL:g}: status {res.status} estimate "
          f"{res.estimate!r} truth {g.true_value!r} rel.err {rel:.3e} iters "
          f"{res.iters} nregions {res.nregions} neval {res.neval} wall "
          f"{wall:.3f} s; launches {dict(cuda_rule.split_launches)}, fused "
          f"{cuda_rule.launches}", flush=True)
    if res.status != 0 or not rel <= SIN_SUM_EPSREL or cuda_rule.launches \
            or not cuda_rule.split_launches["points"]:
        fail(f"sin_sum main path: status {res.status}, rel.err {rel}")
    return launches


CONT_POOL = 1 << 22      # a pool budget at which 8D F4's round 1 walls


def convergence_run(label, g, ws, **kw):
    """``ws.integrate_to_convergence(g, 1e-5, ...)`` with a stage timer and
    its ``integrate`` calls counted; printed, wall first.  Returns the
    result, its stages and its wall."""
    timer = StageTimer()
    runs = [0]
    integrate = ws.integrate

    def counted(*args, **kwargs):
        runs[0] += 1
        return integrate(*args, **kwargs)

    ws.integrate = counted
    cuda_rule.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ws.integrate_to_convergence(g, epsrel=1e-5, epsabs=1e-40,
                                      max_wall_s=600, stage_timer=timer,
                                      **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = abs(res.estimate - g.true_value) / g.true_value
    rounds = sum(1 for k in timer.times if "round" in k)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in timer.report().items())
    stages += (f", outside the stages (checkpoints, slicing, the queue) "
               f"{wall - sum(timer.times.values()):.3f} s")
    print(f"phase 12: wall {wall:.3f} s: {label}: status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g.true_value!r} rel.err {rel:.3e}; {rounds} rounds, "
          f"{runs[0] - rounds} slices; iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} evals/s {res.neval / wall:.4e}; "
          f"stages: {stages}; rule launches {dict(cuda_rule.route_launches)}",
          flush=True)
    if res.status != 0 or not rel <= 1e-5:
        fail(f"{label}: status {res.status}, rel.err {rel}")
    return res, timer.times, wall


def continuation_path(dev):
    """Phase 12: the reference's flagship, 8D Genz F4 at epsrel 1e-5, by
    ``integrate_to_convergence``, as it is (the 16M-region pool budget);
    then with the pool budget cut to CONT_POOL regions, where round 1 walls
    and the partitioned continuation must carry it; then that
    continuation stopped before its first slice (a passed deadline), saved,
    and resumed from the file."""
    g = genz.f4_gaussian(NDIM)
    ws = Workspace(NDIM)
    _, stages, wall = convergence_run(
        f"integrate_to_convergence, f64 8D f4_gaussian epsrel 1e-5, pool "
        f"budget {ws.max_pool_regions}", g, ws)
    engaged = ("engaged" if "slices" in stages
               else "did not engage: round 1 certified")
    print(f"phase 12: at the {ws.max_pool_regions}-region budget the "
          f"continuation {engaged}", flush=True)
    ws = Workspace(NDIM, max_pool_regions=CONT_POOL)
    res, stages, _ = convergence_run(
        f"the same, pool budget {CONT_POOL}", g, ws)
    if "slices" not in stages:
        fail(f"pool budget {CONT_POOL}: stages {sorted(stages)}; the "
             "partitioned continuation should engage")

    sp = cuda_build.BUILD_DIR / "continuation_state"
    ws2 = Workspace(NDIM, max_pool_regions=CONT_POOL)
    t0 = time.perf_counter()
    r1 = ws2.integrate(g, epsrel=1e-5, epsabs=1e-40)
    ck = ws2.make_checkpoint()
    ws2.final_pool = ws2.final_pool_errors = None
    cut = ws2._partitioned_continuation(
        g, 1e-5, 1e-40, None, ck, r1, 15, deadline=time.monotonic() - 1.0,
        state_path=sp)
    saved = (sp.parent / (sp.name + ".npz")).exists()
    resumed = Workspace(NDIM, max_pool_regions=CONT_POOL
                        ).integrate_to_convergence(
        g, epsrel=1e-5, epsabs=1e-40, max_wall_s=600, state_path=sp)
    torch.cuda.synchronize()
    same = (resumed.estimate, resumed.errorest, resumed.neval,
            resumed.nregions) == (res.estimate, res.errorest, res.neval,
                                  res.nregions)
    print(f"phase 12: stopped before the first slice (status {cut.status}, "
          f"state saved: {saved}), resumed from the file: status "
          f"{resumed.status} estimate {resumed.estimate!r} errorest "
          f"{resumed.errorest!r} neval {resumed.neval}: "
          f"{'the same' if same else 'NOT the same'} as the uninterrupted "
          f"run; {time.perf_counter() - t0:.3f} s", flush=True)
    if not (saved and resumed.status == 0 and same):
        fail("the continuation resumed from its state file differs from the "
             "uninterrupted run")
    return wall


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 1: build ------------------------------------------------------
    phase_t0 = t0 = time.perf_counter()
    sources = ["rule_eval.cu", "vegas_sample.cu", "vegas_lookup.cu",
               "rule_split.cu"]
    libs = cuda_build.build_many(sources)
    print(f"phase 1: built {len(libs)} libraries with nvcc in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        print(f"phase 1: {lib.name}: ptxas: {ptxas_summary(log)}; "
              f"{log.strip().splitlines()[-1]}", flush=True)

    try:
        sass = sass_report.report()
        sass_report.show(sass)
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        sass = None
        print(f"phase 1: no SASS report ({e})", flush=True)

    def phase_done(name):
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"{name} took {now - phase_t0:.1f} s", flush=True)
        phase_t0 = now

    phase_done("phase 1")

    # -- phase 2: kernel vs plain version ------------------------------------
    cap = 1 << 16
    n = cap - (cap >> 3)           # blocked pool with padding slots
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, cap, 1, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for g in genz.genz_suite(NDIM):
            compare(f"phase 2: {g.name} {str(dtype)[6:]}", g, tables, lows,
                    lengths, gl, gr, n=n, blocked=True, route="tile")
            compare_routes(f"phase 2: {g.name} {str(dtype)[6:]}", g, tables,
                           lows, lengths, gl, gr, n=n, blocked=True)
    # the generic route at shapes the tile route does not take
    for ndim, small_cap in ((9, 1 << 12), (2, 1 << 14)):
        if cuda_rule.rule_route(ndim) != "generic":
            fail(f"a {ndim}D pool should take the rule kernel's generic route")
        tables = rule_eval.rule_tables(ndim, "float64")
        lows, lengths = random_pool(ndim, small_cap, 3, torch.float64, dev)
        gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
        gr = torch.ones(ndim, dtype=torch.float64, device=dev)
        for g in (genz.f4_gaussian(ndim), genz.f1_oscillatory(ndim)):
            compare(f"phase 2: generic route {ndim}D {g.name} float64", g,
                    tables, lows, lengths, gl, gr,
                    n=small_cap - (small_cap >> 3), blocked=True)

    phase_done("phase 2")

    # -- phase 3: the main path ----------------------------------------------
    # CUDA events around each launch give the kernel's share of the wall.
    kernel_events = []
    launch = cuda_rule.cuda_apply_rule

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        kernel_events.append((start, end))
        return out

    g4 = genz.f4_gaussian(NDIM)
    ws = Workspace(NDIM)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_rule.cuda_apply_rule = timed_launch
    cuda_rule.reset_launches()
    t0 = time.perf_counter()
    try:
        res = ws.integrate(g4, epsrel=1e-3, epsabs=1e-40)
        torch.cuda.synchronize()
    finally:
        cuda_rule.cuda_apply_rule = launch
    wall = time.perf_counter() - t0
    main_launches = cuda_rule.launches
    main_routes = dict(cuda_rule.route_launches)
    kernel_s = sum(s.elapsed_time(e) for s, e in kernel_events) / 1e3
    rel = abs(res.estimate - g4.true_value) / g4.true_value
    print(f"phase 3: f64 8D f4_gaussian epsrel 1e-3: status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g4.true_value!r} rel.err {rel:.3e} iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} wall {wall:.3f} s evals/s "
          f"{res.neval / wall:.4e} peak capacity {ws.peak_capacity} peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"kernel launches {main_launches} (by route {main_routes}), "
          f"kernel time {kernel_s:.4f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall, CUDA events)",
          flush=True)
    if res.status != 0 or not rel <= 1e-3:
        fail(f"main path: status {res.status}, rel.err {rel}")
    if main_launches <= 0 or main_routes["tile"] != main_launches:
        fail(f"main path: {main_launches} launches of the CUDA rule kernel, "
             f"by route {main_routes}; all should take the tile route")
    final_lows, final_lengths, final_n, final_blocked = ws.final_pool

    ws32 = Workspace(NDIM, dtype=torch.float32)
    t0 = time.perf_counter()
    r32 = ws32.integrate(g4, epsrel=1e-3, epsabs=1e-40)
    torch.cuda.synchronize()
    rel32 = abs(r32.estimate - g4.true_value) / g4.true_value
    print(f"phase 3: f32 8D f4_gaussian epsrel 1e-3: status {r32.status} "
          f"rel.err {rel32:.3e} iters {r32.iters} nregions {r32.nregions} "
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    lo32, len32, n32, blocked32 = ws32.final_pool
    compare(f"f32 main-path pool ({n32} regions)", g4,
            rule_eval.rule_tables(NDIM, "float32"), lo32, len32,
            torch.zeros(NDIM, dtype=torch.float32, device=dev),
            torch.ones(NDIM, dtype=torch.float32, device=dev),
            n=n32, blocked=blocked32, min_agree=0.0)
    del ws32, lo32, len32

    g3 = genz.f4_gaussian(3, a=5.0)
    on_card = Workspace(3, chunk_size=1024).integrate(g3, 1e-5, 1e-40)
    on_cpu = Workspace(3, chunk_size=1024, device="cpu").integrate(
        g3, 1e-5, 1e-40)
    same = ((on_card.status, on_card.iters, on_card.nregions, on_card.neval)
            == (on_cpu.status, on_cpu.iters, on_cpu.nregions, on_cpu.neval)
            and math.isclose(on_card.estimate, on_cpu.estimate,
                             rel_tol=1e-10))
    print(f"phase 3: 3D f4 card vs cpu: {on_card.estimate!r} vs "
          f"{on_cpu.estimate!r}, iters {on_card.iters}/{on_cpu.iters}, "
          f"nregions {on_card.nregions}/{on_cpu.nregions}", flush=True)
    if not same:
        fail("3D run on the card differs from the same run on the CPU")

    # -- the kernel at the main path's shapes: its last pool, f64 F4 ---------
    tables64 = rule_eval.rule_tables(NDIM, "float64")
    gl = torch.zeros(NDIM, dtype=torch.float64, device=dev)
    gr = torch.ones(NDIM, dtype=torch.float64, device=dev)
    main_args = (g4, tables64, final_lows, final_lengths, gl, gr)
    main_kw = {"n": final_n, "blocked": final_blocked}
    d_main = compare(f"f64 main-path pool ({final_n} regions, capacity "
                     f"{final_lows.shape[1]})", *main_args, **main_kw,
                     min_agree=0.0)["max_abs_est"]
    compare_routes("f64 main-path pool", *main_args, **main_kw)

    def routed(route):
        return lambda: cuda_rule.cuda_apply_rule(*main_args, **main_kw,
                                                 route=route)

    # tile, generic, generic, tile: the two within one call
    t = [time_ms(routed("tile"), 5), time_ms(routed("generic"), 2),
         time_ms(routed("generic"), 2), time_ms(routed("tile"), 5)]
    ms_main, generic_main = min(t[0], t[3]), min(t[1], t[2])
    plain_main = time_ms(lambda: rule_eval.apply_rule_plain(
        *main_args, chunk_size=ws.chunk_size, **main_kw), 2)
    b_main, by_main = bound_ms(4, NDIM, final_n, torch.float64)
    f64_per_point = tile_f64_per_point(sass)
    floor = "not measured (no SASS report)"
    if f64_per_point is not None:
        floor_ms = f64_pipe_floor_ms(NDIM, final_n, f64_per_point)
        floor = (
             f"{floor_ms:.3f} ms ({ms_main / floor_ms:.2f} times it; "
             f"{f64_per_point:g} f64 instructions a point in this "
             f"build's machine code, {NDIM + 1} of them the axes' and the "
             f"sum's, the rest the exp's; at the bound's "
             f"{PEAK_OPS[torch.float64] / 1e12:g} TFLOP/s)")
    print(f"main-path pool: tile route {ms_main:.4f} ms (two series "
          f"{t[0]:.4f}, {t[3]:.4f}), generic route {generic_main:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_main:.3f} ms, bound "
          f"{b_main:.4f} ms ({by_main}, {100 * b_main / ms_main:.1f}% of it), "
          f"f64 pipe floor {floor}", flush=True)

    phase_done("phase 3")

    # -- phase 4: kernel time on 2^21 regions --------------------------------
    big = 1 << 21
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, big, 2, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for g in genz.genz_suite(NDIM):
            ms, generic = (time_ms(lambda: cuda_rule.cuda_apply_rule(
                g, tables, lows, lengths, gl, gr, route=route), reps)
                for route, reps in (("tile", 5), ("generic", 3)))
            b, by = bound_ms(g.kind, NDIM, big, dtype)
            line = (f"phase 4: {g.name} {str(dtype)[6:]} 2^21 regions: tile "
                    f"route {ms:.3f} ms = "
                    f"{big * tables.feval / ms * 1e3:.4e} evals/s, generic "
                    f"route {generic:.3f} ms, bound {b:.3f} ms ({by}, "
                    f"{100 * b / ms:.1f}% of it)")
            if g.kind == 4:
                plain = time_ms(lambda: rule_eval.apply_rule_plain(
                    g, tables, lows, lengths, gl, gr, chunk_size=4096), 2)
                line += f", plain {plain:.1f} ms"
            print(line, flush=True)
        del lows, lengths
        torch.cuda.empty_cache()

    # lower dimensions: a whole warp per region there too
    for ndim in (3, 5, 6):
        tables = rule_eval.rule_tables(ndim, "float64")
        lows, lengths = random_pool(ndim, big, 2, torch.float64, dev)
        gl = torch.zeros(ndim, dtype=torch.float64, device=dev)
        gr = torch.ones(ndim, dtype=torch.float64, device=dev)
        g = genz.f4_gaussian(ndim)
        ms, generic = (time_ms(lambda: cuda_rule.cuda_apply_rule(
            g, tables, lows, lengths, gl, gr, route=route), 3)
            for route in ("tile", "generic"))
        b, by = bound_ms(4, ndim, big, torch.float64)
        print(f"phase 4: {g.name} float64 {ndim}D ({tables.feval} points) "
              f"2^21 regions: tile route {ms:.3f} ms, generic route "
              f"{generic:.3f} ms, bound {b:.3f} ms ({by}, "
              f"{100 * b / ms:.1f}% of it)", flush=True)
        del lows, lengths

    phase_done("phase 4")

    # -- phases 5-7: VEGAS ---------------------------------------------------
    vegas_err = vegas_checks(dev)
    phase_done("phase 5")
    vegas_launches, vegas_walls = vegas_main_path(dev)
    phase_done("phase 6")
    vegas_kernels = vegas_times(dev, vegas_err, vegas_launches, vegas_walls)
    phase_done("phase 7")

    # -- phase 8: the diff path ----------------------------------------------
    edge_launches, edge_routes, edge_err, edge_fields = diff_path(dev)
    for entry in vegas_kernels:
        if entry["name"] == "vegas_edge_lookup":
            entry.update(launches=edge_launches,
                         launches_by_route=edge_routes,
                         max_abs_err=max(entry["max_abs_err"], edge_err),
                         **edge_fields)
    phase_done("phase 8")

    # -- phases 9-12: the split route, the continuation ----------------------
    split_err = split_checks(dev)
    phase_done("phase 9")
    split_ms, b_points, b_contract = split_times(dev)
    phase_done("phase 10")
    split_launches = split_main_path(dev, res)
    phase_done("phase 11")
    continuation_path(dev)
    phase_done("phase 12")

    # -- the kernels line ----------------------------------------------------
    kernels = [{
        "name": "rule_eval",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_eval.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 2 (F1-F6 8D, f64 and f32) and the "
                                 "main-path pool",
        "launches": main_launches,
        "launches_by_route": main_routes,
        "max_abs_err": d_main,
        "ms": ms_main,
        "generic_route_ms": generic_main,
        "plain_ms": plain_main,
        "bound_ms": b_main,
        "bound_by": by_main,
        "library_ms": None,
    }] + vegas_kernels + [{
        "name": "rule_split_points",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_split.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 9 (EQUAL to rule_eval.rule_points)",
        "launches": split_launches["points"],
        "max_abs_err": 0.0,
        "ms": split_ms["points"],
        "plain_ms": split_ms["plain_points"],
        "bound_ms": b_points,
        "bound_by": "bytes",
        "library_ms": split_ms["addcmul"],
    }, {
        "name": "rule_split_contract",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_split.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 9 (rule_eval.rule_outputs)",
        "launches": split_launches["contract"],
        "max_abs_err": split_err,
        "ms": split_ms["contract"],
        "plain_ms": split_ms["plain_contract"],
        "bound_ms": b_contract,
        "bound_by": "bytes",
        "library_ms": None,
        "sums_only_matmul_ms": split_ms["matmul"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
