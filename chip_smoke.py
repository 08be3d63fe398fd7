"""Smoke run of gpuintegration_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources, holds each against its plain
PyTorch version, drives PAGANI's ``Workspace.integrate`` at 8D and the
VEGAS ``mcubes.integrate`` at 6D through them, and times them.  Imports no
JAX.  Phases (any failure exits non-zero and prints no result line; each
prints its seconds):

The rule kernel and the sampler each have two routes, chosen by the shape:
the one built for this card ('tile', 'paired') and the generic one, which
takes every shape and is the earlier design.  The main paths must go
through the first; the generic routes are held at shapes only they take,
and timed beside the others in the same run.

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
6. the VEGAS main path, 6D Genz F4 (a = 25), epsabs 1e-40: (1) the
   default ``integrate(f, epsrel=1e-3, ncall=1e8)`` (f64, poly map,
   sampler 'hybrid'); (2) ``eval_dtype=float32, ncall=1e9, total_iters=10,
   adjust_iters=5`` (sampler 'fused'); (3) ``importance='grid',
   ncall=1e8``.  Each must end status 0 with |est - truth| <= 5 errorest
   and errorest/|est| <= epsrel, having launched its kernels (counts set
   to 0 before and read after each run), the sampler's all through the
   paired route; run 1 repeated must give the same bits; run 2 repeated
   with CUDA events around every launch says what the events cost and what
   share of the wall the launches are; a 3D run on the card must agree with the same run on the
   CPU;
7. the VEGAS kernels' times at the main path's shapes, the sampler on both
   routes, best of 5 (CUDA events), beside the plain versions', a bound, and one PyTorch call
   computing the same function where there is one;
8. the ``kernels`` JSON line, then the card line and the result line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import kernel_check as vegas_check
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import (cuda_build, cuda_rule, kernel_check,
                                      rule_eval)
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.tools import sass_report

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
            e = vegas_check.check_edge_lookup(VEGAS_NDIM, VEGAS_CHUNK, 2,
                                              nbins, device=dev)
        except AssertionError as exc:
            fail(str(exc))
        print(f"phase 5: nbins {nbins}, {n} samples: histogram max rel "
              f"{h['max_rel']:.3g} (limit {vegas_check.HIST_RTOL:g}), two "
              f"launches bitwise equal; bin resolve ia, xo equal, rc "
              f"{b['rc_ulps']} ulps given xn and {bs['rc_ulps']} drawing xn "
              f"(limit {vegas_check.RC_ULP}); edge lookup equal", flush=True)
        if nbins == 500:
            err.update(vegas_hist=h["max_abs"], vegas_bin_resolve=max(
                b["max_abs"], bs["max_abs"]), vegas_edge_lookup=e["max_abs"])
    return err


class LaunchCounts:
    """The launch counts of the VEGAS wrappers for one run: set to 0 on
    entry, read on exit.  (The kernels are too short for events around each
    launch to time them: phase 7 times each alone, and reckons from the
    counts what the card was busy with.)"""

    def __enter__(self):
        cuda_vegas.reset_launches()
        cuda_lookup.hist_launches = 0
        cuda_lookup.bin_resolve_launches = 0
        cuda_lookup.edge_lookup_launches = 0
        return self

    def __exit__(self, *exc):
        self.sampler_routes = dict(cuda_vegas.route_launches)
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
    NAMES = ((cuda_vegas, "sample_chunk"), (cuda_lookup, "hist"),
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


def vegas_run(label, g, expect, events=False, **kw):
    """One VEGAS run through the entry point; requires status 0, the truth
    within 5 errorest, errorest/|est| <= epsrel and a launch of every
    kernel in ``expect``.  Returns (result, launches, wall seconds).  With
    ``events`` the launches run between CUDA events, and their share of
    that run's (longer) wall is printed."""
    torch.cuda.synchronize()
    with LaunchCounts() as clock:
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
          f"{res.neval / wall:.4e} launches {clock.launches} (sampler by "
          f"route {clock.sampler_routes})", flush=True)
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
    _, l3, walls["run3"] = vegas_run(
        "run 3, f64 grid ncall 1e8", g6, {"vegas_bin_resolve", "vegas_hist"},
        epsrel=1e-3, ncall=1e8, importance="grid")

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

    # the histogram on the ids and f^2 that the fused sampler emits
    _, ia, f2 = cuda_vegas.sample_chunk(
        pmap, g4, case["ng"], npg, case["chunk_cubes"], nbins, True, *tail)
    ia64 = ia.to(torch.int64)
    ms = queued_ms(lambda: cuda_lookup.hist(ia, f2, nbins), 5)
    plain = time_ms(lambda: cuda_lookup.hist_plain(ia, f2, nbins), 2)
    lib = queued_ms(lambda: [torch.bincount(ia64[d], weights=f2,
                                            minlength=nbins)
                             for d in range(ndim)], 5)
    hist_ms = ms
    b = bytes_bound_ms(n * (4 * ndim + 4) + 4 * ndim * nbins)
    print(f"phase 7: histogram, {n} samples: kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, torch.bincount per dimension {lib:.4f} ms, bound "
          f"{b:.4f} ms (bytes, {100 * b / ms:.1f}% of it)", flush=True)
    entries.append({
        "name": "vegas_hist", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:223",
        "launches": launches["run1"]["vegas_hist"],
        "launches_by_run": {r: c["vegas_hist"] for r, c in launches.items()},
        "max_abs_err": err["vegas_hist"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib})

    # the bin resolve as run 3 launches it: xn drawn in the kernel, ids out
    xi32 = torch.as_tensor(vegas_check.random_grid(ndim, nbins, 0),
                           dtype=torch.float32, device=dev)
    rargs = (xi32, nbins, case["ng"], npg, case["chunk_cubes"],
             case["cube0"], case["ncubes"], 0, 1)
    ms = queued_ms(lambda: cuda_lookup.bin_resolve_stratified(
        *rargs, with_ia=True), 5)
    plain = time_ms(lambda: cuda_lookup.bin_resolve_stratified_plain(
        *rargs, with_ia=True), 2)
    xn, _ = cuda_lookup.stratified_xn_plain(
        ndim, case["ng"], npg, nbins, case["chunk_cubes"], case["cube0"],
        case["ncubes"], 0, 1, dev)
    xn = xn.contiguous()
    ms_given = queued_ms(lambda: cuda_lookup.bin_resolve(xi32, xn, nbins,
                                                         with_ia=True), 5)
    idx = torch.clamp(xn.to(torch.int64), 1, nbins)
    idx_lo = idx - 1
    lib = queued_ms(lambda: (torch.gather(xi32, 1, idx_lo),
                             torch.gather(xi32, 1, idx)), 5)
    resolve_ms = ms
    b = bytes_bound_ms(n * ndim * 12 + 4 * ndim * (nbins + 1))
    print(f"phase 7: bin resolve, {n} samples x {ndim}: kernel drawing xn "
          f"{ms:.4f} ms, given xn {ms_given:.4f} ms, plain {plain:.2f} ms, "
          f"two torch.gather {lib:.4f} ms, bound {b:.4f} ms (bytes, "
          f"{100 * b / ms:.1f}% of it)", flush=True)
    entries.append({
        "name": "vegas_bin_resolve", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:152",
        "launches": launches["run3"]["vegas_bin_resolve"],
        "launches_by_run": {r: c["vegas_bin_resolve"]
                            for r, c in launches.items()},
        "max_abs_err": err["vegas_bin_resolve"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib,
        "given_xn_ms": ms_given})

    ids = idx.T.reshape(case["chunk_cubes"], npg, ndim).to(
        torch.int32).contiguous()
    ms = queued_ms(lambda: cuda_lookup.edge_lookup(xi32, ids, nbins), 5)
    plain = time_ms(lambda: cuda_lookup.edge_lookup_plain(xi32, ids, nbins),
                    2)
    b = bytes_bound_ms(n * ndim * 12 + 4 * ndim * (nbins + 1))
    print(f"phase 7: edge lookup, {n} samples x {ndim}: kernel {ms:.4f} ms, "
          f"plain {plain:.3f} ms, two torch.gather {lib:.4f} ms, bound "
          f"{b:.4f} ms (bytes, {100 * b / ms:.1f}% of it)", flush=True)
    entries.append({
        "name": "vegas_edge_lookup", "route": "cuda",
        "source": "gpuintegration_torch/csrc/vegas_lookup.cu",
        "replaces": "gpuintegration_tpu/mcubes/pallas_lookup.py:86",
        "launches": launches["run1"]["vegas_edge_lookup"],
        "launches_by_run": {r: c["vegas_edge_lookup"]
                            for r, c in launches.items()},
        "on_main_path": False,
        "max_abs_err": err["vegas_edge_lookup"], "ms": ms, "plain_ms": plain,
        "bound_ms": b, "bound_by": "bytes", "library_ms": lib})

    # what the card was busy with in each run: launches times the time of a
    # kernel alone, against the run's wall
    adj = {"run1": (sampler_ms["emit+hist (run 1, adjusting)"][0],
                    sampler_ms["emit (run 1, frozen)"][0]),
           "run2": (sampler_ms["fused F4+hist (run 2, adjusting)"][0],
                    sampler_ms["fused F4 (run 2, frozen)"][0]),
           "run3": (resolve_ms, resolve_ms)}
    for run, (with_hist_ms, bare_ms) in adj.items():
        c = launches[run]
        first = c["vegas_sample"] + c["vegas_bin_resolve"]
        busy = (c["vegas_hist"] * (with_hist_ms + hist_ms)
                + (first - c["vegas_hist"]) * bare_ms) / 1e3
        print(f"phase 7: {run}: its kernels alone would take {busy:.4f} s "
              f"({first} + {c['vegas_hist']} launches at the times above) of "
              f"the {walls[run]:.3f} s wall = {100 * busy / walls[run]:.1f}%",
              flush=True)
    return entries


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
    sources = ["rule_eval.cu", "vegas_sample.cu", "vegas_lookup.cu"]
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

    # -- phase 8: the kernels line -------------------------------------------
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
    }] + vegas_kernels
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
