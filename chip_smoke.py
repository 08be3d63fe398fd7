"""Smoke run of gpuintegration_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA rule kernel from the sources, holds it against the plain
PyTorch version, drives PAGANI's ``Workspace.integrate`` at 8D through it,
and times it.  Imports no JAX.  Phases (any failure exits non-zero and
prints no result line):

1. the card's name and power limit; the nvcc build, its seconds and
   ptxas's registers and spills;
2. kernel vs plain version on the card (kernel_check.check_against_plain,
   printed beside its limits): F1-F6 at 8D, a pool of 2^16 regions
   (uniform split plus random sub-regions, blocked layout with padding
   slots), f64 and f32;
3. the main path: ``Workspace(8).integrate(f4_gaussian(8), epsrel=1e-3)``
   in f64 (status 0 and |est - truth|/truth <= 1e-3 required; the
   kernel's share of the wall from CUDA events), then the same in f32
   (reported only), each final pool held against the plain version, and
   a 3D run on the card against the same run on the CPU;
4. kernel time at 8D on 2^21 regions, f64 and f32, best of 5 (CUDA
   events), beside the plain version's;
5. the ``kernels`` JSON line, then the card line and the result line.
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

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval
from gpuintegration_torch.pagani import region_pool

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


def time_ms(fn, reps: int) -> float:
    """Best of ``reps`` single calls, CUDA events, after one warm call."""
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


def random_pool(ndim: int, cap: int, seed: int, dtype, device):
    """``cap`` regions: random sub-boxes of the 2-per-axis uniform split."""
    parents_lo, parents_len, n0 = region_pool.uniform_split(
        ndim, 2, 2 ** ndim, torch.float64)
    rng = np.random.default_rng(seed)
    pick = np.arange(cap) % n0
    frac = rng.uniform(2.0 ** -6, 1.0, (ndim, cap))
    off = rng.uniform(0.0, 1.0, (ndim, cap)) * (1.0 - frac)
    plen = parents_len.numpy()[:, pick]
    lows = parents_lo.numpy()[:, pick] + off * plen
    lengths = frac * plen
    return (torch.as_tensor(lows, dtype=dtype, device=device).contiguous(),
            torch.as_tensor(lengths, dtype=dtype, device=device).contiguous())


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


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        return "ptxas reported no register counts"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers per "
            f"thread, at most {max(spills, default=0)} spill bytes")


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
    t0 = time.perf_counter()
    lib = cuda_rule.build()
    print(f"phase 1: built {lib.name} with nvcc in "
          f"{time.perf_counter() - t0:.2f} s; ptxas: "
          f"{ptxas_summary(lib.with_suffix('.log').read_text())}", flush=True)

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
                    lengths, gl, gr, n=n, blocked=True)

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
    cuda_rule.launches = 0
    t0 = time.perf_counter()
    try:
        res = ws.integrate(g4, epsrel=1e-3, epsabs=1e-40)
        torch.cuda.synchronize()
    finally:
        cuda_rule.cuda_apply_rule = launch
    wall = time.perf_counter() - t0
    main_launches = cuda_rule.launches
    kernel_s = sum(s.elapsed_time(e) for s, e in kernel_events) / 1e3
    rel = abs(res.estimate - g4.true_value) / g4.true_value
    print(f"phase 3: f64 8D f4_gaussian epsrel 1e-3: status {res.status} "
          f"estimate {res.estimate!r} errorest {res.errorest!r} truth "
          f"{g4.true_value!r} rel.err {rel:.3e} iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} wall {wall:.3f} s evals/s "
          f"{res.neval / wall:.4e} peak capacity {ws.peak_capacity} peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"kernel launches {main_launches}, kernel time {kernel_s:.4f} s "
          f"({100 * kernel_s / wall:.1f}% of the wall, CUDA events)",
          flush=True)
    if res.status != 0 or not rel <= 1e-3:
        fail(f"main path: status {res.status}, rel.err {rel}")
    if main_launches <= 0:
        fail("main path did not launch the CUDA rule kernel")
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
    ms_main = time_ms(lambda: rule_eval.apply_rule(*main_args, **main_kw), 5)
    plain_main = time_ms(lambda: rule_eval.apply_rule_plain(
        *main_args, chunk_size=ws.chunk_size, **main_kw), 2)
    b_main, by_main = bound_ms(4, NDIM, final_n, torch.float64)
    print(f"main-path pool: kernel {ms_main:.4f} ms, plain "
          f"{plain_main:.3f} ms, bound {b_main:.4f} ms ({by_main})",
          flush=True)

    # -- phase 4: kernel time on 2^21 regions --------------------------------
    big = 1 << 21
    for dtype in (torch.float64, torch.float32):
        tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
        lows, lengths = random_pool(NDIM, big, 2, dtype, dev)
        gl = torch.zeros(NDIM, dtype=dtype, device=dev)
        gr = torch.ones(NDIM, dtype=dtype, device=dev)
        for g in genz.genz_suite(NDIM):
            ms = time_ms(lambda: rule_eval.apply_rule(
                g, tables, lows, lengths, gl, gr), 5)
            b, by = bound_ms(g.kind, NDIM, big, dtype)
            line = (f"phase 4: {g.name} {str(dtype)[6:]} 2^21 regions: kernel "
                    f"{ms:.3f} ms = {big * tables.feval / ms * 1e3:.4e} "
                    f"evals/s, bound {b:.3f} ms ({by}, "
                    f"{100 * b / ms:.1f}% of it)")
            if g.kind == 4:
                plain = time_ms(lambda: rule_eval.apply_rule_plain(
                    g, tables, lows, lengths, gl, gr, chunk_size=4096), 2)
                line += f", plain {plain:.1f} ms"
            print(line, flush=True)
        del lows, lengths
        torch.cuda.empty_cache()

    # -- phase 5: the kernels line -------------------------------------------
    kernels = [{
        "name": "rule_eval",
        "route": "cuda",
        "source": "gpuintegration_torch/csrc/rule_eval.cu",
        "replaces": "gpuintegration_tpu/ops/pallas_rule.py:86",
        "held_against_plain_in": "phase 2 (F1-F6 8D, f64 and f32) and the "
                                 "main-path pool",
        "launches": main_launches,
        "max_abs_err": d_main,
        "ms": ms_main,
        "plain_ms": plain_main,
        "bound_ms": b_main,
        "bound_by": by_main,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
