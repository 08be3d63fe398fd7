"""Demo and timing harnesses with the reference's CSV schemas (PyTorch port
of ``gpuintegration_tpu/utils/timing.py``; reference harnesses
cuda/pagani/demos/new_time_and_call.cuh:129-245 clean_time_and_call,
cuda/mcubes/demos/demo_utils.cuh:50-100 mcubes_time_and_call,
new_time_and_call.cuh:30-70 call_cubature_rules).

The rows' ``backend`` column names the port's route: ``torch`` for the
plain PyTorch path (a CPU run, or rule_backend='torch'), else PAGANI's
rule backend and kernel route (``cuda-tile``, ``cuda-generic``,
``cuda-split``, ``fused-tile``, ``fused-generic``) and VEGAS's sampler
(``fused``, ``hybrid``, ``torch``; ``grid`` for the grid map's kernels).
Walls are host clocks around calls that end in a synchronisation of the
card (or on the CPU), so they hold the device's work.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from gpuintegration_torch.integrand import (_positional_arity, deduce_ncomp,
                                            make_integrand)
from gpuintegration_torch.mcubes import vegas as vegas_mod
from gpuintegration_torch.ops import cuda_rule, integrand_gen, rule_eval
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.pagani.workspace import Workspace
from gpuintegration_torch.types import Volume

PAGANI_CSV_HEADER = ("id,ndim,backend,true_value,epsrel,epsabs,estimate,"
                     "errorest,nregions,nFinishedRegions,iters,status,time_ms")
MCUBES_CSV_HEADER = ("id,ndim,backend,true_value,epsrel,epsabs,estimate,"
                     "errorest,chi_sq,iters,status,time_ms")
RULES_CSV_HEADER = ("splits_per_dim,regions,padded_capacity,feval,best_s,"
                    "evals_per_sec")
BACKENDS = ("cuda", "fused", "torch")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pagani_backend(ws: Workspace, integrand) -> str:
    """The ``backend`` column of a Workspace's run: 'torch' where the plain
    version runs, else '<rule_backend>-<route>'."""
    if ws.device.type != "cuda" or ws.rule_backend == "torch":
        return "torch"
    if ws.rule_backend == "fused":
        return f"fused-{cuda_rule.rule_route(ws.ndim)}"
    f, _ = make_integrand(integrand, ws.ndim)
    ncomp = deduce_ncomp(f, ws.ndim, ws.dtype, ws.device)
    return f"cuda-{cuda_rule.rule_route(ws.ndim, integrand, ncomp)}"


def clean_time_and_call(
    id: str,
    integrand: Callable,
    epsrel: float,
    true_value: float,
    outfile=None,
    *,
    ndim: int | None = None,
    vol: Volume | None = None,
    epsabs: float = 1e-40,
    runs_per_epsrel: int = 10,
    relerr_classification: bool = True,
    workspace: Workspace | None = None,
    continuation: bool = False,
    max_wall_s: float | None = None,
    **integrate_kw,
) -> bool:
    """Repeated adaptive runs at one tolerance, a CSV row
    (PAGANI_CSV_HEADER) per run.  ``continuation=True`` drives
    ``Workspace.integrate_to_convergence`` (``max_wall_s`` bounding each
    run) instead of ``integrate``.  ``workspace`` None builds
    ``Workspace(ndim)`` on the card.  Returns True if any run converged
    (status 0), the reference harness's contract
    (new_time_and_call.cuh:170-173); extra keyword arguments go to the
    drive function."""
    _, nd = make_integrand(integrand, ndim)
    ws = workspace or Workspace(nd)
    drive = ws.integrate_to_convergence if continuation else ws.integrate
    extra = dict(integrate_kw)
    if continuation:
        extra["max_wall_s"] = max_wall_s
    backend = pagani_backend(ws, integrand)
    good = False
    for _ in range(runs_per_epsrel):
        t0 = time.perf_counter()
        res = drive(integrand, epsrel, epsabs, vol,
                    relerr_classification=relerr_classification, **extra)
        _sync(ws.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        good = good or res.status == 0
        row = (f"{id},{nd},{backend},{true_value:.15e},{epsrel:.15e},"
               f"{epsabs:.15e},{res.estimate:.15e},{res.errorest:.15e},"
               f"{res.nregions},{res.nFinishedRegions},{res.iters},"
               f"{res.status},{dt_ms}")
        if outfile is not None:
            print(row, file=outfile, flush=True)
    return good


def epsrel_ladder(
    id: str,
    integrand: Callable,
    true_value: float,
    outfile=None,
    *,
    start: float = 1e-3,
    floor: float = 1e-9,
    ndim: int | None = None,
    runs_per_epsrel: int = 2,
    **kw,
) -> float | None:
    """Tighten epsrel by 5x until a rung fails or the floor is passed;
    returns the last tolerance achieved, None when the first rung failed
    (the reference demos' ladder, e.g. new_interface_Genz3_3D.cu)."""
    epsrel = start
    achieved = None
    while epsrel >= floor:
        good = clean_time_and_call(
            id, integrand, epsrel, true_value, outfile, ndim=ndim,
            runs_per_epsrel=runs_per_epsrel, **kw)
        if not good:
            break
        achieved = epsrel
        epsrel /= 5.0
    return achieved


def vegas_backend(integrand, ndim, vegas_kw) -> str:
    """The ``backend`` column of a VEGAS run: the sampler it takes."""
    dev = torch.device(vegas_kw.get("device") or "cuda")
    dtype = vegas_kw.get("dtype", torch.float64)
    ed = vegas_kw.get("eval_dtype") or dtype
    importance = vegas_kw.get("importance") or "poly"
    f, nd = make_integrand(integrand, ndim)
    sampler = vegas_mod._resolve_sampler(
        vegas_kw.get("sampler"), importance, dev.type, ed, integrand,
        deduce_ncomp(f, nd, dtype, dev))
    return sampler or importance


def mcubes_time_and_call(
    id: str,
    integrand: Callable,
    epsrel: float,
    true_value: float,
    outfile=None,
    *,
    ndim: int | None = None,
    ncall: float = 1e6,
    vol: Volume | None = None,
    epsabs: float = 1e-40,
    total_iters: int = 15,
    adjust_iters: int = 15,
    skip_iters: int = 5,
    runs: int = 1,
    seed: int = 0,
    **vegas_kw,
) -> bool:
    """VEGAS runs with CSV rows (MCUBES_CSV_HEADER, the demo_utils.cuh:
    50-100 schema), seeds ``seed``, ``seed + 1``, ...  Extra keyword
    arguments (importance=, eval_dtype=, sampler=, device=, ...) go to
    ``mcubes.integrate``; None values are dropped.  Returns True if any
    run converged."""
    _, nd = make_integrand(integrand, ndim)
    vegas_kw = {k: v for k, v in vegas_kw.items() if v is not None}
    backend = vegas_backend(integrand, ndim, vegas_kw)
    dev = vegas_kw.get("device") or "cuda"
    good = False
    for i in range(runs):
        t0 = time.perf_counter()
        res = vegas_mod.integrate(
            integrand, epsrel, epsabs, ncall, vol, total_iters=total_iters,
            adjust_iters=adjust_iters, skip_iters=skip_iters,
            seed=seed + i, ndim=ndim, **vegas_kw)
        _sync(dev)
        dt_ms = (time.perf_counter() - t0) * 1e3
        good = good or res.status == 0
        row = (f"{id},{nd},{backend},{true_value:.15e},{epsrel:.15e},"
               f"{epsabs:.15e},{res.estimate:.15e},{res.errorest:.15e},"
               f"{res.chi_sq:.5f},{res.iters},{res.status},{dt_ms}")
        if outfile is not None:
            print(row, file=outfile, flush=True)
    return good


def call_cubature_rules(
    integrand: Callable,
    ndim: int,
    *,
    splits_per_dim: Sequence[int] = range(5, 16),
    max_regions: int = 35_000_000,
    repeats: int = 11,
    chunk: int = 8192,
    dtype: str = "float64",
    backend: str = "cuda",
    outfile=None,
    device=None,
):
    """Rule-evaluation throughput: for each uniform split s (s^ndim regions,
    at most ``max_regions``) one pool of the next power of two (at least
    128) slots, its s^ndim real regions evaluated ``repeats`` times, the
    best of three such series a repeat (the reference's probe,
    new_time_and_call.cuh:30-70: splits 5..15, <= 35e6 regions, 11
    repeats).  ``backend``: 'cuda' (``rule_eval.apply_rule``: the fused
    kernel for a Genz family, the split route for another callable, the
    plain version on the CPU), 'fused' (a scalar-per-axis callable traced
    into the fused kernel, ``integrand_gen.traced``; the reference's
    'pallas') or 'torch' (the plain version).  Each series is timed by
    the host clock between two synchronisations of the card, a repeat's
    launches queued back to back.  Returns one dict a split, the
    reference's fields; with ``outfile`` a CSV row each
    (RULES_CSV_HEADER)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = torch.device("cuda" if device is None else device)
    dt = getattr(torch, dtype)
    tables = rule_eval.rule_tables(ndim, dtype)
    if backend == "fused":
        if _positional_arity(integrand) != ndim:
            raise ValueError("backend='fused' needs a scalar-per-axis "
                             f"integrand f(x0, ..., x{ndim - 1})")
        f = integrand_gen.traced(integrand, ndim,
                                 max_ndim=integrand_gen.RULE_MAX_NDIM)
    else:
        f = integrand
    apply = (rule_eval.apply_rule_plain if backend == "torch"
             else rule_eval.apply_rule)
    feval = tables.feval
    gl = torch.zeros(ndim, dtype=dt, device=dev)
    gr = torch.ones(ndim, dtype=dt, device=dev)
    results = []
    for s in splits_per_dim:
        n_regions = s ** ndim
        if n_regions > max_regions:
            continue
        cap = max(region_pool.next_pow2(n_regions), 128)
        lows, lengths, _ = region_pool.uniform_split(ndim, s, cap, dt, dev)
        chunk_size = chunk if cap > chunk else None

        def sweep():
            return apply(f, tables, lows, lengths, gl, gr,
                         chunk_size=chunk_size, n=n_regions)

        sweep()                                  # builds and warms
        _sync(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(repeats):
                sweep()
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / repeats)
        evals = n_regions * feval
        rec = {"splits_per_dim": s, "regions": n_regions,
               "padded_capacity": cap, "feval": feval, "best_s": best,
               "evals_per_sec": evals / best}
        results.append(rec)
        if outfile is not None:
            print(f"{s},{n_regions},{cap},{feval},{best},{evals / best}",
                  file=outfile, flush=True)
    return results
