"""Rank-side drivers of mesh runs: what ``parallel.launch.run_on_ranks``
runs on each rank for the mesh tests and ``chip_smoke.py``.

A spawned rank re-imports the module of the function it runs, so these
live in the port, where importing them pulls in torch and the port only,
and the integrands are named by spec, not passed as callables:

  ("genz", "f4_gaussian", ndim, {"a": 5.0})   models.genz.f4_gaussian(...)
  ("misc", "sin_sum", ndim, {})               models.misc.sin_sum(...)
  ("nan", ndim)                               NaN where x0 > 1/2, else 1
  ("vector", [spec, spec, ...])               the members stacked (..., k)

A case is a dict: ``what`` ('pagani', 'convergence', 'vegas' or
'stages'),
``integrand`` (a spec), ``ws`` (Workspace keywords, dtype as 'float32' or
'float64'), ``kw`` (the call's keywords; a 'convergence' case returns the
names of its ``StageTimer`` stages), and for 'pagani' ``checkpoint``
(return ``make_checkpoint()``'s arrays), ``single`` (also run the same
call without a mesh on the rank's device, for D = 1 against one device) and
``trace_classifier`` (return each ``classify_ladder`` call's regions,
verdict, threshold and survivors).  A 'convergence' case also counts its
rebalanced resumes (``_rebalance_checkpoint_for_mesh`` calls).
A 'stages' case runs ``parallel.sharded``'s stages in the reference's
order on this rank's shard of ``pool`` (the reference's dealt global pool,
``convert.shards_from_reference``); see ``run_stages``.
``run_cases`` returns {name: outcome}, each outcome the result's fields,
the fused or VEGAS phases' stats and, on the card, the kernels' launches
by route over the case.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.parallel import mesh as pmesh
from gpuintegration_torch.utils.profiling import StageTimer

FIELDS = ("status", "iters", "nregions", "nFinishedRegions", "neval",
          "estimate", "errorest", "estimates", "errorests", "chi_sq")


def _nan(x):
    return torch.where(x[..., 0] > 0.5, torch.full_like(x[..., 0], np.nan),
                       torch.ones_like(x[..., 0]))


def integrand(spec):
    """The callable of a spec (see the module docstring)."""
    kind = spec[0]
    if kind in ("genz", "misc"):
        _, name, ndim, kw = spec
        return getattr(genz if kind == "genz" else misc, name)(ndim, **kw)
    if kind == "nan":
        def nan(x):
            return _nan(x)

        nan.ndim = spec[1]
        return nan
    if kind == "vector":
        members = [integrand(m) for m in spec[1]]

        def f(x):
            return torch.stack([g(x) for g in members], dim=-1)

        f.ndim = members[0].ndim
        return f
    raise ValueError(f"integrand spec {spec!r}")


def outcome(res) -> dict:
    """A result's fields as plain Python and NumPy values."""
    out = {}
    for k in FIELDS:
        v = getattr(res, k, None)
        out[k] = None if v is None else (
            np.asarray(v).copy() if np.ndim(v) else v)
    return out


def _workspace(case, mesh, device):
    from gpuintegration_torch import Workspace
    ws_kw = dict(case.get("ws", {}))
    if "dtype" in ws_kw:
        ws_kw["dtype"] = getattr(torch, ws_kw["dtype"])
    return Workspace(case["ndim"], mesh=mesh,
                     device=None if mesh is not None else device, **ws_kw)


def _launches() -> dict:
    from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
    from gpuintegration_torch.ops import cuda_rule
    return {"rule": dict(cuda_rule.route_launches),
            "rule_total": cuda_rule.launches,
            "split": dict(cuda_rule.split_launches),
            "contract": dict(cuda_rule.contract_route_launches),
            "frac": dict(cuda_rule.frac_route_launches),
            "sampler": dict(cuda_vegas.route_launches),
            "sampler_total": cuda_vegas.launches,
            "hist": dict(cuda_lookup.hist_route_launches),
            "resolve": dict(cuda_lookup.resolve_route_launches)}


def _reset_launches():
    from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
    from gpuintegration_torch.ops import cuda_rule
    cuda_rule.reset_launches()
    cuda_vegas.reset_launches()
    cuda_lookup.reset_launches()


def _np(*tensors):
    return tuple(t.cpu().numpy() if torch.is_tensor(t) else t
                 for t in tensors)


def run_stages(case: dict, mesh, device) -> dict:
    """``parallel.sharded``'s stages on this rank's shard of the reference
    pool ``case["pool"]`` = (global lows, lengths, counts), f64, ``epsrel``
    ``case["epsrel"]``: the first sweep's evaluation (unblocked), post
    stage (no parents), reductions and compaction + split; the second
    sweep's evaluation (blocked, with the cut fractions), post stage
    (with parents), compaction + split with ``extra=``; the split of the
    first pool's regions with the first sweep's axes; and the vector post
    stage on (est, 2 est) and (err, 3 err).  Every output comes back as
    NumPy, the rank's slice."""
    from gpuintegration_torch import convert
    from gpuintegration_torch.pagani import region_pool
    from gpuintegration_torch.parallel import sharded as S
    f = integrand(case["integrand"])
    ndim, eps, chunk = case["ndim"], case["epsrel"], case["chunk"]
    d, k = mesh.size(), mesh.get_local_rank()
    lo, ln, n = convert.shards_from_reference(*case["pool"], d,
                                              device=device)[k]
    cap = lo.shape[1]
    f64 = torch.float64
    gl = torch.zeros(ndim, dtype=f64, device=device)
    gr = torch.ones(ndim, dtype=f64, device=device)

    def child_cap(n_act):
        hottest = int(pmesh.gather_counts(mesh, n_act, device).max())
        return max(region_pool.next_pow2(2 * hottest), chunk)

    out = {}
    est, err, sd = S.sharded_eval_stage(f, ndim, "float64", mesh, lo, ln, gl,
                                        gr, ns=n, blocked=False)
    out["eval1"] = _np(est, err, sd)
    e1, r1, a1, m1, n_act, s1 = S.sharded_post_stage(
        True, False, mesh, est, err, n, torch.zeros(cap, dtype=f64,
                                                    device=device),
        False, eps)
    out["post1"] = _np(e1, r1, a1, m1, n_act, s1)
    out["reductions"] = _np(S.sharded_reductions(mesh, e1, r1, a1))[0]
    cap2 = child_cap(n_act)
    n2, lo2, ln2, par, perr = S.sharded_compact_split(
        mesh, cap2, a1, lo, ln, sd, e1, r1)
    out["split1"] = _np(n2, lo2, ln2, par, perr)
    est2, err2, sd2, fr2 = S.sharded_eval_stage(
        f, ndim, "float64", mesh, lo2, ln2, gl, gr, ns=n2, blocked=True,
        with_split_frac=True)
    out["eval2"] = _np(est2, err2, sd2, fr2)
    e2, r2, a2, m2, n_act2, s2 = S.sharded_post_stage(
        True, True, mesh, est2, err2, n2, par, True, eps)
    out["post2"] = _np(e2, r2, a2, m2, n_act2, s2)
    n3, lo3, ln3, par3, perr3 = S.sharded_compact_split(
        mesh, child_cap(n_act2), a2, lo2, ln2, sd2, e2, r2, extra=fr2)
    out["split2"] = _np(n3, lo3, ln3, par3, perr3)
    out["split_only"] = _np(*S.sharded_split(mesh, 2 * cap, lo, ln, sd, n))
    ev = torch.stack([est2, 2 * est2])
    rv = torch.stack([err2, 3 * err2])
    pv = torch.stack([par, 2 * par])
    out["post_vector"] = _np(*S.sharded_post_stage_vector(
        True, True, mesh, ev, rv, n2, pv, True, eps))
    return out


@contextlib.contextmanager
def _traced_classifier(calls: list):
    """Record each classifier call in this process into ``calls``:
    (regions, verdict, threshold, survivors)."""
    from gpuintegration_torch.pagani.classifier import HeuristicClassifier
    ladder = HeuristicClassifier.classify_ladder

    def traced(self, errorests, mask, num_regions, *args, **kw):
        res = ladder(self, errorests, mask, num_regions, *args, **kw)
        calls.append((int(num_regions),
                      bool(res.pass_mem and res.pass_errorest_budget),
                      res.threshold, res.num_active))
        return res

    HeuristicClassifier.classify_ladder = traced
    try:
        yield calls
    finally:
        HeuristicClassifier.classify_ladder = ladder


def _run_workspace(case, ws, f, kw, out):
    """A 'pagani' or 'convergence' case's call on ``ws``; its checkpoint,
    stages and rebalances into ``out``."""
    if case["what"] == "convergence":
        timer = StageTimer()
        rebalance = ws._rebalance_checkpoint_for_mesh
        out["rebalances"] = 0

        def counted(ckpt):
            out["rebalances"] += 1
            return rebalance(ckpt)

        ws._rebalance_checkpoint_for_mesh = counted
        res = ws.integrate_to_convergence(f, stage_timer=timer, **kw)
        out["stages"] = sorted(timer.report())
        return res
    res = ws.integrate(f, **kw)
    if case.get("checkpoint"):
        ck = ws.make_checkpoint()
        out["checkpoint"] = {k: getattr(ck, k) for k in (
            "lows", "lengths", "estimate", "errorest", "nregions", "iters",
            "neval", "region_estimates", "region_errorests")}
    return res


def run_case(case: dict, mesh, device) -> dict:
    """One case on this rank (``mesh`` None runs it on one device)."""
    from gpuintegration_torch.mcubes import phases, vegas
    from gpuintegration_torch.pagani import fused_loop
    f = integrand(case["integrand"])
    kw = dict(case.get("kw", {}))
    for key in ("dtype", "eval_dtype"):
        if isinstance(kw.get(key), str):
            kw[key] = getattr(torch, kw[key])
    on_card = device.type == "cuda"
    if on_card:
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fused_loop.reset_stats()
    phases.reset_stats()
    if case["what"] == "stages":
        return {"stages": run_stages(case, mesh, device)}
    t0 = time.perf_counter()
    out = {}
    if case["what"] == "vegas":
        res = vegas.vegas(f, mesh=mesh,
                          device=None if mesh is not None else device, **kw)
    else:
        ws = _workspace(case, mesh, device)
        trace = (_traced_classifier(out.setdefault("classifier", []))
                 if case.get("trace_classifier")
                 else contextlib.nullcontext())
        with trace:
            res = _run_workspace(case, ws, f, kw, out)
    if on_card:
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["result"] = outcome(res)
    out["fused_stats"] = dict(fused_loop.stats)
    out["fused_exits"] = list(fused_loop.exits)
    out["vegas_stats"] = dict(phases.stats)
    if on_card:
        out["launches"] = _launches()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        out["free_gib"] = torch.cuda.mem_get_info(device)[0] / 2 ** 30
    return out


def run_cases(rank: int, cases: dict, device_type: str = "cpu",
              threads: int | None = 1, flush_denormal: bool = True) -> dict:
    """Every case of ``cases`` ({name: case}) in turn on this rank's mesh
    (``parallel.mesh.make_mesh(device_type=)``); a case with ``single``
    also runs without the mesh, as ``name + "/single"``.  A spawned rank
    inherits neither the intra-op thread count nor the denormal flush, so
    they are set here (``threads`` None leaves the count)."""
    if threads is not None:
        torch.set_num_threads(threads)
    torch.set_flush_denormal(flush_denormal)
    mesh = pmesh.make_mesh(device_type=device_type)
    device = pmesh.mesh_device(mesh)
    out = {}
    for name, case in cases.items():
        out[name] = run_case(case, mesh, device)
        if case.get("single"):
            out[name + "/single"] = run_case(case, None, device)
    return out


def refusals(rank: int, device_type: str = "cpu") -> dict:
    """What a mesh refuses, as {option: (exception type, message)}: the
    reference's ``vegas_assisted``/``predict_split`` refusal (ValueError)
    and a ``device`` other than the rank's."""
    from gpuintegration_torch import Workspace
    mesh = pmesh.make_mesh(device_type=device_type)
    g = genz.f4_gaussian(2)
    other = "cuda" if device_type == "cpu" else "cpu"
    tries = {
        "vegas_assisted": lambda: Workspace(2, mesh=mesh).integrate(
            g, vegas_assisted=True),
        "predict_split": lambda: Workspace(2, mesh=mesh).integrate(
            g, predict_split=True),
        "device": lambda: Workspace(2, mesh=mesh, device=other),
    }
    out = {}
    for name, call in tries.items():
        try:
            call()
            out[name] = None
        except (ValueError, TypeError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def fail_on_rank(rank: int, bad: int, mode: str) -> int:
    """For the launcher's own checks: rank ``bad`` raises (``mode``
    'raise') or never returns ('hang'); every other rank waits in an
    all-reduce that rank ``bad`` does not join."""
    import torch.distributed as dist
    if rank == bad:
        if mode == "raise":
            raise ValueError(f"rank {rank} fails on purpose")
        time.sleep(3600)
    dist.all_reduce(torch.ones(1))
    return rank
