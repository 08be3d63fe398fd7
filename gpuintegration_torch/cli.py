"""Command-line demo and profile tool (PyTorch port of
``gpuintegration_tpu/cli.py``): one CLI in place of the reference's single-
integrand executables (cuda/{pagani,mcubes}/{demos,profile}/*.cu).

Examples:
  python -m gpuintegration_torch.cli pagani --integrand f4_gaussian --ndim 8 \\
      --epsrel 1e-6
  python -m gpuintegration_torch.cli mcubes --integrand gauss9d --ncall 1e8
  python -m gpuintegration_torch.cli suave --integrand f2_product_peak --ndim 5
  python -m gpuintegration_torch.cli ladder --integrand f2_product_peak --ndim 6
  python -m gpuintegration_torch.cli scan --integrand f4_gaussian --grad
  python -m gpuintegration_torch.cli profile --integrand f1_oscillatory --ndim 8

Every subcommand runs on the card unless ``--device cpu`` is given.  The
exit code is the reference's: 0 when a run converged (``scan`` and
``profile``: always), 1 when none did, 2 for an unknown command; an
unknown integrand exits with its message.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.utils import timing


def _resolve_integrand(name: str, ndim: int):
    """(integrand, ndim, true_value, volume or None)."""
    factories = {
        "f1_oscillatory": genz.f1_oscillatory,
        "f2_product_peak": genz.f2_product_peak,
        "f3_corner_peak": genz.f3_corner_peak,
        "f4_gaussian": genz.f4_gaussian,
        "f5_c0": genz.f5_c0_continuous,
        "f6_discontinuous": genz.f6_discontinuous,
        "g_function": misc.g_function,
        "sin_sum": misc.sin_sum,
        "addition": misc.addition,
        "oscillatory": misc.oscillatory,
    }
    fixed_dim = {
        "abs_cos_sum_5d": lambda: (misc.abs_cos_sum_5d(), None),
        "genz_1abs_5d": lambda: (misc.abs_cos_sum_5d(normalized=True), None),
        "cos_sum_plus1_5d": lambda: (misc.cos_sum_plus1_5d(), None),
        "fun6": lambda: (misc.fun6(), None),
        "xyz": lambda: (misc.xyz(), None),
        "diagonal_ridge_2d": lambda: misc.diagonal_ridge_2d(),
        "gauss9d": lambda: misc.gauss9d(),
    }
    if name in fixed_dim:
        g, vol = fixed_dim[name]()
        return g, g.ndim, g.true_value, vol
    if name.startswith("box_"):
        b = misc.box_integral(ndim, float(name.split("_")[1]))
        return b, ndim, b.true_value, None
    if name not in factories:
        raise SystemExit(
            f"unknown integrand {name!r}; choices: "
            f"{sorted(factories) + sorted(fixed_dim) + ['box_<s>']}")
    g = factories[name](ndim)
    return g, g.ndim, g.true_value, None


# The families of ``scan``, f(x, a) with the family's parameter a.
SCAN_FAMILIES = {
    "f4_gaussian": lambda x, a: torch.exp(
        -(a * a) * torch.sum((x - 0.5) ** 2, dim=-1)),
    "f2_product_peak": lambda x, a: 1.0 / torch.prod(
        1.0 / (a * a) + (x - 0.5) ** 2, dim=-1),
    "f5_c0": lambda x, a: torch.exp(
        -a * torch.sum(torch.abs(x - 0.5), dim=-1)),
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpuintegration_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default=None,
                        help="'cuda' (the default: the card) or 'cpu' "
                             "(the plain PyTorch versions)")
    common = argparse.ArgumentParser(add_help=False, parents=[device])
    common.add_argument("--integrand", default="f4_gaussian")
    common.add_argument("--ndim", type=int, default=5)
    common.add_argument("--epsrel", type=float, default=1e-3)
    common.add_argument("--epsabs", type=float, default=1e-40)
    common.add_argument("--runs", type=int, default=1)

    sp = sub.add_parser("pagani", parents=[common],
                        help="adaptive cubature (clean_time_and_call)")
    sp.add_argument("--continuation", action="store_true",
                    help="drive integrate_to_convergence (checkpoint-"
                         "resume rounds and the partitioned continuation "
                         "past the pool wall: deep tolerances)")
    sp.add_argument("--max-wall-s", type=float, default=None,
                    help="wall-clock bound per continuation run")
    sp.add_argument("--finish-scale", type=float, default=1.0,
                    help="retire regions at epsrel*SCALE while certifying "
                         "at epsrel (Workspace.integrate)")
    sp.add_argument("--finish-abs-per-vol", type=float, default=0.0,
                    help="also retire a region once its error is below "
                         "VALUE*vol_region")
    sp.add_argument("--crease-split", action="store_true",
                    help="crease/jump-aware splitting "
                         "(Workspace.integrate crease_split)")
    sp = sub.add_parser("mcubes", parents=[common],
                        help="VEGAS Monte Carlo (mcubes_time_and_call)")
    sp.add_argument("--ncall", type=float, default=1e6)
    sp.add_argument("--iters", type=int, default=15)
    sp.add_argument("--adjust-iters", type=int, default=15)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--importance", choices=["auto", "grid", "poly"],
                    default="auto", help="importance map: auto is the "
                    "polynomial inverse-CDF, grid the reference-parity "
                    "table lookup")
    sp.add_argument("--refine", choices=["host", "device"], default="host",
                    help="grid refinement: exact-f64 host NumPy or the "
                    "device-resident adjustment phase in f32")
    sp.add_argument("--eval-dtype", choices=["float32", "float64"],
                    default=None, help="integrand evaluation dtype "
                    "(accumulators stay f64; float32 lets AUTO take the "
                    "fused sampler)")
    sp = sub.add_parser("suave", parents=[common],
                        help="Suave subregion-adaptive importance MC")
    sp.add_argument("--nnew", type=int, default=2048,
                    help="fresh samples per region per pass")
    sp.add_argument("--nmin", type=int, default=2,
                    help="sampling passes per cycle")
    sp.add_argument("--flatness", type=float, default=50.0,
                    help="fluctuation-norm exponent (capped at 16)")
    sp.add_argument("--max-regions", type=int, default=1024)
    sp.add_argument("--seed", type=int, default=0)
    sp = sub.add_parser("ladder", parents=[common],
                        help="tighten epsrel until failure")
    sp.add_argument("--floor", type=float, default=1e-9)
    sp = sub.add_parser(
        "scan", parents=[device],
        help="parameter scan (+ optional d/dtheta) on a fixed mesh: "
             "torch.func.vmap over diff.fixed_mesh_integral")
    sp.add_argument("--integrand", default="f4_gaussian",
                    choices=sorted(SCAN_FAMILIES))
    sp.add_argument("--ndim", type=int, default=5)
    sp.add_argument("--values", default="1:9:17",
                    help="theta grid lo:hi:count (the family's 'a')")
    sp.add_argument("--partitions", type=int, default=4,
                    help="uniform mesh partitions per axis")
    sp.add_argument("--grad", action="store_true",
                    help="also print dI/da per row")
    sp = sub.add_parser("profile", parents=[device],
                        help="rule-evaluation throughput sweep "
                             "(call_cubature_rules)")
    sp.add_argument("--integrand", default="f4_gaussian")
    sp.add_argument("--ndim", type=int, default=5)
    sp.add_argument("--splits", default="5:16")
    sp.add_argument("--repeats", type=int, default=11)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    g, ndim, truth, vol = _resolve_integrand(args.integrand, args.ndim)
    dev = args.device

    if args.cmd == "pagani":
        from gpuintegration_torch.pagani.workspace import Workspace
        print(timing.PAGANI_CSV_HEADER)
        extra = {}
        if args.finish_scale != 1.0:
            extra["finish_epsrel_scale"] = args.finish_scale
        if args.finish_abs_per_vol != 0.0:
            # negatives pass through, for Workspace.integrate to refuse
            extra["finish_abs_per_vol"] = args.finish_abs_per_vol
        if args.crease_split:
            extra["crease_split"] = True
        good = timing.clean_time_and_call(
            args.integrand, g, args.epsrel, truth, sys.stdout,
            ndim=ndim, vol=vol, epsabs=args.epsabs,
            runs_per_epsrel=args.runs, continuation=args.continuation,
            max_wall_s=args.max_wall_s,
            workspace=Workspace(ndim, device=dev), **extra)
        return 0 if good else 1
    if args.cmd == "mcubes":
        print(timing.MCUBES_CSV_HEADER)
        good = timing.mcubes_time_and_call(
            args.integrand, g, args.epsrel, truth, sys.stdout,
            ndim=ndim, ncall=args.ncall, vol=vol, epsabs=args.epsabs,
            total_iters=args.iters, adjust_iters=args.adjust_iters,
            runs=args.runs, seed=args.seed,
            importance=(None if args.importance == "auto"
                        else args.importance),
            eval_dtype=(None if args.eval_dtype is None
                        else getattr(torch, args.eval_dtype)),
            refine=args.refine, device=dev)
        return 0 if good else 1
    if args.cmd == "suave":
        from gpuintegration_torch.pagani.suave import suave
        print("id,ndim,true_value,epsrel,epsabs,estimate,errorest,"
              "nregions,neval,iters,status,time_ms")
        good = False
        for i in range(args.runs):
            t0 = time.perf_counter()
            r = suave(g, epsrel=args.epsrel, epsabs=args.epsabs, vol=vol,
                      ndim=ndim, nnew=args.nnew, nmin=args.nmin,
                      flatness=args.flatness, max_regions=args.max_regions,
                      seed=args.seed + i, device=dev)
            ms = (time.perf_counter() - t0) * 1e3
            good = good or r.status == 0
            print(f"{args.integrand},{ndim},{truth:.15e},"
                  f"{args.epsrel:.3e},{args.epsabs:.3e},"
                  f"{r.estimate:.15e},{r.errorest:.15e},{r.nregions},"
                  f"{r.neval},{r.iters},{r.status},{ms:.1f}", flush=True)
        return 0 if good else 1
    if args.cmd == "ladder":
        from gpuintegration_torch.pagani.workspace import Workspace
        print(timing.PAGANI_CSV_HEADER)
        achieved = timing.epsrel_ladder(
            args.integrand, g, truth, sys.stdout, start=args.epsrel,
            floor=args.floor, ndim=ndim, runs_per_epsrel=args.runs,
            vol=vol, epsabs=args.epsabs,
            workspace=Workspace(ndim, device=dev))
        if achieved is None:
            print("# achieved epsrel: none (first rung failed)")
            return 1
        print(f"# achieved epsrel: {achieved}")
        return 0
    if args.cmd == "scan":
        from gpuintegration_torch.diff import fixed_mesh_integral
        lo_s, hi_s, cnt_s = args.values.split(":")
        est_fn = fixed_mesh_integral(SCAN_FAMILIES[args.integrand],
                                     args.ndim,
                                     partitions_per_axis=args.partitions,
                                     device=dev)
        mesh_dev = torch.device("cuda" if dev is None else dev)
        thetas = torch.linspace(float(lo_s), float(hi_s), int(cnt_s),
                                dtype=torch.float64, device=mesh_dev)
        ests, errs = torch.func.vmap(est_fn)(thetas)
        grads = (torch.func.vmap(torch.func.grad(
            lambda a: est_fn(a)[0]))(thetas) if args.grad else None)
        print("a,estimate,errorest" + (",dI_da" if args.grad else ""))
        for i in range(thetas.shape[0]):
            row = (f"{float(thetas[i]):.6g},{float(ests[i]):.17e},"
                   f"{float(errs[i]):.3e}")
            if grads is not None:
                row += f",{float(grads[i]):.10e}"
            print(row, flush=True)
        return 0
    if args.cmd == "profile":
        lo, hi = (int(t) for t in args.splits.split(":"))
        print(timing.RULES_CSV_HEADER)
        timing.call_cubature_rules(
            g, ndim, splits_per_dim=range(lo, hi), repeats=args.repeats,
            outfile=sys.stdout, device=dev)
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
