"""The kernels' build and bits, for comparing two checkouts.

    python3 gpuintegration_torch/tools/route_bits.py

Builds csrc/rule_eval.cu, rule_split.cu, split_frac.cu, vegas_sample.cu and
vegas_lookup.cu of the ``gpuintegration_torch`` package that ``import``
finds (run it with ``PYTHONPATH`` set to another checkout's root to read
that one), prints each kernel's registers, spill bytes, stack frame and
static shared memory from nvcc's ``-Xptxas -v`` report, and runs the
PAGANI main path, ``Workspace(8).integrate(f4_gaussian(8), 1e-3, 1e-40,
fused=False)`` in f64, the same at 10D (the generic route) and at 17D with
a = 1 (the wide route; a checkout without it prints the refusal), the
split route's main path (8D F4, a = 25, as a plain callable at 1e-3),
``misc.sin_sum(12)`` at 1e-8 and 17D F4 (a = 1) as a plain callable at
1e-3 (the split route past 16D; a checkout without it prints the
refusal), VEGAS runs 1-3 (6D F4 at 1e-3: ncall 1e8,
'hybrid'; ncall 1e9 f32 'fused', 10 iterations, 5 adjusting; the grid map,
ncall 1e8), BASELINE's 9D VEGAS Gaussian (``misc.gauss9d`` at 1e-3,
ncall 1e9, 'hybrid') and 9D Genz F4 (a = 10) on the grid map at 1e-3,
ncall 1e9, printing status, iterations, regions or neval and the estimate
and errorest as hex floats (the bits), and each run's sampler, histogram
and bin-resolve launches by route.  Run once from each checkout in one
call to the card: the two tables and the runs must match where the
kernels are meant to be the same (the 9D poly run's routes, and with them
its histogram's order of addition, differ between checkouts that route 9D
otherwise; the bin resolve's routes give the same bits, so the 9D grid
run must not differ).  Needs a CUDA card.
"""
from __future__ import annotations

import re
import subprocess
import sys

import torch

import gpuintegration_torch
from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_build

_TYPES = {"d": "double", "f": "float"}
_BOOL = {"0": "false", "1": "true"}


def kernel_name(mangled: str) -> str:
    """A readable name of rule_eval.cu's, rule_split.cu's and the VEGAS
    sources' kernels (their template arguments spelt out), fill_padding's
    too, else the mangled one; an older checkout's generic rule kernel
    (``rule_kernel``) too."""
    m = re.search(r"rule_tile_kernelILi(\d)E([df])Li(\d+)E(?:Lb([01])E)?",
                  mangled)
    if m:
        tail = f", {_BOOL[m[4]]}" if m[4] else ""
        return (f"rule_tile_kernel<{m[1]}, {_TYPES[m[2]]}, {m[3]}{tail}>")
    m = re.search(r"rule_generic_kernelILi(\d)E([df])Li(\d+)E", mangled)
    if m:
        return f"rule_generic_kernel<{m[1]}, {_TYPES[m[2]]}, {m[3]}>"
    m = re.search(r"rule_wide_kernelILi(\d)E([df])E", mangled)
    if m:
        return f"rule_wide_kernel<{m[1]}, {_TYPES[m[2]]}>"
    # the generic route's kernel before its classes of dimensions, as an
    # older checkout's report names it
    m = re.search(r"rule_kernelILi(\d)E([df])(?:Lb([01])E)?", mangled)
    if m:
        tail = f", {_BOOL[m[3]]}" if m[3] else ""
        return f"rule_kernel<{m[1]}, {_TYPES[m[2]]}{tail}>"
    m = re.search(r"(sample_pair_kernel|sample_wide_kernel|sample_kernel|"
                  r"resolve_sample_kernel|resolve_wide_kernel|resolve_kernel)"
                  r"I((?:L[ib]\d+E)+)",
                  mangled)
    if m:
        args = [v if k == "i" else _BOOL[v]
                for k, v in re.findall(r"L([ib])(\d+)E", m[2])]
        return f"{m[1]}<{', '.join(args)}>"
    m = re.search(r"hist_grouped_kernelILi(\d+)E([df])E", mangled)
    if m:
        return f"hist_grouped_kernel<{m[1]}, {_TYPES[m[2]]}>"
    m = re.search(r"\d+([a-z_]+)I([df])((?:Lb[01]E)*)", mangled)
    if m:
        flags = "".join(f", {_BOOL[b]}" for b in re.findall(r"Lb([01])E",
                                                           m[3]))
        return f"{m[1]}<{_TYPES[m[2]]}{flags}>"
    return mangled


def ptxas_kernels(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill bytes stored + loaded, stack frame
    bytes)} from an nvcc ``-Xptxas -v`` report: each "Compiling entry
    function" line names the kernel that the next "Function properties"
    line (stack frame and spills) and "Used N registers" line describe."""
    out, name, spills, stack = {}, None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills, stack = kernel_name(m[1]), 0, 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack, spills = int(m[1]), int(m[2]) + int(m[3])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m[1]), spills, stack)
            name = None
    return out


def ptxas_smem(log: str) -> dict[str, int]:
    """{kernel: static shared memory bytes} from an nvcc ``-Xptxas -v``
    report (the "bytes smem" of each kernel's "Used N registers" line; 0
    where the line has none)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m[1])
            continue
        m = re.search(r"Used \d+ registers", line)
        if m and name:
            s = re.search(r"(\d+) bytes smem", line)
            out[name] = int(s[1]) if s else 0
            name = None
    return out


def f4_callable(ndim: int, a: float):
    """Genz F4 (b = 1/2) as a plain batched callable, which no fused kernel
    knows: the split route's integrand."""
    return lambda x: torch.exp(-torch.sum((a * a) * (x - 0.5) ** 2, dim=-1))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"package: {gpuintegration_torch.__file__}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for lib in cuda_build.build_many(["rule_eval.cu", "rule_split.cu",
                                      "split_frac.cu", "vegas_sample.cu",
                                      "vegas_lookup.cu"]):
        log = lib.with_suffix(".log").read_text()
        smem = ptxas_smem(log)
        for name, (regs, spills, stack) in sorted(ptxas_kernels(
                log).items()):
            print(f"ptxas: {name}: {regs} registers, {spills} spill bytes, "
                  f"{stack} bytes stack frame, {smem.get(name, 0)} bytes "
                  "smem")
    for label, ndim, g, eps in (
            ("main path", 8, genz.f4_gaussian(8), 1e-3),
            ("10D generic", 10, genz.f4_gaussian(10), 1e-3),
            ("17D wide", 17, genz.f4_gaussian(17, a=1.0), 1e-3),
            ("8D split main path", 8, f4_callable(8, 25.0), 1e-3),
            ("12D split sin_sum", 12, misc.sin_sum(12), 1e-8),
            ("17D split", 17, f4_callable(17, 1.0), 1e-3)):
        try:
            res = Workspace(ndim).integrate(g, eps, 1e-40, fused=False)
        except ValueError as e:      # a checkout without the route
            print(f"{label}: refused ({e})", flush=True)
            continue
        print(f"{label}: status {res.status} iters {res.iters} nregions "
              f"{res.nregions} neval {res.neval} estimate "
              f"{float(res.estimate).hex()} errorest "
              f"{float(res.errorest).hex()}", flush=True)
    g6 = genz.f4_gaussian(6)
    g9, vol9 = misc.gauss9d()
    for run, g, kw in (("run 1", g6, dict(ncall=1e8)),
                       ("run 2", g6, dict(ncall=1e9, eval_dtype=torch.float32,
                                          total_iters=10, adjust_iters=5)),
                       ("run 3", g6, dict(ncall=1e8, importance="grid")),
                       ("9D gauss9d", g9, dict(ncall=1e9, vol=vol9,
                                               sampler="hybrid")),
                       ("9D F4 grid", genz.f4_gaussian(9, a=10.0),
                        dict(ncall=1e9, importance="grid"))):
        cuda_vegas.reset_launches()
        cuda_lookup.reset_launches()
        r = mcubes.integrate(g, 1e-3, 1e-40, **kw)
        print(f"vegas {run}: status {r.status} iters {r.iters} neval "
              f"{r.neval} estimate {float(r.estimate).hex()} errorest "
              f"{float(r.errorest).hex()}; sampler launches "
              f"{dict(cuda_vegas.route_launches)}, histogram "
              f"{dict(cuda_lookup.hist_route_launches)}, bin resolve "
              f"{dict(cuda_lookup.resolve_route_launches)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
