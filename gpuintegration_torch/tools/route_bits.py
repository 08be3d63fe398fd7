"""The rule kernels' build and bits, for comparing two checkouts.

    python3 gpuintegration_torch/tools/route_bits.py

Builds csrc/rule_eval.cu, rule_split.cu and split_frac.cu of the
``gpuintegration_torch`` package that ``import`` finds (run it with
``PYTHONPATH`` set to another checkout's root to read that one), prints
each kernel's registers, spill bytes and stack frame from nvcc's
``-Xptxas -v`` report,
and runs the PAGANI main path,
``Workspace(8).integrate(f4_gaussian(8), 1e-3, 1e-40, fused=False)`` in
f64, printing its status, iterations, regions, neval and the estimate and
errorest as hex floats (the bits).  Run once from each checkout in one call
to the card: the two tables and the two runs must match where the kernels
are meant to be the same.  Needs a CUDA card.
"""
from __future__ import annotations

import re
import subprocess
import sys

import torch

import gpuintegration_torch
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_build

_TYPES = {"d": "double", "f": "float"}
_BOOL = {"0": "false", "1": "true"}


def kernel_name(mangled: str) -> str:
    """A readable name of rule_eval.cu's and rule_split.cu's kernels
    (their template arguments spelt out), fill_padding's too, else the
    mangled one."""
    m = re.search(r"rule_tile_kernelILi(\d)E([df])Li(\d+)E(?:Lb([01])E)?",
                  mangled)
    if m:
        tail = f", {_BOOL[m[4]]}" if m[4] else ""
        return (f"rule_tile_kernel<{m[1]}, {_TYPES[m[2]]}, {m[3]}{tail}>")
    m = re.search(r"rule_kernelILi(\d)E([df])(?:Lb([01])E)?", mangled)
    if m:
        tail = f", {_BOOL[m[3]]}" if m[3] else ""
        return f"rule_kernel<{m[1]}, {_TYPES[m[2]]}{tail}>"
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"package: {gpuintegration_torch.__file__}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for lib in cuda_build.build_many(["rule_eval.cu", "rule_split.cu",
                                      "split_frac.cu"]):
        for name, (regs, spills, stack) in sorted(ptxas_kernels(
                lib.with_suffix(".log").read_text()).items()):
            print(f"ptxas: {name}: {regs} registers, {spills} spill bytes, "
                  f"{stack} bytes stack frame")
    g = genz.f4_gaussian(8)
    res = Workspace(8).integrate(g, 1e-3, 1e-40, fused=False)
    print(f"main path: status {res.status} iters {res.iters} nregions "
          f"{res.nregions} neval {res.neval} estimate "
          f"{float(res.estimate).hex()} errorest "
          f"{float(res.errorest).hex()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
