"""Instruction counts of the kernels' loops, read from the machine code.

    python3 -m gpuintegration_torch.tools.sass_report [pattern ...]

Builds the CUDA libraries (ops/cuda_build.py), disassembles them with
``cuobjdump -sass`` (it ships with the CUDA toolkit) and, for every kernel
whose demangled name contains one of the patterns, lists its loops: a loop
is a backward branch, its body the instructions from the branch's target to
the branch.  Per loop: the instructions in the body, how many of them are
f64 arithmetic (DFMA, DADD, DMUL, ...), f32 arithmetic (FFMA, FADD, FMUL,
MUFU), shared-memory loads (LDS), global or local loads (LDG, LDL, LD),
and how deep the loop is nested.  Loops of fewer than 50 instructions are
left out (the compiler's small copy loops), and of the rest only the
innermost are listed, equal ones once with their number.  With no pattern
it reports the kernels of the two main paths: the rule kernels of 8D F4,
the samplers of 6D F4, both routes of the 6D histogram and bin resolve,
and the bin resolve's wide route (9..32D).

Where the card's profilers cannot be run, this is what the machine code
can say about the cost of a pass through a loop without them.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

from gpuintegration_torch.ops import cuda_build

SOURCES = ("rule_eval.cu", "vegas_sample.cu", "vegas_lookup.cu")
DEFAULT_PATTERNS = (
    "rule_tile_kernel<4, double, 8>", "rule_generic_kernel<4, double, 8>",
    "rule_generic_kernel<4, double, 12>", "rule_tile_kernel<4, float, 8>",
    "rule_generic_kernel<4, float, 8>",
    "sample_pair_kernel<4, 6>", "sample_kernel<4>",
    "sample_pair_kernel<0, 6>", "sample_kernel<0>",
    "hist_grouped_kernel<6, float>", "hist_kernel",
    "resolve_sample_kernel<6,", "resolve_wide_kernel", "resolve_kernel")
CLASSES = (
    ("f64", re.compile(r"^(DFMA|DADD|DMUL|DSETP|DMNMX)")),
    ("f32", re.compile(r"^(FFMA|FADD|FMUL|FSETP|FMNMX|MUFU|FSEL)")),
    ("lds", re.compile(r"^LDS")),
    ("ldg", re.compile(r"^(LDG|LDL|LD\.|LDC)")),
    ("int", re.compile(r"^(IMAD|IADD|LOP|SHF|LEA|ISETP|SEL|PRMT|BFE|SGXT|"
                       r"IABS|I2F|F2I|MOV|SHFL)")),
)
MIN_LOOP = 50    # loops of fewer instructions are not listed
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)"
                    r"(.*?);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for c in (shutil.which(name),
              str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / name)):
        if c and Path(c).is_file():
            return c
    raise RuntimeError(f"{name} not found (no CUDA toolkit)")


def short_name(name: str) -> str:
    """A demangled kernel name without its namespace and parameters."""
    short = name.replace("(anonymous namespace)::", "")
    return short.replace("(int)", "").replace("void ", "").split("(")[0]


def functions(library: Path, patterns=()) -> dict[str, list[tuple[int, str,
                                                                  str]]]:
    """{demangled kernel name: [(address, opcode, operands)]} of a
    library's kernels whose short name holds one of ``patterns`` (none:
    every kernel).  Only those kernels' instructions are parsed."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    lines = sass.splitlines()
    names = [line.split("Function :")[1].strip() for line in lines
             if "Function :" in line]
    plain = subprocess.run([_tool("cu++filt"), *names], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    wanted = {n: p for n, p in zip(names, plain)
              if not patterns or any(q in short_name(p) for q in patterns)}
    mangled, out = None, {}
    for line in lines:
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            if mangled in wanted:
                out[mangled] = []
            else:
                mangled = None
        elif mangled:
            m = _INSTR.search(line)
            if m:
                out[mangled].append((int(m.group(1), 16), m.group(2),
                                     m.group(3)))
    return {wanted[n]: instrs for n, instrs in out.items()}


def loops(instrs):
    """[(first address, last address, depth, counts)] of a kernel's loops."""
    found = []
    for addr, op, rest in instrs:
        if op.startswith("BRA"):
            m = _TARGET.search(rest)
            if m and int(m.group(1), 16) <= addr:
                found.append((int(m.group(1), 16), addr))
    report = []
    for lo, hi in sorted(set(found)):
        body = [(a, op) for a, op, _ in instrs if lo <= a <= hi]
        counts = {"all": len(body)}
        for name, pat in CLASSES:
            counts[name] = sum(1 for _, op in body if pat.match(op))
        depth = sum(1 for l2, h2 in set(found)
                    if l2 <= lo and hi <= h2 and (l2, h2) != (lo, hi))
        report.append((lo, hi, depth, counts))
    return report


def report(patterns=()):
    """[(kernel, instructions, [(depth, counts)])] for the kernels whose
    name holds one of ``patterns`` (none: DEFAULT_PATTERNS): the innermost
    loops of at least MIN_LOOP instructions, in the order of the code."""
    patterns = tuple(patterns) or DEFAULT_PATTERNS
    out = []
    for lib in cuda_build.build_many(list(SOURCES)):
        for name, instrs in functions(lib, patterns).items():
            short = short_name(name)
            listed = [l for l in loops(instrs) if l[3]["all"] >= MIN_LOOP]
            inner = [(depth, c) for lo, hi, depth, c in listed
                     if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                                for l2, h2, _, _ in listed)]
            out.append((short, len(instrs), inner))
    return out


def show(found) -> None:
    """Print ``report``'s list, equal loops once with their number."""
    for short, n_instr, inner in found:
        print(f"sass: {short}: {n_instr} instructions", flush=True)
        lines = {}
        for depth, c in inner:
            line = (f"depth {depth}: "
                    + " ".join(f"{k} {v}" for k, v in c.items()))
            lines[line] = lines.get(line, 0) + 1
        for line, count in lines.items():
            print(f"sass:   {count} innermost loop(s), {line}", flush=True)


def main(patterns) -> int:
    show(report(patterns))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
