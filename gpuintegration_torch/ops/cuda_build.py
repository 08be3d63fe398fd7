"""Build and load the package's CUDA sources (csrc/*.cu).

Each source is compiled with nvcc for ``sm_90a`` at first use into
``build/`` beside this package, into a shared library with a plain C
interface that ``ctypes`` loads.  The library's name carries a digest of
the source and of every header in csrc/, so an edited file is rebuilt and
an unchanged one is reused.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (no CUDA toolkit): the CUDA kernels "
                       "cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{Path(name).stem}_{h.hexdigest()[:16]}.so"


def build_many(names) -> list[Path]:
    """Compile csrc/<name> for each name, all nvcc processes started
    together, and return the libraries' paths in order.  nvcc's report
    (ptxas registers and spills per kernel) is kept beside each library,
    ``<library>.log``.  Raises RuntimeError if any build fails."""
    outs = [_target(n) for n in names]
    running = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n"
                            f"{err}")
            continue
        out.with_suffix(".log").write_text(err)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name> (once per content) and return the library."""
    return build_many([name])[0]


def load(name: str, configure) -> ctypes.CDLL:
    """The library of csrc/<name>, built at first use and loaded once;
    ``configure(lib)`` declares its functions' ctypes signatures then."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        configure(lib)
        _libs[name] = lib
    return _libs[name]
