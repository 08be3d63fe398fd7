"""Build and load the package's CUDA sources (csrc/*.cu).

Each source is compiled with nvcc for ``sm_90a`` at first use into
``build/`` beside this package, into a shared library with a plain C
interface that ``ctypes`` loads.  The library's name carries a digest of
the flags, the source and every header in csrc/, so an edited file is
rebuilt and an unchanged one is reused.  A failed build raises.

``build_generated`` builds csrc/gen_integrand.cu for one traced callable:
its generated header (ops/integrand_gen.py ``emit_cuda``) is written to
``build/gen/<digest>.cuh``, never into csrc/ (whose headers every
library's digest reads), and nvcc pre-includes it.  That library's digest
also covers the generated header.  csrc/gen_values.cu, the check of the
emitted integrand alone, is built the same way into a library of its own,
only when a check asks for it (``source=GEN_VALUES_SOURCE``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# --split-compile 0 (CUDA 12.1 on) optimises a source's kernels on all the
# host's cores: the templates make some hundred kernels of two sources.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile", "0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

GEN_SOURCE = "gen_integrand.cu"
GEN_VALUES_SOURCE = "gen_values.cu"
GEN_DIR = BUILD_DIR / "gen"

_libs: dict[str, ctypes.CDLL] = {}
_configured: set = set()
# Seconds of each generated library built in this process, by library
# name: a first build's time, reported apart from the warm runs.
generated_builds: dict[str, float] = {}


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


def _target(name: str, generated: str = "") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(generated.encode())
    return BUILD_DIR / f"lib{Path(name).stem}_{h.hexdigest()[:16]}.so"


def build_many(names, generated=(), source: str = GEN_SOURCE) -> list[Path]:
    """Compile csrc/<name> for each name and csrc/<source> (gen_integrand.cu
    by default) for each
    generated header text in ``generated``, all nvcc processes started
    together, and return the libraries' paths in order (the sources', then
    the generated ones').  nvcc's report (ptxas registers and spills per
    kernel, and the seconds until this source was done) is kept beside
    each library, ``<library>.log``.  Raises RuntimeError if any build
    fails."""
    jobs = [(n, _target(n), ()) for n in names]
    for text in generated:
        out = _target(source, text)
        header = GEN_DIR / f"{out.stem.rsplit('_', 1)[-1]}.cuh"
        jobs.append((source, out, (header, text)))
    running = []
    t0 = time.perf_counter()
    for name, out, gen in jobs:
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        extra = []
        if gen:
            header, text = gen
            GEN_DIR.mkdir(parents=True, exist_ok=True)
            header.write_text(text)
            extra = ["-I", str(CSRC), "--pre-include", str(header)]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / name)]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n"
                            f"{err}")
            continue
        seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(
            err + f"nvcc: {name} built in {seconds:.2f} s "
                  "(all sources started together)\n")
        os.replace(tmp, out)
        if name == GEN_SOURCE:
            generated_builds[out.name] = seconds
    if failures:
        raise RuntimeError("\n".join(failures))
    return [out for _, out, _ in jobs]


def build_generated(header: str, source: str = GEN_SOURCE) -> Path:
    """Compile csrc/<source> (gen_integrand.cu by default) with the
    generated ``header`` (once per content of the flags, the sources and
    the header) and return the library.  Raises RuntimeError with nvcc's
    report if it fails."""
    return build_many([], [header], source)[0]


def load_generated(header: str, configure,
                   source: str = GEN_SOURCE) -> ctypes.CDLL:
    """The library of csrc/<source> with the generated ``header``, built at
    first use and loaded once; ``configure(lib)`` declares the ctypes
    signatures of the entry points its caller uses, once for each function
    ``configure``."""
    key = header if source == GEN_SOURCE else (source, header)
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = ctypes.CDLL(str(build_generated(header, source)))
    if (key, configure) not in _configured:
        configure(lib)
        _configured.add((key, configure))
    return lib


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
