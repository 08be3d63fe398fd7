"""Wrapper of the CUDA rule-evaluation kernel (csrc/rule_eval.cu).

Replaces ``gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule`` (the
f32 Pallas kernel) and, in f64, the XLA path ``rule_eval._eval_chunk``:
one launch evaluates the Genz-Malik rule over every real region of a pool
with the integrand fused in, in f64 or f32, and returns what
``rule_eval.apply_rule_plain`` returns.

What bounds it: for Genz integrands each region reads 2*ndim values and
writes 3, against feval * (~6*ndim + 3) f64 (or f32) operations, so the
kernel is bound by FP64/FP32 arithmetic, never by memory.  The design
keeps every rule point and integrand value in registers and shared memory
(one thread block per region, 128 threads over the points) and spends
the arithmetic on plain FMA units: no tensor cores, no TF32, because the
null-rule sums cancel.

The kernel knows the integrand as a Genz family id (F1..F6) and its
parameters (models.genz.GenzIntegrand); any other callable raises
NotImplementedError on a CUDA pool -- pass ``rule_backend="torch"`` to the
Workspace to run the plain version on the card instead.

The library is compiled with nvcc at first use into ``build/`` beside this
package, from the package's own source (ops/cuda_build.py); a failed build
raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from gpuintegration_torch.ops import cuda_build, rule_eval

_SOURCE = "rule_eval.cu"
MAX_NDIM = 16

# Launches of the kernel since the count was last set to 0; callers reset
# it and read it to show that a run went through the kernel.
launches = 0


def build() -> Path:
    """Compile csrc/rule_eval.cu into build/ (once per source content) and
    return the library's path (``cuda_build.build``).  Raises RuntimeError
    if nvcc fails."""
    return cuda_build.build(_SOURCE)


def _configure(lib):
    fn = lib.rule_eval_launch
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 8
                   + [ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int


def kernel_params(integrand) -> tuple[int, np.ndarray]:
    """(family id, 34 host doubles: coeffs[16], bounds[16], s0, s1) of a
    Genz integrand; NotImplementedError for a callable the kernel lacks."""
    kind = getattr(integrand, "kind", None)
    params = getattr(integrand, "params", None)
    if kind not in (1, 2, 3, 4, 5, 6) or params is None:
        raise NotImplementedError(
            "the CUDA rule kernel evaluates the Genz families F1-F6 "
            "(gpuintegration_torch.models.genz) only; for another integrand "
            "on the card pass rule_backend='torch' to the Workspace (the "
            "plain PyTorch rule evaluation)")
    p = np.zeros(2 * MAX_NDIM + 2, dtype=np.float64)
    if kind in (1, 3, 6):
        coeffs = np.asarray(params["coeffs"], dtype=np.float64)
        p[:coeffs.size] = coeffs
    if kind == 1:
        p[2 * MAX_NDIM] = params["offset"]
    elif kind == 2:
        p[2 * MAX_NDIM] = 1.0 / params["a"] ** 2
        p[2 * MAX_NDIM + 1] = params["b"]
    elif kind == 4:
        p[2 * MAX_NDIM] = params["a"] * params["a"]
        p[2 * MAX_NDIM + 1] = params["b"]
    elif kind == 5:
        p[2 * MAX_NDIM] = params["a"]
        p[2 * MAX_NDIM + 1] = params["b"]
    elif kind == 6:
        bounds = np.asarray(params["bounds"], dtype=np.float64)
        p[MAX_NDIM:MAX_NDIM + bounds.size] = bounds
    return kind, p


def cuda_apply_rule(integrand, tables: rule_eval.RuleTables, lows, lengths,
                    global_lo, global_range, *, n: int | None = None,
                    blocked: bool = False):
    """One kernel launch over the ``n`` real regions of a CUDA pool
    (all of it when ``n`` is None).  Arguments and outputs as
    ``rule_eval.apply_rule_plain``: (estimate (cap,), errorest (cap,),
    split_dim (cap,) int32), with est = err = 0 and split_dim 0 in the
    padding slots."""
    global launches
    kind, params = kernel_params(integrand)
    ndim = tables.ndim
    if getattr(integrand, "ndim", ndim) != ndim:
        raise ValueError(f"integrand ndim {integrand.ndim} != rule {ndim}")
    if not 2 <= ndim <= MAX_NDIM:
        raise ValueError(f"the CUDA rule kernel takes ndim 2..{MAX_NDIM}, "
                         f"not {ndim}")
    if lows.device.type != "cuda":
        raise ValueError(f"cuda_apply_rule needs CUDA tensors, got "
                         f"{lows.device}")
    dtype = lows.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype {dtype} (float64 or float32)")
    cap = lows.shape[1]
    for name, t, shape in (("lows", lows, (ndim, cap)),
                           ("lengths", lengths, (ndim, cap)),
                           ("global_lo", global_lo, (ndim,)),
                           ("global_range", global_range, (ndim,))):
        if (t.device != lows.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor of shape {shape} "
                f"on {lows.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    n = cap if n is None else int(n)
    if not 0 <= n <= cap or (blocked and n % 2):
        raise ValueError(f"n={n} for a pool of {cap} (blocked={blocked})")
    if cap >= 2 ** 31 // ndim:
        raise ValueError(f"pool of {cap} regions is too large for int32 "
                         "indexing")

    _, orbit_wts, scale, norm = rule_eval.device_tables(ndim, dtype,
                                                        lows.device)
    gen_t = _gen_dims_major(ndim, dtype, lows.device)
    est = torch.empty(cap, dtype=dtype, device=lows.device)
    err = torch.empty(cap, dtype=dtype, device=lows.device)
    sdim = torch.empty(cap, dtype=torch.int32, device=lows.device)
    ob = (ctypes.c_int * 10)(*tables.orbit_bounds)
    hp = params.ctypes.data_as(ctypes.c_void_p)
    stream = torch.cuda.current_stream(lows.device).cuda_stream
    rc = cuda_build.load(_SOURCE, _configure).rule_eval_launch(
        kind, int(dtype == torch.float64), ndim, tables.feval, cap, n,
        int(bool(blocked)), lows.data_ptr(), lengths.data_ptr(),
        global_lo.data_ptr(), global_range.data_ptr(), gen_t.data_ptr(),
        orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
        float(tables.ratio), ctypes.cast(ob, ctypes.c_void_p), hp,
        est.data_ptr(), err.data_ptr(), sdim.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule kernel launch failed: error {rc}")
    launches += 1
    return est, err, sdim


@functools.lru_cache(maxsize=None)
def _gen_dims_major(ndim: int, dtype: torch.dtype, device: torch.device):
    """(ndim, feval) generator table, so neighbouring threads read
    neighbouring points."""
    t = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    return torch.as_tensor(np.ascontiguousarray(t.gen[:t.feval].T),
                           device=device)
