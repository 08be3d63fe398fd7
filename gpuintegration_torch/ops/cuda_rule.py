"""Wrapper of the CUDA rule-evaluation kernels (csrc/rule_eval.cu).

Replaces ``gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule`` (the
f32 Pallas kernel) and, in f64, the XLA path ``rule_eval._eval_chunk``:
one launch evaluates the Genz-Malik rule over every real region of a pool
with the integrand fused in, in f64 or f32, and returns what
``rule_eval.apply_rule_plain`` returns.

Two kernels compute it, and ``rule_route`` chooses between them by the
shape alone (never by catching a failure):

* ``'tile'``, for ndim in ``TILE_NDIMS``: persistent blocks whose warps walk
  over tiles of at most 32 neighbouring pool slots, fetched by bulk
  asynchronous copies into a two-stage ring; one warp per region; ndim a
  compile-time constant.  A region's rule points share 11 coordinates per
  axis (0 and +-the five generators), so the warp computes those once per
  region, applies the part of the integrand that depends on one coordinate
  alone, and a point is then ndim shared-memory reads and multiply-adds.
  Which coordinate each (point, axis) takes is a 4-bit code
  (``pack_generators``), staged once per block.
* ``'generic'``, every ndim 2..16: one thread block per region that reads
  the generator table from global memory.  It is also the kernel the tile
  route is timed against.

What bounds them: for Genz integrands each region reads 2*ndim values and
writes 3, against feval * (~6*ndim + 3) f64 (or f32) operations, so the
kernels are bound by arithmetic, never by memory.  The tile route spends
ndim multiply-adds and the family's finish per point on the f64/f32 pipe
(in f64 an exp of some 19 f64 instructions for F4-F6, which the bound counts
as one operation; tools/sass_report.py reads the count from the machine
code); the generic route spends most of its scheduler slots on loads,
address arithmetic and the search for a point's orbit.  No tensor cores, no
TF32: the null-rule sums cancel.

Both know the integrand as a Genz family id (F1..F6) and its parameters
(models.genz.GenzIntegrand); any other callable raises NotImplementedError
on a CUDA pool -- pass ``rule_backend="torch"`` to the Workspace to run the
plain version on the card instead.

``launches`` counts every launch since it was last set to 0, and
``route_launches`` the same per route; ``reset_launches()`` zeroes both.

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
from gpuintegration_torch.ops.genz_malik import GENERATORS

_SOURCE = "rule_eval.cu"
MAX_NDIM = 16
ROUTES = ("tile", "generic")
# The dimensions csrc/rule_eval.cu compiles the tile route for: every one
# whose point codes fit a 32-bit word (4 bits an axis) above 2D, where the 33
# points would leave a warp idle most of the time.
TILE_NDIMS = (3, 4, 5, 6, 7, 8)
TILE_WARPS = 16                 # warps of a persistent block, one per SM
MAX_TILE = 32                   # regions of a tile: one per lane
CODE_BITS = 4                   # bits of a (point, axis) code

# Launches since the counts were last set to 0; callers reset them and read
# them to show that a run went through the kernel, and by which route.
launches = 0
route_launches = {r: 0 for r in ROUTES}


def reset_launches():
    global launches
    launches = 0
    for r in ROUTES:
        route_launches[r] = 0


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
    fn = lib.rule_eval_tile_launch
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 9
                   + [ctypes.c_double, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
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


# ---------------------------------------------------------------------------
# Host-side layouts of the tile route

def rule_route(ndim: int) -> str:
    """The kernel a pool of this dimension takes: 'tile' where the source
    compiles it, else 'generic'.  The working type does not enter: both
    routes are compiled for float64 and float32."""
    return "tile" if ndim in TILE_NDIMS else "generic"


@functools.lru_cache(maxsize=None)
def pack_generators(ndim: int) -> tuple[np.ndarray, np.ndarray]:
    """The generator table as codes: (codes (feval,) uint64, lam (16,)
    float64) with ``gen[p, d] == lam[(codes[p] >> 4 d) & 15]`` exactly.
    lam[0] = 0, lam[1..5] the rule's five generators, lam[6..10] their
    negatives; the codes 11..15 are unused and their lam is 0."""
    gen = rule_eval.rule_tables(ndim).gen
    gen = gen[:rule_eval.rule_tables(ndim).feval]
    lam = np.zeros(1 << CODE_BITS, dtype=np.float64)
    lam[1:6] = GENERATORS
    lam[6:11] = -lam[1:6]
    code = np.full(gen.shape, -1, dtype=np.int64)
    for c in range(11):
        code[gen == lam[c]] = c
    if (code < 0).any():
        raise AssertionError("a rule abscissa is none of the 11 generators")
    shifts = (CODE_BITS * np.arange(ndim, dtype=np.uint64))[None, :]
    return ((code.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64),
            lam)


def unpack_generators(codes: np.ndarray, lam: np.ndarray,
                      ndim: int) -> np.ndarray:
    """(feval, ndim) generators from ``pack_generators``' codes, as the
    kernel decodes them."""
    shifts = (CODE_BITS * np.arange(ndim, dtype=np.uint64))[None, :]
    idx = (codes[:, None] >> shifts) & np.uint64((1 << CODE_BITS) - 1)
    return lam[idx.astype(np.int64)]


def tile_plan(n: int, blocked: bool, sm_count: int) -> tuple[int, int]:
    """(regions per tile, persistent blocks) for ``n`` real regions on a
    card of ``sm_count`` SMs.  A tile is at most MAX_TILE regions and
    smaller, in steps of 4, where the pool has too few regions to give
    every warp of the card a full one."""
    workers = sm_count * TILE_WARPS
    tile = min(MAX_TILE, max(4, 4 * -(-n // (4 * workers))))
    parts = 2 if blocked else 1
    tiles = parts * -(-(n // parts) // tile)
    return tile, max(1, min(sm_count, -(-tiles // TILE_WARPS)))


def tile_slots(cap: int, n: int, blocked: bool, tile: int):
    """[(first slot, regions)] of every tile, as the kernel walks them:
    the plain layout's real regions are slots [0, n); the blocked layout's
    are the first n/2 slots of each half of the pool
    (region_pool.block_mask), tiled half by half."""
    parts = 2 if blocked else 1
    per_part = n // parts
    tiles_per_part = -(-per_part // tile)
    out = []
    for t in range(parts * tiles_per_part):
        part, k = divmod(t, tiles_per_part)
        off = k * tile
        out.append((part * (cap // 2) + off, min(tile, per_part - off)))
    return out


@functools.lru_cache(maxsize=None)
def _tile_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """(codes (feval,) int32 bit patterns, lam (16,)) on the device.  The
    tile route takes ndim <= 8, so a point's codes fit 32 bits."""
    codes, lam = pack_generators(ndim)
    return (torch.as_tensor(codes.astype(np.uint32).view(np.int32),
                            device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


def cuda_apply_rule(integrand, tables: rule_eval.RuleTables, lows, lengths,
                    global_lo, global_range, *, n: int | None = None,
                    blocked: bool = False, route: str | None = None):
    """One kernel launch over the ``n`` real regions of a CUDA pool
    (all of it when ``n`` is None).  Arguments and outputs as
    ``rule_eval.apply_rule_plain``: (estimate (cap,), errorest (cap,),
    split_dim (cap,) int32), with est = err = 0 and split_dim 0 in the
    padding slots.  ``route`` None takes ``rule_route(ndim)``; naming a
    route runs that kernel (the checks and timings hold the two against
    each other) and raises if it does not take the shape."""
    global launches
    kind, params = kernel_params(integrand)
    ndim = tables.ndim
    if getattr(integrand, "ndim", ndim) != ndim:
        raise ValueError(f"integrand ndim {integrand.ndim} != rule {ndim}")
    if not 2 <= ndim <= MAX_NDIM:
        raise ValueError(f"the CUDA rule kernel takes ndim 2..{MAX_NDIM}, "
                         f"not {ndim}")
    if route is None:
        route = rule_route(ndim)
    if route not in ROUTES or (route == "tile" and ndim not in TILE_NDIMS):
        raise ValueError(f"route {route!r} does not take ndim {ndim} "
                         f"(tile: {TILE_NDIMS}; generic: 2..{MAX_NDIM})")
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
    if not 0 <= n <= cap or (blocked and (n % 2 or cap % 2)):
        raise ValueError(f"n={n} for a pool of {cap} (blocked={blocked})")
    if cap >= 2 ** 31 // ndim:
        raise ValueError(f"pool of {cap} regions is too large for int32 "
                         "indexing")

    _, orbit_wts, scale, norm = rule_eval.device_tables(ndim, dtype,
                                                        lows.device)
    est = torch.empty(cap, dtype=dtype, device=lows.device)
    err = torch.empty(cap, dtype=dtype, device=lows.device)
    sdim = torch.empty(cap, dtype=torch.int32, device=lows.device)
    hp = params.ctypes.data_as(ctypes.c_void_p)
    stream = torch.cuda.current_stream(lows.device).cuda_stream
    lib = cuda_build.load(_SOURCE, _configure)
    is_double = int(dtype == torch.float64)
    if route == "tile":
        codes, lam = _tile_tables(ndim, dtype, lows.device)
        tile, blocks = tile_plan(n, blocked, torch.cuda.get_device_properties(
            lows.device).multi_processor_count)
        rc = lib.rule_eval_tile_launch(
            kind, is_double, ndim, cap, n, int(bool(blocked)),
            lows.data_ptr(), lengths.data_ptr(), global_lo.data_ptr(),
            global_range.data_ptr(), codes.data_ptr(), lam.data_ptr(),
            orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
            float(tables.ratio), hp, tile, blocks, est.data_ptr(),
            err.data_ptr(), sdim.data_ptr(), stream)
    else:
        gen_t = _gen_dims_major(ndim, dtype, lows.device)
        ob = (ctypes.c_int * 10)(*tables.orbit_bounds)
        rc = lib.rule_eval_launch(
            kind, is_double, ndim, tables.feval, cap, n, int(bool(blocked)),
            lows.data_ptr(), lengths.data_ptr(), global_lo.data_ptr(),
            global_range.data_ptr(), gen_t.data_ptr(), orbit_wts.data_ptr(),
            scale.data_ptr(), norm.data_ptr(), float(tables.ratio),
            ctypes.cast(ob, ctypes.c_void_p), hp, est.data_ptr(),
            err.data_ptr(), sdim.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule kernel ({route} route) launch failed: "
                           f"error {rc}")
    launches += 1
    route_launches[route] += 1
    return est, err, sdim


@functools.lru_cache(maxsize=None)
def _gen_dims_major(ndim: int, dtype: torch.dtype, device: torch.device):
    """(ndim, feval) generator table of the generic route, so neighbouring
    threads read neighbouring points."""
    t = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    return torch.as_tensor(np.ascontiguousarray(t.gen[:t.feval].T),
                           device=device)
