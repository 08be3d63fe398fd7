"""Wrappers of the VEGAS grid-path kernels (csrc/vegas_lookup.cu), each with
its plain PyTorch version beside it:

* ``hist`` / ``hist_plain`` -- the (ndim, nbins) f32 histogram of
  min(f2, HIST_CAP) over per-dimension bin ids; replaces
  ``gpuintegration_tpu/mcubes/pallas_lookup.py::hist_pallas``.
  ``hist_accum`` / ``hist_accum_plain`` add one chunk's histogram into the
  accumulator, saturating at HIST_CAP, which is how ``vegas`` calls it;
* ``bin_resolve`` / ``bin_resolve_plain`` -- grid coordinate xn to
  (rc, xo[, ia]); replaces ``::bin_resolve_pallas``.
  ``bin_resolve_stratified`` is the same kernel drawing xn itself from the
  Philox stream (mcubes/stream.py), which is how the grid map runs on the
  card; ``stratified_xn_plain`` is that draw in plain PyTorch;
* ``edge_lookup`` / ``edge_lookup_plain`` -- bin ids to their edge pairs;
  replaces ``::edge_lookup_pallas``.  Like its TPU counterpart it lies on
  no path of ``vegas``; it is the bin-edge fetch of the frozen-grid
  estimate (``gpuintegration_torch.diff.frozen_grid_estimate``).

Each kernel has two routes, the bin resolve three, and ``hist_route`` /
``resolve_route`` / ``edge_route`` choose between them by the shape alone:
``'grouped'`` (a block per range of samples and all dimensions, lanes of
one bin grouped, thread-block clusters) against ``'generic'`` for the
histogram, ``'sample'`` (ndim 1..8: a persistent grid, a thread per 4
samples of all dimensions) and ``'wide'`` (ndim 9..32: a persistent grid,
a thread per 4 samples of one group of 4 dimensions) against
``'generic'`` for the bin resolve, ``'vector'`` (a persistent grid,
the table as edge pairs, a thread per 4 elements) against ``'generic'`` for
the edge lookup.  The generic kernels are the first design and what the
others are timed against.  A wrapper's ``route=`` runs one by name; a route
that does not take the shape raises.

A wrapper takes the plain version only for tensors on the CPU, whatever
route is named; on CUDA tensors it launches its kernel or raises.  The
histogram repeats bitwise from launch to launch (no atomics on floats; see
the source's header); its two routes add in different orders and agree
within rounding.  ``ia``, the edges and ``xo`` equal the plain versions'
bit for bit on every route; ``rc`` is held to 2 ulp.  ``hist_launches``,
``bin_resolve_launches`` and ``edge_lookup_launches`` count the launches,
``hist_route_launches``, ``resolve_route_launches`` and
``edge_route_launches`` the same per route; ``reset_launches()`` zeroes them
all.  The library is built at first use
(ops/cuda_build.py).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gpuintegration_torch.mcubes import stream
from gpuintegration_torch.ops import cuda_build

# f32-safe saturation of the adaptation histogram, the single source.  The
# histogram is f32 (it only steers adaptation) but huge-magnitude
# integrands overflow it: per-sample f^2 ~ 1e44 is inf in f32 and one inf
# poisons the grid.  Clamping each value before it is added, and the
# accumulation across chunks (``hist_accum``), keeps every bin finite; the
# rebin is scale-invariant and renormalises in f64.
HIST_CAP = 3.0e37

_SOURCE = "vegas_lookup.cu"
THREADS = 256
HIST_PER_BLOCK = 8192      # samples per block of the generic histogram
MAX_BLOCKS = 1 << 16
SMEM_BYTES = 227 * 1024    # shared memory one block may have
HIST_ROUTES = ("grouped", "generic")
RESOLVE_ROUTES = ("sample", "wide", "generic")
EDGE_ROUTES = ("vector", "generic")
HIST_CLUSTER = 8           # blocks of a grouped-histogram cluster
# the most clusters of a grouped launch at 1..8D: as many as an H100 SXM
# holds at once at the main path's shape (6D, 500 bins, 8 warps a block)
HIST_MAX_CLUSTERS = 30
# from 9D, clusters an H100 SXM holds at once for each block an SM holds
# (vegas_hist_clusters: 15 at one block an SM, 30 at two, 45 at three, 62
# at four), and the most blocks an SM holds of the 9..16D instances (64-71
# registers, blocks of 6 or 8 warps)
HIST_CLUSTERS_A_BLOCK = 15
HIST_WIDE_BLOCKS = 4
HIST_MAX_WARPS = 8         # a grouped block's most warps (its launch bounds)
# registers a thread of the run-time 17..32D instance takes (ptxas: 69-71,
# allocated by 8), against an SM's 64K: 3 blocks of 8 warps an SM, 4 of 5-7
# (chip_smoke.py phase 7 fails where ptxas reports more)
HIST_RUNTIME_REGISTERS = 72
SM_REGISTERS = 65536
SM_SMEM_BYTES = 228 * 1024  # shared memory of an SM, 1 KB of it a block's
SM_THREADS = 2048
# bytes of static shared memory the grouped kernel declares beside its rows
# (ptxas reports 16)
HIST_STATIC_SMEM = 16
HIST_SEGMENT = 128         # samples a warp takes at once, 4 a lane
HIST_WARPS = (8, 4)        # warps of a grouped block at 1..8D, the most that fit
HIST_SETS = (2, 1)         # sets of rows of a block from 9D, the most that fit
# the dimensions csrc/vegas_lookup.cu compiles the grouped histogram and
# the bin resolve's sample route for, and those the wrapper sends to the
# bin resolve's wide route (its kernel takes ndim at run time)
HIST_NDIMS = tuple(range(1, 33))
RESOLVE_NDIMS = tuple(range(1, 9))
RESOLVE_WIDE_NDIMS = tuple(range(9, 33))
# bytes of static shared memory the wide route's kernel declares beside
# the edges (WidePlaces: each of 8 groups' place and its reciprocal)
RESOLVE_WIDE_STATIC_SMEM = 96

# Launches of each kernel since its count was last set to 0.
hist_launches = 0
bin_resolve_launches = 0
edge_lookup_launches = 0
hist_route_launches = {r: 0 for r in HIST_ROUTES}
resolve_route_launches = {r: 0 for r in RESOLVE_ROUTES}
edge_route_launches = {r: 0 for r in EDGE_ROUTES}


def reset_launches():
    global hist_launches, bin_resolve_launches, edge_lookup_launches
    hist_launches = bin_resolve_launches = edge_lookup_launches = 0
    for counts in (hist_route_launches, resolve_route_launches,
                   edge_route_launches):
        for r in counts:
            counts[r] = 0


def _configure(lib):
    vp, ll, i, f, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_uint)
    lib.vegas_hist_launch.argtypes = [vp, vp, vp, ll, i, i, i, i, f, vp]
    lib.vegas_hist_grouped_launch.argtypes = [vp, vp, i, vp, vp, vp, ll, i, i,
                                              i, i, i, i, i, f, vp]
    lib.vegas_resolve_launch.argtypes = [i, vp, vp, vp, vp, vp, ll, ll, ll,
                                         i, i, i, i, f, u, u, vp, u, u, i, i,
                                         vp]
    lib.vegas_edge_launch.argtypes = [i, vp, vp, vp, vp, ll, i, i, i, i, i,
                                      vp]
    lib.vegas_resident_blocks.argtypes = [i, i, i]
    lib.vegas_hist_clusters.argtypes = [i, i, i, i]
    for fn in (lib.vegas_hist_launch, lib.vegas_hist_grouped_launch,
               lib.vegas_resolve_launch, lib.vegas_edge_launch,
               lib.vegas_resident_blocks, lib.vegas_hist_clusters):
        fn.restype = ctypes.c_int


def _lib():
    return cuda_build.load(_SOURCE, _configure)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _need(name, t, dtype, shape, dev):
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape "
                         f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA {what} kernel launch failed: error {rc}")


def _aligned(n: int, *tensors) -> bool:
    """Whether a kernel may move 4 samples as one 16-byte word: rows of a
    multiple of 4 samples, every tensor 16-byte aligned."""
    return n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                              if t is not None)


# ---------------------------------------------------------------------------
# f^2 adaptation histogram

def _dims_major(ia):
    """(C, npg, ndim) bin ids as (ndim, N), n = cube * npg + sample."""
    return ia.movedim(-1, 0).reshape(ia.shape[-1], -1) if ia.dim() == 3 else ia


def hist_plain(ia, f2, nbins: int):
    """(ndim, nbins) f32 histogram of min(f2, HIST_CAP) over per-dim bin
    ids.  ia: (C, npg, ndim) or dims-major (ndim, N) integer ids in
    [0, nbins); f2: (C, npg) or (N,) values.  The clamped f32 values are
    added in f64 and the sums rounded to f32 once, so the result does not
    depend on the order of the additions."""
    ia_t = _dims_major(ia).to(torch.int64)
    f2f = torch.clamp(f2.to(torch.float32), max=HIST_CAP).reshape(-1)
    out = torch.zeros((ia_t.shape[0], nbins), dtype=torch.float64,
                      device=f2.device)
    out.scatter_add_(1, ia_t, f2f.to(torch.float64).expand(ia_t.shape[0], -1))
    return out.to(torch.float32)


def hist_accum_plain(d, ia, f2, nbins: int, *, base: int = 0):
    """The accumulator ``d`` (ndim, nbins) f32 plus one chunk's histogram of
    bin ids ``ia - base``, saturating at HIST_CAP: a new tensor."""
    return torch.clamp(d + hist_plain(ia - base, f2, nbins), max=HIST_CAP)


def hist_groups(ndim: int) -> int:
    """Groups of dimensions of the grouped kernel: 1 up to 8D (a warp adds
    every dimension), from 9D ceil(ndim / 4) groups of 3 or 4 dimensions
    (3 or 4 groups at 9..16D, 5..8 at 17..32D), one warp of each sharing a
    set of rows (csrc/vegas_lookup.cu dim_groups)."""
    return 1 if ndim <= 8 else -(-ndim // 4)


def hist_warps(ndim: int, nbins: int) -> int:
    """Warps of a grouped-histogram block, or 0 where none fits a block's
    shared memory beside the kernel's own HIST_STATIC_SMEM bytes: up to 8D
    the most of HIST_WARPS, each with private rows of ndim x nbins f32;
    from 9D ``hist_groups`` warps a set of rows, the most of HIST_SETS
    within HIST_MAX_WARPS (2 sets at 9..16D, 1 at 17..32D)."""
    if ndim <= 8:
        for warps in HIST_WARPS:
            if 4 * warps * ndim * nbins + HIST_STATIC_SMEM <= SMEM_BYTES:
                return warps
        return 0
    for sets in HIST_SETS:
        if (sets * hist_groups(ndim) <= HIST_MAX_WARPS
                and 4 * sets * ndim * nbins + HIST_STATIC_SMEM <= SMEM_BYTES):
            return sets * hist_groups(ndim)
    return 0


def hist_sets(ndim: int, nbins: int) -> int:
    """Sets of private rows of a grouped block: the warps that take
    segments side by side."""
    return hist_warps(ndim, nbins) // hist_groups(ndim)


def hist_route(ndim: int, nbins: int) -> str:
    """The histogram kernel a shape takes: 'grouped' for the dimensions the
    source compiles it for, where the rows of at least min(HIST_WARPS)
    warps fit the shared memory; else 'generic'."""
    return ("grouped" if ndim in HIST_NDIMS and hist_warps(ndim, nbins)
            else "generic")


def hist_max_clusters(ndim: int, nbins: int) -> int:
    """The most clusters of a grouped launch for a shape: HIST_MAX_CLUSTERS
    at 1..8D (the count the route has had since its first design, which
    sets those shapes' bits); from 9D HIST_CLUSTERS_A_BLOCK for each block
    an SM holds by its shared memory (1 KB a block besides the rows), its
    threads, HIST_WIDE_BLOCKS and, at 17..32D, its registers (0 where no
    block fits)."""
    if ndim <= 8:
        return HIST_MAX_CLUSTERS
    warps = hist_warps(ndim, nbins)
    if not warps:
        return 0
    block = 4 * hist_sets(ndim, nbins) * ndim * nbins + HIST_STATIC_SMEM
    per_sm = min(SM_SMEM_BYTES // (block + 1024), SM_THREADS // (32 * warps),
                 HIST_WIDE_BLOCKS)
    if ndim > 16:
        per_sm = min(per_sm,
                     SM_REGISTERS // (HIST_RUNTIME_REGISTERS * 32 * warps))
    return HIST_CLUSTERS_A_BLOCK * per_sm


def hist_plan(n: int, ndim: int, nbins: int):
    """(warps, clusters) of a grouped launch over n samples: n and the
    shape alone set the clusters, no more than ``hist_max_clusters`` nor
    than give every set of rows one segment of HIST_SEGMENT samples.  The
    clusters set the order of the additions, so the card's model does
    not."""
    warps = hist_warps(ndim, nbins)
    segments = -(-n // HIST_SEGMENT)
    per_cluster = HIST_CLUSTER * hist_sets(ndim, nbins)
    return warps, max(1, min(hist_max_clusters(ndim, nbins),
                             -(-segments // per_cluster)))


def hist_clusters_on_card(ndim: int, nbins: int, f2_type=torch.float32):
    """How many clusters of the grouped kernel for this shape the current
    card holds at once (cudaOccupancyMaxActiveClusters): what
    HIST_MAX_CLUSTERS and HIST_ONE_BLOCK_CLUSTERS were read from, and what
    the checks hold ``hist_plan`` to.  Needs a card; launches nothing."""
    got = _lib().vegas_hist_clusters(ndim, nbins, hist_warps(ndim, nbins),
                                     int(f2_type == torch.float64))
    if got <= 0:
        raise RuntimeError(f"CUDA grouped histogram {ndim} x {nbins}: no "
                           f"cluster fits (error {-got})")
    return got


_tickets: dict = {}


def stream_tickets(dev):
    """The grouped histogram's ticket words of the current stream on
    ``dev``, made (zeroed) at the first call: one set per stream, since two
    streams' launches in flight at once would count into each other's.  A
    caller about to capture a CUDA graph on a stream calls this first, so
    that the words exist, zeroed, outside the capture."""
    handle = _stream(dev)
    if (dev.index, handle) not in _tickets:
        _tickets[dev.index, handle] = torch.zeros(HIST_CLUSTER,
                                                  dtype=torch.int32,
                                                  device=dev)
    return _tickets[dev.index, handle]


def _grouped(ia_t, f2f, nbins: int, out, base: int, accumulate: bool):
    """One grouped launch into ``out``: the histogram, or (accumulate) out
    plus it, saturating."""
    dev = f2f.device
    ndim, n = ia_t.shape
    is64 = f2f.dtype == torch.float64
    warps, clusters = hist_plan(n, ndim, nbins)
    tickets = stream_tickets(dev)
    handle = _stream(dev)
    part = torch.empty((clusters, ndim * nbins), dtype=torch.float32,
                       device=dev)
    _check(_lib().vegas_hist_grouped_launch(
        ia_t.data_ptr(), f2f.data_ptr(), int(is64), part.data_ptr(),
        out.data_ptr(), tickets.data_ptr(), n, ndim,
        nbins, base, int(accumulate), int(_aligned(n, ia_t, f2f)), warps,
        clusters, HIST_CAP, handle), "grouped histogram")
    return out


def _generic(ia_t, f2f, nbins: int):
    """The generic kernel: per-block partials summed over blocks."""
    dev = f2f.device
    ndim, n = ia_t.shape
    blocks = -(-n // HIST_PER_BLOCK)
    part = torch.empty((blocks, ndim, nbins), dtype=torch.float32, device=dev)
    _check(_lib().vegas_hist_launch(
        ia_t.data_ptr(), f2f.data_ptr(), part.data_ptr(), n, ndim, nbins,
        HIST_PER_BLOCK, blocks, HIST_CAP, _stream(dev)), "histogram")
    return part.sum(dim=0)


def _pick_hist_route(ndim: int, nbins: int, route):
    shape_route = hist_route(ndim, nbins)
    if route is None:
        route = shape_route
    if route not in HIST_ROUTES or (route == "grouped"
                                    and shape_route != "grouped"):
        raise ValueError(f"histogram route {route!r} does not take "
                         f"{ndim} x {nbins} bins (grouped: ndim in "
                         f"{HIST_NDIMS}, the rows of {min(HIST_WARPS)} warps "
                         f"within {SMEM_BYTES} bytes)")
    if route == "generic" and 4 * 8 * nbins > SMEM_BYTES:
        raise ValueError(f"nbins={nbins} does not fit the generic histogram "
                         "kernel's shared memory")
    return route


def _hist_inputs(ia, f2, types):
    """ia as a contiguous (ndim, N) int32 tensor and f2 as (N,) of one of
    ``types``, both on f2's device, or ValueError."""
    dev = f2.device
    ia_t = _dims_major(ia).contiguous()
    f2f = f2.reshape(-1)
    ndim, n = ia_t.shape
    _need("ia", ia_t, torch.int32, (ndim, n), dev)
    if f2f.dtype not in types:
        raise ValueError(f"f2: need one of {types}, got {f2f.dtype}")
    _need("f2", f2f, f2f.dtype, (n,), dev)
    return ia_t, f2f


def _count_hist(route):
    global hist_launches
    hist_launches += 1
    hist_route_launches[route] += 1


def hist(ia, f2, nbins: int, *, route: str | None = None):
    """``hist_plain`` on CPU tensors; on CUDA tensors one launch of the
    route ``hist_route`` gives the shape (or ``route``), whose result
    repeats bitwise.  ia int32; f2 float32, or float64 on the grouped
    route, which rounds it to f32 as ``.to(torch.float32)`` does."""
    if f2.device.type == "cpu":
        return hist_plain(ia, f2, nbins)
    ndim = _dims_major(ia).shape[0]
    route = _pick_hist_route(ndim, nbins, route)
    if route == "grouped":
        ia_t, f2f = _hist_inputs(ia, f2, (torch.float32, torch.float64))
        out = torch.empty((ndim, nbins), dtype=torch.float32, device=f2.device)
        _grouped(ia_t, f2f, nbins, out, 0, False)
    else:
        out = _generic(*_hist_inputs(ia, f2, (torch.float32,)), nbins)
    _count_hist(route)
    return out


def hist_accum(d, ia, f2, nbins: int, *, base: int = 0,
               route: str | None = None):
    """min(d + the histogram of bin ids ``ia - base``, HIST_CAP), written
    into the accumulator ``d`` ((ndim, nbins) contiguous f32), which it
    returns.  On CPU tensors ``hist_accum_plain``, whatever ``route`` says.
    On CUDA tensors the grouped route is one launch: it reads ia and f2
    (f32 or f64) as they are and finishes d in the kernel.  The generic
    route takes the first design's steps around its kernel in PyTorch: ids
    less ``base``, f2 to f32, the sum over blocks, the add and the clamp."""
    if f2.device.type == "cpu":
        return d.copy_(hist_accum_plain(d, ia, f2, nbins, base=base))
    ndim = _dims_major(ia).shape[0]
    _need("d", d, torch.float32, (ndim, nbins), f2.device)
    route = _pick_hist_route(ndim, nbins, route)
    if route == "grouped":
        ia_t, f2f = _hist_inputs(ia, f2, (torch.float32, torch.float64))
        _grouped(ia_t, f2f, nbins, d, base, True)
        _count_hist(route)
        return d
    h = hist(ia - base if base else ia, f2.to(torch.float32), nbins,
             route="generic")
    return torch.clamp(d + h, max=HIST_CAP, out=d)


# ---------------------------------------------------------------------------
# bin resolve

def bin_resolve_plain(xi32, xn, nbins: int, *, with_ia: bool = False):
    """xn (ndim, N) f32 in [1, nbins+1) -> (rc, xo, ia or None), each
    (ndim, N): ia = clip(int(xn), 1, nbins), xo = xi[d, ia] - xi[d, ia-1],
    rc = xi[d, ia-1] + (xn - ia) * xo  (Setup_Integrand_Eval,
    vegasT.cuh:188-235).  xi32: (ndim, nbins+1) f32."""
    ia = torch.clamp(xn.to(torch.int32), 1, nbins)
    idx = ia.to(torch.int64)
    lo = torch.gather(xi32, 1, idx - 1)
    xo = torch.gather(xi32, 1, idx) - lo
    rc = lo + (xn - ia.to(torch.float32)) * xo
    return rc, xo, (ia if with_ia else None)


def grid_step(nbins: int, ng: int) -> float:
    """nbins / ng rounded to f32 once: the bin units of one stratification
    interval.  Formed on the host, because PyTorch on a CUDA tensor divides
    by a Python number as a product with its rounded reciprocal, which can
    lie an ulp away (500 / 10000: 0.0499999970 against 0.0500000007)."""
    return float(np.float32(nbins) / np.float32(ng))


def stratified_xn_plain(ndim: int, ng: int, npg: int, nbins: int,
                        chunk_cubes: int, cube0: int, ncubes: int, seed: int,
                        iteration: int, device, *, bits=None):
    """(xn (ndim, N) f32, valid (N,) bool) of a chunk of cubes: the
    stratified grid coordinate xn = (kg - u) * (nbins / ng) + 1 of every
    sample, n = cube * npg + slot, each product and sum rounded on its own
    (vegasT.cuh:205).  ``bits`` as ``cuda_vegas.sample_chunk``."""
    f32 = torch.float32
    cube = cube0 + torch.arange(chunk_cubes, dtype=torch.int64, device=device)
    kg = stream.decode_cube(cube, ng, ndim).T.to(f32)            # (ndim, C)
    if bits is None:
        bits = stream.stream_bits(seed, iteration, cube, npg, ndim)
    u = stream.bits_to_uniform(bits).reshape(npg, ndim, chunk_cubes)
    dxg = torch.full((), grid_step(nbins, ng), dtype=f32, device=device)
    xn = (kg[None] - u) * dxg + 1.0                              # (npg, ndim, C)
    valid = (cube < ncubes)[:, None].expand(chunk_cubes, npg).reshape(-1)
    return xn.permute(1, 2, 0).reshape(ndim, -1), valid


def resolve_groups(ndim: int) -> int:
    """Groups of 4 dimensions (the last one ragged) of the wide route: a
    thread's item is 4 samples of one group, whose words are one Philox
    block a sample."""
    return -(-ndim // 4)


def resolve_items(ndim: int, n: int) -> int:
    """Threads' items of a wide-route launch over n samples: each group's
    quads of 4 samples, rounded up to a multiple of 32 so that a warp's
    lanes take 32 neighbouring quads of one group."""
    return resolve_groups(ndim) * (-(-n // 128) * 32)


def resolve_route(ndim: int, nbins: int, n: int) -> str:
    """The bin-resolve kernel a shape takes, where all edges fit a block's
    shared memory and n < 2^31 samples: 'sample' at ndim 1..8, 'wide' at
    9..32 (beside its RESOLVE_WIDE_STATIC_SMEM bytes); else 'generic'."""
    edges = 4 * ndim * (nbins + 1)
    if n < 2 ** 31:
        if ndim in RESOLVE_NDIMS and edges <= SMEM_BYTES:
            return "sample"
        if (ndim in RESOLVE_WIDE_NDIMS
                and edges + RESOLVE_WIDE_STATIC_SMEM <= SMEM_BYTES):
            return "wide"
    return "generic"


def _pick_resolve_route(ndim: int, nbins: int, n: int, route):
    shape_route = resolve_route(ndim, nbins, n)
    if route is None:
        route = shape_route
    if route not in RESOLVE_ROUTES or (route != "generic"
                                       and route != shape_route):
        raise ValueError(f"bin-resolve route {route!r} does not take ndim "
                         f"{ndim}, {nbins} bins, {n} samples (sample: ndim "
                         f"in {RESOLVE_NDIMS}, wide: ndim in "
                         f"{RESOLVE_WIDE_NDIMS}, the edges within "
                         f"{SMEM_BYTES} bytes, n < 2^31)")
    if route == "generic" and 4 * (nbins + 1) > 48 * 1024:
        raise ValueError(f"nbins={nbins} does not fit the generic "
                         "bin-resolve kernel's shared memory")
    return route


_resident: dict = {}
# the persistent-grid kernels vegas_resident_blocks knows, by its number
_PERSISTENT = {"resolve given xn": 0, "resolve drawing xn": 1,
               "edge vector": 2, "resolve wide given xn": 3,
               "resolve wide drawing xn": 4}
# the bin-resolve routes by their number in vegas_resolve_launch
_RESOLVE_CODES = {"generic": 0, "sample": 1, "wide": 2}


def _resident_blocks(dev, kernel: str, ndim: int, nbins: int) -> int:
    """How many blocks of a persistent-grid ``kernel`` the card holds at
    once, asked of the CUDA runtime once per device and shape."""
    key = (dev.index, kernel, ndim, nbins)
    if key not in _resident:
        got = _lib().vegas_resident_blocks(_PERSISTENT[kernel], ndim, nbins)
        if got <= 0:
            raise RuntimeError(f"CUDA {kernel}: no block of the kernel fits "
                               f"(error {-got})")
        _resident[key] = got
    return _resident[key]


def _launch_resolve(xi32, xn, n, with_ia, nbins, route, cube0=0, ncubes=0,
                    ng=1, npg=1, seed=0, iteration=0):
    global bin_resolve_launches
    dev = xi32.device
    ndim = xi32.shape[0]
    _need("xi", xi32, torch.float32, (ndim, nbins + 1), dev)
    route = _pick_resolve_route(ndim, nbins, n, route)
    rc = torch.empty((ndim, n), dtype=torch.float32, device=dev)
    xo = torch.empty_like(rc)
    ia = (torch.empty((ndim, n), dtype=torch.int32, device=dev)
          if with_ia else None)
    k0, k1 = stream.seed_key(seed)
    word = None
    if xn is None:
        stream.check_counter(npg, ndim)
        word = stream.counter(iteration, dev)
    if route == "generic":
        blocks = min(-(-n // THREADS), MAX_BLOCKS)
    else:
        # a persistent grid: a thread per 4 samples (on the wide route of
        # one group of dimensions, a group's quads rounded up to whole
        # warps), no more blocks than the card holds at once
        items = (resolve_items(ndim, n) if route == "wide"
                 else -(-n // 4))
        kernel = ("resolve wide " if route == "wide" else "resolve ") + (
            "drawing xn" if xn is None else "given xn")
        blocks = min(-(-items // THREADS),
                     _resident_blocks(dev, kernel, ndim, nbins))
    _check(_lib().vegas_resolve_launch(
        _RESOLVE_CODES[route], xi32.data_ptr(),
        None if xn is None else xn.data_ptr(), rc.data_ptr(), xo.data_ptr(),
        None if ia is None else ia.data_ptr(), n, int(cube0), int(ncubes),
        ndim, nbins, ng, npg, grid_step(nbins, ng), k0, k1,
        None if word is None else word.data_ptr(),
        stream.decode_reciprocal(ng), stream.decode_reciprocal(npg),
        int(_aligned(n, xn, rc, xo, ia)), blocks, _stream(dev)),
        f"bin-resolve ({route} route)")
    bin_resolve_launches += 1
    resolve_route_launches[route] += 1
    return rc, xo, ia


def bin_resolve(xi32, xn, nbins: int, *, with_ia: bool = False,
                route: str | None = None):
    """``bin_resolve_plain`` on CPU tensors, whatever ``route`` says; on
    CUDA tensors one launch of the route ``resolve_route`` gives the shape
    (or ``route``)."""
    if xn.device.type == "cpu":
        return bin_resolve_plain(xi32, xn, nbins, with_ia=with_ia)
    ndim, n = xn.shape
    _need("xn", xn, torch.float32, (ndim, n), xi32.device)
    return _launch_resolve(xi32, xn, n, with_ia, nbins, route)


def bin_resolve_stratified_plain(xi32, nbins: int, ng: int, npg: int,
                                 chunk_cubes: int, cube0: int, ncubes: int,
                                 seed: int, iteration: int, *,
                                 with_ia: bool = False, bits=None,
                                 resolve=bin_resolve_plain):
    """(rc, xo, ia or None) of a chunk of cubes whose grid coordinates are
    drawn from the stream: ``stratified_xn_plain`` then ``resolve``.
    Samples of cubes beyond the lattice get rc = xo = 0 (weight 0) and
    ia = 1."""
    xn, valid = stratified_xn_plain(xi32.shape[0], ng, npg, nbins,
                                    chunk_cubes, cube0, ncubes, seed,
                                    iteration, xi32.device, bits=bits)
    rc, xo, ia = resolve(xi32, xn.contiguous(), nbins, with_ia=with_ia)
    zero = torch.zeros_like(rc)
    return (torch.where(valid, rc, zero), torch.where(valid, xo, zero),
            None if ia is None else torch.where(valid, ia,
                                                torch.ones_like(ia)))


def bin_resolve_stratified(xi32, nbins: int, ng: int, npg: int,
                           chunk_cubes: int, cube0: int, ncubes: int,
                           seed: int, iteration: int, *,
                           with_ia: bool = False, bits=None,
                           route: str | None = None):
    """``bin_resolve_stratified_plain`` on a CPU grid.  On a CUDA grid one
    kernel launch (by ``route``, as ``bin_resolve``) that draws xn itself
    and keeps it out of memory; given ``bits`` (the parity hook), xn is
    formed in plain PyTorch and resolved by the kernel.  ``iteration``: a
    host integer or a 0-d int64 counter on the grid's device
    (``stream.counter``), whose value the kernel reads when it runs."""
    if xi32.device.type == "cuda" and bits is None:
        return _launch_resolve(xi32, None, chunk_cubes * npg, with_ia, nbins,
                               route, cube0, ncubes, ng, npg, seed,
                               iteration)
    return bin_resolve_stratified_plain(
        xi32, nbins, ng, npg, chunk_cubes, cube0, ncubes, seed, iteration,
        with_ia=with_ia, bits=bits,
        resolve=functools.partial(bin_resolve, route=route))


# ---------------------------------------------------------------------------
# edge lookup

def edge_lookup_plain(xi32, ia, nbins: int):
    """(xi[d, ia-1], xi[d, ia]) for bin ids ia (C, npg, ndim) in
    [1, nbins]; xi32 (ndim, nbins+1) f32.  Two (C, npg, ndim) f32."""
    idx = torch.clamp(ia.to(torch.int64), 1, nbins)
    dims = torch.arange(xi32.shape[0], device=xi32.device)
    return xi32[dims, idx - 1], xi32[dims, idx]


def edge_route(ndim: int, nbins: int) -> str:
    """The edge-lookup kernel a shape takes: 'vector' where the table's
    edge pairs (8 ndim nbins bytes) fit a block's shared memory; else
    'generic'."""
    return "vector" if 8 * ndim * nbins <= SMEM_BYTES else "generic"


def _pick_edge_route(ndim: int, nbins: int, route):
    shape_route = edge_route(ndim, nbins)
    if route is None:
        route = shape_route
    if route not in EDGE_ROUTES or (route == "vector"
                                    and shape_route != "vector"):
        raise ValueError(f"edge-lookup route {route!r} does not take "
                         f"{ndim} x {nbins} bins (vector: the edge pairs, "
                         f"8 ndim nbins bytes, within {SMEM_BYTES} bytes)")
    if route == "generic" and 4 * ndim * (nbins + 1) > SMEM_BYTES:
        raise ValueError(f"a grid of {ndim} x {nbins + 1} edges does not fit "
                         "the edge-lookup kernel's shared memory")
    return route


def edge_plan(total: int, ia_ptr: int, lo_ptr: int, hi_ptr: int):
    """(head, quads, vec_out) of a vector-route launch over ``total`` int32
    ids at address ``ia_ptr``: the head elements before ia's first 16-byte
    boundary (block 0 takes them one by one), the quads of 4 elements after
    it (the last one ragged where the rest is not a multiple of 4), and
    whether lo and hi at the head are 16-byte aligned too, so that a quad's
    edges go out as 16-byte stores (else as 4-byte ones)."""
    head = min((-(ia_ptr // 4)) % 4, total)
    quads = -(-(total - head) // 4)
    vec_out = (lo_ptr + 4 * head) % 16 == 0 and (hi_ptr + 4 * head) % 16 == 0
    return head, quads, vec_out


def edge_lookup(xi32, ia, nbins: int, *, route: str | None = None):
    """``edge_lookup_plain`` on CPU tensors, whatever ``route`` says; on
    CUDA tensors one launch of the route ``edge_route`` gives the shape (or
    ``route``).  ia: int32 (..., ndim), contiguous, any offset in its
    storage."""
    global edge_lookup_launches
    dev = ia.device
    if dev.type == "cpu":
        return edge_lookup_plain(xi32, ia, nbins)
    ndim = xi32.shape[0]
    _need("xi", xi32, torch.float32, (ndim, nbins + 1), dev)
    _need("ia", ia, torch.int32, tuple(ia.shape[:-1]) + (ndim,), dev)
    route = _pick_edge_route(ndim, nbins, route)
    lo = torch.empty(ia.shape, dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    total = ia.numel()
    if route == "vector":
        head, quads, vec_out = edge_plan(total, ia.data_ptr(), lo.data_ptr(),
                                         hi.data_ptr())
        if quads >= 2 ** 31:
            raise ValueError(f"{total} ids: the vector route takes fewer "
                             "than 2^33")
        blocks = min(-(-quads // THREADS),
                     _resident_blocks(dev, "edge vector", ndim, nbins))
    else:
        head, vec_out, blocks = 0, False, min(-(-total // THREADS),
                                               MAX_BLOCKS)
    _check(_lib().vegas_edge_launch(
        int(route == "vector"), xi32.data_ptr(), ia.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), total, ndim, nbins, head, int(vec_out), max(blocks, 1),
        _stream(dev)), f"edge-lookup ({route} route)")
    edge_lookup_launches += 1
    edge_route_launches[route] += 1
    return lo, hi
