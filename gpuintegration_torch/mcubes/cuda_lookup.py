"""Wrappers of the VEGAS grid-path kernels (csrc/vegas_lookup.cu), each with
its plain PyTorch version beside it:

* ``hist`` / ``hist_plain`` -- the (ndim, nbins) f32 histogram of
  min(f2, HIST_CAP) over per-dimension bin ids; replaces
  ``gpuintegration_tpu/mcubes/pallas_lookup.py::hist_pallas``;
* ``bin_resolve`` / ``bin_resolve_plain`` -- grid coordinate xn to
  (rc, xo[, ia]); replaces ``::bin_resolve_pallas``.
  ``bin_resolve_stratified`` is the same kernel drawing xn itself from the
  Philox stream (mcubes/stream.py), which is how the grid map runs on the
  card; ``stratified_xn_plain`` is that draw in plain PyTorch;
* ``edge_lookup`` / ``edge_lookup_plain`` -- bin ids to their edge pairs;
  replaces ``::edge_lookup_pallas``.  Like its TPU counterpart it lies on
  no path of ``vegas``: only tests and the smoke run call it.

A wrapper takes the plain version only for tensors on the CPU; on CUDA
tensors it launches its kernel or raises.  The histogram repeats bitwise
from launch to launch (no atomics; see the source's header).  ``ia``, the
edges and ``xo`` equal the plain versions' bit for bit; ``rc`` is held to
2 ulp.  The library is built at first use (ops/cuda_build.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from gpuintegration_torch.mcubes import stream
from gpuintegration_torch.ops import cuda_build

# f32-safe saturation of the adaptation histogram, the single source.  The
# histogram is f32 (it only steers adaptation) but huge-magnitude
# integrands overflow it: per-sample f^2 ~ 1e44 is inf in f32 and one inf
# poisons the grid.  Clamping each value before it is added, and the
# accumulation across chunks (vegas._hist_accum), keeps every bin finite;
# the rebin is scale-invariant and renormalises in f64.
HIST_CAP = 3.0e37

_SOURCE = "vegas_lookup.cu"
THREADS = 256
HIST_PER_BLOCK = 8192      # samples per histogram block
MAX_BLOCKS = 1 << 16

# Launches of each kernel since its count was last set to 0.
hist_launches = 0
bin_resolve_launches = 0
edge_lookup_launches = 0


def _configure(lib):
    vp, ll, i, f, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_uint)
    lib.vegas_hist_launch.argtypes = [vp, vp, vp, ll, i, i, i, i, f, vp]
    lib.vegas_resolve_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll,
                                         i, i, i, i, f, u, u, u, i, vp]
    lib.vegas_edge_launch.argtypes = [vp, vp, vp, vp, ll, i, i, i, vp]
    for fn in (lib.vegas_hist_launch, lib.vegas_resolve_launch,
               lib.vegas_edge_launch):
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


def hist(ia, f2, nbins: int):
    """``hist_plain`` on CPU tensors; on CUDA tensors one kernel launch
    (ia int32, f2 float32), whose result repeats bitwise."""
    global hist_launches
    dev = f2.device
    if dev.type == "cpu":
        return hist_plain(ia, f2, nbins)
    ia_t = _dims_major(ia).contiguous()
    f2f = f2.reshape(-1)
    ndim, n = ia_t.shape
    _need("ia", ia_t, torch.int32, (ndim, n), dev)
    _need("f2", f2f, torch.float32, (n,), dev)
    if 4 * 8 * nbins > 227 * 1024:
        raise ValueError(f"nbins={nbins} does not fit the histogram "
                         "kernel's shared memory")
    blocks = -(-n // HIST_PER_BLOCK)
    part = torch.empty((blocks, ndim, nbins), dtype=torch.float32, device=dev)
    _check(_lib().vegas_hist_launch(
        ia_t.data_ptr(), f2f.data_ptr(), part.data_ptr(), n, ndim, nbins,
        HIST_PER_BLOCK, blocks, HIST_CAP, _stream(dev)), "histogram")
    hist_launches += 1
    return part.sum(dim=0)


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
    dxg = torch.tensor(float(nbins), dtype=f32, device=device) / ng
    xn = (kg[None] - u) * dxg + 1.0                              # (npg, ndim, C)
    valid = (cube < ncubes)[:, None].expand(chunk_cubes, npg).reshape(-1)
    return xn.permute(1, 2, 0).reshape(ndim, -1), valid


def _launch_resolve(xi32, xn, n, with_ia, nbins, cube0=0, ncubes=0, ng=1,
                    npg=1, seed=0, iteration=0):
    global bin_resolve_launches
    dev = xi32.device
    ndim = xi32.shape[0]
    _need("xi", xi32, torch.float32, (ndim, nbins + 1), dev)
    if 4 * (nbins + 1) > 48 * 1024:
        raise ValueError(f"nbins={nbins} does not fit the bin-resolve "
                         "kernel's shared memory")
    rc = torch.empty((ndim, n), dtype=torch.float32, device=dev)
    xo = torch.empty_like(rc)
    ia = (torch.empty((ndim, n), dtype=torch.int32, device=dev)
          if with_ia else None)
    k0, k1 = stream.seed_key(seed)
    _check(_lib().vegas_resolve_launch(
        xi32.data_ptr(), None if xn is None else xn.data_ptr(),
        rc.data_ptr(), xo.data_ptr(), None if ia is None else ia.data_ptr(),
        n, int(cube0), int(ncubes), ndim, nbins, ng, npg,
        float(np.float32(nbins) / np.float32(ng)), k0, k1,
        int(iteration) & stream.MASK32, min(-(-n // THREADS), MAX_BLOCKS),
        _stream(dev)),
        "bin-resolve")
    bin_resolve_launches += 1
    return rc, xo, ia


def bin_resolve(xi32, xn, nbins: int, *, with_ia: bool = False):
    """``bin_resolve_plain`` on CPU tensors; on CUDA tensors one kernel
    launch."""
    if xn.device.type == "cpu":
        return bin_resolve_plain(xi32, xn, nbins, with_ia=with_ia)
    ndim, n = xn.shape
    _need("xn", xn, torch.float32, (ndim, n), xi32.device)
    return _launch_resolve(xi32, xn, n, with_ia, nbins)


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
                           with_ia: bool = False, bits=None):
    """``bin_resolve_stratified_plain`` on a CPU grid.  On a CUDA grid one
    kernel launch that draws xn itself and keeps it out of memory; given
    ``bits`` (the parity hook), xn is formed in plain PyTorch and resolved
    by the kernel."""
    if xi32.device.type == "cuda" and bits is None:
        return _launch_resolve(xi32, None, chunk_cubes * npg, with_ia, nbins,
                               cube0, ncubes, ng, npg, seed, iteration)
    return bin_resolve_stratified_plain(
        xi32, nbins, ng, npg, chunk_cubes, cube0, ncubes, seed, iteration,
        with_ia=with_ia, bits=bits, resolve=bin_resolve)


# ---------------------------------------------------------------------------
# edge lookup

def edge_lookup_plain(xi32, ia, nbins: int):
    """(xi[d, ia-1], xi[d, ia]) for bin ids ia (C, npg, ndim) in
    [1, nbins]; xi32 (ndim, nbins+1) f32.  Two (C, npg, ndim) f32."""
    idx = torch.clamp(ia.to(torch.int64), 1, nbins)
    dims = torch.arange(xi32.shape[0], device=xi32.device)
    return xi32[dims, idx - 1], xi32[dims, idx]


def edge_lookup(xi32, ia, nbins: int):
    """``edge_lookup_plain`` on CPU tensors; on CUDA tensors one kernel
    launch (ia int32)."""
    global edge_lookup_launches
    dev = ia.device
    if dev.type == "cpu":
        return edge_lookup_plain(xi32, ia, nbins)
    ndim = xi32.shape[0]
    _need("xi", xi32, torch.float32, (ndim, nbins + 1), dev)
    _need("ia", ia, torch.int32, tuple(ia.shape[:-1]) + (ndim,), dev)
    if 4 * ndim * (nbins + 1) > 227 * 1024:
        raise ValueError(f"a grid of {ndim} x {nbins + 1} edges does not fit "
                         "the edge-lookup kernel's shared memory")
    lo = torch.empty(ia.shape, dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    total = ia.numel()
    _check(_lib().vegas_edge_launch(
        xi32.data_ptr(), ia.data_ptr(), lo.data_ptr(), hi.data_ptr(), total,
        ndim, nbins, min(-(-total // THREADS), MAX_BLOCKS), _stream(dev)),
        "edge-lookup")
    edge_lookup_launches += 1
    return lo, hi
