"""Wrapper of the fused VEGAS sampler kernel (csrc/vegas_sample.cu), with
its plain PyTorch version ``sample_chunk_plain`` beside it.

Replaces ``gpuintegration_tpu/mcubes/pallas_vegas.py::poly_sample_chunk``:
one launch runs a chunk of sub-cubes through the sampling machinery
(uniforms, stratified positions, the joint Chebyshev map, the clip to the
volume, the weight) and either evaluates a Genz integrand in f32 and
reduces each cube to (fb, f2b) -- the fused mode -- or emits the
coordinates and weights for an integrand evaluated outside in the
accumulator type -- the emit mode.  With ``with_hist`` the per-dimension
bin ids (and, fused, f^2) come out too.

Three kernels compute it, and ``sampler_route`` chooses between them by
the shape alone (never by catching a failure):

* ``'paired'``, for ndim in ``PAIRED_NDIMS`` (1..8) and a map whose packed
  form fits the kernel's shared memory: ndim is a compile-time constant; the
  coefficients come packed (``pack_map``: four terms of P and four of q to
  a pair of 16-byte loads, q zero-padded to a multiple of four terms) so
  that the loops run four terms a pass without a test of the term index; a
  cube's samples go through the recurrence two at a time, one load feeding
  two independent chains; the cube id is decoded in 32-bit arithmetic with
  the reciprocal of ng (``stream.decode_reciprocal``) when the lattice has
  fewer than 2^32 cubes; a pair's outputs are stored as 8-byte words.
  Within a chain the order of operations is the generic kernel's.
* ``'wide'``, for ndim in ``WIDE_NDIMS`` (9..32) under the same condition:
  the paired design with the dimension a compile-time class
  (``wide_class``: NMAX 12, 16, 24 or 32, loops unrolled to NMAX and the
  dimensions past ndim skipped), and a cube's samples spread over a group
  of ``wide_lanes(chunk_cubes, npg, emit_ids)`` lanes where a chunk has
  few cubes of many samples; the group's first lane adds its values in
  sample order.  Emitting bin ids at npg <= 2 (a cube a lane), the NMAX 32
  class leaves the launch to the generic route, which was faster there.
* ``'generic'``, every ndim whose map fits (the route above 32D): run-time
  loops over sample slots, dimensions and terms, one 4-byte coefficient
  load per multiply-add, a 64-bit decode.  It is also the kernel the others
  are checked and timed against.

The fused mode takes ndim up to ``MAX_NDIM`` (the Genz parameters a kernel
holds, packed by ``cuda_rule.kernel_params(integrand, MAX_NDIM)``; a
traced callable's library up to the same); the emit mode any ndim.

Within a chain every route keeps the generic kernel's order of operations,
so coordinates, weights, bin ids and f^2 are the same bits on every route,
and so is each cube's (fb, f2b); the f64 sums over a chunk's cubes group
by route and agree within their rounding.

The fused mode also takes a traced per-axis callable
(``ops.integrand_gen.TracedIntegrand``, what ``vegas(sampler='fused')``
makes of one): the same kernels instantiated for the generated family,
from a library built for that callable at first use (csrc/gen_integrand.cu,
``cuda_build.load_generated``).

``launches`` counts every launch since it was last set to 0, and
``route_launches`` the same per route (``generated_launches`` those of
traced callables among them); ``reset_launches()`` zeroes them.

What changed against the TPU kernel, and why:

* outputs are in the flat order n = cube * npg + sample, dims-major
  (ndim, N); the reference's (tile, slot, A, 128) order was the TPU's;
* the sums over cubes are f64 and come back as one (2,) tensor
  [sum fb, sum f2b]; the TPU kernel wrote f32 lanes and widened outside;
* npg is a run-time loop and cube ids are 64-bit, so neither npg > 8 nor
  a lattice of 2^31 cubes leaves the kernels;
* the uniforms are the Philox stream of mcubes/stream.py (``rng='device'``)
  or a tensor of words (``bits=``, the parity hook);
* a cube beyond the lattice (the padding of the last chunk) gives neutral
  outputs: the volume's low corner with weight 0, bin 0, f^2 0.

What bounds the kernel is written in the source's header.  The library is
built at first use (ops/cuda_build.py); a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gpuintegration_torch.mcubes import stream
from gpuintegration_torch.mcubes.grid import TINY
from gpuintegration_torch.ops import cuda_build, cuda_rule, integrand_gen

_SOURCE = "vegas_sample.cu"
MAX_NDIM = 32          # the fused mode's most dimensions
THREADS = 256
MAX_BLOCKS = 1 << 16
MAX_CHUNK_CUBES = 1 << 30
ROUTES = ("paired", "wide", "generic")
# The dimensions csrc/vegas_sample.cu compiles the paired and the wide
# routes for.
PAIRED_NDIMS = tuple(range(1, 9))
WIDE_NDIMS = tuple(range(9, 33))
SMEM_BYTES = 48 * 1024          # the map's room in a block's shared memory
# Threads a fused or plain emit launch of the wide kernel spreads a cube's
# samples over lanes to reach: 768 for each of an H100's 132 SMs (4 lanes
# at 16D and ncall 1e9, 2^15 cubes of 23 samples; 1 at 12D, 2^18 of 4)
RESIDENT_SLOTS = 132 * 768
MAX_LANES = 32

# Launches of the kernels since the counts were last set to 0.
launches = 0
route_launches = {r: 0 for r in ROUTES}
generated_launches = {r: 0 for r in ROUTES}   # a traced callable's, by route


def reset_launches():
    global launches
    launches = 0
    for r in ROUTES:
        route_launches[r] = 0
        generated_launches[r] = 0


# the route argument of vegas_sample_launch
_ROUTE_CODE = {"generic": 0, "paired": 1, "wide": 2}


def _configure(lib):
    fn = lib.vegas_sample_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_uint]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_uint] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class PolyMap:
    """The importance map as the sampler takes it: one f32 tensor holding
    the volume-folded P series (ndim*kp), the q series (ndim*kq), and the
    volume's low and high corners (ndim each).  ``packed`` is the same
    map in the paired and wide kernels' layout (``pack_map``);
    ``fold_map`` fills it once per map, so that a launch does not."""
    table: torch.Tensor
    ndim: int
    kp: int
    kq: int
    packed: torch.Tensor | None = None

    def parts(self):
        n, kp, kq = self.ndim, self.kp, self.kq
        t = self.table
        return (t[:n * kp].view(n, kp), t[n * kp:n * (kp + kq)].view(n, kq),
                t[n * (kp + kq):n * (kp + kq + 1)], t[n * (kp + kq + 1):])


def fold_map(p_coeffs, q_coeffs, regn_lo, dx) -> PolyMap:
    """Fold the volume transform into the map's coefficients, in f32:
    x = lo + P(s) dx  ==  (lo + c0 dx) + sum_i (c_i dx) T_i  (T_0 = 1)."""
    f32 = torch.float32
    lo32 = regn_lo.to(f32)
    dx32 = dx.to(f32)
    pf = p_coeffs.to(f32) * dx32[:, None]
    pf[:, 0] += lo32
    ndim, kp = pf.shape
    table = torch.cat([pf.reshape(-1), q_coeffs.to(f32).reshape(-1), lo32,
                       lo32 + dx32]).contiguous()
    pmap = PolyMap(table, ndim, kp, q_coeffs.shape[1])
    return dataclasses.replace(pmap, packed=pack_map(pmap))


def padded_terms(kp: int, kq: int) -> tuple[int, int]:
    """(kp4, kq4): the terms of P and of q padded to multiples of four."""
    return 4 * -(-kp // 4), 4 * -(-kq // 4)


def pack_map(pmap: PolyMap) -> torch.Tensor:
    """The map in the paired and wide kernels' layout, one f32 tensor: per
    dimension kq4/4 groups of (four terms of P, four of q), then
    (kp4 - kq4)/4 groups of four terms of P alone, both series padded with
    zeros; then the low and the high corners.  kp4 + kq4 words per
    dimension, each group 16-byte aligned."""
    n, kp, kq = pmap.ndim, pmap.kp, pmap.kq
    kp4, kq4 = padded_terms(kp, kq)
    p, q, lo, hi = pmap.parts()
    pf = torch.nn.functional.pad(p, (0, kp4 - kp))
    qf = torch.nn.functional.pad(q, (0, kq4 - kq))
    joint = torch.stack([pf[:, :kq4].reshape(n, -1, 4),
                         qf.reshape(n, -1, 4)], dim=2)     # (n, kq4/4, 2, 4)
    body = torch.cat([joint.reshape(n, -1), pf[:, kq4:]], dim=1)
    return torch.cat([body.reshape(-1), lo, hi]).contiguous()


def unpack_map(packed: torch.Tensor, ndim: int, kp: int, kq: int):
    """(p (ndim, kp), q (ndim, kq), lo, hi) from ``pack_map``'s tensor, as
    the kernel reads it."""
    kp4, kq4 = padded_terms(kp, kq)
    body = packed[:ndim * (kp4 + kq4)].view(ndim, kp4 + kq4)
    joint = body[:, :2 * kq4].reshape(ndim, -1, 2, 4)
    p = torch.cat([joint[:, :, 0].reshape(ndim, -1), body[:, 2 * kq4:]],
                  dim=1)
    q = joint[:, :, 1].reshape(ndim, -1)
    rest = packed[ndim * (kp4 + kq4):]
    return p[:, :kp], q[:, :kq], rest[:ndim], rest[ndim:]


def sampler_route(ndim: int, kp: int, kq: int) -> str:
    """The kernel a map of this shape takes where the packed map fits the
    shared memory: 'paired' at ndim 1..8, 'wide' at 9..32; else
    'generic'."""
    kp4, kq4 = padded_terms(kp, kq)
    if 4 * ndim * (kp4 + kq4 + 2) > SMEM_BYTES:
        return "generic"
    if ndim in PAIRED_NDIMS:
        return "paired"
    return "wide" if ndim in WIDE_NDIMS else "generic"


def wide_class(ndim: int) -> int:
    """NMAX of the wide kernel instance that vegas_sample.cu launches for
    ``ndim`` (a generated library's instance is its own ndim)."""
    return next(nmax for nmax in (12, 16, 24, 32) if ndim <= nmax)


def wide_lanes(chunk_cubes: int, npg: int, emit_ids: bool = False) -> int:
    """Lanes of the wide route a cube, a power of two at most MAX_LANES.
    Emitting points with bin ids: enough lanes that a cube's samples go in
    one round (their stores then fill whole sectors; 16 at npg 23).
    Otherwise doubled from 1 while a lane keeps a pair of samples to draw
    and the chunk's threads stay below RESIDENT_SLOTS: more lanes would
    leave slots idle and lengthen the first lane's in-order sum.  Set by
    the shape and the mode alone, not the card: it groups the fused mode's
    f64 sums over cubes."""
    lanes, pairs = 1, -(-npg // 2)
    while lanes < MAX_LANES and lanes < pairs and (
            emit_ids or chunk_cubes * lanes < RESIDENT_SLOTS):
        lanes *= 2
    return lanes


def _cheb_joint(p, q, t):
    kp, kq = p.shape[0], q.shape[0]
    acc_p = p[0] + p[1] * t
    acc_q = q[0] + (q[1] * t if kq > 1 else torch.zeros_like(t))
    t_prev, t_cur = torch.ones_like(t), t
    t2 = t + t
    for i in range(2, kp):
        t_next = t2 * t_cur - t_prev
        acc_p = acc_p + p[i] * t_next
        if i < kq:
            acc_q = acc_q + q[i] * t_next
        t_prev, t_cur = t_cur, t_next
    return acc_p, acc_q


def sample_chunk_plain(pmap: PolyMap, integrand, ng: int, npg: int,
                       chunk_cubes: int, nbins: int, with_hist: bool,
                       xjac: float, cube0: int, ncubes: int, seed: int,
                       iteration, *, bits=None,
                       emit_points: bool = False):
    """The kernel's function in plain PyTorch, operation for operation in
    f32 (unfused: the kernel's multiply-adds round once, these twice).
    Arguments and returns as ``sample_chunk``."""
    f32 = torch.float32
    dev = pmap.table.device
    ndim = pmap.ndim
    p, q, lo, hi = pmap.parts()
    cube = cube0 + torch.arange(chunk_cubes, dtype=torch.int64, device=dev)
    valid = cube < ncubes
    kg = (stream.decode_cube(cube, ng, ndim) - 1).T.to(f32)      # (ndim, C)
    if bits is None:
        bits = stream.stream_bits(seed, iteration, cube, npg, ndim)
    u = stream.bits_to_uniform(bits).reshape(npg, ndim, chunk_cubes)
    s = (kg[None] + (1.0 - u)) * (1.0 / ng)                      # (npg, ndim, C)

    def flat(a, fill):
        """(npg, C) -> (N,) in the order n = cube * npg + slot, neutral
        in cubes beyond the lattice."""
        return torch.where(valid[None], a,
                           torch.as_tensor(fill, dtype=a.dtype, device=dev)
                           ).T.reshape(-1)

    xs, ias = [], []
    w = None
    for d in range(ndim):
        acc_p, acc_q = _cheb_joint(p[d], q[d], 2.0 * s[:, d] - 1.0)
        xs.append(torch.minimum(torch.maximum(acc_p, lo[d]), hi[d]))
        wd = acc_q * acc_q
        w = wd if w is None else w * wd
        if with_hist:
            ias.append(flat(torch.clamp((s[:, d] * nbins).to(torch.int32),
                                        0, nbins - 1), 0))
    ia = torch.stack(ias) if with_hist else None
    if emit_points:
        return (torch.stack([flat(xs[d], lo[d]) for d in range(ndim)]),
                flat(w, 0.0), ia)

    fx = integrand(torch.stack(xs, dim=-1)).to(f32) * (w * xjac)  # (npg, C)
    fx = torch.where(valid[None], fx, torch.zeros_like(fx))
    f2 = fx * fx
    fb = fx.sum(dim=0)
    sq = torch.sqrt(f2.sum(dim=0) * float(npg))
    f2b = (sq - fb) * (sq + fb)
    f2b = torch.where(f2b <= 0.0, torch.full_like(f2b, TINY), f2b)
    f2b = torch.where(valid, f2b, torch.zeros_like(f2b))
    sums = torch.stack([fb.to(torch.float64).sum(),
                        f2b.to(torch.float64).sum()])
    return sums, ia, (f2.T.reshape(-1) if with_hist else None)


def n_blocks(chunk_cubes: int, lanes: int = 1) -> int:
    """Thread blocks of one launch: ``lanes`` threads per cube up to
    MAX_BLOCKS blocks, a grid-stride loop beyond."""
    return min(-(-chunk_cubes * lanes // THREADS), MAX_BLOCKS)


def sample_chunk(pmap: PolyMap, integrand, ng: int, npg: int,
                 chunk_cubes: int, nbins: int, with_hist: bool, xjac: float,
                 cube0: int, ncubes: int, seed: int, iteration, *,
                 bits=None, emit_points: bool = False,
                 route: str | None = None):
    """One chunk of ``chunk_cubes`` sub-cubes, global ids ``cube0``...,
    through the sampler.  On a CPU map the plain version; on a CUDA map
    one kernel launch, by the route ``sampler_route`` gives the map's
    shape.  Naming a ``route`` runs that kernel (the checks and timings
    hold the two against each other) and raises if it does not take the
    shape.

    ``emit_points``: returns (xs (ndim, N) f32, wt (N,) f32, ia) with
    N = chunk_cubes * npg; ``integrand`` is not used.  Otherwise returns
    (sums (2,) f64 = [sum fb, sum f2b], ia, f2 (N,) f32); ``integrand``
    is a Genz family (models.genz) or a traced per-axis callable
    (``integrand_gen.TracedIntegrand``), evaluated in f32.  ``ia`` ((ndim, N)
    int32 bin ids in [0, nbins)) and ``f2`` are None unless ``with_hist``.

    ``bits``: (npg * ndim, chunk_cubes) int32 words to take the uniforms
    from, row slot * ndim + d; None draws the Philox stream of
    (seed, iteration).  ``iteration``: a host integer or a 0-d int64 counter
    on the map's device (``stream.counter``), whose value the kernel reads
    when it runs, so a captured CUDA graph replays it on whatever iteration
    the card's counter holds; the same words either way."""
    global launches
    dev = pmap.table.device
    if dev.type == "cpu":
        return sample_chunk_plain(pmap, integrand, ng, npg, chunk_cubes,
                                  nbins, with_hist, xjac, cube0, ncubes, seed,
                                  iteration, bits=bits,
                                  emit_points=emit_points)
    ndim, kp, kq = pmap.ndim, pmap.kp, pmap.kq
    if ndim < 1 or (not emit_points and ndim > MAX_NDIM):
        raise ValueError(f"the fused sampler takes ndim 1..{MAX_NDIM}, not "
                         f"{ndim}; the emit mode (sampler='hybrid') takes "
                         "any")
    if not 1 <= chunk_cubes <= MAX_CHUNK_CUBES or npg < 1:
        raise ValueError(f"chunk_cubes={chunk_cubes}, npg={npg}")
    if bits is None:
        stream.check_counter(npg, ndim)
    if 4 * ndim * (kp + kq + 2) > SMEM_BYTES:
        raise ValueError(f"a map of {ndim} x ({kp} + {kq}) coefficients "
                         "does not fit the kernel's shared memory")
    if not 1 <= ng < 2 ** 31:
        raise ValueError(f"ng={ng} (1 .. 2^31 - 1)")
    if route is None:
        route = sampler_route(ndim, kp, kq)
        if (route == "wide" and emit_points and with_hist
                and wide_class(ndim) == 32 and npg <= 2):
            # one cube a lane (wide_lanes): there the generic route took
            # 0.85-0.94 of the NMAX 32 instance's time at 30-32D on an
            # H100, where in the other modes the instance took 0.72-0.80
            # of the generic route's (tools/wide_times.py, PERF.md)
            route = "generic"
    if route not in ROUTES or (route != "generic"
                               and sampler_route(ndim, kp, kq) != route):
        raise ValueError(f"route {route!r} does not take a map of {ndim} x "
                         f"({kp} + {kq}) coefficients (paired: ndim in "
                         f"{PAIRED_NDIMS}, wide: ndim in {WIDE_NDIMS}, the "
                         f"packed map within {SMEM_BYTES} bytes)")
    if (pmap.table.dtype != torch.float32 or not pmap.table.is_contiguous()
            or pmap.table.numel() != ndim * (kp + kq + 2)):
        raise ValueError("PolyMap.table: need the contiguous float32 tensor "
                         "of fold_map")
    if bits is not None and (
            bits.device != dev or bits.dtype != torch.int32
            or tuple(bits.shape) != (npg * ndim, chunk_cubes)
            or not bits.is_contiguous()):
        raise ValueError(
            f"bits: need a contiguous int32 tensor of shape "
            f"({npg * ndim}, {chunk_cubes}) on {dev}")
    if emit_points:
        family, genz = 0, None
    else:
        # the Genz parameters at the sampler's MAX_NDIM axes (the rule
        # kernels keep their 16)
        family, genz = cuda_rule.kernel_params(integrand, MAX_NDIM)
        if getattr(integrand, "ndim", ndim) != ndim:
            raise ValueError(f"integrand ndim {integrand.ndim} != map {ndim}")

    n = chunk_cubes * npg
    lanes = (wide_lanes(chunk_cubes, npg, emit_points and with_hist)
             if route == "wide" else 1)
    blocks = n_blocks(chunk_cubes, lanes)
    i32, f32 = torch.int32, torch.float32
    xs = wt = partial = ia = f2 = None
    if emit_points:
        xs = torch.empty((ndim, n), dtype=f32, device=dev)
        wt = torch.empty(n, dtype=f32, device=dev)
    else:
        partial = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
        if with_hist:
            f2 = torch.empty(n, dtype=f32, device=dev)
    if with_hist:
        ia = torch.empty((ndim, n), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    k0, k1 = stream.seed_key(seed)
    word = stream.counter(iteration, dev)
    gp = None if genz is None else genz.ctypes.data_as(ctypes.c_void_p)
    kp4, kq4 = padded_terms(kp, kq)
    if route != "generic":
        table = pmap.packed if pmap.packed is not None else pack_map(pmap)
        if (table.device != dev or table.dtype != torch.float32
                or not table.is_contiguous()
                or table.numel() != ndim * (kp4 + kq4 + 2)):
            raise ValueError("PolyMap.packed: need the contiguous float32 "
                             "tensor of pack_map")
    else:
        table = pmap.table
    generated = family == integrand_gen.KIND
    lib = (cuda_build.load_generated(integrand_gen.header(integrand.program),
                                     _configure) if generated
           else cuda_build.load(_SOURCE, _configure))
    rc = lib.vegas_sample_launch(
        _ROUTE_CODE[route], kp4, kq4, stream.decode_reciprocal(ng), lanes,
        family, blocks, table.data_ptr(), ptr(bits), ptr(partial),
        ptr(xs), ptr(wt), ptr(ia), ptr(f2), int(cube0), int(ncubes),
        chunk_cubes, ndim, ng, npg, kp, kq, nbins,
        float(np.float32(1.0 / ng)), float(np.float32(xjac)), k0, k1,
        word.data_ptr(), gp, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA sampler kernel ({route} route) launch "
                           f"failed: error {rc}")
    launches += 1
    route_launches[route] += 1
    if generated:
        generated_launches[route] += 1
    if emit_points:
        return xs, wt, ia
    return partial.sum(dim=0), ia, f2
