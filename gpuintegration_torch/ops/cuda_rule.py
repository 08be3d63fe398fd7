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
* ``'generic'``, every ndim 2..16: the same ideas where ndim is known at
  run time only.  Four classes of dimensions (``generic_class``: NMAX 4,
  8, 12, 16; a traced callable's library its own ndim) unroll the axis
  loops to NMAX, axes past ndim folding a neutral row; persistent blocks
  whose warps walk over tiles of consecutive slots (``generic_plan``); a
  group of 32 lanes a region (8 at NMAX 4, four regions a warp); the
  region's coordinate table in shared memory; orbits 0-7 from the packed
  codes, the 2^n corners from the point index (``generic_point_codes``
  mirrors the decoding); each orbit a strided loop into one running sum
  (``generic_orbit_bounds``), a lane-parallel epilogue.
* ``'wide'``, a Genz family at ndim 17..``WIDE_MAX_NDIM`` (24), where the
  generic route's packed codes, byte offsets and corner table no longer
  fit (csrc/rule_wide.cuh): one block of 16 warps a region, ndim at run
  time; points of orbits 0-7 from a table of one 32-bit word a point, up
  to three (axis, code) pairs (``wide_orbit_codes``, ``wide_point_codes``
  mirrors the decoding), the 2^n corners from the point index with the
  generic route's convention; each thread's running sums, xor-shuffle
  trees a warp, the warps' sums added in an order fixed by ndim alone.
  Its launches are counted in ``wide_launches`` (and in ``launches``).
  No crease run and no traced callable takes it: past 16D they raise,
  naming ``rule_backend='torch'``.

What bounds them: for Genz integrands each region reads 2*ndim values and
writes 3, against feval * (~6*ndim + 3) f64 (or f32) operations, so the
kernels are bound by arithmetic, never by memory.  Both routes spend one
byte extraction, one shared-memory read and one multiply-add per (point,
axis) and the family's finish per point (in f64 an exp of some 19 f64
instructions for F4-F6, which the bound counts as one operation;
tools/sass_report.py reads the count from the machine code); the generic
route folds NMAX axes, not ndim.  No tensor cores, no TF32: the null-rule
sums cancel.

Both know the integrand as a Genz family id (F1..F6) and its parameters
(models.genz.GenzIntegrand), or as a traced per-axis callable
(``integrand_gen.TracedIntegrand``, what ``Workspace(rule_backend='fused')``
passes): its kernels are the same templates instantiated for the generated
family, from a library built for that callable at first use
(csrc/gen_integrand.cu, ``cuda_build.load_generated``), with the same
routes and counts, and ``generated_launches`` counting them apart by
route.  No crease run takes them.  Any other integrand takes a third route,
``'split'`` (``cuda_apply_rule_split``, csrc/rule_split.cu): chunk by chunk,
a points kernel writes every rule point, the callable runs on them as
ordinary torch operations, and a contraction kernel reduces its values to
est, err and split_dim, at ndim 2..``WIDE_MAX_NDIM`` (24): past 16D the
kernels' wide instances (the points from ``wide_orbit_codes``, the sums in
runs) on chunks cut to ``SPLIT_CHUNK_BYTES`` of points
(``split_chunk_size``).  ``rule_route(ndim, integrand)`` chooses the route
from the integrand and the shape.  The contraction has two routes of its
own, which ``contract_route`` chooses from the values' type, shape and
strides: ``'cluster'`` (the points of each group of 32 regions split
across a thread block cluster, streamed by bulk copies through a ring in
shared memory; ``cluster_plan``, ``cluster_partition``) where a region's
points or a point's regions lie contiguous, ``'generic'`` (the first
design) at any strides.  A vector-valued integrand, f: (..., ndim) ->
(..., ncomp), always takes the split route, and its values (C, feval,
ncomp) one of two contractions of their own (``split_contract_components``),
which ``contract_route`` chooses too: ``'components_cluster'`` where they
lie component-minor (what ``torch.stack(..., -1)`` gives; the cluster
design over a region's points x ncomp values, the scalar cluster route's
point ranges and order, so that each component is bit for bit that route's
on its plane; ``comp_cluster_plan``, ``comp_cluster_partition``), up to
``MAX_COMP_CLUSTER`` components, and ``'components'`` (the generic design
over the components, in passes of one 32-byte sector, each component summed
in the generic kernel's order) at any strides.

A crease run (``with_split_frac``) takes the route it would take without
the fraction, and the kernel that already holds each region's 4 ndim + 1
collinear values computes the crease/jump-aware cut fraction in its
epilogue, EQUAL to ``rule_eval.split_fraction`` on those values (the device
functions of csrc/split_frac.cuh): a Genz family's fused kernel, tile or
generic, from the values it keeps on chip; a callable's scalar
contraction, cluster or generic, from the values it reads.  The fraction
is the fourth output (cap,), and split_dim the axis a jump overrides.  The
same function as a kernel of its own, ``rule_split_frac_kernel``
(csrc/split_frac.cu, ``split_frac``), takes any values; no crease run
launches it, and the checks hold the folded forms against it.

``launches`` counts every launch of the fused kernels since it was last set
to 0, and ``route_launches`` the same per route (``generated_launches``
those of traced callables among them); ``split_launches`` counts
the split route's two kernels, ``'points'`` and ``'contract'``,
``split_frac_launches`` the standalone split fraction kernel's,
``generated_value_launches`` the check-only kernel of a traced callable's
values alone (``generated_values``),
``frac_route_launches`` the folded forms' launches, by the kernel that
computed the fraction (``FRAC_ROUTES``: ``'tile'``, ``'generic'``,
``'cluster'``, ``'contract_generic'``), and
``contract_route_launches`` the contraction's by route (``'cluster'``,
``'generic'``, ``'components_cluster'``, ``'components'``);
``reset_launches()`` zeroes them all.

The libraries are compiled with nvcc at first use into ``build/`` beside
this package, from the package's own sources (ops/cuda_build.py); a failed
build or launch raises, and nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.ops import (cuda_build, genz_malik, integrand_gen,
                                      rule_eval)
from gpuintegration_torch.ops.genz_malik import GENERATORS

_SOURCE = "rule_eval.cu"
_SPLIT_SOURCE = "rule_split.cu"
_FRAC_SOURCE = "split_frac.cu"
MAX_NDIM = 16
ROUTES = ("tile", "generic")
# The wide route (csrc/rule_wide.cuh): a Genz family at MAX_NDIM + 1 ..
# WIDE_MAX_NDIM, one block of WIDE_WARPS warps a region; a point of orbits
# 0-7 is WIDE_PAIRS (axis, code) pairs of WIDE_PAIR_BITS bits, the axis in
# the low WIDE_AXIS_BITS.
WIDE = "wide"
WIDE_MAX_NDIM = 24
WIDE_WARPS = 16
WIDE_BLOCKS_PER_SM = 2          # a launch's blocks at most, per SM
WIDE_PAIRS = 3
WIDE_AXIS_BITS = 5
WIDE_PAIR_BITS = WIDE_AXIS_BITS + 4
# The split route takes any callable up to WIDE_MAX_NDIM too.  Past
# MAX_NDIM its kernels are the wide instances of csrc/rule_split.cu: the
# points kernel from ``wide_orbit_codes`` (no generator table, 3.2 GB at
# 24D in f64), the contractions with fourth-difference rows for
# WIDE_MAX_NDIM axes (``fd_rows``) and their sums in runs; and a chunk
# holds at most the regions whose points fit SPLIT_CHUNK_BYTES
# (``split_chunk_size``), at least one: the Workspace's chunk of at least
# 1024 regions would be 19.3 GB of points at 17D and 3.3 TB at 24D in f64.
SPLIT_CHUNK_BYTES = 4 << 30
# The dimensions csrc/rule_eval.cu compiles the tile route for: every one
# whose point codes fit a 32-bit word (4 bits an axis) above 2D, where the 33
# points would leave a warp idle most of the time.
TILE_NDIMS = (3, 4, 5, 6, 7, 8)
TILE_WARPS = 16                 # warps of a persistent block, one per SM
MAX_TILE = 32                   # regions of a tile: one per lane
CODE_BITS = 4                   # bits of a (point, axis) code
# The generic route's classes of dimensions (csrc/rule_eval.cuh
# GenericClass): NMAX, lanes a region, most regions a tile.
GENERIC_WARPS = 16
GENERIC_NMAX = (4, 8, 12, 16)
# The contraction's cluster route (csrc/rule_split.cu).  Its stage size,
# ring and launch width were read off the H100 (PERF.md): bulk copies
# of 1 KB a region's segment or more, two 32 KB stages a CTA so that two
# CTAs share an SM, and some 224 CTAs, which clusters of up to 8 can keep
# all resident.
CONTRACT_ROUTES = ("cluster", "generic")     # a scalar integrand's values
COMPONENTS_CLUSTER = "components_cluster"   # a vector integrand's values
COMPONENTS = "components"
VECTOR_ROUTES = (COMPONENTS_CLUSTER, COMPONENTS)
CLUSTER_GROUP = 32              # regions of a cluster: one per lane
CLUSTER_WARPS = 8               # consumer warps of a CTA
CLUSTER_STAGE_BYTES = 32768     # a stage: 128 f64 or 256 f32 points
CLUSTER_RING = 2                # stages of a CTA's ring
# CTAs a launch aims at.  A constant, never the card's SM count: the
# partition, and so the bits, depend on the shape alone.
CLUSTER_CTAS = 224
# Values as planes come in segments of one point's 32 regions (256 bytes
# in f64), copies too small for the bulk copies to keep up below this many
# points a region: there the generic route is faster (PERF.md).
CLUSTER_PLANES_FEVAL = 4096
MAX_CLUSTER = 8                 # the portable cluster size
# The components cluster route: a region's segment of a stage about 1 KB
# (32 points of four f64 components), the size at which the scalar route's
# bulk copies keep up; warps' sums for at most this many components; a CTA's
# shared memory at most MAX_SMEM bytes.
COMP_STAGE_BYTES = 32768
COMP_RING = 2
MAX_COMP_CLUSTER = 8
MAX_SMEM = 227 * 1024
PAIR_SMEM = 112 * 1024          # a CTA's at most, for two to share an SM

# The kernels that fold a crease run's cut fraction into their epilogue:
# the fused routes and the scalar contraction's two routes (the standalone
# kernel is counted in split_frac_launches).
FRAC_ROUTES = ("tile", "generic", "cluster", "contract_generic")
CONTRACT_FRAC_ROUTE = {"cluster": "cluster", "generic": "contract_generic"}

# Launches since the counts were last set to 0; callers reset them and read
# them to show that a run went through the kernel, and by which route.
launches = 0
route_launches = {r: 0 for r in ROUTES}
wide_launches = 0               # the wide route's (also in launches)
generated_launches = {r: 0 for r in ROUTES}   # a traced callable's, by route
generated_value_launches = 0    # the check-only generated values kernel's
split_launches = {"points": 0, "contract": 0}
split_frac_launches = 0         # the standalone split fraction kernel's
frac_route_launches = {r: 0 for r in FRAC_ROUTES}
contract_route_launches = {r: 0 for r in CONTRACT_ROUTES + VECTOR_ROUTES}


def reset_launches():
    global launches, split_frac_launches, generated_value_launches
    global wide_launches
    launches = split_frac_launches = generated_value_launches = 0
    wide_launches = 0
    for counts in (route_launches, generated_launches, split_launches,
                   contract_route_launches, frac_route_launches):
        for k in counts:
            counts[k] = 0


def build() -> Path:
    """Compile csrc/rule_eval.cu into build/ (once per source content) and
    return the library's path (``cuda_build.build``).  Raises RuntimeError
    if nvcc fails."""
    return cuda_build.build(_SOURCE)


def _configure(lib):
    # both routes' entry points take the same arguments; rule_eval.cu's
    # library (not a generated one) also holds the wide route's
    for fn in (lib.rule_eval_launch, lib.rule_eval_tile_launch):
        fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 9
                       + [ctypes.c_double, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    if hasattr(lib, "rule_wide_launch"):
        fn = lib.rule_wide_launch
        fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 9
                       + [ctypes.c_double, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int


def _configure_split(lib):
    head = ([ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2)
    fn = lib.rule_split_points_launch
    fn.argtypes = head + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    fn = lib.rule_split_points_wide_launch
    fn.argtypes = head + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    fn = lib.rule_split_contract_launch
    fn.argtypes = (head + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 6 + [ctypes.c_double, ctypes.c_void_p]
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    fn = lib.rule_split_contract_comp_launch
    fn.argtypes = (head + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                   + [ctypes.c_double, ctypes.c_void_p]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    for fn in (lib.rule_split_cluster_occupancy,
               lib.rule_split_comp_cluster_occupancy):
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int


def _configure_frac(lib):
    fn = lib.rule_split_frac_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int


def is_genz_family(integrand) -> bool:
    """Whether the fused routes know ``integrand`` as a Genz family: a
    family id F1..F6 with its parameters (models.genz.GenzIntegrand)."""
    return (getattr(integrand, "kind", None) in (1, 2, 3, 4, 5, 6)
            and getattr(integrand, "params", None) is not None)


def is_generated(integrand) -> bool:
    """Whether ``integrand`` is a traced per-axis callable
    (``integrand_gen.TracedIntegrand``), whose generated kernels the fused
    routes launch."""
    return isinstance(integrand, integrand_gen.TracedIntegrand)


def kernel_params(integrand, width: int = MAX_NDIM
                  ) -> tuple[int, np.ndarray]:
    """(family id, 2 width + 2 host doubles: coeffs[width], bounds[width],
    s0, s1) of a Genz integrand, or (integrand_gen.KIND, zeros) of a traced
    callable; NotImplementedError for a callable the kernels lack,
    ValueError for per-axis parameters past ``width`` axes.  The rule
    kernels take width MAX_NDIM (34 doubles), the wide route
    WIDE_MAX_NDIM (50), the sampler its own (cuda_vegas.MAX_NDIM)."""
    p = np.zeros(2 * width + 2, dtype=np.float64)
    if is_generated(integrand):
        return integrand_gen.KIND, p
    if not is_genz_family(integrand):
        raise NotImplementedError(
            "the fused rule kernels evaluate the Genz families F1-F6 "
            "(gpuintegration_torch.models.genz) and traced per-axis "
            "callables (integrand_gen.traced) only; another integrand "
            "takes the split route (cuda_apply_rule_split), as "
            "rule_eval.apply_rule chooses by rule_route")
    kind, params = integrand.kind, integrand.params
    if kind in (1, 3, 6):
        coeffs = np.asarray(params["coeffs"], dtype=np.float64)
        if coeffs.size > width:
            raise ValueError(f"{coeffs.size} per-axis coefficients: the "
                             f"kernels hold {width}")
        p[:coeffs.size] = coeffs
    if kind == 1:
        p[2 * width] = params["offset"]
    elif kind == 2:
        p[2 * width] = 1.0 / params["a"] ** 2
        p[2 * width + 1] = params["b"]
    elif kind == 4:
        p[2 * width] = params["a"] * params["a"]
        p[2 * width + 1] = params["b"]
    elif kind == 5:
        p[2 * width] = params["a"]
        p[2 * width + 1] = params["b"]
    elif kind == 6:
        bounds = np.asarray(params["bounds"], dtype=np.float64)
        p[width:width + bounds.size] = bounds
    return kind, p


# ---------------------------------------------------------------------------
# Host-side layouts of the tile route

def past_16d(what: str, ndim: int, max_ndim: int = MAX_NDIM) -> str:
    """The refusal of a pool past ``max_ndim`` that ``what`` does not
    take."""
    return (f"{what} takes ndim 2..{max_ndim}, not {ndim} (past {MAX_NDIM}D "
            f"the card runs, up to {WIDE_MAX_NDIM}D, a Genz family of "
            f"models.genz on the {WIDE!r} route and any other scalar or "
            f"vector callable on the split route; a traced callable and "
            f"crease_split stop at {MAX_NDIM}D); rule_backend='torch' runs "
            f"the plain version at any ndim")


def rule_route(ndim: int, integrand=None, ncomp: int = 1) -> str:
    """The route a pool of this dimension takes: 'split' for an integrand
    that is neither a Genz family (``is_genz_family``) nor a traced
    callable (``is_generated``) and for any vector integrand (``ncomp`` >
    1: no fused kernel evaluates one), up to WIDE_MAX_NDIM; else 'tile'
    where the source compiles it, else 'generic' up to MAX_NDIM, and past
    it 'wide' for a Genz family (``integrand`` None stands for one) up to
    WIDE_MAX_NDIM.  ValueError, naming rule_backend='torch', for a pool
    that no route takes: a traced callable past MAX_NDIM, anything past
    WIDE_MAX_NDIM.  A crease run takes the same route up to MAX_NDIM:
    each route's kernel computes the cut fraction from the values it
    holds; past it the kernels compute none and the wrappers refuse one.
    The working type does not enter: every route is compiled for float64
    and float32."""
    if ncomp > 1 or (integrand is not None and not (
            is_genz_family(integrand) or is_generated(integrand))):
        if ndim > WIDE_MAX_NDIM:
            raise ValueError(past_16d("the split route (any callable "
                                      "other than a Genz family)", ndim,
                                      WIDE_MAX_NDIM))
        return "split"
    if ndim <= MAX_NDIM:
        return "tile" if ndim in TILE_NDIMS else "generic"
    if integrand is not None and is_generated(integrand):
        raise ValueError(past_16d("a traced callable's kernels", ndim))
    if ndim > WIDE_MAX_NDIM:
        raise ValueError(past_16d(f"the CUDA rule kernel (the {WIDE!r} route "
                                  f"to {WIDE_MAX_NDIM}D)", ndim))
    return WIDE


def generator_lam() -> np.ndarray:
    """(16,) float64, the generator of each code: lam[0] = 0, lam[1..5] the
    rule's five generators, lam[6..10] their negatives; the codes 11..15
    are unused and their lam is 0."""
    lam = np.zeros(1 << CODE_BITS, dtype=np.float64)
    lam[1:6] = GENERATORS
    lam[6:11] = -lam[1:6]
    return lam


def generator_codes(gen: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """(P, ndim) int64 codes of abscissae ``gen``: ``lam[code] == gen``
    exactly; AssertionError where an abscissa is none of the 11."""
    code = np.full(gen.shape, -1, dtype=np.int64)
    for c in range(11):
        code[gen == lam[c]] = c
    if (code < 0).any():
        raise AssertionError("a rule abscissa is none of the 11 generators")
    return code


@functools.lru_cache(maxsize=None)
def pack_generators(ndim: int) -> tuple[np.ndarray, np.ndarray]:
    """The generator table as codes: (codes (feval,) uint64, lam (16,)
    float64, ``generator_lam``) with ``gen[p, d] == lam[(codes[p] >> 4 d) &
    15]`` exactly."""
    gen = rule_eval.rule_tables(ndim).gen
    gen = gen[:rule_eval.rule_tables(ndim).feval]
    lam = generator_lam()
    code = generator_codes(gen, lam)
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


def generic_class(ndim: int, nmax: int | None = None
                  ) -> tuple[int, int, int]:
    """(NMAX, lanes a region, most regions a tile) of the generic kernel
    that takes ``ndim``: a Genz family's class (``GENERIC_NMAX``), or the
    class ``nmax`` (a traced callable's library: its own ndim).  32 lanes
    a region, 8 at NMAX <= 4; tiles of 32 regions up to NMAX 8, 16 up to
    12, else 8 (the block's shared memory: csrc/rule_eval.cuh
    GenericLayout)."""
    if nmax is None:
        nmax = next(c for c in GENERIC_NMAX if ndim <= c)
    return (nmax, 8 if nmax <= 4 else 32,
            32 if nmax <= 8 else 16 if nmax <= 12 else 8)


def generic_plan(ndim: int, n: int, blocked: bool, sm_count: int,
                 nmax: int | None = None) -> tuple[int, int]:
    """(regions per tile, persistent blocks) of the generic kernel for
    ``n`` real regions on a card of ``sm_count`` SMs: a tile at most the
    class's and smaller, in steps of a warp's regions at once, where the
    pool has too few regions to give every warp of the card a full one."""
    _, group, most = generic_class(ndim, nmax)
    step = 32 // group
    workers = sm_count * GENERIC_WARPS
    tile = min(most, max(step, step * -(-n // (step * workers))))
    parts = 2 if blocked else 1
    tiles = parts * -(-(n // parts) // tile)
    return tile, max(1, min(sm_count, -(-tiles // GENERIC_WARPS)))


def generic_orbit_bounds(ndim: int) -> tuple[int, ...]:
    """The generic kernel's segments of the point list, as it computes them
    from ndim: (0, 8n + 1, k6, k7, k8, feval): points 0..8n (the centre and
    orbits 1-4, kept), orbits 5, 6, 7, then the 2^n corners."""
    n = ndim
    k5 = 8 * n + 1
    k6 = k5 + 2 * n * (n - 1)
    k7 = k6 + 4 * n * (n - 1)
    k8 = k7 + 4 * n * (n - 1) * (n - 2) // 3
    return (0, k5, k6, k7, k8, k8 + (1 << n))


def generic_point_codes(ndim: int, nmax: int | None = None) -> np.ndarray:
    """(feval, ndim) generator codes (indices into ``pack_generators``'
    lam) of every rule point as the generic kernel decodes them: points of
    orbits 0-7 from the packed codes, corner k = it * G + lane from two
    words, the high axes' from ``it``'s bits and the low axes' from the
    lane's (G the class's lanes a region; axis d is -lambda_5, code 10,
    where bit n-1-d of k is set, else code 5)."""
    codes, _ = pack_generators(ndim)
    k8 = generic_orbit_bounds(ndim)[4]
    shifts = (CODE_BITS * np.arange(ndim, dtype=np.uint64))[None, :]
    table = ((codes[:k8, None] >> shifts)
             & np.uint64((1 << CODE_BITS) - 1)).astype(np.int64)
    _, group, _ = generic_class(ndim, nmax)
    lane_axes = min(group.bit_length() - 1, ndim)
    high = ndim - lane_axes

    def word(bits: int, d0: int, count: int) -> np.ndarray:
        w = np.zeros(ndim, dtype=np.int64)
        for i in range(count):
            w[d0 + i] = 10 if (bits >> (count - 1 - i)) & 1 else 5
        return w

    corners = np.zeros((1 << ndim, ndim), dtype=np.int64)
    for it in range(1 << high):
        for lane in range(1 << lane_axes):
            corners[(it << lane_axes) + lane] = (word(it, 0, high)
                                                 | word(lane, high,
                                                        lane_axes))
    return np.concatenate([table, corners])


@functools.lru_cache(maxsize=None)
def _tile_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """(codes (feval,) int32 bit patterns, lam (16,)) on the device.  The
    tile route takes ndim <= 8, so a point's codes fit 32 bits."""
    codes, lam = pack_generators(ndim)
    return (torch.as_tensor(codes.astype(np.uint32).view(np.int32),
                            device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _generic_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """(codes of orbits 0-7 (k8,) int64 bit patterns, lam (16,)) on the
    device: the generic kernel spreads the codes to byte offsets once a
    block and decodes the corners from the point index."""
    codes, lam = pack_generators(ndim)
    k8 = generic_orbit_bounds(ndim)[4]
    return (torch.as_tensor(codes[:k8].view(np.int64), device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Host-side layouts of the wide route

@functools.lru_cache(maxsize=None)
def wide_orbit_codes(ndim: int) -> np.ndarray:
    """(k8,) uint32, the wide route's table of orbits 0-7 (points 0 ..
    k8 - 1 of ``rule_eval.rule_tables(ndim).gen``, built from
    ``genz_malik.orbit_head``, which makes those rows, without the
    table's 2^n corners): a point's nonzero axes,
    at most WIDE_PAIRS of them (orbit 7 has three), in ascending order as
    pairs of WIDE_PAIR_BITS bits, pair i at bit WIDE_PAIR_BITS i, its axis
    in the low WIDE_AXIS_BITS and its code (``generator_lam``) above; the
    pairs a point lacks are 0, which names no coordinate but the centre."""
    k8 = generic_orbit_bounds(ndim)[4]
    code = generator_codes(genz_malik.orbit_head(ndim)[0], generator_lam())
    if code.shape[0] != k8:
        raise AssertionError(f"{code.shape[0]} points of orbits 0-7, not {k8}")
    nonzero = code != 0
    if (nonzero.sum(axis=1) > WIDE_PAIRS).any():
        raise AssertionError(f"a point of orbits 0-7 has more than "
                             f"{WIDE_PAIRS} nonzero axes")
    rank = np.cumsum(nonzero, axis=1) - 1
    rows, axes = np.nonzero(nonzero)
    pairs = ((axes | code[rows, axes] << WIDE_AXIS_BITS)
             << (WIDE_PAIR_BITS * rank[rows, axes]))
    words = np.zeros(k8, dtype=np.uint64)
    np.bitwise_or.at(words, rows, pairs.astype(np.uint64))
    return words.astype(np.uint32)


def wide_point_codes(ndim: int, points=None) -> np.ndarray:
    """(P, ndim) generator codes (indices into ``generator_lam``) of rule
    points ``points`` (indices; all of them where None) as the wide kernel
    decodes them: a point of orbits 0-7 from its word of
    ``wide_orbit_codes`` (the axes no pair names take code 0), corner k
    (point k8 + k) from its index, axis d code 10 (-lambda_5) where bit
    n-1-d of k is set, else 5: ``generic_point_codes``' convention."""
    k8 = generic_orbit_bounds(ndim)[4]
    p = (np.arange(rule_eval.rule_tables(ndim).feval) if points is None
         else np.asarray(points, dtype=np.int64))
    out = np.zeros((p.size, ndim), dtype=np.int64)
    orbit = p < k8
    words = wide_orbit_codes(ndim)[p[orbit]].astype(np.int64)
    rows = np.nonzero(orbit)[0]
    for i in range(WIDE_PAIRS):
        pair = words >> (WIDE_PAIR_BITS * i)
        axis = pair & ((1 << WIDE_AXIS_BITS) - 1)
        code = (pair >> WIDE_AXIS_BITS) & ((1 << CODE_BITS) - 1)
        out[rows, axis] |= code
    k = p[~orbit] - k8
    bits = (k[:, None] >> (ndim - 1 - np.arange(ndim))[None, :]) & 1
    out[~orbit] = np.where(bits == 1, 10, 5)
    return out


def wide_plan(n: int, sm_count: int) -> int:
    """Blocks of a wide launch over ``n`` real regions: one a region, at
    most WIDE_BLOCKS_PER_SM a SM, each walking the regions
    blockIdx.x, blockIdx.x + blocks, ...; the bits do not depend on it."""
    return max(1, min(n, WIDE_BLOCKS_PER_SM * sm_count))


@functools.lru_cache(maxsize=None)
def _wide_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """(orbit codes (k8,) int32 bit patterns, lam (16,), orbit_wts, scale,
    norm) on the device; not the (feval, ndim) points, which the kernel
    never reads (3.2 GB at 24D in f64)."""
    t = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return (put(wide_orbit_codes(ndim).view(np.int32)),
            torch.as_tensor(generator_lam(), dtype=dtype, device=device),
            put(t.orbit_wts), put(t.scale), put(t.norm))


def _wide_apply_rule(integrand, tables: rule_eval.RuleTables, lows, lengths,
                     global_lo, global_range, n, blocked):
    """One launch of the wide route (``cuda_apply_rule``'s, route 'wide')."""
    global launches, wide_launches
    ndim = tables.ndim
    kind, params = kernel_params(integrand, WIDE_MAX_NDIM)
    _check_ndim("cuda_apply_rule", ndim, WIDE_MAX_NDIM)
    cap, n = _check_pool("cuda_apply_rule", tables, lows, lengths, global_lo,
                         global_range, n, blocked)
    dtype = lows.dtype
    codes, lam, orbit_wts, scale, norm = _wide_tables(ndim, dtype,
                                                      lows.device)
    est = torch.empty(cap, dtype=dtype, device=lows.device)
    err = torch.empty(cap, dtype=dtype, device=lows.device)
    sdim = torch.empty(cap, dtype=torch.int32, device=lows.device)
    lib = cuda_build.load(_SOURCE, _configure)
    blocks = wide_plan(n, torch.cuda.get_device_properties(
        lows.device).multi_processor_count)
    rc = lib.rule_wide_launch(
        kind, int(dtype == torch.float64), ndim, cap, n, int(bool(blocked)),
        lows.data_ptr(), lengths.data_ptr(), global_lo.data_ptr(),
        global_range.data_ptr(), codes.data_ptr(), lam.data_ptr(),
        orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
        float(tables.ratio), params.ctypes.data_as(ctypes.c_void_p), blocks,
        est.data_ptr(), err.data_ptr(), sdim.data_ptr(),
        torch.cuda.current_stream(lows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule kernel ({WIDE} route) launch failed: "
                           f"error {rc}")
    launches += 1
    wide_launches += 1
    return est, err, sdim


def cuda_apply_rule(integrand, tables: rule_eval.RuleTables, lows, lengths,
                    global_lo, global_range, *, n: int | None = None,
                    blocked: bool = False, route: str | None = None,
                    with_split_frac: bool = False, kept=None):
    """One kernel launch over the ``n`` real regions of a CUDA pool
    (all of it when ``n`` is None).  Arguments and outputs as
    ``rule_eval.apply_rule_plain``: (estimate (cap,), errorest (cap,),
    split_dim (cap,) int32), with est = err = 0 and split_dim 0 in the
    padding slots; with ``with_split_frac`` the crease run's kernel, which
    also returns the cut fraction (cap,), 0.5 in the padding slots, and
    split_dim the axis a jump overrides.  ``kept`` (check only; with
    ``with_split_frac``): a contiguous (cap, 4 ndim + 1) tensor of the
    pool's type into which the kernel writes each real region's collinear
    values, the fraction's input.  ``route`` None takes
    ``rule_route(ndim)``; naming a route runs that kernel (the checks and
    timings hold the two against each other) and raises if it does not
    take the shape.  A traced callable's (``is_generated``) launches its
    generated library's kernels, which take no crease fraction.  Past
    MAX_NDIM a Genz family takes the wide route (``rule_route``), which
    computes no crease fraction either."""
    global launches
    ndim = tables.ndim
    kind, params = kernel_params(
        integrand, WIDE_MAX_NDIM if ndim > MAX_NDIM else MAX_NDIM)
    generated = is_generated(integrand)
    if generated and with_split_frac:
        raise ValueError("a traced callable's kernels compute no crease "
                         "fraction: crease_split needs rule_backend='cuda'")
    if getattr(integrand, "ndim", ndim) != ndim:
        raise ValueError(f"integrand ndim {integrand.ndim} != rule {ndim}")
    if route is None:
        route = rule_route(ndim, integrand)
    if route == WIDE and MAX_NDIM < ndim <= WIDE_MAX_NDIM and not generated:
        if with_split_frac:
            raise ValueError(past_16d("crease_split", ndim))
        return _wide_apply_rule(integrand, tables, lows, lengths, global_lo,
                                global_range, n, blocked)
    if route not in ROUTES or (route == "tile" and ndim not in TILE_NDIMS):
        raise ValueError(f"route {route!r} does not take ndim {ndim} "
                         f"(tile: {TILE_NDIMS}; generic: 2..{MAX_NDIM}; "
                         f"{WIDE}: a Genz family at {MAX_NDIM + 1}.."
                         f"{WIDE_MAX_NDIM})")
    _check_ndim("cuda_apply_rule", ndim, MAX_NDIM)
    cap, n = _check_pool("cuda_apply_rule", tables, lows, lengths, global_lo,
                         global_range, n, blocked)
    dtype = lows.dtype
    if cap >= 2 ** 31 // ndim:
        raise ValueError(f"pool of {cap} regions is too large for int32 "
                         "indexing")

    _, orbit_wts, scale, norm = rule_eval.device_tables(ndim, dtype,
                                                        lows.device)
    est = torch.empty(cap, dtype=dtype, device=lows.device)
    err = torch.empty(cap, dtype=dtype, device=lows.device)
    sdim = torch.empty(cap, dtype=torch.int32, device=lows.device)
    crease = _fused_frac_args(ndim, cap, lows, with_split_frac, kept)
    hp = params.ctypes.data_as(ctypes.c_void_p)
    stream = torch.cuda.current_stream(lows.device).cuda_stream
    lib = (cuda_build.load_generated(integrand_gen.header(integrand.program),
                                     _configure) if generated
           else cuda_build.load(_SOURCE, _configure))
    sm_count = torch.cuda.get_device_properties(
        lows.device).multi_processor_count
    if route == "tile":
        codes, lam = _tile_tables(ndim, dtype, lows.device)
        tile, blocks = tile_plan(n, blocked, sm_count)
        launch = lib.rule_eval_tile_launch
    else:
        codes, lam = _generic_tables(ndim, dtype, lows.device)
        tile, blocks = generic_plan(ndim, n, blocked, sm_count,
                                    ndim if generated else None)
        launch = lib.rule_eval_launch
    rc = launch(
        kind, int(dtype == torch.float64), ndim, cap, n, int(bool(blocked)),
        lows.data_ptr(), lengths.data_ptr(), global_lo.data_ptr(),
        global_range.data_ptr(), codes.data_ptr(), lam.data_ptr(),
        orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
        float(tables.ratio), hp, tile, blocks, est.data_ptr(),
        err.data_ptr(), sdim.data_ptr(), *crease[1:], stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule kernel ({route} route) launch failed: "
                           f"error {rc}")
    launches += 1
    route_launches[route] += 1
    if generated:
        generated_launches[route] += 1
    if not with_split_frac:
        return est, err, sdim
    frac_route_launches[route] += 1
    return est, err, sdim, crease[0]


def _configure_values(lib):
    fn = lib.gen_values_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int


def generated_values(integrand, x):
    """A traced callable's values at the points ``x`` (ndim, N), planes of
    coordinates: on CUDA tensors one launch of ``gen_values_kernel``
    (csrc/gen_values.cu: the emitted ``gen_integrand`` alone, a check-only
    library built at this first use), counted
    in ``generated_value_launches``; on CPU tensors its plain version,
    ``integrand_gen.evaluate``.  The check that the emitted header rounds
    as the callable's own PyTorch calls do; no path launches it."""
    global generated_value_launches
    if not is_generated(integrand):
        raise ValueError("generated_values takes a traced callable "
                         "(integrand_gen.traced)")
    ndim = integrand.ndim
    if x.dim() != 2 or x.shape[0] != ndim or x.shape[1] < 1:
        raise ValueError(f"points: need ({ndim}, N >= 1) coordinate "
                         f"planes, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return integrand_gen.evaluate(integrand.program, x.unbind(0))
    if x.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype {x.dtype} (float64 or float32)")
    x = x.contiguous()
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    lib = cuda_build.load_generated(integrand_gen.header(integrand.program),
                                    _configure_values,
                                    cuda_build.GEN_VALUES_SOURCE)
    rc = lib.gen_values_launch(
        int(x.dtype == torch.float64), x.shape[1], x.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA generated values kernel launch failed: "
                           f"error {rc}")
    generated_value_launches += 1
    return out


def _fused_frac_args(ndim, cap, lows, with_split_frac, kept):
    """(frac, then the launch's frac, stencil and kept pointers) of a fused
    launch: a new (cap,) fraction and the stencil's host arrays with
    ``with_split_frac``, else (None, four null pointers).  ValueError for a
    ``kept`` without the fraction or of another shape, type or device than
    a contiguous (cap, 4 ndim + 1) of the pool's."""
    if not with_split_frac:
        if kept is not None:
            raise ValueError("kept holds the fraction's input: it needs "
                             "with_split_frac")
        return (None,) + (None,) * 4
    shape = (cap, 4 * ndim + 1)
    if kept is not None and (tuple(kept.shape) != shape
                             or kept.dtype != lows.dtype
                             or kept.device != lows.device
                             or not kept.is_contiguous()):
        raise ValueError(f"kept: need a contiguous {lows.dtype} tensor of "
                         f"shape {shape} on {lows.device}, got {kept.dtype} "
                         f"{tuple(kept.shape)} on {kept.device}")
    frac = torch.empty(cap, dtype=lows.dtype, device=lows.device)
    slots, consts = _frac_tables(ndim, lows.dtype)
    return (frac, frac.data_ptr(), slots.ctypes.data_as(ctypes.c_void_p),
            consts.ctypes.data_as(ctypes.c_void_p),
            None if kept is None else kept.data_ptr())


def _check_ndim(what: str, ndim: int, max_ndim: int):
    """ValueError for a dimension that ``what`` does not take: below 2, or
    past ``max_ndim`` (``past_16d``, naming rule_backend='torch')."""
    if ndim < 2:
        raise ValueError(f"{what} takes ndim 2..{max_ndim}, not {ndim}")
    if ndim > max_ndim:
        raise ValueError(past_16d(what, ndim, max_ndim))


def _check_pool(what: str, tables: rule_eval.RuleTables, lows, lengths,
                global_lo, global_range, n, blocked) -> tuple[int, int]:
    """(cap, n) of a pool that the kernels take; ValueError for one they do
    not: another device than CUDA, another type than f64/f32, a shape,
    device or type that differs, a non-contiguous tensor, or an ``n`` that
    the layout cannot hold.  The callers check the dimension first
    (``_check_ndim``)."""
    ndim = tables.ndim
    if lows.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {lows.device}")
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
    return cap, n


# ---------------------------------------------------------------------------
# The split route: any integrand

def split_chunk_size(ndim: int, dtype: torch.dtype,
                     chunk_size: int | None) -> int | None:
    """Regions a chunk of the split route: ``chunk_size`` (None: every real
    region in one) up to MAX_NDIM; past it no more than the regions whose
    points, (feval, ndim) values of ``dtype`` each, fit SPLIT_CHUNK_BYTES,
    and at least one.  A region's outputs do not depend on its chunk."""
    if ndim <= MAX_NDIM:
        return chunk_size
    item = torch.finfo(dtype).bits // 8
    fit = max(1, SPLIT_CHUNK_BYTES
              // (genz_malik.feval_per_region(ndim) * ndim * item))
    return fit if chunk_size is None else max(1, min(fit, int(chunk_size)))


def split_chunks(n: int, chunk_size: int | None) -> list[tuple[int, int]]:
    """[(first real region, regions)] of every chunk the split route walks
    over ``n`` real regions: ``chunk_size`` at a time (all of them when
    None), in the order of ``rule_eval.apply_rule_plain``'s chunks.  Real
    region r lies in pool slot ``split_slots``' r."""
    step = n if chunk_size is None else max(int(chunk_size), 1)
    return [(first, min(step, n - first)) for first in range(0, n, step)]


def split_slots(cap: int, n: int, blocked: bool, first: int,
                count: int) -> np.ndarray:
    """Pool slots of real regions first .. first + count - 1, as the split
    kernels compute them: [0, n) in the plain layout; in the blocked one
    the first n/2 slots of each half of the pool (region_pool.block_mask),
    the first half's before the second's."""
    r = np.arange(first, first + count, dtype=np.int64)
    if not blocked:
        return r
    return np.where(r >= n // 2, cap // 2 + r - n // 2, r)


@functools.lru_cache(maxsize=256)
def points_strides(count: int, feval: int, ndim: int) -> tuple:
    """The strides of ``rule_eval.rule_points``' (count, feval, ndim)
    tensor, which the points kernel writes: PyTorch's layout of that
    broadcast expression, read from the same expression on meta tensors
    (for count >= 2 coordinate planes with the region fastest, (1, count,
    count * feval); for one region points-major)."""
    c = torch.empty((ndim, count), device="meta")
    g = torch.empty((feval, ndim), device="meta")
    return (c.T[:, None, :] - g[None, :, :] * c.T[:, None, :]).stride()


def _points_launch(lib, tables, lows, lengths, global_lo, global_range,
                   cap, n, blocked, first, count):
    strides = points_strides(count, tables.feval, tables.ndim)
    x = torch.empty_strided((count, tables.feval, tables.ndim), strides,
                            dtype=lows.dtype, device=lows.device)
    if tables.ndim > MAX_NDIM:
        codes, lam = _wide_tables(tables.ndim, lows.dtype, lows.device)[:2]
        launch, gen = lib.rule_split_points_wide_launch, (codes.data_ptr(),
                                                          lam.data_ptr())
    else:
        launch = lib.rule_split_points_launch
        gen = (rule_eval.device_tables(tables.ndim, lows.dtype,
                                       lows.device)[0].data_ptr(),)
    rc = launch(
        int(lows.dtype == torch.float64), tables.ndim, tables.feval, cap, n,
        int(bool(blocked)), first, count, *strides, lows.data_ptr(),
        lengths.data_ptr(), global_lo.data_ptr(), global_range.data_ptr(),
        *gen, x.data_ptr(),
        torch.cuda.current_stream(lows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule points kernel launch failed: error "
                           f"{rc}")
    split_launches["points"] += 1
    return x


def cluster_plan(dtype: torch.dtype, ndim: int, count: int,
                 feval: int) -> tuple[int, int, int, int]:
    """(cluster size K, points per stage, stages, stages of a CTA's ring) of
    the cluster route for ``count`` regions of ``feval`` values of type
    ``dtype``: a cluster of K CTAs for each group of CLUSTER_GROUP regions,
    K the least that brings the launch to CLUSTER_CTAS CTAs, at most
    MAX_CLUSTER and at most the stages, so that every rank has one.  The
    stages cut the points past the head's 4 ndim + 1 (orbits 0-2, which the
    leader holds apart) into CLUSTER_STAGE_BYTES of 32 regions.  The shape
    alone decides."""
    item = torch.finfo(dtype).bits // 8
    points = CLUSTER_STAGE_BYTES // (CLUSTER_GROUP * item)
    stages = -(-(feval - (4 * ndim + 1)) // points)
    groups = -(-count // CLUSTER_GROUP)
    k = max(1, min(MAX_CLUSTER, -(-CLUSTER_CTAS // groups), stages))
    return k, points, stages, CLUSTER_RING


def cluster_partition(dtype: torch.dtype, ndim: int, count: int,
                      feval: int) -> list[tuple[int, int, int, np.ndarray]]:
    """[(cluster rank, stage, consumer warp, points)] of one group of
    regions as the cluster kernel sums them, in its order: the leader's
    head rows 0 .. 4 ndim (stage -1), then each rank's stages, rank r the
    stages r T / K .. (r + 1) T / K - 1 (``cluster_plan``); warp w takes
    rows w, w + CLUSTER_WARPS, ... of a stage.  A warp adds its points in
    the order listed, a running sum per orbit; the warps' sums are added
    in warp order, the ranks' in rank order."""
    k, rows, stages, _ = cluster_plan(dtype, ndim, count, feval)
    head = 4 * ndim + 1
    out = [(0, -1, w, np.arange(w, head, CLUSTER_WARPS))
           for w in range(CLUSTER_WARPS)]
    for r in range(k):
        for t in range(r * stages // k, (r + 1) * stages // k):
            r0 = head + t * rows
            n_rows = min(rows, feval - r0)
            out += [(r, t, w, r0 + np.arange(w, n_rows, CLUSTER_WARPS))
                    for w in range(CLUSTER_WARPS)]
    return out


def contract_route(dtype: torch.dtype, ndim: int, count: int, feval: int,
                   strides: tuple, ncomp: int = 1) -> str:
    """The contraction's route for values (count, feval) of ``dtype`` at
    ``strides`` (elements), or a vector integrand's (count, feval, ncomp)
    at three strides: for a vector 'components_cluster' where
    ``comp_cluster_takes`` (component-minor, at most MAX_COMP_CLUSTER
    components, the shared memory within a CTA's), else 'components'; for
    a scalar 'cluster' where a region's points lie
    contiguous (rows, sp = 1: what a callable that reduces over the axes
    returns), or a point's regions do (planes, sc = 1: what a per-axis
    callable returns) and a region has CLUSTER_PLANES_FEVAL points or more;
    else 'generic'.  Any count and any address: the bulk copies move whole
    16-byte units around each contiguous segment.  Decided from the shape,
    never by trying a launch; named, the cluster routes take any values
    that ``cluster_takes`` or ``comp_cluster_takes``."""
    if len(strides) == 3:
        if ncomp < 2:
            raise ValueError(f"a vector's values (strides {strides}) need "
                             f"their ncomp > 1, got {ncomp}")
        return (COMPONENTS_CLUSTER if comp_cluster_takes(
            dtype, ndim, count, feval, strides, ncomp) else COMPONENTS)
    if cluster_takes(dtype, ndim, count, feval, strides) and (
            strides[1] == 1 or feval >= CLUSTER_PLANES_FEVAL):
        return "cluster"
    return "generic"


def cluster_takes(dtype: torch.dtype, ndim: int, count: int, feval: int,
                  strides: tuple) -> bool:
    """Whether the cluster route can take values (count, feval) at
    ``strides``: as rows or as planes, on a grid of fewer than 2^31 CTAs."""
    sc, sp = strides
    k = cluster_plan(dtype, ndim, count, feval)[0]
    return (sp == 1 or sc == 1) and -(-count // CLUSTER_GROUP) * k < 2 ** 31


def comp_cluster_plan(dtype: torch.dtype, ndim: int, count: int, feval: int,
                      ncomp: int) -> tuple[int, int, int, int]:
    """(cluster size K, rows, points per stage, stages of a CTA's ring) of
    the components cluster route for ``count`` regions of ``feval`` points
    of ``ncomp`` components: K and the ranks' point ranges are the scalar
    cluster route's (``cluster_plan``: rank r the points of its stages r T
    / K .. (r + 1) T / K - 1 of ``rows`` points past the head), each range
    cut into stages of ``points`` points, about COMP_STAGE_BYTES for 32
    regions and a multiple of CLUSTER_WARPS, so that warp w sums the points
    of the scalar route's warp w.  The shape alone decides."""
    k, rows, _, _ = cluster_plan(dtype, ndim, count, feval)
    item = torch.finfo(dtype).bits // 8
    points = COMP_STAGE_BYTES // (CLUSTER_GROUP * item * ncomp)
    points = max(CLUSTER_WARPS, points // CLUSTER_WARPS * CLUSTER_WARPS)
    return k, rows, points, COMP_RING


def _seg_pitch(item: int, n: int) -> int:
    """csrc/rule_split.cu's seg_pitch of a row segment of ``n`` values:
    room for its copy in whole 16-byte units from any address."""
    slack = 16 // item
    return (n + 2 * slack - 1) // slack * slack


def fd_rows(ndim: int) -> int:
    """The contractions' fourth-difference rows for a pool of ``ndim``:
    MAX_NDIM in the instances up to it, WIDE_MAX_NDIM in the wide ones."""
    return MAX_NDIM if ndim <= MAX_NDIM else WIDE_MAX_NDIM


def comp_cluster_smem(dtype: torch.dtype, ndim: int, ncomp: int,
                      points: int, ring: int) -> int:
    """Bytes of a components cluster CTA's dynamic shared memory, as
    csrc/rule_split.cu's CompClusterSmem counts them: the ring of ``ring``
    tiles of 32 segments of ``points`` x ncomp values, or the leader's head
    tile (points 0..4n) and one tile beside it where that is larger and two
    CTAs still share an SM (PAIR_SMEM), else the head tile over the ring's
    slots where it is larger; the CTA's orbit sums [9][ncomp][32], the
    fourth differences [``fd_rows``][32] and the warps' mailbox
    [8][ncomp][32]."""
    item = torch.finfo(dtype).bits // 8
    tile = 32 * _seg_pitch(item, points * ncomp)
    head = 32 * _seg_pitch(item, (4 * ndim + 1) * ncomp)
    other = (9 + CLUSTER_WARPS) * ncomp * 32 + fd_rows(ndim) * 32
    area = max(ring * tile, head + tile)
    if (area + other) * item > PAIR_SMEM:
        area = max(ring * tile, head)
    return (area + other) * item


def comp_cluster_takes(dtype: torch.dtype, ndim: int, count: int, feval: int,
                       strides: tuple, ncomp: int) -> bool:
    """Whether the components cluster route can take a vector's values
    (count, feval, ncomp) at ``strides``: component-minor (sk = 1, sp =
    ncomp), 2..MAX_COMP_CLUSTER components, a CTA's shared memory within
    MAX_SMEM, a grid of fewer than 2^31 CTAs.  Component-major values
    (strides (feval, 1, C feval)) would be ncomp segments a region and
    stage, each a quarter of the 1 KB copies at 4 components, or stages
    four times the ring's: they keep 'components'."""
    sc, sp, sk = strides
    k, _, points, ring = comp_cluster_plan(dtype, ndim, count, feval, ncomp)
    return (2 <= ncomp <= MAX_COMP_CLUSTER and sk == 1 and sp == ncomp
            and comp_cluster_smem(dtype, ndim, ncomp, points, ring)
            <= MAX_SMEM and -(-count // CLUSTER_GROUP) * k < 2 ** 31)


def comp_cluster_partition(dtype: torch.dtype, ndim: int, count: int,
                           feval: int, ncomp: int
                           ) -> list[tuple[int, int, int, np.ndarray]]:
    """[(cluster rank, stage, consumer warp, points)] of one group of
    regions as the components cluster kernel sums them, in its order: the
    leader's head tile, points 0 .. 4 ndim (stage -1), then each rank's
    stages of ``comp_cluster_plan``'s points over its point range; warp w
    takes rows w, w + CLUSTER_WARPS, ... of a stage.  Each component is
    summed in that order, a running sum per orbit a warp, the warps' sums
    added in warp order, the ranks' in rank order: the points of each
    (rank, warp) and their order are ``cluster_partition``'s."""
    k, rows, points, _ = comp_cluster_plan(dtype, ndim, count, feval, ncomp)
    head = 4 * ndim + 1
    total = -(-(feval - head) // rows)
    out = [(0, -1, w, np.arange(w, head, CLUSTER_WARPS))
           for w in range(CLUSTER_WARPS)]
    for r in range(k):
        lo = head + r * total // k * rows
        hi = min(feval, head + (r + 1) * total // k * rows)
        for t, p0 in enumerate(range(lo, hi, points)):
            n_rows = min(points, hi - p0)
            out += [(r, t, w, p0 + np.arange(w, n_rows, CLUSTER_WARPS))
                    for w in range(CLUSTER_WARPS)]
    return out


def cluster_occupancy(dtype: torch.dtype, rows: bool, ndim: int, count: int,
                      feval: int) -> int:
    """How many clusters of the cluster route's launch for this shape
    (``cluster_plan``; values as rows or as planes) the card holds at once
    (cudaOccupancyMaxActiveClusters); RuntimeError if the query fails."""
    lib = cuda_build.load(_SPLIT_SOURCE, _configure_split)
    k, points, _, ring = cluster_plan(dtype, ndim, count, feval)
    got = lib.rule_split_cluster_occupancy(int(dtype == torch.float64),
                                           int(rows), ndim, k, points, ring)
    if got < 0:
        raise RuntimeError(f"cluster occupancy query failed: error {-got}")
    return got


def comp_cluster_occupancy(dtype: torch.dtype, ndim: int, count: int,
                           feval: int, ncomp: int) -> int:
    """How many clusters of the components cluster route's launch for this
    shape (``comp_cluster_plan``) the card holds at once; RuntimeError if
    the query fails."""
    lib = cuda_build.load(_SPLIT_SOURCE, _configure_split)
    k, _, points, ring = comp_cluster_plan(dtype, ndim, count, feval, ncomp)
    got = lib.rule_split_comp_cluster_occupancy(
        int(dtype == torch.float64), ndim, ncomp, k, points, ring)
    if got < 0:
        raise RuntimeError(f"cluster occupancy query failed: error {-got}")
    return got


def _weight_tables(ndim: int, dtype: torch.dtype, device: torch.device):
    """(orbit_wts, scale, norm) on the device for the contractions; past
    MAX_NDIM as the wide route takes them, without the (feval, ndim)
    generator table."""
    if ndim > MAX_NDIM:
        return _wide_tables(ndim, dtype, device)[2:]
    return rule_eval.device_tables(ndim, dtype, device)[1:]


def _contract_launch(lib, tables, vals, lengths, global_range, cap, n,
                     blocked, first, count, est, err, sdim, frac=None,
                     route=None):
    dtype = vals.dtype
    shape = (dtype, tables.ndim, count, tables.feval)
    chosen = contract_route(*shape, vals.stride())
    if route is None:
        route = chosen
    elif route not in CONTRACT_ROUTES or (
            route == "cluster" and not cluster_takes(*shape, vals.stride())):
        raise ValueError(f"contraction route {route!r} does not take values "
                         f"of strides {vals.stride()} ({count} regions, "
                         f"{dtype})")
    cluster, points, _, ring = (cluster_plan(*shape) if route == "cluster"
                                else (0, 0, 0, 0))
    orbit_wts, scale, norm = _weight_tables(tables.ndim, dtype, vals.device)
    ob = (ctypes.c_int * 10)(*tables.orbit_bounds)
    stencil = (None, None)
    if frac is not None:
        slots, consts = _frac_tables(tables.ndim, dtype)
        stencil = (slots.ctypes.data_as(ctypes.c_void_p),
                   consts.ctypes.data_as(ctypes.c_void_p))
    rc = lib.rule_split_contract_launch(
        int(dtype == torch.float64), tables.ndim, tables.feval, cap, n,
        int(bool(blocked)), first, count, *vals.stride(), cluster, points,
        ring, vals.data_ptr(), lengths.data_ptr(), global_range.data_ptr(),
        orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
        float(tables.ratio), ctypes.cast(ob, ctypes.c_void_p), est.data_ptr(),
        err.data_ptr(), sdim.data_ptr(),
        None if frac is None else frac.data_ptr(), *stencil,
        torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule contraction kernel ({route} route) "
                           f"launch failed: error {rc}")
    split_launches["contract"] += 1
    contract_route_launches[route] += 1
    if frac is not None:
        frac_route_launches[CONTRACT_FRAC_ROUTE[route]] += 1


def _contract_comp_launch(lib, tables, vals, lengths, global_range, cap, n,
                          blocked, first, count, est, err, sdim, route=None):
    dtype, ncomp = vals.dtype, vals.shape[2]
    shape = (dtype, tables.ndim, count, tables.feval)
    if route is None:
        route = contract_route(*shape, vals.stride(), ncomp)
    elif route not in VECTOR_ROUTES or (
            route == COMPONENTS_CLUSTER
            and not comp_cluster_takes(*shape, vals.stride(), ncomp)):
        raise ValueError(f"contraction route {route!r} does not take a "
                         f"vector's values of strides {vals.stride()} "
                         f"({count} regions, {ncomp} components, {dtype})")
    plan = (comp_cluster_plan(*shape, ncomp) if route == COMPONENTS_CLUSTER
            else (0, 0, 0, 0))
    orbit_wts, scale, norm = _weight_tables(tables.ndim, dtype, vals.device)
    ob = (ctypes.c_int * 10)(*tables.orbit_bounds)
    rc = lib.rule_split_contract_comp_launch(
        int(dtype == torch.float64), tables.ndim, tables.feval, cap, n,
        int(bool(blocked)), first, count, ncomp, *vals.stride(), *plan,
        vals.data_ptr(), lengths.data_ptr(), global_range.data_ptr(),
        orbit_wts.data_ptr(), scale.data_ptr(), norm.data_ptr(),
        float(tables.ratio), ctypes.cast(ob, ctypes.c_void_p), est.data_ptr(),
        err.data_ptr(), sdim.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA rule contraction kernel ({route} route) "
                           f"launch failed: error {rc}")
    split_launches["contract"] += 1
    contract_route_launches[route] += 1


def _check_chunk(cap, n, first, count):
    if not (0 <= first and 1 <= count and first + count <= n <= cap):
        raise ValueError(f"regions {first}..{first + count - 1} of {n} real "
                         f"in a pool of {cap}")


def split_points(tables: rule_eval.RuleTables, lows, lengths, global_lo,
                 global_range, first: int, count: int, *,
                 n: int | None = None, blocked: bool = False):
    """One launch of the points kernel: the rule points (count, feval,
    ndim) of real regions first .. first + count - 1 of a CUDA pool, EQUAL
    to ``rule_eval.rule_points`` of the same regions.  Past MAX_NDIM the
    wide points kernel (``rule_points_wide_kernel``), from the orbit
    table."""
    _check_ndim("split_points", tables.ndim, WIDE_MAX_NDIM)
    cap, n = _check_pool("split_points", tables, lows, lengths, global_lo,
                         global_range, n, blocked)
    _check_chunk(cap, n, first, count)
    return _points_launch(cuda_build.load(_SPLIT_SOURCE, _configure_split),
                          tables, lows, lengths, global_lo, global_range,
                          cap, n, blocked, first, count)


def split_contract(vals, tables: rule_eval.RuleTables, lows, lengths,
                   global_lo, global_range, first: int, *,
                   n: int | None = None, blocked: bool = False, out=None,
                   route: str | None = None, with_split_frac: bool = False):
    """One launch of the contraction kernel: est, err and split_dim of real
    regions first .. first + C - 1 from their rule values ``vals`` (C,
    feval), written at their slots of ``out`` = (est, err, split_dim), each
    (cap,) (new zeroed tensors when None), which it returns.  What
    ``rule_eval.rule_outputs`` computes; with ``with_split_frac`` also the
    cut fraction, ``out`` then (est, err, split_dim, frac) (new: frac 0.5),
    split_dim the axis a jump overrides.  ``route`` None takes
    ``contract_route``'s; naming one runs it (the checks and timings hold
    the two against each other) and raises ValueError where the values'
    layout does not take it.  Past MAX_NDIM the contraction's wide
    instances, which compute no cut fraction: ``with_split_frac`` raises
    there."""
    _refuse_frac_past_16d(tables.ndim, with_split_frac)
    _check_ndim("split_contract", tables.ndim, WIDE_MAX_NDIM)
    cap, n = _check_pool("split_contract", tables, lows, lengths, global_lo,
                         global_range, n, blocked)
    count = vals.shape[0] if vals.dim() == 2 else 0
    _check_chunk(cap, n, first, count)
    _check_vals(vals, count, tables, lows)
    if out is None:
        out = _zero_outputs(cap, lows) + ((torch.full(
            (cap,), 0.5, dtype=lows.dtype, device=lows.device),)
            if with_split_frac else ())
    if len(out) != 3 + with_split_frac:
        raise ValueError(f"out: need {3 + with_split_frac} tensors "
                         f"(with_split_frac={with_split_frac}), got "
                         f"{len(out)}")
    _contract_launch(cuda_build.load(_SPLIT_SOURCE, _configure_split), tables,
                     vals, lengths, global_range, cap, n, blocked, first,
                     count, *out, route=route)
    return out


def _refuse_frac_past_16d(ndim: int, with_split_frac: bool):
    if with_split_frac and ndim > MAX_NDIM:
        raise ValueError(past_16d("crease_split", ndim))


def _check_vals(vals, count, tables, lows, ncomp: int = 1):
    """The values the contraction takes, at any strides (it only reads
    them): (count, feval), or (count, feval, ncomp) for a vector integrand
    (``ncomp`` > 1), of the pool's type and device."""
    shape = (count, tables.feval) + ((ncomp,) if ncomp > 1 else ())
    if (tuple(vals.shape) != shape or vals.dtype != lows.dtype
            or vals.device != lows.device):
        raise ValueError(
            f"integrand values: need a {lows.dtype} tensor of shape "
            f"{shape} on {lows.device}, got {vals.dtype} "
            f"{tuple(vals.shape)} on {vals.device}")


def _zero_outputs(cap, lows, ncomp: int = 1):
    """Zeroed (est, err, split_dim): (cap,) each, or est and err (ncomp,
    cap) for a vector integrand (``ncomp`` > 1)."""
    eshape = (ncomp, cap) if ncomp > 1 else (cap,)
    return (torch.zeros(eshape, dtype=lows.dtype, device=lows.device),
            torch.zeros(eshape, dtype=lows.dtype, device=lows.device),
            torch.zeros(cap, dtype=torch.int32, device=lows.device))


def split_contract_components(vals, tables: rule_eval.RuleTables, lows,
                              lengths, global_lo, global_range, first: int, *,
                              n: int | None = None, blocked: bool = False,
                              out=None, route: str | None = None):
    """One launch of a vector's contraction: est and err (ncomp, cap) and
    split_dim (cap,) of real regions first .. first + C - 1 from a vector
    integrand's values ``vals`` (C, feval, ncomp > 1), written at their
    slots of ``out`` (new zeroed tensors when None), which it returns.
    What ``rule_eval.rule_outputs_vector`` computes.  ``route`` None takes
    ``contract_route``'s; named, 'components' takes any strides (component
    k bit for bit ``split_contract(vals[..., k], route='generic')``),
    'components_cluster' what ``comp_cluster_takes`` (component k bit for
    bit ``split_contract(vals[..., k].contiguous(), route='cluster')``) and
    raises ValueError for other values."""
    _check_ndim("split_contract_components", tables.ndim, WIDE_MAX_NDIM)
    cap, n = _check_pool("split_contract_components", tables, lows, lengths,
                         global_lo, global_range, n, blocked)
    count, ncomp = vals.shape[::2] if vals.dim() == 3 else (0, 0)
    _check_chunk(cap, n, first, count)
    if ncomp < 2:
        raise ValueError(f"integrand values: need a vector's (count, "
                         f"{tables.feval}, ncomp > 1), got "
                         f"{tuple(vals.shape)}")
    _check_vals(vals, count, tables, lows, ncomp)
    if out is None:
        out = _zero_outputs(cap, lows, ncomp)
    _contract_comp_launch(cuda_build.load(_SPLIT_SOURCE, _configure_split),
                          tables, vals, lengths, global_range, cap, n,
                          blocked, first, count, *out, route=route)
    return out


@functools.lru_cache(maxsize=None)
def _frac_tables(ndim: int, dtype: torch.dtype):
    """The split fraction's host constants as the launch takes them:
    (slots (ndim, 4) int32, consts (ndim, 5) float64 holding values of the
    working type), C-contiguous (``rule_eval.split_stencil``)."""
    slots, consts = rule_eval.split_stencil(ndim, rule_eval.dtype_name(dtype))
    if dtype == torch.float32:
        consts = consts.astype(np.float32).astype(np.float64)
    return np.ascontiguousarray(slots), np.ascontiguousarray(consts)


def _frac_launch(lib, tables, vals, cap, n, blocked, first, count, sdim,
                 frac):
    global split_frac_launches
    slots, consts = _frac_tables(tables.ndim, vals.dtype)
    rc = lib.rule_split_frac_launch(
        int(vals.dtype == torch.float64), tables.ndim, cap, n,
        int(bool(blocked)), first, count, *vals.stride(),
        slots.ctypes.data_as(ctypes.c_void_p),
        consts.ctypes.data_as(ctypes.c_void_p), vals.data_ptr(),
        sdim.data_ptr(), frac.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA split fraction kernel launch failed: "
                           f"error {rc}")
    split_frac_launches += 1


def split_frac(vals, split_dim, ndim: int):
    """The crease/jump-aware cut fraction of C regions from their rule
    values ``vals`` (C, feval), at any strides, and their split axis (C,)
    int32: (frac (C,) of the values' type, split_dim (C,) int32).  On CUDA
    tensors one launch of the standalone ``rule_split_frac_kernel``
    (csrc/split_frac.cu), EQUAL to ``rule_eval.split_fraction``, which runs
    on CPU tensors.  No crease run launches it (the kernels that hold the
    values compute the fraction); the checks hold those against it."""
    if vals.device.type == "cpu":
        return rule_eval.split_fraction(vals, split_dim, ndim)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(vals.dtype))
    count = vals.shape[0] if vals.dim() == 2 else 0
    if count < 1:
        raise ValueError(f"values: need (C >= 1, {tables.feval}), got "
                         f"{tuple(vals.shape)}")
    _check_vals(vals, count, tables, vals)
    if tuple(split_dim.shape) != (count,) or split_dim.device != vals.device:
        raise ValueError(f"split_dim: need ({count},) on {vals.device}")
    sdim = split_dim.to(torch.int32).contiguous().clone()
    frac = torch.empty(count, dtype=vals.dtype, device=vals.device)
    _frac_launch(cuda_build.load(_FRAC_SOURCE, _configure_frac), tables,
                 vals, count, count, False, 0, count, sdim, frac)
    return frac, sdim


def cuda_apply_rule_split(integrand, tables: rule_eval.RuleTables, lows,
                          lengths, global_lo, global_range, *,
                          chunk_size: int | None = None,
                          n: int | None = None, blocked: bool = False,
                          route: str | None = None, ncomp: int = 1,
                          with_split_frac: bool = False):
    """The split route over the ``n`` real regions of a CUDA pool (all of
    it when ``n`` is None), ``chunk_size`` regions at a time, past MAX_NDIM
    fewer (``split_chunk_size``, ``split_chunks``): the points kernel,
    ``integrand`` (any form ``make_integrand`` takes) on the (C, feval,
    ndim) points, its values cast to the pool's type (no copy where they
    have it), the contraction kernel; ndim 2..WIDE_MAX_NDIM.  Arguments and
    outputs as ``rule_eval.apply_rule_plain``: (estimate, errorest,
    split_dim (cap,) int32), zeros in the padding slots; estimate and
    errorest (cap,), or (ncomp, cap) for a vector integrand (``ncomp`` >
    1), whose values (C, feval, ncomp) take a vector's contraction.
    ``route`` names the contraction's route for every chunk, as
    ``split_contract``'s and ``split_contract_components``' do (None:
    ``contract_route``'s for each).  ``with_split_frac`` (a scalar
    integrand): each chunk's contraction also computes the cut fraction
    from the values it reads, and a fourth output, the cut fraction (cap,),
    0.5 in the padding slots, split_dim the axis a jump overrides; past
    MAX_NDIM it raises ValueError, as a traced callable does there."""
    _refuse_frac_past_16d(tables.ndim, with_split_frac)
    _check_ndim("cuda_apply_rule_split", tables.ndim, WIDE_MAX_NDIM)
    cap, n = _check_pool("cuda_apply_rule_split", tables, lows, lengths,
                         global_lo, global_range, n, blocked)
    if ncomp > 1 and route not in (None,) + VECTOR_ROUTES:
        raise ValueError(f"a vector integrand's values take the "
                         f"{COMPONENTS_CLUSTER!r} or {COMPONENTS!r} "
                         f"contraction, not {route!r}")
    if with_split_frac and ncomp > 1:
        raise ValueError("with_split_frac is scalar-only")
    batched, _ = make_integrand(integrand, tables.ndim)
    lib = cuda_build.load(_SPLIT_SOURCE, _configure_split)
    out = _zero_outputs(cap, lows, ncomp)
    if with_split_frac:
        out += (torch.full((cap,), 0.5, dtype=lows.dtype,
                           device=lows.device),)
    for first, count in split_chunks(
            n, split_chunk_size(tables.ndim, lows.dtype, chunk_size)):
        x = _points_launch(lib, tables, lows, lengths, global_lo,
                           global_range, cap, n, blocked, first, count)
        vals = batched(x).to(lows.dtype)
        del x
        _check_vals(vals, count, tables, lows, ncomp)
        if ncomp > 1:
            _contract_comp_launch(lib, tables, vals, lengths, global_range,
                                  cap, n, blocked, first, count, *out,
                                  route=route)
        else:
            _contract_launch(lib, tables, vals, lengths, global_range,
                             cap, n, blocked, first, count, *out,
                             route=route)
    return out
