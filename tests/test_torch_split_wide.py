"""The split route past 16D (any callable, a vector, at 17-24D: the wide
points kernel and the contractions' wide instances of csrc/rule_split.cu)
on the CPU, where the plain version runs:

* 17D PAGANI runs of a callable (Genz F4 wrapped in a lambda, so that no
  fused kernel knows it) and of a vector against the JAX package's host
  loop: the same decisions, the estimates to roundoff;
* the wide points kernel's decode and its walk over the elements,
  mirrored in NumPy: the rule's points bitwise, in ``rule_points``'
  layout;
* the chunk plan past 16D (``split_chunk_size``), and the contractions'
  plans, partitions and shared memory at 17-24D.

The card's tests are tests/test_torch_cuda_split_wide.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.models import misc as jax_misc
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_rule, genz_malik, rule_eval

ND = 17


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def test_17d_callable_run_matches_reference():
    """Genz F4 (a = 1) as a plain lambda at 17D, 1e-3, three iterations of
    the host loop in both packages: the same status, iterations, regions
    and neval; the estimate and errorest to roundoff."""
    g, jg = genz.f4_gaussian(ND, a=1.0), jax_genz.f4_gaussian(ND, a=1.0)
    kw = dict(epsrel=1e-3, max_iterations=3, fused=False)
    ref = JaxWorkspace(ND, chunk_size=64).integrate(lambda x: jg(x), **kw)
    got = Workspace(ND, chunk_size=64, device="cpu").integrate(
        lambda x: g(x), **kw)
    assert (got.status, got.iters, got.nregions, got.neval) == (
        ref.status, ref.iters, ref.nregions, ref.neval)
    assert math.isclose(got.estimate, ref.estimate, rel_tol=1e-12)
    assert math.isclose(got.errorest, ref.errorest, rel_tol=1e-10)


def test_17d_vector_run_matches_reference():
    """[F4 (a = 1) wrapped, sin_sum] at 17D, two iterations of the vector
    host loop in both packages: the same decisions, each component's
    estimate and errorest to roundoff (as the scalar run's)."""
    g, s = genz.f4_gaussian(ND, a=1.0), misc.sin_sum(ND)
    jg, js = jax_genz.f4_gaussian(ND, a=1.0), jax_misc.sin_sum(ND)

    def fvec(x):
        return torch.stack([g(x), s(x)], dim=-1)

    def fvec_jax(x):
        return jnp.stack([jg(x), js(x)], axis=-1)

    fvec.ndim = fvec_jax.ndim = ND
    kw = dict(epsrel=1e-3, max_iterations=2, fused=False)
    ref = JaxWorkspace(ND, chunk_size=64).integrate(fvec_jax, **kw)
    got = Workspace(ND, chunk_size=64, device="cpu").integrate(fvec, **kw)
    assert (got.status, got.iters, got.nregions, got.nFinishedRegions,
            got.neval) == (ref.status, ref.iters, ref.nregions,
                           ref.nFinishedRegions, ref.neval)
    # as the scalar 17D run: 138,281 values a region summed in other orders
    assert np.allclose(got.estimates, ref.estimates, rtol=1e-12, atol=0.0)
    assert np.allclose(got.errorests, ref.errorests, rtol=1e-10, atol=0.0)


def _codes_like_kernel(ndim: int, p: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The generator code of rule point p on axis d (arrays of one shape) as
    rule_points_wide_kernel decodes it: p < k8 from its word of the orbit
    table, the OR of the codes of the pairs naming axis d (0 where none
    does); corner k = p - k8 code 10 where bit ndim-1-d of k is set, else
    5."""
    k8 = cuda_rule.generic_orbit_bounds(ndim)[4]
    words = cuda_rule.wide_orbit_codes(ndim)
    code = np.zeros(p.shape, dtype=np.int64)
    orbit = p < k8
    w = words[p[orbit]].astype(np.int64)
    for i in range(3):
        pair = w >> (cuda_rule.WIDE_PAIR_BITS * i)
        code[orbit] |= np.where((pair & 31) == d[orbit], (pair >> 5) & 15, 0)
    corner = ((p[~orbit] - k8) >> (ndim - 1 - d[~orbit])) & 1
    code[~orbit] = np.where(corner == 1, 10, 5)
    return code


@pytest.mark.parametrize("ndim", [17, 20])
def test_wide_points_decode_gives_the_rule(ndim):
    """Every (point, axis) code as the kernel decodes it gives the rule's
    generator table bitwise (``generator_lam`` of the code), and the table
    of ``wide_point_codes`` too."""
    tables = rule_eval.rule_tables(ndim)
    feval = tables.feval
    p = np.repeat(np.arange(feval, dtype=np.int64), ndim)
    d = np.tile(np.arange(ndim, dtype=np.int64), feval)
    code = _codes_like_kernel(ndim, p, d).reshape(feval, ndim)
    lam = cuda_rule.generator_lam()
    assert np.array_equal(lam[code].view(np.uint64),
                          tables.gen[:feval].view(np.uint64))
    some = np.arange(0, feval, 997)
    assert np.array_equal(cuda_rule.wide_point_codes(ndim, some), code[some])


def _points_like_kernel(tables, lows, lengths, glo, grange, first, count,
                        n, blocked, dtype):
    """x (count, feval, ndim) as rule_points_wide_kernel writes it: its
    threads' element order (the planes' layout, sc = 1: region fastest,
    then point, a grid row an axis; else axis fastest, then point, then
    region), each element's region, point and axis from its index, the
    coordinate rounded as rule_points rounds it.  Returns the tensor and
    the addresses in the threads' order."""
    ndim, feval = tables.ndim, tables.feval
    strides = cuda_rule.points_strides(count, feval, ndim)
    cap = lows.shape[1]
    if strides[0] == 1:
        i = np.arange(count * feval, dtype=np.int64)
        p, c = np.divmod(i, count)
        c, p = np.tile(c, ndim), np.tile(p, ndim)
        d = np.repeat(np.arange(ndim, dtype=np.int64), count * feval)
    else:
        i = np.arange(count * feval * ndim, dtype=np.int64)
        q, d = np.divmod(i, ndim)
        c, p = np.divmod(q, feval)
    slot = cuda_rule.split_slots(cap, n, blocked, first, count)[c]
    lo, ln = lows[d, slot], lengths[d, slot]
    rg, gl = grange[d], glo[d]
    half = dtype.type(0.5)
    length = ln * rg
    cen = gl + (lo + half * ln) * rg
    g = cuda_rule.generator_lam().astype(dtype)[_codes_like_kernel(ndim, p,
                                                                   d)]
    addr = c * strides[0] + p * strides[1] + d * strides[2]
    flat = np.empty(count * feval * ndim, dtype=dtype)
    flat[addr] = cen - g * length
    x = torch.as_strided(torch.from_numpy(flat), (count, feval, ndim),
                         strides)
    return x, addr


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("count", [1, 3])
def test_wide_points_kernel_mirror_equals_rule_points(dtype, count):
    """The kernel's walk mirrored at 17D on a blocked pool: each element
    written once, a warp's stores contiguous (addresses ascending by one),
    and the points EQUAL to ``rule_eval.rule_points`` of the chunk's
    regions, in its layout."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(count)
    cap, n, first = 8, 6, 2
    lows = rng.uniform(0.0, 0.5, (ND, cap)).astype(dtype)
    lengths = rng.uniform(0.01, 0.5, (ND, cap)).astype(dtype)
    glo = rng.uniform(-1.0, 0.0, ND).astype(dtype)
    grange = rng.uniform(1.0, 2.0, ND).astype(dtype)
    tables = rule_eval.rule_tables(ND, dtype.name)
    x, addr = _points_like_kernel(tables, lows, lengths, glo, grange, first,
                                  count, n, True, dtype)
    assert np.array_equal(addr, np.arange(addr.size))
    slots = cuda_rule.split_slots(cap, n, True, first, count)
    t = [torch.from_numpy(a) for a in (lows, lengths, glo, grange)]
    want, _, _ = rule_eval.rule_points(tables, t[0][:, slots],
                                       t[1][:, slots], t[2], t[3])
    assert x.stride() == want.stride()
    assert np.array_equal(x.contiguous().numpy().view(np.uint8),
                          want.contiguous().numpy().view(np.uint8))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_chunk_plan(dtype):
    """Past 16D a chunk holds the regions whose points fit
    SPLIT_CHUNK_BYTES, at least one and at most the chunk asked for (17D
    f64: 228, 20D: 25, 24D: 1); up to 16D the chunk asked for, as
    before."""
    item = torch.finfo(dtype).bits // 8
    for ndim in (8, 12, 16):
        for chunk in (None, 1, 1024, 4096):
            assert cuda_rule.split_chunk_size(ndim, dtype, chunk) == chunk
        assert cuda_rule.split_chunks(5000, cuda_rule.split_chunk_size(
            ndim, dtype, 1024)) == [(0, 1024), (1024, 1024), (2048, 1024),
                                    (3072, 1024), (4096, 904)]
    for ndim in range(17, 25):
        per = genz_malik.feval_per_region(ndim) * ndim * item
        got = cuda_rule.split_chunk_size(ndim, dtype, 1024)
        assert got >= 1
        assert got == 1 or got * per <= cuda_rule.SPLIT_CHUNK_BYTES
        assert (got + 1) * per > cuda_rule.SPLIT_CHUNK_BYTES
        assert cuda_rule.split_chunk_size(ndim, dtype, None) == got
        assert cuda_rule.split_chunk_size(ndim, dtype, 7) == min(7, got)
    if dtype == torch.float64:
        assert [cuda_rule.split_chunk_size(n, dtype, 1024)
                for n in (17, 20, 24)] == [228, 25, 1]


def _cluster_smem(dtype, ndim, points, stages):
    """csrc/rule_split.cu's ClusterSmem::bytes: the ring, the head tile
    (points 0..4n), the warps', the CTA's and the cluster's orbit sums;
    a tile of p points is seg_pitch(rows, p) x seg_pitch(planes, p)."""
    item = torch.finfo(dtype).bits // 8

    def tile(p):
        return (cuda_rule._seg_pitch(item, p)
                * cuda_rule._seg_pitch(item, 32))

    return (stages * tile(points) + tile(4 * ndim + 1)
            + (cuda_rule.CLUSTER_WARPS + 2) * 9 * 32) * item


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,count", [(17, 228), (17, 5), (20, 25),
                                        (24, 1), (24, 2)])
def test_wide_cluster_plans(dtype, ndim, count):
    """The cluster routes at the chunks past 16D: clusters of 8 CTAs (so a
    region's bits do not depend on its chunk's count), each CTA's shared
    memory within 227 KB, the fourth-difference rows for 24 axes within
    the warps' partial sums they reuse, and each partition covering every
    point once (the components route's ranges the scalar route's)."""
    feval = genz_malik.feval_per_region(ndim)
    k, points, stages, ring = cuda_rule.cluster_plan(dtype, ndim, count,
                                                     feval)
    assert k == cuda_rule.MAX_CLUSTER
    assert _cluster_smem(dtype, ndim, points, ring) <= cuda_rule.MAX_SMEM
    item = torch.finfo(dtype).bits // 8
    assert (cuda_rule.fd_rows(ndim) + 5 + 3 + 1) * 32 * item + 2 * 32 * 4 \
        <= cuda_rule.CLUSTER_WARPS * 9 * 32 * item
    assert cuda_rule.fd_rows(ndim) == cuda_rule.WIDE_MAX_NDIM == 24
    assert cuda_rule.fd_rows(16) == cuda_rule.MAX_NDIM
    if ndim < 24 or dtype == torch.float32:
        seen = np.concatenate([pts for _, _, _, pts in
                               cuda_rule.cluster_partition(dtype, ndim, count,
                                                           feval)])
        assert np.array_equal(np.sort(seen), np.arange(feval))
    for ncomp in (2, 4):
        kc, rows, cpoints, cring = cuda_rule.comp_cluster_plan(
            dtype, ndim, count, feval, ncomp)
        assert (kc, rows) == (k, points)
        smem = cuda_rule.comp_cluster_smem(dtype, ndim, ncomp, cpoints, cring)
        assert smem <= cuda_rule.MAX_SMEM
        assert cuda_rule.contract_route(
            dtype, ndim, count, feval, (feval * ncomp, ncomp, 1),
            ncomp) == cuda_rule.COMPONENTS_CLUSTER
    if ndim == 17 and count == 5:
        seen = np.concatenate([pts for _, _, _, pts in
                               cuda_rule.comp_cluster_partition(
                                   dtype, ndim, count, feval, 4)])
        assert np.array_equal(np.sort(seen), np.arange(feval))
    # the scalar values as rows and as planes take the cluster route
    assert cuda_rule.contract_route(dtype, ndim, count, feval,
                                    (feval, 1)) == "cluster"
    assert cuda_rule.contract_route(dtype, ndim, count, feval,
                                    (1, count)) == "cluster"


def test_comp_cluster_smem_grows_past_16d(monkeypatch):
    """The components cluster CTA's shared memory past 16D holds 24 rows of
    fourth differences, 8 rows of 32 values more than the same CTA with
    the ≤ 16D instances' 16 (whose bytes tests/test_torch_components_
    cluster.py holds); 8 f64 components at 24D leave the route (past 227
    KB) for 'components'."""
    f17 = genz_malik.feval_per_region(17)
    for dtype in (torch.float64, torch.float32):
        item = torch.finfo(dtype).bits // 8
        _, _, points, ring = cuda_rule.comp_cluster_plan(dtype, 17, 64, f17,
                                                         4)
        wide = cuda_rule.comp_cluster_smem(dtype, 17, 4, points, ring)
        with monkeypatch.context() as m:
            m.setattr(cuda_rule, "fd_rows", lambda ndim: cuda_rule.MAX_NDIM)
            narrow = cuda_rule.comp_cluster_smem(dtype, 17, 4, points, ring)
        assert wide - narrow == 8 * 32 * item
    f24 = genz_malik.feval_per_region(24)
    assert not cuda_rule.comp_cluster_takes(torch.float64, 24, 1, f24,
                                            (f24 * 8, 8, 1), 8)
    assert cuda_rule.contract_route(torch.float64, 24, 1, f24,
                                    (f24 * 8, 8, 1), 8) == cuda_rule.COMPONENTS
