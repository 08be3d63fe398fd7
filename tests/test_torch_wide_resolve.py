"""The bin resolve at 9..32D, where the CUDA kernel takes its wide route
(csrc/vegas_lookup.cu resolve_wide_kernel: a thread per 4 samples of one
group of 4 dimensions).

* The plain version against the JAX package's XLA branch and its Pallas
  kernel in interpret mode, as its own tests run it, on the same numpy
  inputs: rc, xo and ia EQUAL to the XLA branch's; xo and ia EQUAL to the
  Pallas kernel's, rc within 2 ulp of it (that kernel contracts rc's
  multiply-add, which the reference's own tests allow for).
* One grid-map VEGAS iteration at 9D and 12D on injected uniforms (the
  parity hook ``bits=``), a chunk that runs past the lattice's end,
  against the JAX package's ``_vegas_iteration`` run eagerly
  (``jax.disable_jit``): the chunk's bin ids EQUAL, ti and tsi within
  1e-12 relative (only the order of the f64 sums differs), the histogram
  within 1e-6 per bin (tests/test_torch_vegas_iteration.py's tolerances).
* A numpy model of the wide route's index arithmetic: the items each thread
  of a persistent grid takes (every (sample, dimension) written once), the
  group decode with its carries (stream.decode_cube's digits) and the
  generator words a thread draws (stream.stream_bits's).  The kernel
  itself runs on the card only (tests/test_torch_cuda_vegas.py).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.integrand import make_integrand as jax_make_integrand
from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.mcubes.pallas_lookup import bin_resolve_pallas
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.mcubes import cuda_lookup, kernel_check, stream
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the workers running side by side would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the plain version against the reference's kernel and XLA branch --------

@pytest.mark.parametrize("with_ia", [False, True])
@pytest.mark.parametrize("ndim,nbins", [(9, 500), (12, 50), (16, 500),
                                        (20, 500), (32, 50)])
def test_bin_resolve_matches_pallas_and_xla(ndim, nbins, with_ia):
    xi32 = kernel_check.random_grid(ndim, nbins, 20 + ndim).astype(
        np.float32)
    rng = np.random.default_rng(ndim)
    n = 1234
    xn = (1.0 + rng.random((ndim, n)) * nbins).astype(np.float32)
    xn[:, 0] = 1.0                       # the lowest coordinate
    xn[:, 1] = np.nextafter(np.float32(nbins + 1), np.float32(0))
    xn[:, 2] = np.floor(xn[:, 2])        # on a bin's edge
    rc, xo, ia = cuda_lookup.bin_resolve_plain(
        torch.as_tensor(xi32), torch.as_tensor(xn), nbins, with_ia=with_ia)
    rc_k, xo_k, ia_k = bin_resolve_pallas(
        jnp.asarray(xi32), jnp.asarray(xn), nbins, with_ia=with_ia,
        interpret=True)
    # the XLA branch's arithmetic, op for op (vegas chunk_body)
    xn_j = jnp.moveaxis(jnp.asarray(xn), 0, -1)[None]
    ia_j = jnp.clip(xn_j.astype(jnp.int32), 1, nbins)
    lo_j, hi_j = JV._edge_lookup(jnp.asarray(xi32), ia_j, nbins)
    xo_j = hi_j - lo_j
    rc_j = lo_j + (xn_j - ia_j.astype(jnp.float32)) * xo_j

    def dims_major(a):
        return np.moveaxis(np.asarray(a)[0], -1, 0)

    for got, pallas, xla in ((rc, rc_k, rc_j), (xo, xo_k, xo_j)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (ndim, n)
        np.testing.assert_array_equal(got.numpy(), dims_major(xla))
        if got is rc:
            # the Pallas kernel contracts lo + (xn - ia) * xo into one
            # multiply-add where XLA does not (pallas_lookup.py; the
            # reference's own tests hold its two branches to 2 ulp)
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(pallas),
                                            maxulp=2)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if with_ia:
        np.testing.assert_array_equal(ia.numpy(), np.asarray(ia_k))
        np.testing.assert_array_equal(ia.numpy(), dims_major(ia_j))
    else:
        assert ia is None and ia_k is None


# -- one grid-map iteration against the reference's ----------------------

# ndim: (ng, npg, chunk_cubes, chunk): a lattice of ng^ndim cubes whose one
# chunk, the chunk-th of chunk_cubes cubes, runs past its end
ITERATION_SHAPES = {9: (2, 2, 200, 2), 12: (2, 3, 300, 13)}
NBINS = 50


def _iteration_inputs(ndim, npg, chunk_cubes, volume):
    rng = np.random.default_rng(ndim)
    xi = kernel_check.random_grid(ndim, NBINS, ndim)
    bits = rng.integers(0, 2 ** 32, (npg * ndim, chunk_cubes),
                        dtype=np.uint64).astype(np.uint32)
    if volume == "unit":
        lo, hi = np.zeros(ndim), np.ones(ndim)
    else:
        lo = rng.uniform(-1.0, 0.5, ndim)
        hi = lo + rng.uniform(0.5, 2.0, ndim)
    return xi, bits, lo, hi - lo


def _uniforms(bits, ndim, npg, chunk_cubes):
    """The port's uniforms of ``bits`` as the reference's (C, npg, ndim)."""
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return jnp.asarray(np.moveaxis(u.reshape(npg, ndim, chunk_cubes), -1, 0))


@pytest.mark.parametrize("volume", ["unit", "non-unit"])
@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("ndim", sorted(ITERATION_SHAPES))
def test_grid_iteration_matches_reference(ndim, with_hist, volume):
    ng, npg, chunk_cubes, chunk = ITERATION_SHAPES[ndim]
    ncubes = ng ** ndim
    cube0 = chunk * chunk_cubes
    assert cube0 < ncubes < cube0 + chunk_cubes
    assert cuda_lookup.resolve_route(ndim, NBINS, chunk_cubes * npg) == "wide"
    xi, bits, lo, dx = _iteration_inputs(ndim, npg, chunk_cubes, volume)
    xjac = float(np.prod(dx)) / (npg * ncubes)
    g = genz.f4_gaussian(ndim, a=3.0)
    fj, _ = jax_make_integrand(jax_genz.f4_gaussian(ndim, a=3.0), ndim)
    ft, _ = make_integrand(g, ndim)
    with mock.patch("jax.random.uniform",
                    return_value=_uniforms(bits, ndim, npg, chunk_cubes)), \
            jax.disable_jit():
        ti, tsi, d_ref = JV._vegas_iteration.__wrapped__(
            fj, ndim, ng, npg, chunk_cubes, 1, NBINS, with_hist, "float64",
            jax.random.PRNGKey(0), jnp.asarray(xi), jnp.asarray(lo),
            jnp.asarray(dx), jnp.asarray(xjac), jnp.asarray(ncubes, jnp.int64),
            jnp.asarray(chunk, jnp.int64))
    words = torch.as_tensor(bits.view(np.int32))
    sums, d = V._vegas_iteration(
        ft, ndim, ng, npg, chunk_cubes, 1, NBINS, with_hist, torch.float64, 0,
        1, torch.as_tensor(xi), torch.as_tensor(lo), torch.as_tensor(dx),
        xjac, ncubes, bits=words, chunk0=chunk)
    assert float(sums[0]) == pytest.approx(float(ti), rel=1e-12)
    assert float(sums[1]) == pytest.approx(float(tsi), rel=1e-12)
    d_ref = np.asarray(d_ref)
    assert d.dtype == torch.float32 and tuple(d.shape) == (ndim, NBINS)
    if with_hist:
        assert d_ref.sum() > 0
        np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-6,
                                   atol=1e-6 * d_ref.max())
    else:
        assert not d.numpy().any() and not d_ref.any()
    # the chunk's bin ids: the reference's xn and clip against the port's
    # resolve on the same words (beyond the lattice: 1)
    ids = np.arange(cube0, cube0 + chunk_cubes)
    kg = np.asarray(JV._decode_cube(jnp.asarray(ids), ng, ndim))
    xn = ((kg[:, None, :].astype(np.float32)
           - np.asarray(_uniforms(bits, ndim, npg, chunk_cubes)))
          * (np.float32(NBINS) / np.float32(ng)) + np.float32(1.0))
    ia_ref = np.clip(xn.astype(np.int32), 1, NBINS)
    ia_ref[ids >= ncubes] = 1
    _, _, ia = cuda_lookup.bin_resolve_stratified(
        torch.as_tensor(xi, dtype=torch.float32), NBINS, ng, npg, chunk_cubes,
        cube0, ncubes, 0, 1, with_ia=True, bits=words)
    np.testing.assert_array_equal(
        ia.numpy(), np.moveaxis(ia_ref, -1, 0).reshape(ndim, -1))


# -- the wide route's index arithmetic, in numpy ----------------------------

def wide_items(n: int, ndim: int, threads: int):
    """[(thread, g, q)] of a launch over n samples on ``threads`` threads
    (a multiple of the warp's 32), as resolve_wide_kernel walks them: item
    t = g * span + q, span a group's quads rounded up to whole warps,
    thread T starting at t = T and stepping by ``threads`` through (g, q)
    with one carry, no division in the loop."""
    span = cuda_lookup.resolve_items(ndim, n) // cuda_lookup.resolve_groups(
        ndim)
    groups = cuda_lookup.resolve_groups(ndim)
    t = np.arange(threads, dtype=np.int64)
    g, q = t // span, t % span
    step_g, step_q = threads // span, threads % span
    out = []
    while True:
        live = g < groups
        if not live.any():
            return out
        out.extend(zip(t[live], g[live], q[live]))
        q = q + step_q
        carry = q >= span
        q = np.where(carry, q - span, q)
        g = g + step_g + carry


def item_samples(q: int, n: int, vec: bool):
    """The samples of quad q below n: 4q .. 4q + 3 on 16-byte rows, else 4
    lying 32 apart, a warp's lanes (q % 32) taking 128 neighbouring
    samples."""
    if vec:
        first, step = 4 * q, 1
    else:
        first, step = 4 * (q - q % 32) + q % 32, 32
    return [s for s in range(first, first + 4 * step, step) if s < n]


@pytest.mark.parametrize("ndim,n,threads,vec", [
    (9, 4096, 256, True), (9, 4096, 256, False), (9, 4100, 1024, True),
    (12, 1 << 14, 256 * 7, True), (12, 1 << 14, 256 * 7, False),
    (16, 23 * 300, 256 * 3, True), (16, 23 * 300, 256 * 3, False),
    (13, 4 * 97 + 1, 256, False), (16, 3, 256, False),
    (11, 1001, 4096, False), (14, 2 * 2049, 256 * 5, False),
    (10, 4 * 3001, 2048, True), (17, 7 * 300, 256 * 3, False),
    (20, 953 * 4, 256 * 5, True), (32, 2 * 1000, 256 * 7, True),
    (29, 4 * 77 + 3, 256, False)])
def test_wide_items_write_each_sample_and_dimension_once(ndim, n, threads,
                                                         vec):
    """The items of all threads cover each (dimension, sample) exactly
    once, on 16-byte rows (n % 4 == 0) and on ragged or unaligned ones,
    for a grid smaller than, or larger than, the items; a thread's items
    are t, t + threads, ... in order; a warp's lanes take neighbouring
    quads of one group, so on ragged rows each of its 4 loads and stores
    covers 32 neighbouring samples."""
    assert not (vec and n % 4)         # 16-byte rows need n % 4 == 0
    written = np.zeros((ndim, n), dtype=np.int64)
    last, warps = {}, {}
    span = cuda_lookup.resolve_items(ndim, n) // cuda_lookup.resolve_groups(
        ndim)
    for t, g, q in wide_items(n, ndim, threads):
        item = g * span + q
        assert item == last.get(t, t - threads) + threads
        last[t] = item
        assert q % 32 == t % 32
        warps.setdefault((t // 32, item // 32), set()).add(g)
        samples = item_samples(q, n, vec)
        written[4 * g:min(4 * g + 4, ndim), samples] += 1
    assert (written == 1).all()
    assert all(len(gs) == 1 for gs in warps.values())


def group_places(ng: int, ndim: int):
    """(place, recip) of each group: ng^(dimensions after it) and
    min(floor(2^32 / place), 2^32 - 1), 0 where place has more than 32
    bits (WidePlaces)."""
    places, recips = [], []
    for g in range(cuda_lookup.resolve_groups(ndim)):
        place = ng ** (ndim - min(4 * g + 4, ndim))
        places.append(place)
        recips.append(2 ** 32 - 1 if place == 1 else 2 ** 32 // place)
    return places, recips


def group_digits(cube, ng, ndim, g, small):
    """(digits, cube mod place) of a cube inside the lattice for group g,
    as the kernel's group_digits: one division by the group's place (a
    32-bit reciprocal below 2^32 cubes, else 64-bit // and %), then one by
    ng a digit."""
    places, recips = group_places(ng, ndim)
    place, recip = places[g], recips[g]
    nd = min(4, ndim - 4 * g)
    digit = [0] * nd
    if small:
        if place <= 2 ** 32 - 1:
            m, low = (int(v) for v in stream.reciprocal_divmod(
                cube, place, recip))
        else:
            m, low = 0, cube
        for j in range(nd - 1, -1, -1):
            m, digit[j] = (int(v) for v in stream.reciprocal_divmod(
                m, ng, stream.decode_reciprocal(ng)))
    else:
        m, low = divmod(cube, place)
        for j in range(nd - 1, -1, -1):
            m, digit[j] = divmod(m, ng)
    return digit, low


def wide_decode(n, npg, ng, ndim, g, cube0, ncubes, vec):
    """(cube, slot, digits) of samples 0..n-1 for group g as a thread forms
    them.  On 16-byte rows the first sample of its quad is divided by npg
    with ``reciprocal_divmod`` and that cube's digits decoded
    (``group_digits``), then each next sample follows by a step of the
    slot and, at a new cube, a carry through the remainder below the
    digits and, where it wraps, through the digits.  On ragged rows each
    sample is divided and decoded on its own.  digits (n, nd) are 0-based
    and mean nothing for cubes beyond the lattice."""
    place = group_places(ng, ndim)[0][g]
    nd = min(4, ndim - 4 * g)
    small = ncubes <= 2 ** 32 - 1
    recip_npg = stream.decode_reciprocal(npg)
    cube_out = np.zeros(n, dtype=np.int64)
    slot_out = np.zeros(n, dtype=np.int64)
    dig_out = np.zeros((n, nd), dtype=np.int64)
    for q in range(cuda_lookup.resolve_items(ndim, n) // -(-ndim // 4)):
        samples = item_samples(q, n, vec)
        if not samples:
            continue
        if not vec:
            for s in samples:
                lc, slot = (int(v) for v in stream.reciprocal_divmod(
                    s, npg, recip_npg))
                cube = cube0 + lc
                if cube < ncubes:
                    dig_out[s] = group_digits(cube, ng, ndim, g, small)[0]
                cube_out[s], slot_out[s] = cube, slot
            continue
        lc, slot = (int(v) for v in stream.reciprocal_divmod(
            samples[0], npg, recip_npg))
        cube = cube0 + lc
        digit, low = ([0] * nd, 0)
        if cube < ncubes:
            digit, low = group_digits(cube, ng, ndim, g, small)
        for k, s in enumerate(samples):
            if k > 0:
                slot += 1
                if slot == npg:
                    slot = 0
                    cube += 1
                    low += 1
                    if low == place:
                        low = 0
                        for j in range(nd - 1, -1, -1):
                            digit[j] += 1
                            if digit[j] < ng:
                                break
                            digit[j] = 0
            cube_out[s], slot_out[s] = cube, slot
            dig_out[s] = digit
    return cube_out, slot_out, dig_out


# (ndim, ncall): the 1e9 runs' lattices at 9, 12, 16 and 17D (5 groups),
# an npg of 5 and of 152, and lattices of more than 2^32 cubes (the 64-bit
# decode; 32D at 1e10, 8 groups, has 2^32 exactly)
WIDE_DECODE_SHAPES = [(9, 1e9), (12, 1e9), (16, 1e9), (9, 1e7), (16, 1e7),
                      (10, 2e10), (9, 5e10), (17, 1e9), (32, 1e10)]


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("position", ["middle", "end"])
@pytest.mark.parametrize("ndim,ncall", WIDE_DECODE_SHAPES)
def test_wide_group_decode_gives_the_cube_digits(ndim, ncall, position, vec):
    """For every group, the cube, slot and digits of stream.decode_cube for
    every sample of a chunk, at the volume's centre and on the last chunk,
    whose last cubes lie beyond the lattice; on 16-byte rows (the carries)
    and on ragged ones (n - 3 samples, each decoded alone)."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk = min(1032, ncubes, 8192 // npg // 4 * 4)   # n <= 8192
    cube0 = kernel_check._chunk_start(ng, ndim, ncubes, chunk, position)
    n = chunk * npg - (0 if vec else 3)
    assert (n % 4 == 0) == vec
    i = np.arange(n)
    for g in range(cuda_lookup.resolve_groups(ndim)):
        cube, slot, digits = wide_decode(n, npg, ng, ndim, g, cube0, ncubes,
                                         vec)
        assert (cube == cube0 + i // npg).all() and (slot == i % npg).all()
        inside = cube < ncubes
        if position == "end":
            assert not inside.all() and inside.any()
        d0 = 4 * g
        want = stream.decode_cube(torch.as_tensor(cube[inside]), ng,
                                  ndim).numpy()[:, d0:d0 + 4] - 1
        assert (digits[inside] == want).all()
    if ncubes > 2 ** 32:
        assert cube0 > 2 ** 32


@pytest.mark.parametrize("ndim,npg", [(9, 2), (12, 4), (16, 23), (13, 3),
                                      (17, 7), (20, 5), (32, 2)])
def test_wide_thread_words_are_the_stream(ndim, npg):
    """A thread's item draws one Philox block a sample, counter (cube,
    iteration, B slot + g) with B = stream.slot_blocks(ndim) (4 up to
    16D), and takes word j for dimension 4g + j: the words of
    stream.stream_bits, row slot * ndim + d, for every item of a chunk
    (samples n = cube * npg + slot)."""
    seed, iteration = 987, 11
    chunk = 37
    cubes = 2 ** 32 - 5 + torch.arange(chunk)       # across 2^32
    want = stream.stream_bits(seed, iteration, cubes, npg, ndim)
    k0, k1 = stream.seed_key(seed)
    n = chunk * npg
    i = torch.arange(n)
    cube, slot = cubes[i // npg], i % npg
    c0, c1 = cube & stream.MASK32, cube >> 32
    c2 = torch.full_like(cube, iteration)
    for t, g, q in wide_items(n, ndim, 64):
        k = torch.as_tensor(item_samples(q, n, n % 4 == 0), dtype=torch.int64)
        if not len(k):
            continue
        block = stream.philox4x32(c0[k], c1[k], c2[k],
                                  stream.slot_blocks(ndim) * slot[k] + g,
                                  k0, k1)
        for d in range(4 * g, min(ndim, 4 * g + 4)):
            assert torch.equal(block[d - 4 * g],
                               want[slot[k] * ndim + d, k // npg])


# -- the card's checks rehearsed on the CPU ---------------------------------

@pytest.mark.parametrize("ndim,ncall,chunk", [(12, 1e7, 1 << 10),
                                              (16, 1e7, 96), (9, 1e9, 300)])
def test_wide_route_check_on_cpu(ndim, ncall, chunk):
    """check_resolve_routes at 9..16D names the wide route beside the
    generic one and, on CPU tensors (each route the plain version), finds
    them EQUAL at the centre, past the lattice's end and on a ragged row."""
    r = kernel_check.check_resolve_routes(ndim, ncall, chunk, 50,
                                          device="cpu")
    assert r["routes"] == ["wide", "generic"] and r["rc_ulps"] == 0
    kernel_check.check_resolve_counter(ndim, ncall, chunk, 50, route="wide",
                                       device="cpu")

