"""The host-side plans of the redesigned VEGAS lookup kernels, on the CPU:
the grouped histogram's split of samples over blocks, warps and lanes and of
bins over a cluster's ranks, the sample route's cube decode and generator
words, the route each shape takes, and the plain versions the accumulating
form is held to.  The kernels themselves run on the card only
(tests/test_torch_cuda_vegas.py)."""
import numpy as np
import pytest
import torch

from gpuintegration_torch.mcubes import cuda_lookup, kernel_check, stream
from gpuintegration_torch.mcubes import vegas as V

HIST_CAP = cuda_lookup.HIST_CAP


# -- the kernels' index arithmetic, in numpy ---------------------------------------

def hist_block_segments(n: int, blocks: int):
    """[(first, stop)]: the range of HIST_SEGMENT-sample segments each
    block of a grouped launch takes, as hist_grouped_kernel splits them.
    Warp w of ``warps`` takes segments first + w, first + w + warps, ...
    below stop; lane l samples 4l..4l+3 of each."""
    segments = -(-n // cuda_lookup.HIST_SEGMENT)
    per = -(-segments // blocks)
    return [(b * per, min(segments, b * per + per)) for b in range(blocks)]


def hist_shares(rows: int):
    """[(lo, hi)]: the entries of the ndim * nbins histogram that each rank
    of a cluster sums over the cluster, and that the last cluster to finish
    that share sums over the clusters."""
    share = -(-rows // cuda_lookup.HIST_CLUSTER)
    return [(r * share, min(rows, r * share + share))
            for r in range(cuda_lookup.HIST_CLUSTER)]


def resolve_quads(n: int, npg: int, ng: int, ndim: int, cube0: int,
                  ncubes: int):
    """(cube, slot, digits) of samples 0..n-1 of a chunk as
    resolve_sample_kernel forms them: a thread's first sample i0 = 4q
    divided by npg with ``reciprocal_divmod``, that cube's digits decoded
    by it digit by digit (64-bit // and % from 2^32 cubes on), then each
    next sample by one step of the slot and, at a new cube, one carry
    through the digits.  digits (n, ndim) are 0-based, most significant
    first, and mean nothing for cubes beyond the lattice."""
    quads = -(-n // 4)
    i0 = 4 * np.arange(quads, dtype=np.uint64)
    lc, slot = stream.reciprocal_divmod(i0, npg, stream.decode_reciprocal(npg))
    cube = np.int64(cube0) + lc.astype(np.int64)
    inside = cube < ncubes
    digits = np.zeros((quads, ndim), dtype=np.int64)
    m = np.where(inside, cube, 0).astype(np.uint64)
    small = ncubes <= 2 ** 32 - 1
    for d in range(ndim - 1, -1, -1):
        if small:
            m, r = stream.reciprocal_divmod(m, ng,
                                            stream.decode_reciprocal(ng))
        else:
            m, r = m // np.uint64(ng), m % np.uint64(ng)
        digits[:, d] = r.astype(np.int64)
    slot = slot.astype(np.int64)
    out_cube, out_slot, out_digits = [], [], []
    for k in range(4):
        if k:
            slot = slot + 1
            wrap = slot == npg
            slot[wrap] = 0
            cube = cube + wrap
            carry = wrap
            for d in range(ndim - 1, -1, -1):
                digits[carry, d] += 1
                over = carry & (digits[:, d] == ng)
                digits[over, d] = 0
                carry = over
        out_cube.append(cube.copy())
        out_slot.append(slot.copy())
        out_digits.append(digits.copy())

    def samples(parts):
        return np.stack(parts, axis=1).reshape((4 * quads,)
                                               + parts[0].shape[1:])[:n]
    return samples(out_cube), samples(out_slot), samples(out_digits)


# -- histogram, grouped route ---------------------------------------------------

# past 128 * 8 * 8 * 30 samples the plan reaches HIST_MAX_CLUSTERS
@pytest.mark.parametrize("n", [1, 5, 127, 129, 30011, 245761, 1 << 21,
                               (1 << 21) - 3])
@pytest.mark.parametrize("ndim,nbins", [(6, 500), (1, 11), (8, 1700)])
def test_grouped_plan_covers_every_sample_once(n, ndim, nbins):
    """Blocks take contiguous ranges of 128-sample segments, warps take a
    block's segments in turn and lane l samples 4l..4l+3 of each: every
    sample below n is added once, by ragged n and by n below one block."""
    warps, clusters = cuda_lookup.hist_plan(n, ndim, nbins)
    assert warps == cuda_lookup.hist_warps(ndim, nbins) in (8, 4)
    assert 1 <= clusters <= cuda_lookup.HIST_MAX_CLUSTERS
    blocks = clusters * cuda_lookup.HIST_CLUSTER
    ranges = hist_block_segments(n, blocks)
    assert len(ranges) == blocks
    seg = cuda_lookup.HIST_SEGMENT
    hits = np.zeros(n, dtype=np.int64)
    lane_samples = (4 * np.arange(32)[:, None] + np.arange(4)).reshape(-1)
    for first, stop in ranges:
        for w in range(warps):
            for s in range(first + w, stop, warps):
                idx = s * seg + lane_samples
                np.add.at(hits, idx[idx < n], 1)
    assert (hits == 1).all()
    # ranges are contiguous and in block order
    assert ranges[0][0] == 0
    assert all(a[1] <= b[0] or b[0] >= b[1] for a, b in zip(ranges, ranges[1:]))


def test_grouped_plan_leaves_no_warp_without_a_segment_when_it_can():
    """Clusters are not more than give every warp one segment, nor more
    than HIST_MAX_CLUSTERS; n alone sets them, whatever the f2 type."""
    for n in (128, 128 * 64, 128 * 64 + 1, 128 * 64 * 30,
              128 * 64 * 30 + 1, 1 << 21):
        warps, clusters = cuda_lookup.hist_plan(n, 6, 500)
        segments = -(-n // cuda_lookup.HIST_SEGMENT)
        per_cluster = cuda_lookup.HIST_CLUSTER * warps
        assert clusters == max(1, min(cuda_lookup.HIST_MAX_CLUSTERS,
                                      -(-segments // per_cluster)))
    assert cuda_lookup.hist_plan(1 << 21, 6, 500) == (8, 30)


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 300, 3000, 12288, 6 * 2048])
def test_cluster_shares_cover_each_bin_once(rows):
    """Rank r of a cluster sums (and the last cluster of each share
    finishes) its eighth of the ndim * nbins entries: each entry once."""
    shares = hist_shares(rows)
    assert len(shares) == cuda_lookup.HIST_CLUSTER
    hits = np.zeros(rows, dtype=np.int64)
    for lo, hi in shares:
        hits[lo:max(lo, hi)] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("ndim,nbins,warps,route", [
    (6, 500, 8, "grouped"), (6, 50, 8, "grouped"), (1, 11, 8, "grouped"),
    (6, 2048, 4, "grouped"), (8, 1700, 4, "grouped"), (8, 1900, 0, "generic"),
    (8, 2048, 0, "generic"), (8, 7000, 0, "generic"), (9, 50, 8, "generic"),
    (16, 500, 4, "generic"), (8, 907, 8, "grouped"), (8, 908, 4, "grouped"),
    (8, 1815, 4, "grouped"), (8, 1816, 0, "generic")])
def test_hist_route_by_shape(ndim, nbins, warps, route):
    """The grouped route for the dimensions the source compiles (1..8)
    where the rows of 8, else 4, warps fit a block's 227 KB beside the
    kernel's static shared memory; the generic route else.  Rows of
    exactly 227 KB (8D at 908 bins on 8 warps, 1816 on 4) leave no room
    for it."""
    assert cuda_lookup.hist_warps(ndim, nbins) == warps
    assert cuda_lookup.hist_route(ndim, nbins) == route
    if warps:
        assert (4 * warps * ndim * nbins + cuda_lookup.HIST_STATIC_SMEM
                <= cuda_lookup.SMEM_BYTES)


def test_hist_route_names_are_checked():
    """A route that lacks the shape, or no route at all, raises; the
    generic route refuses what its shared memory cannot hold."""
    pick = cuda_lookup._pick_hist_route
    assert pick(6, 500, None) == "grouped"
    assert pick(6, 500, "generic") == "generic"
    assert pick(8, 2048, None) == "generic"
    with pytest.raises(ValueError, match="does not take"):
        pick(8, 2048, "grouped")
    with pytest.raises(ValueError, match="does not take"):
        pick(9, 50, "grouped")
    with pytest.raises(ValueError, match="does not take"):
        pick(6, 500, "atomic")
    with pytest.raises(ValueError, match="generic histogram"):
        pick(1, 8000, "generic")


@pytest.mark.parametrize("f2_type", [torch.float32, torch.float64])
@pytest.mark.parametrize("near_cap", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_hist_accum_plain_is_the_saturating_add(base, near_cap, f2_type):
    """hist_accum_plain equals vegas._hist_accum(d, hist_plain(ia - base,
    f2)) bit for bit, from zero and from bins near HIST_CAP, with an inf
    and a value above the cap in f2."""
    rng = np.random.default_rng(7 + base)
    ndim, n, nbins = 3, 4000, 50
    ia = torch.as_tensor(rng.integers(base, nbins + base, (ndim, n)),
                         dtype=torch.int32)
    f2 = torch.as_tensor(rng.random(n) ** 6, dtype=f2_type)
    f2[:2] = torch.tensor([float("inf"), 1e38])
    d = torch.zeros((ndim, nbins), dtype=torch.float32)
    if near_cap:
        d = torch.as_tensor(rng.uniform(0.9, 1.0, (ndim, nbins)) * HIST_CAP,
                            dtype=torch.float32)
    got = cuda_lookup.hist_accum_plain(d, ia, f2, nbins, base=base)
    want = V._hist_accum(d, cuda_lookup.hist_plain(ia - base, f2, nbins))
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    assert float(got.max()) <= np.float32(HIST_CAP)
    # the wrapper on CPU tensors: the plain version, written into d
    acc = d.clone()
    out = cuda_lookup.hist_accum(acc, ia, f2, nbins, base=base,
                                 route="grouped")
    assert out is acc and torch.equal(acc, want)


def test_grid_path_histogram_keeps_its_bits():
    """The grid path's plain chunk body, ids 1-based and f2 in f64, gives
    what it gave before the accumulating form: _hist_accum of hist_plain
    of ia - 1 and f2 rounded to f32."""
    rng = np.random.default_rng(11)
    ndim, n, nbins = 4, 3000, 40
    ia = torch.as_tensor(rng.integers(1, nbins + 1, (ndim, n)),
                         dtype=torch.int32)
    f2 = torch.as_tensor(rng.random((n // 2, 2)) * 1e3)
    d = torch.as_tensor(rng.random((ndim, nbins)), dtype=torch.float32)
    before = V._hist_accum(d, cuda_lookup.hist_plain(
        ia - 1, f2.to(torch.float32).reshape(-1), nbins))
    assert torch.equal(cuda_lookup.hist_accum_plain(d, ia, f2, nbins, base=1),
                       before)


# -- bin resolve, sample route ----------------------------------------------------

# (ndim, ncall): the main paths' lattices (6D at 1e8 and 1e9, the 3D card
# runs), an odd npg, one dimension, sixteen, and a lattice of 20^8 > 2^32
# cubes (the 64-bit decode)
DECODE_SHAPES = [(6, 1e8), (6, 1e9), (3, 5e4), (6, 3e6), (1, 2e4),
                 (8, 1e7), (16, 1e7), (8, 5.2e10)]


@pytest.mark.parametrize("position", ["middle", "end"])
@pytest.mark.parametrize("ndim,ncall", DECODE_SHAPES)
def test_sample_route_decode_gives_the_cube_digits(ndim, ncall, position):
    """A thread's first sample divided by npg and its cube decoded with the
    reciprocals, the next samples by a step and a carry: the cube, slot
    and digits of stream.decode_cube for every sample of the chunk, at the
    volume's centre and on the last chunk, whose last cubes lie beyond the
    lattice."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk = min(4099, ncubes)
    cube0 = kernel_check._chunk_start(ng, ndim, ncubes, chunk, position)
    n = chunk * npg
    cube, slot, digits = resolve_quads(n, npg, ng, ndim, cube0, ncubes)
    i = np.arange(n)
    assert (cube == cube0 + i // npg).all() and (slot == i % npg).all()
    inside = cube < ncubes
    if position == "end":
        assert not inside.all() and inside.any()
    want = stream.decode_cube(torch.as_tensor(cube[inside]), ng,
                              ndim).numpy() - 1
    assert (digits[inside] == want).all()
    if ncubes > 2 ** 32:
        assert cube0 > 2 ** 32


@pytest.mark.parametrize("ndim,npg", [(6, 2), (3, 3), (8, 5), (1, 2),
                                      (5, 152)])
def test_sample_route_words_are_the_stream(ndim, npg):
    """One Philox block per sample and group of four dimensions, counter
    (cube, iteration, 4 slot + group), word d % 4 for dimension d: the
    words of stream.stream_bits, row slot * ndim + d."""
    seed, iteration = 12345, 7
    cubes = torch.as_tensor([0, 1, 2 ** 31 + 5, 2 ** 33 + 3, 987654321])
    want = stream.stream_bits(seed, iteration, cubes, npg, ndim)
    k0, k1 = stream.seed_key(seed)
    c0, c1 = cubes & stream.MASK32, cubes >> 32
    c2 = torch.full_like(cubes, iteration)
    for slot in range(npg):
        for g in range(-(-ndim // 4)):
            block = stream.philox4x32(c0, c1, c2,
                                      torch.full_like(cubes, 4 * slot + g),
                                      k0, k1)
            for d in range(4 * g, min(ndim, 4 * g + 4)):
                assert torch.equal(block[d % 4], want[slot * ndim + d])


@pytest.mark.parametrize("ndim,nbins,n,route", [
    (6, 500, 1 << 21, "sample"), (8, 500, 1 << 21, "sample"),
    (1, 11, 30011, "sample"), (6, 2048, 1 << 21, "sample"),
    (8, 7000, 100, "sample"), (8, 8000, 100, "generic"),
    (9, 500, 1 << 21, "generic"), (16, 50, 100, "generic"),
    (6, 500, 2 ** 31, "generic")])
def test_resolve_route_by_shape(ndim, nbins, n, route):
    """The sample route for the dimensions the source compiles (1..8), all
    edges within a block's 227 KB and n < 2^31; the generic route else."""
    assert cuda_lookup.resolve_route(ndim, nbins, n) == route


def test_resolve_route_names_are_checked():
    pick = cuda_lookup._pick_resolve_route
    assert pick(6, 500, 1 << 21, None) == "sample"
    assert pick(6, 500, 1 << 21, "generic") == "generic"
    assert pick(9, 500, 1 << 21, None) == "generic"
    with pytest.raises(ValueError, match="does not take"):
        pick(9, 500, 1 << 21, "sample")
    with pytest.raises(ValueError, match="does not take"):
        pick(6, 500, 1 << 21, "tile")
    with pytest.raises(ValueError, match="generic bin-resolve"):
        pick(6, 20000, 100, "generic")


# -- the wrappers on the CPU, the counts, the checks rehearsed -------------------

def test_route_argument_is_ignored_on_the_cpu():
    """CPU tensors take the plain versions whatever route is named, even
    one that no kernel has."""
    rng = np.random.default_rng(2)
    ndim, nbins, n = 3, 30, 999
    ia = torch.as_tensor(rng.integers(0, nbins, (ndim, n)), dtype=torch.int32)
    f2 = torch.as_tensor(rng.random(n), dtype=torch.float32)
    want = cuda_lookup.hist_plain(ia, f2, nbins)
    for route in (None, "grouped", "generic", "no such route"):
        assert torch.equal(cuda_lookup.hist(ia, f2, nbins, route=route), want)
    xi32 = torch.as_tensor(kernel_check.random_grid(ndim, nbins, 0),
                           dtype=torch.float32)
    xn = torch.as_tensor((1.0 + rng.random((ndim, n)) * nbins), dtype=torch.float32)
    plain = cuda_lookup.bin_resolve_plain(xi32, xn, nbins, with_ia=True)
    args = (xi32, nbins, 4, 2, 64, 0, 4 ** 3, 0, 1)
    strat = cuda_lookup.bin_resolve_stratified_plain(*args, with_ia=True)
    for route in (None, "sample", "generic", "no such route"):
        got = cuda_lookup.bin_resolve(xi32, xn, nbins, with_ia=True,
                                      route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
        got = cuda_lookup.bin_resolve_stratified(*args, with_ia=True,
                                                 route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, strat))
    ids = torch.as_tensor(rng.integers(1, nbins + 1, (n, ndim)),
                          dtype=torch.int32)
    edges = cuda_lookup.edge_lookup_plain(xi32, ids, nbins)
    for route in (None, "vector", "generic", "no such route"):
        got = cuda_lookup.edge_lookup(xi32, ids, nbins, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, edges))
    assert cuda_lookup.hist_launches == cuda_lookup.bin_resolve_launches == 0
    assert cuda_lookup.edge_lookup_launches == 0


def test_launch_counts_reset():
    cuda_lookup.hist_launches = 4
    cuda_lookup.bin_resolve_launches = 2
    cuda_lookup.edge_lookup_launches = 1
    cuda_lookup.hist_route_launches["grouped"] = 3
    cuda_lookup.resolve_route_launches["sample"] = 2
    cuda_lookup.edge_route_launches["vector"] = 1
    cuda_lookup.reset_launches()
    assert (cuda_lookup.hist_launches, cuda_lookup.bin_resolve_launches,
            cuda_lookup.edge_lookup_launches) == (0, 0, 0)
    assert cuda_lookup.hist_route_launches == {"grouped": 0, "generic": 0}
    assert cuda_lookup.resolve_route_launches == {"sample": 0, "generic": 0}
    assert cuda_lookup.edge_route_launches == {"vector": 0, "generic": 0}


@pytest.mark.parametrize("ndim,nbins", [(6, 50), (8, 2048)])
def test_hist_route_check_on_cpu(ndim, nbins):
    """On CPU tensors every route is the plain version: the check finds
    each within the limit, twice the same bits, the accumulating form the
    saturating add of the route's histogram."""
    r = kernel_check.check_hist_routes(ndim, 3001, nbins, device="cpu")
    want = (["grouped", "generic"] if cuda_lookup.hist_route(ndim, nbins)
            == "grouped" else ["generic"])
    assert r["routes"] == want
    for route in want:
        assert r[route]["max_rel"] == r[route]["accum_max_rel"] == 0.0
    if len(want) == 2:
        assert r["between_routes_max_rel"] == 0.0


def test_hist_route_check_catches_an_accumulator_off_its_histogram(
        monkeypatch):
    """An accumulating form that adds another order than the route's own
    histogram (here: one ulp off in one bin) fails the check."""
    plain = cuda_lookup.hist_accum

    def off(d, *a, **kw):
        out = plain(d, *a, **kw)
        out[0, 3] = torch.nextafter(out[0, 3], torch.tensor(0.0))
        return out

    monkeypatch.setattr(cuda_lookup, "hist_accum", off)
    with pytest.raises(AssertionError, match="min\\(d \\+ the histogram"):
        kernel_check.check_hist_routes(3, 2000, 20, device="cpu")


@pytest.mark.parametrize("ndim,ncall,chunk", [(6, 3e6, 1 << 10),
                                              (3, 5e4, 999), (9, 4e6, 256)])
def test_resolve_route_check_on_cpu(ndim, ncall, chunk):
    r = kernel_check.check_resolve_routes(ndim, ncall, chunk, 50,
                                          device="cpu")
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    n = min(chunk, ncubes) * V.samples_per_cube(ncall, ncubes)
    assert r["routes"] == (["sample", "generic"] if ndim <= 8
                           else ["generic"])
    assert r["rc_ulps"] == 0 and r["samples"] == n


def test_resolve_route_check_catches_another_bin(monkeypatch):
    plain = cuda_lookup.bin_resolve

    def by_route(xi32, xn, nbins, *, with_ia=False, route=None):
        rc, xo, ia = plain(xi32, xn, nbins, with_ia=with_ia)
        if route == "sample":
            ia = ia.clone()
            ia[0, 5] = ia[0, 5] % nbins + 1
        return rc, xo, ia

    monkeypatch.setattr(cuda_lookup, "bin_resolve", by_route)
    with pytest.raises(AssertionError, match="ia differ"):
        kernel_check.check_resolve_routes(3, 5e4, 999, 50, device="cpu")


@pytest.mark.parametrize("nbins", [50, 500, 2048])
def test_grid_step_is_the_f32_quotient(nbins):
    """The bin units of a stratification interval, formed on the host: the
    f32 quotient that PyTorch's division gives on the CPU, for every ng a
    lattice of 1..8 dimensions reaches up to 20000."""
    ng = torch.arange(1, 20001, dtype=torch.float32)
    want = torch.tensor(float(nbins), dtype=torch.float32) / ng
    got = torch.tensor([cuda_lookup.grid_step(nbins, int(g)) for g in ng],
                       dtype=torch.float32)
    assert torch.equal(got, want)


# -- the edge lookup's vector route ----------------------------------------------

@pytest.mark.parametrize("ndim,nbins,route", [
    (6, 500, "vector"), (1, 11, "vector"), (8, 2048, "vector"),
    (16, 500, "vector"), (8, 3632, "vector"), (8, 3633, "generic"),
    (16, 2048, "generic"), (2, 20000, "generic")])
def test_edge_route_by_shape(ndim, nbins, route):
    """The vector route wherever the edge pairs, 8 ndim nbins bytes, fit a
    block's 227 KB (8D at 3632 bins exactly); the generic route else."""
    assert cuda_lookup.edge_route(ndim, nbins) == route


def test_edge_route_names_are_checked():
    pick = cuda_lookup._pick_edge_route
    assert pick(6, 500, None) == "vector"
    assert pick(6, 500, "generic") == "generic"
    assert pick(16, 2048, None) == "generic"
    with pytest.raises(ValueError, match="does not take"):
        pick(16, 2048, "vector")
    with pytest.raises(ValueError, match="does not take"):
        pick(6, 500, "sample")
    with pytest.raises(ValueError, match="shared memory"):
        pick(8, 8000, None)


@pytest.mark.parametrize("total,ia_off,out_off,want", [
    (100, 0, 0, (0, 25, True)),        # aligned, a multiple of 4
    (103, 0, 0, (0, 26, True)),        # a ragged last quad
    (100, 4, 0, (3, 25, False)),       # ia 1 element past a boundary
    (100, 8, 0, (2, 25, False)),
    (100, 12, 0, (1, 25, False)),
    (100, 12, 12, (1, 25, True)),      # outputs in ia's phase
    (2, 4, 0, (2, 0, False)),          # all of it head
    (1, 0, 0, (0, 1, True))])
def test_edge_plan(total, ia_off, out_off, want):
    base = 1 << 20
    assert cuda_lookup.edge_plan(total, base + ia_off, base + out_off,
                                 2 * base + out_off) == want


def edge_walk(total: int, ndim: int, head: int, blocks: int):
    """For each element, (times visited, dimension the thread carried
    there), as edge_vector_kernel walks: block 0 takes the head elements
    one by one, then thread t of the grid takes quads t, t + stride, ...
    after the head, carrying its dimension from quad to quad by a step of
    (4 stride) % ndim and from element to element by one, in 32 bits."""
    visits = np.zeros(total, np.int64)
    dims = np.full(total, -1, np.int64)
    visits[:head] += 1
    dims[:head] = np.arange(head) % ndim
    body = total - head
    quads = -(-body // 4)
    stride = blocks * cuda_lookup.THREADS
    q = np.arange(stride, dtype=np.int64)
    d = (head + 4 * q) % ndim
    step = (4 * stride) % ndim
    while (q < quads).any():
        dk = d.copy()
        for k in range(4):
            e = head + 4 * q + k
            ok = (q < quads) & (e < total)
            np.add.at(visits, e[ok], 1)
            dims[e[ok]] = dk[ok]
            dk = np.where(dk + 1 == ndim, 0, dk + 1)
        d = d + step
        d = np.where(d >= ndim, d - ndim, d)
        q = q + stride
    return visits, dims


@pytest.mark.parametrize("ndim", [1, 2, 3, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("total,head,blocks", [
    (1, 0, 1), (3, 3, 1), (4099, 1, 1), (6 * 2501, 2, 2), (30011, 3, 3),
    (1 << 14, 0, 5)])
def test_edge_walk_takes_every_element_once_in_its_dimension(
        total, head, blocks, ndim):
    visits, dims = edge_walk(total, ndim, min(head, total), blocks)
    assert (visits == 1).all()
    assert np.array_equal(dims, np.arange(total) % ndim)


def test_edge_route_check_on_cpu():
    r = kernel_check.check_edge_routes(6, 100, 2, 500, offset=3,
                                       device="cpu")
    assert r["routes"] == ["vector", "generic"] and r["samples"] == 200
    assert kernel_check.check_edge_routes(16, 10, 1, 2048, device="cpu")[
        "routes"] == ["generic"]
    ids = kernel_check.edge_ids(7, 3, 4, 50, offset=2, device="cpu")
    assert ids.shape == (7, 3, 4) and ids.storage_offset() == 2
    assert int(ids.min()) >= 1 and int(ids.max()) <= 50


def test_edge_route_check_catches_another_edge(monkeypatch):
    plain = cuda_lookup.edge_lookup

    def by_route(xi32, ia, nbins, *, route=None):
        lo, hi = plain(xi32, ia, nbins)
        if route == "vector":
            hi = hi.clone()
            hi.view(-1)[7] = lo.view(-1)[7]
        return lo, hi

    monkeypatch.setattr(cuda_lookup, "edge_lookup", by_route)
    with pytest.raises(AssertionError, match="hi edges differ"):
        kernel_check.check_edge_routes(3, 20, 2, 50, device="cpu")
