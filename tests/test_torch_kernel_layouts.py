"""The host-side layouts and arithmetic of the redesigned CUDA kernels, on
the CPU: the packed generator codes of the rule kernel's tile route, its
tile and grid arithmetic, the packed map and the reciprocal decode of the
sampler's paired route, and the route each shape takes.  The kernels
themselves run on the card only (tests/test_torch_cuda_rule.py,
tests/test_torch_cuda_vegas.py)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gpuintegration_torch.mcubes import cuda_vegas, stream
from gpuintegration_torch.ops import cuda_rule, rule_eval
from gpuintegration_torch.pagani.region_pool import block_mask


# -- rule kernel, tile route --------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("ndim", range(2, 17))
def test_packed_generators_decode_to_the_rule_table(ndim, dtype_name):
    """The 4-bit codes, decoded as the kernel decodes them, give
    rule_tables(ndim).gen bit for bit in both working types."""
    codes, lam = cuda_rule.pack_generators(ndim)
    t = rule_eval.rule_tables(ndim, dtype_name)
    gen = cuda_rule.unpack_generators(codes, lam.astype(t.gen.dtype), ndim)
    want = t.gen[:t.feval]
    assert gen.dtype == want.dtype and gen.shape == want.shape
    assert gen.tobytes() == want.tobytes()
    assert codes.shape == (t.feval,) and int(codes.max()) < 16 ** ndim
    assert lam[0] == 0 and (lam[11:] == 0).all()
    assert (lam[6:11] == -lam[1:6]).all() and (lam[1:6] > 0).all()


@pytest.mark.parametrize("ndim", cuda_rule.TILE_NDIMS)
def test_tile_route_codes_fit_one_word(ndim):
    """The tile route hands the kernel 32-bit code words."""
    codes, _ = cuda_rule.pack_generators(ndim)
    assert ndim * cuda_rule.CODE_BITS <= 32 and int(codes.max()) < 2 ** 32


@pytest.mark.parametrize("ndim", range(2, 17))
def test_kept_points_lead_the_point_list(ndim):
    """The kernel keeps the values of points 0..8n: the centre, then the
    four single-axis orbits in (axis, +, -) order, which the fourth
    differences and the orbit sums 1..4 read by position."""
    codes, lam = cuda_rule.pack_generators(ndim)
    gen = cuda_rule.unpack_generators(codes, lam, ndim)
    assert not gen[0].any()
    for orbit in range(4):
        for d in range(ndim):
            for k, sign in enumerate((1.0, -1.0)):
                row = gen[1 + 2 * ndim * orbit + 2 * d + k]
                want = np.zeros(ndim)
                want[d] = sign * lam[1 + orbit]
                assert (row == want).all()
    ob = rule_eval.rule_tables(ndim).orbit_bounds
    assert ob[5] == 8 * ndim + 1
    assert ob[6] - ob[5] == 2 * ndim * (ndim - 1)
    assert ob[7] - ob[6] == 4 * ndim * (ndim - 1)
    assert ob[8] - ob[7] == 4 * ndim * (ndim - 1) * (ndim - 2) // 3
    assert ob[9] - ob[8] == 2 ** ndim


TILE_CASES = [(64, 0, False), (64, 0, True), (64, 1, False), (64, 37, False),
              (64, 64, False), (64, 64, True), (64, 22, True), (64, 2, True),
              (4096, 3583, False), (4096, 3584, True), (1 << 16, 57344, True),
              (6, 6, True), (6, 5, False)]


@pytest.mark.parametrize("tile", [4, 8, 20, 32])
@pytest.mark.parametrize("cap,n,blocked", TILE_CASES)
def test_tiles_cover_each_real_slot_once(cap, n, blocked, tile):
    """The kernel's walk over tiles touches exactly the real slots of the
    pool (region_pool.block_mask), each once, plain and blocked, with odd
    tails and n = 0."""
    hits = np.zeros(cap, dtype=np.int64)
    for slot0, count in cuda_rule.tile_slots(cap, n, blocked, tile):
        assert 1 <= count <= tile
        hits[slot0:slot0 + count] += 1
    mask = block_mask(cap, n, blocked, torch.device("cpu")).numpy()
    assert (hits == mask.astype(np.int64)).all()


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("n", [0, 2, 36, 256, 5000, 67584, 1 << 20, 9098752])
def test_tile_plan(n, blocked):
    """A tile is a multiple of 4 regions in 4..32 (so that its rows are 16
    bytes long in both working types), full-size once the pool gives every
    warp of the card one, and the grid is at most one block per SM and no
    more than the tiles need."""
    sms = 132
    tile, blocks = cuda_rule.tile_plan(n, blocked, sms)
    assert tile % 4 == 0 and 4 <= tile <= cuda_rule.MAX_TILE
    assert 1 <= blocks <= sms
    tiles = len(cuda_rule.tile_slots(max(n, 2), n, blocked, tile))
    assert blocks == max(1, min(sms, -(-tiles // cuda_rule.TILE_WARPS)))
    if n >= cuda_rule.MAX_TILE * sms * cuda_rule.TILE_WARPS:
        assert tile == cuda_rule.MAX_TILE and blocks == sms
    if tile > 4:
        # a smaller tile would leave warps of the card without one
        assert n > (tile - 4) * sms * cuda_rule.TILE_WARPS


@pytest.mark.parametrize("ndim", range(2, 17))
def test_rule_route(ndim):
    """'tile' for the dimensions the source compiles, 'generic' else; the
    working type does not enter."""
    want = "tile" if 3 <= ndim <= 8 else "generic"
    assert cuda_rule.rule_route(ndim) == want


def test_rule_wrapper_refuses_a_route_that_lacks_the_shape():
    from gpuintegration_torch.models import genz
    t = rule_eval.rule_tables(9)
    z = torch.zeros((9, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="route 'tile' does not take ndim 9"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(9), t, z, z + 1.0, z[:, 0],
                                  z[:, 0] + 1.0, route="tile")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(9), t, z, z + 1.0, z[:, 0],
                                  z[:, 0] + 1.0)


def test_launch_counts_reset():
    cuda_rule.launches = 3
    cuda_rule.route_launches["tile"] = 2
    cuda_rule.reset_launches()
    assert cuda_rule.launches == 0
    assert cuda_rule.route_launches == {"tile": 0, "generic": 0}
    cuda_vegas.launches = 3
    cuda_vegas.route_launches["generic"] = 3
    cuda_vegas.route_launches["wide"] = 2
    cuda_vegas.reset_launches()
    assert cuda_vegas.launches == 0
    assert cuda_vegas.route_launches == {"paired": 0, "wide": 0,
                                         "generic": 0}


# -- sampler, paired route ------------------------------------------------------

MAP_SHAPES = [(6, 30, 15), (3, 2, 1), (4, 18, 9), (8, 5, 5), (6, 32, 16),
              (3, 4, 4), (8, 29, 1), (1, 30, 15), (16, 30, 15)]


def _map(ndim, kp, kq, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.0, 0.0, ndim)
    return cuda_vegas.fold_map(
        torch.as_tensor(rng.standard_normal((ndim, kp)), dtype=torch.float32),
        torch.as_tensor(rng.standard_normal((ndim, kq)), dtype=torch.float32),
        torch.as_tensor(lo), torch.as_tensor(rng.uniform(0.5, 2.0, ndim)))


@pytest.mark.parametrize("ndim,kp,kq", MAP_SHAPES)
def test_packed_map_unpacks_to_the_map(ndim, kp, kq):
    """The interleaved layout gives back PolyMap's p, q, lo, hi bit for
    bit; its padding is zeros; every group of four is 16-byte aligned."""
    pmap = _map(ndim, kp, kq)
    kp4, kq4 = cuda_vegas.padded_terms(kp, kq)
    assert kp4 % 4 == 0 and kq4 % 4 == 0
    assert kp <= kp4 < kp + 4 and kq <= kq4 < kq + 4
    packed = pmap.packed
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() == ndim * (kp4 + kq4 + 2)
    for got, want in zip(cuda_vegas.unpack_map(packed, ndim, kp, kq),
                         pmap.parts()):
        assert torch.equal(got, want)
    assert torch.equal(cuda_vegas.pack_map(pmap), packed)
    # the words that are no coefficient are zeros: as many as the padding
    body = packed[:ndim * (kp4 + kq4)]
    assert int((body == 0).sum()) >= ndim * (kp4 - kp + kq4 - kq)
    # read as the kernel reads it: group g of dimension d
    d, per_dim = ndim - 1, kp4 + kq4
    p, q, _, _ = pmap.parts()
    row = body[d * per_dim:(d + 1) * per_dim]
    assert torch.equal(row[0:min(4, kp)], p[d, :min(4, kp)])
    assert torch.equal(row[4:4 + min(4, kq)], q[d, :min(4, kq)])
    if kp4 > kq4:
        first_alone = row[2 * kq4:2 * kq4 + 4]
        want = torch.zeros(4)
        want[:max(min(kp - kq4, 4), 0)] = p[d, kq4:kq4 + 4]
        assert torch.equal(first_alone, want)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 2 ** 32 - 1), st.integers(0, 2 ** 32 - 1))
def test_reciprocal_divmod_is_exact(ng, m):
    """The kernel's division by ng (high word of the product with the
    reciprocal, one correction) equals // and % on every 32-bit word."""
    recip = stream.decode_reciprocal(ng)
    assert 1 <= recip < 2 ** 32
    for word in (m, ng - 1, ng, min(ng + 1, 2 ** 32 - 1), 2 ** 32 - 1,
                 (m // ng) * ng, max((m // ng) * ng - 1, 0)):
        q, r = stream.reciprocal_divmod([word], ng, recip)
        assert (int(q[0]), int(r[0])) == divmod(word, ng)


@pytest.mark.parametrize("ng", [1, 2, 3, 19, 20, 26, 1000, 65536, 2 ** 31 - 1])
def test_reciprocal_decode_gives_the_cube_digits(ng):
    """Digit by digit from the least significant, as the kernel decodes a
    cube id below 2^32: the digits of stream.decode_cube."""
    ndim = 1
    while ng ** (ndim + 1) < 2 ** 32 and ndim < 8:
        ndim += 1
    ncubes = min(ng ** ndim, 2 ** 32)
    rng = np.random.default_rng(ng)
    cubes = np.unique(np.concatenate([
        rng.integers(0, ncubes, 2000), [0, ncubes - 1, ncubes // 2]]))
    recip = stream.decode_reciprocal(ng)
    m = cubes.astype(np.uint64)
    digits = np.zeros((cubes.size, ndim), dtype=np.int64)
    for d in range(ndim - 1, -1, -1):
        m, r = stream.reciprocal_divmod(m, ng, recip)
        digits[:, d] = r.astype(np.int64)
    want = stream.decode_cube(torch.as_tensor(cubes, dtype=torch.int64), ng,
                              ndim).numpy() - 1
    assert (digits == want).all()


@pytest.mark.parametrize("degree", [0, 8, 14, 40])
@pytest.mark.parametrize("ndim", range(1, 35))
def test_sampler_route(ndim, degree):
    """'paired' at ndim 1..8 and 'wide' at 9..32, the dimensions the source
    compiles them for, at every degree here: each packed map fits the
    shared memory (32D at degree 40 takes 4 * 32 * (84 + 44 + 2) bytes);
    'generic' above 32D."""
    kp, kq = 2 * degree + 2, degree + 1
    kp4, kq4 = cuda_vegas.padded_terms(kp, kq)
    assert 4 * ndim * (kp4 + kq4 + 2) <= cuda_vegas.SMEM_BYTES
    want = "paired" if ndim <= 8 else "wide" if ndim <= 32 else "generic"
    assert cuda_vegas.sampler_route(ndim, kp, kq) == want
    if want == "wide":
        assert cuda_vegas.wide_class(ndim) == next(
            nmax for nmax in (12, 16, 24, 32) if ndim <= nmax)


def test_sampler_route_by_map_size():
    """A map too large for the paired or wide kernel's shared memory goes
    the generic way (which refuses it in turn if it is too large for
    it)."""
    assert cuda_vegas.sampler_route(8, 1000, 500) == "paired"
    assert cuda_vegas.sampler_route(8, 1024, 512) == "generic"
    assert cuda_vegas.sampler_route(16, 500, 250) == "wide"
    assert cuda_vegas.sampler_route(16, 512, 256) == "generic"


def test_route_argument_is_ignored_on_the_cpu_and_checked_on_the_card():
    """On a CPU map the plain version answers whatever route is named."""
    pmap = _map(5, 6, 3)
    args = (pmap, None, 4, 2, 64, 10, True, 1.0, 0, 4 ** 5, 0, 1)
    a = cuda_vegas.sample_chunk(*args, emit_points=True)
    b = cuda_vegas.sample_chunk(*args, emit_points=True, route="generic")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the route-against-route checks, rehearsed on the CPU -----------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rng", ["input", "device"])
def test_sampler_route_check_on_cpu(fused, rng):
    """On CPU tensors both routes are the plain version: the check must
    find them equal, and a route that bins differently must fail it."""
    from gpuintegration_torch.mcubes import kernel_check
    from gpuintegration_torch.models import genz
    case = kernel_check.sampler_case(3, 2e4, 256, nbins=50, degree=8,
                                     device="cpu")
    g = genz.f4_gaussian(3) if fused else None
    r = kernel_check.check_sampler_routes(case, g, with_hist=True, rng=rng)
    assert r["ia_equal"] and r["samples"] == 256 * case["npg"]
    assert all(v == 0.0 for k, v in r.items() if k.endswith("_ulps"))


def test_sampler_route_check_catches_other_bins(monkeypatch):
    from gpuintegration_torch.mcubes import kernel_check
    case = kernel_check.sampler_case(3, 2e4, 256, nbins=50, degree=8,
                                     device="cpu")
    plain = cuda_vegas.sample_chunk_plain

    def by_route(*a, route=None, **kw):
        xs, wt, ia = plain(*a, **kw)
        return (xs, wt, torch.clamp(ia + 1, max=49)) if route == "paired" \
            else (xs, wt, ia)

    monkeypatch.setattr(cuda_vegas, "sample_chunk", by_route)
    with pytest.raises(AssertionError, match="bin ids differ between"):
        kernel_check.check_sampler_routes(case, None, with_hist=True,
                                          rng="device")


def test_rule_route_check_on_cpu(monkeypatch):
    """check_routes with the plain version standing in for both routes
    passes; a route that splits one region along another axis, or that
    does not repeat its bits, fails it."""
    from gpuintegration_torch.models import genz
    from gpuintegration_torch.ops import kernel_check
    ndim, cap = 3, 64
    rng = np.random.default_rng(0)
    lows = torch.as_tensor(rng.uniform(0.0, 0.5, (ndim, cap)))
    lengths = torch.as_tensor(rng.uniform(0.05, 0.5, (ndim, cap)))
    gl, gr = torch.zeros(ndim, dtype=torch.float64), torch.ones(
        ndim, dtype=torch.float64)
    tables = rule_eval.rule_tables(ndim)
    g = genz.f4_gaussian(ndim)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []

    def stand_in(f, tables, *pool, n, blocked, route):
        calls.append(route)
        return rule_eval.apply_rule_plain(f, tables, *pool, n=n,
                                          blocked=blocked)

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", stand_in)
    r = kernel_check.check_routes(g, tables, lows, lengths, gl, gr, n=40,
                                  blocked=True)
    assert r == {"slots": cap, "split_dim_equal": True, "est_rel": 0.0,
                 "err_rel": 0.0}
    assert calls == ["tile", "tile", "generic", "generic"]

    def other_axis(f, tables, *pool, n, blocked, route):
        est, err, sdim = stand_in(f, tables, *pool, n=n, blocked=blocked,
                                  route=route)
        if route == "tile":
            sdim = sdim.clone()
            sdim[3] = (sdim[3] + 1) % ndim
        return est, err, sdim

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", other_axis)
    with pytest.raises(AssertionError, match="split_dim differs"):
        kernel_check.check_routes(g, tables, lows, lengths, gl, gr, n=40,
                                  blocked=True)

    def drifting(f, tables, *pool, n, blocked, route):
        est, err, sdim = stand_in(f, tables, *pool, n=n, blocked=blocked,
                                  route=route)
        return est * (1.0 + 1e-15 * len(calls)), err, sdim

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", drifting)
    with pytest.raises(AssertionError, match="two launches"):
        kernel_check.check_routes(g, tables, lows, lengths, gl, gr, n=40,
                                  blocked=True)


# -- the fused mode's rounding scales (mcubes/kernel_check.py) ------------------

def _fused_case():
    """A lattice of 20^8 cubes under F3: every f^2 lies near the bottom of
    the f32 range and most cubes take the variance floor."""
    from gpuintegration_torch.mcubes import kernel_check
    from gpuintegration_torch.models import genz
    case = kernel_check.sampler_case(8, 5.2e10, 512, nbins=100, degree=8,
                                     position="middle", device="cpu")
    return kernel_check, case, genz.f3_corner_peak(8)


def _shifted_sampler(monkeypatch, d_f2b=0.0, f2_factor=1.0, f2b_factor=1.0):
    plain = cuda_vegas.sample_chunk_plain

    def fake(*a, route=None, **kw):
        sums, ia, f2 = plain(*a, **kw)
        sums = sums * torch.tensor([1.0, f2b_factor], dtype=sums.dtype)
        return (sums + torch.tensor([0.0, d_f2b], dtype=sums.dtype), ia,
                f2 * f2_factor)

    monkeypatch.setattr(cuda_vegas, "sample_chunk", fake)


@pytest.mark.parametrize("steps", [-3, -1, 0, 1, 2])
def test_floor_ties_take_whole_floors_off_the_f2b_difference(monkeypatch,
                                                             steps):
    """A sampler that floors a few tied cubes more or fewer than the plain
    version differs by that many TINY and passes; the reading before the
    ties is what the difference was."""
    kernel_check, case, g = _fused_case()
    _shifted_sampler(monkeypatch, d_f2b=steps * kernel_check.TINY)
    r = kernel_check.check_sampler(case, g, with_hist=True, rng="device")
    assert r["f2b_floor_ties"] >= 3 and r["f2b_floor_steps"] == steps
    assert r["f2b_ulps"] <= 1e-3
    assert (r["f2b_ulps_before_floor_ties"] > 1e3) == (steps != 0)


@pytest.mark.parametrize("floors", [0.4, 1.5, 1e6])
def test_floor_ties_do_not_hide_another_f2b_difference(monkeypatch, floors):
    """Half a floor, or more floors than the chunk has tied cubes, is not
    a tie: the check fails as before."""
    kernel_check, case, g = _fused_case()
    _shifted_sampler(monkeypatch, d_f2b=floors * kernel_check.TINY)
    with pytest.raises(AssertionError, match="f2b_ulps"):
        kernel_check.check_sampler(case, g, with_hist=True, rng="device")


def test_f2b_reading_is_unchanged_far_above_the_floor(monkeypatch):
    """Where the sum of f2b is many orders above TINY, the few floors that
    tied cubes could account for change nothing: a relative error of 1e-9
    is read over the scale as before."""
    from gpuintegration_torch.mcubes import kernel_check
    from gpuintegration_torch.models import genz
    case = kernel_check.sampler_case(3, 2e4, 256, nbins=50, degree=8,
                                     device="cpu")
    _shifted_sampler(monkeypatch, f2b_factor=1.0 + 1e-9)
    r = kernel_check.check_sampler(case, genz.f2_product_peak(3),
                                   with_hist=True, rng="device")
    assert r["sum_f2b"] > 1e20 * kernel_check.TINY
    assert 0.0 < r["f2b_ulps"] <= 1.0
    assert r["f2b_ulps"] == pytest.approx(r["f2b_ulps_before_floor_ties"],
                                          rel=1e-9)


def test_square_ulps_reads_an_error_of_fx():
    """_square_ulps gives back r for f^2 = (fx + r eps v)^2 against fx^2:
    the linear reading where fx is large, the square's where fx is zero."""
    from gpuintegration_torch.mcubes import kernel_check as kc
    fx = torch.tensor([1.0, 1e-3, 1e-9, 0.0, -2.0], dtype=torch.float64)
    v = torch.tensor([3.0, 1.0, 1.0, 5.0, 2.0], dtype=torch.float64)
    for r in (0.5, 4.0, 16.0):
        a = (fx.abs() + r * kc.EPS32 * v) ** 2
        got = kc._square_ulps(a, fx * fx, fx, v)
        assert torch.allclose(got, torch.full_like(got, r), rtol=1e-6)
    # equal values read 0 even where the f32 scale has overflowed
    inf = torch.tensor([float("inf")])
    assert float(kc._square_ulps(one := torch.tensor([1.0]), one, one,
                                 inf)) == 0.0
    # far above its error the reading is the difference over eps 2 |fx| v
    a, b = torch.tensor([1.0 + 1e-6]), torch.tensor([1.0])
    assert float(kc._square_ulps(a, b, one, one)) == pytest.approx(
        float((a - b) / (kc.EPS32 * 2.0)), rel=1e-4)


def test_f2_scale_carries_the_weights_rounding(monkeypatch):
    """An f^2 off by 8 ulps of the weight's rounding scale passes; the
    same relative error on a sampler whose weights have no scale to speak
    of (the identity-like degree 0) fails."""
    from gpuintegration_torch.mcubes import kernel_check as kc
    from gpuintegration_torch.models import genz
    g = genz.f1_oscillatory(3)
    wide = kc.sampler_case(3, 2e4, 256, nbins=50, degree=8, device="cpu")
    q = wide["pmap"].parts()[1]
    s_w = float(torch.prod(q.abs().sum(dim=1) ** 2))
    assert s_w > 4.0
    _shifted_sampler(monkeypatch, f2_factor=1.0 + 2 * 8 * kc.EPS32)
    kc.check_sampler(wide, g, with_hist=True, rng="device")
    flat = kc.sampler_case(3, 2e4, 256, nbins=50, degree=0, device="cpu")
    _shifted_sampler(monkeypatch, f2_factor=1.0 + 2 * 40 * kc.EPS32)
    with pytest.raises(AssertionError, match="f2_ulps"):
        kc.check_sampler(flat, g, with_hist=True, rng="device")


@pytest.mark.parametrize("rng", ["input", "device"])
def test_f64_witness_on_cpu(rng):
    """On CPU tensors the kernel is the plain version: both lie equally
    near the f64 evaluation, within the f^2 limit, and the sum of f2b is a
    whole number of floors above the f64 sum."""
    kernel_check, case, g = _fused_case()
    w = kernel_check.sampler_f64_witness(case, g, rng=rng)
    assert w["kernel_f2_ulps"] == w["plain_f2_ulps"] <= kernel_check.ULPS["f2"]
    assert w["kernel_f2b_floors"] == w["plain_f2b_floors"]
    assert w["sum_f2b_f64"] < 1e-3 * kernel_check.TINY
    assert abs(w["plain_f2b_floors"] - round(w["plain_f2b_floors"])) < 1e-3
    assert round(w["plain_f2b_floors"]) >= 3


def test_route_bits_names_the_wide_routes():
    """``tools/route_bits.py`` spells out the template arguments of the
    sampler's wide instances and the grouped histogram's, so that the 9..16D
    instances stand beside the 1..8D ones in its table."""
    from gpuintegration_torch.tools.route_bits import kernel_name
    for mangled, name in (
            ("_ZN12_GLOBAL__N_17sampler18sample_wide_kernelILi4ELi16EEEvNS0_"
             "10SampleArgsE", "sample_wide_kernel<4, 16>"),
            ("_ZN12_GLOBAL__N_17sampler18sample_pair_kernelILi0ELi1EEEvNS0_"
             "10SampleArgsE", "sample_pair_kernel<0, 1>"),
            ("_ZN12_GLOBAL__N_119hist_grouped_kernelILi12EdEEvNS_8HistArgsE",
             "hist_grouped_kernel<12, double>"),
            ("_ZN12_GLOBAL__N_119hist_grouped_kernelILi6EfEEvNS_8HistArgsE",
             "hist_grouped_kernel<6, float>")):
        assert kernel_name(mangled) == name


@pytest.mark.parametrize("chunk,npg,lanes,ids_lanes", [
    (1 << 20, 2, 1, 1), (1 << 18, 4, 1, 2), (1 << 15, 23, 4, 16),
    (91181, 23, 2, 16), (4096, 23, 16, 16), (4096, 33, 32, 32),
    (1, 2, 1, 1), (1, 1000, 32, 32), (1 << 16, 33, 2, 32)])
def test_wide_lanes_by_shape(chunk, npg, lanes, ids_lanes):
    """The wide route's lanes a cube, a power of two up to 32: emitting
    points with bin ids, enough that a cube's samples go in one round;
    else doubled while a lane keeps a pair of samples and the chunk's
    threads stay below RESIDENT_SLOTS (16D at ncall 1e9: 2^15 cubes of 23
    samples, 4 lanes)."""
    got = cuda_vegas.wide_lanes(chunk, npg)
    assert got == lanes and cuda_vegas.wide_lanes(chunk, npg, True) == ids_lanes
    pairs = -(-npg // 2)
    assert ids_lanes == min(cuda_vegas.MAX_LANES, 1 << (pairs - 1).bit_length())
    if got > 1:
        assert (got // 2) * chunk < cuda_vegas.RESIDENT_SLOTS
        assert got // 2 < pairs
    assert cuda_vegas.n_blocks(chunk, got) == min(
        -(-chunk * got // cuda_vegas.THREADS), cuda_vegas.MAX_BLOCKS)


@pytest.mark.parametrize("ndim,ncall", [(1, 2e4), (2, 1e5), (9, 4e3)])
def test_weight_witness_on_cpu(monkeypatch, ndim, ncall):
    """The sampler check's f64 witness of the weights: on the CPU the
    plain version stands in for the kernel, so both lie as far from the
    f64 evaluation, within the limit; weights moved by twice the limit,
    in ulps of their rounding scale, fail it."""
    from gpuintegration_torch.mcubes import kernel_check
    case = kernel_check.sampler_case(ndim, ncall, 256, nbins=50, degree=14,
                                     device="cpu")
    r = kernel_check.check_sampler(case, None, with_hist=True, rng="device",
                                   weight_witness=True)
    assert r["kernel_w_f64_ulps"] == r["plain_w_f64_ulps"]
    assert r["kernel_w_f64_ulps"] <= kernel_check.ULPS["w"]
    plain = cuda_vegas.sample_chunk_plain

    q = case["pmap"].parts()[1]
    shift = (2 * kernel_check.ULPS["w"] * kernel_check.EPS32
             * float(torch.prod(q.abs().sum(dim=1) ** 2)))

    def off(*a, **kw):
        xs, wt, ia = plain(*a, **kw)
        return xs, wt + shift, ia

    monkeypatch.setattr(cuda_vegas, "sample_chunk", off)
    with pytest.raises(AssertionError, match="from the f64 evaluation"):
        kernel_check.check_sampler(case, None, with_hist=True, rng="device",
                                   weight_witness=True)
