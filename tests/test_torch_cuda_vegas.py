"""The four VEGAS kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_vegas.py

The checks themselves (gpuintegration_torch/mcubes/kernel_check.py) are
rehearsed on the CPU by tests/test_torch_vegas_kernels.py.
"""
import contextlib
import math
from unittest import mock

import pytest
import torch

from gpuintegration_torch.mcubes import integrate, kernel_check
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("rng", ["input", "device"])
@pytest.mark.parametrize("with_hist", [False, True])
@pytest.mark.parametrize("position", ["end", "middle"])
def test_sampler_matches_plain_on_card(position, with_hist, rng):
    """Emit mode and every fused Genz family, 5D in a non-unit volume: the
    chunk whose last cubes lie beyond the lattice, and the one around the
    volume's centre."""
    _card()
    case = kernel_check.sampler_case(
        5, 2e5, 4096, nbins=50, degree=8, seed=3, position=position,
        lows=[0.1, -1.0, 0.0, 0.0, 0.2], highs=[0.9, 2.0, 1.0, 0.5, 1.2])
    kernel_check.check_sampler(case, None, with_hist=with_hist, rng=rng)
    for g in genz.genz_suite(5):
        kernel_check.check_sampler(case, g, with_hist=with_hist, rng=rng)


# (ndim, ncall, chunk): one dimension; sixteen (ng 2, 152 samples a cube,
# four generator blocks a sample); a lattice of 20^8 > 2^32 cubes
EXTREME_SHAPES = [(1, 2e4, 4096), (16, 1e7, 256), (8, 5.2e10, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,chunk", [(6, 1e6, 1 << 14)]
                         + EXTREME_SHAPES)
def test_stream_matches_plain_on_card(ndim, ncall, chunk):
    _card()
    kernel_check.check_stream(kernel_check.sampler_case(ndim, ncall, chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,chunk", EXTREME_SHAPES)
def test_extreme_shapes_match_plain_on_card(ndim, ncall, chunk):
    """Run-time sample and dimension loops and 64-bit cube ids: no shape
    needs another route than the kernels."""
    _card()
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=100)
    if ndim == 8:
        assert case["cube0"] > 2 ** 32
    kernel_check.check_sampler(case, None, with_hist=True, rng="device")
    kernel_check.check_sampler(case, genz.f5_c0_continuous(ndim),
                               with_hist=True, rng="device")
    kernel_check.check_bin_resolve_stratified(ndim, ncall, chunk, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,nbins", [(1, 11), (6, 500), (16, 500)])
def test_lookup_kernels_match_plain_on_card(ndim, nbins):
    _card()
    kernel_check.check_hist(ndim, 30_011, nbins)
    kernel_check.check_bin_resolve(ndim, 30_011, nbins)
    kernel_check.check_bin_resolve_stratified(ndim, 1e7, 1 << 13, nbins)
    kernel_check.check_edge_lookup(ndim, 1009, 3, nbins)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,cpu_sampler,counts", [
    (dict(), "hybrid", (True, True, False)),
    (dict(eval_dtype=torch.float32), "fused", (True, True, False)),
    (dict(importance="grid"), None, (False, True, True)),
])
def test_run_on_card_matches_cpu_and_launches_kernels(kw, cpu_sampler, counts):
    """A 3D run on the card equals the same run on the CPU (the same
    uniforms, another roundoff), repeats bitwise, and went through the
    kernels it should."""
    _card()
    g = genz.f4_gaussian(3, a=5.0)
    args = dict(epsrel=1e-3, ncall=5e4, total_iters=10, adjust_iters=6,
                seed=2, **kw)
    cuda_vegas.launches = 0
    cuda_lookup.reset_launches()
    on_card = integrate(g, **args)
    got = (cuda_vegas.launches > 0, cuda_lookup.hist_launches > 0,
           cuda_lookup.bin_resolve_launches > 0)
    assert got == counts
    # every launch of the lookups by the route built for the card
    assert cuda_lookup.hist_route_launches == {
        "grouped": cuda_lookup.hist_launches, "generic": 0}
    assert cuda_lookup.resolve_route_launches == {
        "sample": cuda_lookup.bin_resolve_launches, "wide": 0, "generic": 0}
    again = integrate(g, **args)
    assert (again.estimate, again.errorest) == (on_card.estimate,
                                                on_card.errorest)
    on_cpu = integrate(g, device="cpu", sampler=cpu_sampler, **args)
    assert (on_card.status, on_card.iters, on_card.neval) == (
        on_cpu.status, on_cpu.iters, on_cpu.neval)
    assert on_card.estimate == pytest.approx(on_cpu.estimate, rel=1e-6)
    assert on_card.status == 0


@pytest.mark.gpu
def test_other_routes_on_card():
    """A per-axis callable goes through the kernels (the emit-mode sampler
    in f64, its traced twin in the fused sampler in f32);
    ``sampler='torch'`` keeps a card run on the plain versions; one
    dimension works; 'fused' refuses a callable that does not trace."""
    _card()

    def peak(x, y):
        return torch.exp(-9.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))

    truth = (math.sqrt(math.pi) / 3.0 * math.erf(1.5)) ** 2
    kw = dict(epsrel=2e-3, ncall=5e4, seed=4)
    for extra, launched in ((dict(), True),
                            (dict(eval_dtype=torch.float32), True),
                            (dict(sampler="torch"), False),
                            (dict(importance="grid", sampler="torch"), False)):
        cuda_vegas.launches = 0
        cuda_lookup.hist_launches = cuda_lookup.bin_resolve_launches = 0
        r = integrate(peak, **kw, **extra)
        assert r.status == 0 and abs(r.estimate - truth) <= 5 * r.errorest
        assert (cuda_vegas.launches > 0) == launched
        assert (cuda_lookup.hist_launches > 0) == launched
        assert cuda_lookup.bin_resolve_launches == 0
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        integrate(lambda x, y: torch.sum(x) * y, sampler="fused", **kw)
    r = integrate(lambda x: torch.cos(x[..., 0]), ndim=1, epsrel=1e-3,
                  ncall=2e4, seed=5)
    assert abs(r.estimate - math.sin(1.0)) <= 5 * r.errorest


# (ndim, ncall, chunk, degree): the paired route's dimensions, npg 2 and
# odd npg (3 at 6D, 5 at 8D), degrees whose term counts are and are not
# multiples of four; the production lattice (6D, ncall 1e8, degree 14) and
# a lattice of 20^8 cubes, where cubes take the variance floor and f^2 falls
# below the f32 normal range
PAIRED_SHAPES = [(3, 5e4, 4096, 8), (4, 1e6, 1 << 14, 8),
                 (5, 2e5, 4096, 8), (6, 3e6, 1 << 14, 8),
                 (6, 3e6, 1 << 14, 5), (7, 1e7, 4096, 8), (8, 1e7, 4096, 8),
                 (6, 1e8, 1 << 14, 14), (8, 5.2e10, 4096, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("position", ["end", "middle"])
@pytest.mark.parametrize("ndim,ncall,chunk,degree", PAIRED_SHAPES)
def test_both_sampler_routes_match_plain_and_each_other_on_card(
        ndim, ncall, chunk, degree, position):
    """Each route against the plain version with kernel_check's unchanged
    limits and against the other route (bin ids EQUAL, each twice the same
    bits), emit mode and every fused family, uniforms from a tensor and
    from the stream; the generator word for word on both routes."""
    _card()
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=100,
                                     degree=degree, position=position)
    pmap = case["pmap"]
    assert cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq) == "paired"
    for integrand in [None] + genz.genz_suite(ndim):
        for rng in ("input", "device"):
            for route in ("paired", "generic"):
                kernel_check.check_sampler(case, integrand, with_hist=True,
                                           rng=rng, route=route)
            r = kernel_check.check_sampler_routes(case, integrand,
                                                  with_hist=True, rng=rng)
            assert r["ia_equal"]
        kernel_check.check_sampler_routes(case, integrand, with_hist=False,
                                          rng="device")
    for route in ("paired", "generic"):
        kernel_check.check_stream(case, route=route)


# (ndim, ncall, chunk, degree): the dimensions the paired route took over
# (1, 2) and the wide route's (9..16): npg 2 at 1D, 2D and 9D; 12D at npg 4;
# 16D at ncall 1e9 (ng 3, npg 23) on a chunk of 2^12 cubes (16 lanes a
# cube) and of 2^15 (8 lanes, the run's chunk); 13D at npg 9 (odd, 8
# lanes); 10D at npg 33 (32 lanes, the whole warp); a degree whose term
# counts are not multiples of four; the 1e9 runs' lattices at 17, 20, 24
# and 28D (NMAX 24 and 32; 20D at npg 953, 32 lanes) and 32D at ncall 1e10
# (2^32 cubes: the 64-bit decode), on chunks of 16K-61K samples
WIDE_SHAPES = [(1, 2e4, 4096, 8), (2, 1e6, 1 << 14, 14), (9, 4e6, 1 << 14, 8),
               (9, 1e9, 1 << 16, 14), (12, 1e9, 1 << 14, 14),
               (16, 1e9, 1 << 12, 14), (16, 1e9, 1 << 15, 14),
               (13, 1.5e7, 4096, 5), (10, 2e6, 4096, 8),
               (17, 1e9, 1 << 12, 14), (20, 1e9, 64, 14),
               (24, 1e9, 1024, 14), (28, 1e9, 1 << 13, 14),
               (32, 1e10, 1 << 13, 14)]


def _wide_suite(ndim):
    """F1..F6 at ndim, F2 at a = 2 from 9D: at its default a = 50 its peak,
    2500^ndim, lies past f32's largest value (at a = 5, 25^16, its f^2
    still does at 16D), and the fused f32 mode's values there are
    infinities whose pattern follows the order of the denominator's
    product (the plain version's torch.prod against the kernels' running
    product) and which f32 value rounds past the largest, not the kernels'
    roundings.  At a = 2 the peak is 4^ndim.  Past 16D F3's closed form
    (a sum over the 2^ndim corners) is left out: the checks read only the
    family and its coefficients."""
    with (mock.patch.object(genz, "_corner_peak_truth", lambda a: math.nan)
          if ndim > 16 else contextlib.nullcontext()):
        suite = genz.genz_suite(ndim)
    return [genz.f2_product_peak(ndim, a=2.0) if g.kind == 2 and ndim > 8
            else g for g in suite]


@pytest.mark.gpu
@pytest.mark.parametrize("position", ["end", "middle"])
@pytest.mark.parametrize("ndim,ncall,chunk,degree", WIDE_SHAPES)
def test_new_sampler_routes_match_generic_and_plain_on_card(
        ndim, ncall, chunk, degree, position):
    """The paired route at 1D and 2D and the wide route at 9..32D against
    the plain version with kernel_check's limits and against the generic
    route (coordinates, weights, bin ids and f^2 EQUAL, each route twice
    the same bits), emit mode and every fused family, uniforms from a
    tensor and from the stream, a chunk past the lattice's end; the
    generator word for word."""
    _card()
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=100,
                                     degree=degree, position=position)
    pmap = case["pmap"]
    route = "paired" if ndim <= 2 else "wide"
    assert cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq) == route
    for integrand in [None] + _wide_suite(ndim):
        for rng in ("input", "device"):
            for r in (route, "generic"):
                kernel_check.check_sampler(case, integrand, with_hist=True,
                                           rng=rng, route=r)
            got = kernel_check.check_sampler_routes(case, integrand,
                                                    with_hist=True, rng=rng)
            assert got["routes"] == [route, "generic"] and got["ia_equal"]
        kernel_check.check_sampler_routes(case, integrand, with_hist=False,
                                          rng="device")
    for r in (route, "generic"):
        kernel_check.check_stream(case, route=r)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,chunk,degree", [
    (6, 1e8, 1 << 16, 14), (4, 1e6, 1 << 14, 14), (8, 1e7, 4096, 0),
    (3, 2e5, 4096, 1), (6, 1e8, 1 << 14, 40), (8, 5.2e10, 4096, 8)])
def test_sampler_routes_at_other_degrees_on_card(ndim, ncall, chunk, degree):
    """The production shape (6D, degree 14), the identity-like degrees 0
    and 1, a high degree, and a lattice of 20^8 > 2^32 cubes (the 64-bit
    decode): emit mode and a fused family on both routes."""
    _card()
    fused = (genz.f3_corner_peak(ndim) if ncall > 1e10
             else genz.f4_gaussian(ndim))
    for position in ("end", "middle"):
        case = kernel_check.sampler_case(ndim, ncall, chunk, degree=degree,
                                         position=position)
        for integrand in (None, fused):
            for route in ("paired", "generic"):
                kernel_check.check_sampler(case, integrand, with_hist=True,
                                           rng="device", route=route)
            kernel_check.check_sampler_routes(case, integrand, with_hist=True,
                                              rng="input")


@pytest.mark.gpu
def test_sampler_launches_are_counted_by_route_on_card():
    """A 9D map goes through the wide kernel, a 6D and a 2D one through the
    paired kernel, a named generic route through the generic one; naming
    the paired route for 9D, or the wide one for 6D, raises."""
    _card()
    cuda_vegas.reset_launches()
    for ndim, route in ((9, "wide"), (6, "paired"), (2, "paired")):
        case = kernel_check.sampler_case(ndim, 2e5, 4096, nbins=50, degree=8)
        kernel_check.check_sampler(case, None, with_hist=True, rng="device")
    kernel_check.check_sampler(case, None, with_hist=True, rng="device",
                               route="generic")
    assert cuda_vegas.route_launches == {"paired": 2, "wide": 1,
                                         "generic": 1}
    assert cuda_vegas.launches == 4
    for ndim, route in ((9, "paired"), (6, "wide")):
        case = kernel_check.sampler_case(ndim, 2e5, 4096, nbins=50, degree=8)
        with pytest.raises(ValueError, match="does not take a map"):
            kernel_check.check_sampler(case, None, with_hist=True,
                                       rng="device", route=route)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["paired", "generic"])
@pytest.mark.parametrize("ndim,ncall,chunk,degree,position,family", [
    (6, 1e8, 1 << 20, 14, "end", "f1_oscillatory"),
    (6, 1e8, 1 << 14, 14, "end", "f3_corner_peak"),
    (6, 1e8, 1 << 14, 14, "end", "f5_c0"),
    (8, 5.2e10, 4096, 8, "middle", "f3_corner_peak")])
def test_sampler_against_the_f64_witness_on_card(ndim, ncall, chunk, degree,
                                                 position, family, route):
    """Where f^2 and the sum of f2b are hardest to read (fx crossing zero,
    weights far below their rounding scale, cubes at the variance floor):
    each kernel lies as near the f64 evaluation as the plain version does,
    and where the whole sum of f2b is floors, each side's distance from the
    f64 sum is a whole number of them."""
    _card()
    nbins = 500 if degree == 14 else 100
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=nbins,
                                     degree=degree, position=position)
    g = genz.FAMILIES[family](ndim)
    for rng in ("input", "device"):
        kernel_check.check_sampler(case, g, with_hist=True, rng=rng,
                                   route=route)
        w = kernel_check.sampler_f64_witness(case, g, rng=rng, route=route)
        assert w["kernel_f2_ulps"] <= kernel_check.ULPS["f2"]
        assert w["kernel_f2_ulps"] <= 2.0 * w["plain_f2_ulps"] + 1.0
        if w["sum_f2b_f64"] < 1e-3 * kernel_check.TINY:
            for side in ("kernel", "plain"):
                floors = w[f"{side}_f2b_floors"]
                assert abs(floors - round(floors)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,nbins", [(6, 50), (6, 500), (6, 2048),
                                        (1, 11), (8, 500), (8, 2048),
                                        (16, 500), (8, 908), (8, 1815),
                                        (8, 1816), (9, 500), (10, 500),
                                        (11, 500), (12, 500), (13, 500),
                                        (14, 500), (15, 500), (9, 50),
                                        (16, 50), (9, 2048), (16, 2048),
                                        (9, 3229), (9, 7000), (16, 4000),
                                        (17, 500), (20, 500), (24, 500),
                                        (28, 500), (32, 500), (32, 1815),
                                        (32, 1816)])
@pytest.mark.parametrize("n", [30_011, 1 << 18])
def test_both_hist_routes_match_plain_on_card(ndim, nbins, n):
    """Each histogram route against the plain version within HIST_RTOL,
    twice the same bits, f2 in f64 as in f32, the accumulating form from
    bins near the cap EQUAL to min(d + the route's histogram, cap).  At 8D
    the rows of 4 warps fill the shared memory up to 1815 bins (908: 8
    warps' rows would fill it exactly, so 4 warps take it); from 1816 bins
    they do not fit beside the kernel's static shared memory.  9..16D take
    the grouped route with their dimensions in groups, two sets of rows a
    block (one at 16D and 2048 bins, 9D and 3229); 9D at 7000 bins and 16D
    at 4000 do not fit one set and take the generic route, as 8D at 1816
    and 2048 does.  17..32D take one set of rows (run-time ndim), 32D up to
    1815 bins."""
    _card()
    r = kernel_check.check_hist_routes(ndim, n, nbins)
    fits = cuda_lookup.hist_route(ndim, nbins) == "grouped"
    assert fits == ((ndim, nbins) not in ((8, 2048), (8, 1816), (9, 7000),
                                          (16, 4000), (32, 1816)))
    assert r["routes"] == (["grouped", "generic"] if fits else ["generic"])
    if fits:
        assert r["between_routes_max_rel"] <= 2 * kernel_check.HIST_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("ndim", range(9, 17))
@pytest.mark.parametrize("nbins", [50, 500, 1000, 2048])
def test_hist_clusters_fit_the_card(ndim, nbins):
    """hist_plan's clusters at 9..16D, set by shape, are no more than the
    card holds at once (the query its constants were read from)."""
    _card()
    _, clusters = cuda_lookup.hist_plan(1 << 21, ndim, nbins)
    for f2_type in (torch.float32, torch.float64):
        assert clusters <= cuda_lookup.hist_clusters_on_card(ndim, nbins,
                                                             f2_type)


def _one_set_bins(ndim):
    """The most bins whose rows fit a block's shared memory at ``ndim``."""
    return ((cuda_lookup.SMEM_BYTES - cuda_lookup.HIST_STATIC_SMEM)
            // (4 * ndim))


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,nbins", [
    (ndim, nbins) for ndim in range(17, 33)
    for nbins in (50, 500, 1000, min(2048, _one_set_bins(ndim)))])
def test_hist_clusters_fit_the_card_past_16d(ndim, nbins):
    """hist_plan's clusters of the run-time 17..32D instance (one set of
    rows, its registers counted as HIST_RUNTIME_REGISTERS) are no more
    than the card holds at once, up to 2048 bins or the most that fit."""
    _card()
    assert cuda_lookup.hist_route(ndim, nbins) == "grouped"
    _, clusters = cuda_lookup.hist_plan(1 << 21, ndim, nbins)
    for f2_type in (torch.float32, torch.float64):
        assert clusters <= cuda_lookup.hist_clusters_on_card(ndim, nbins,
                                                             f2_type)


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [50, 500, 2048])
@pytest.mark.parametrize("ndim,ncall,chunk", [
    (6, 1e8, 1 << 16), (6, 3e6, 4099), (3, 5e4, 999), (1, 2e4, 4096),
    (8, 1e7, 4096), (8, 5.2e10, 4096), (9, 4e6, 2048), (9, 1e9, 1 << 16),
    (12, 1e9, 1 << 14), (16, 1e9, 1 << 12), (13, 1e7, 999),
    (10, 2e10, 4096), (17, 1e9, 1 << 12), (20, 1e9, 64),
    (24, 1e9, 1024), (28, 1e9, 1 << 13), (32, 1e10, 1 << 13)])
def test_resolve_routes_equal_on_card(ndim, ncall, chunk, nbins):
    """rc, xo, ia EQUAL between the routes, drawing xn (the main path's
    lattice, odd npg and chunk, one dimension, lattices of 20^8 and 10^10
    > 2^32 cubes, the 1e9 runs' lattices at 9..28D, 2^32 cubes at 32D) at
    the centre and at the lattice's ragged end, and given xn over a row of
    a multiple of 4 samples and a ragged one; each route against the plain
    version.  9..32D take the wide route."""
    _card()
    r = kernel_check.check_resolve_routes(ndim, ncall, chunk, nbins)
    # 32D's 2048-bin edges (256 KB) do not fit: the generic route alone
    assert r["routes"] == (["generic"] if (ndim, nbins) == (32, 2048)
                           else ["sample", "generic"] if ndim <= 8
                           else ["wide", "generic"])
    assert r["rc_ulps"] <= kernel_check.RC_ULP


# (cubes, npg, offset): a total that is a multiple of 4 or not, ia off a
# 16-byte boundary by 1, 2 and 3 elements (head elements; 4-byte stores),
# a single sample, and some 4M ids, several strides of the persistent grid
EDGE_CASES = [(1009, 3, 0), (1000, 4, 0), (1001, 1, 1), (257, 2, 2),
              (333, 3, 3), (1, 1, 0), (1, 1, 3), ((1 << 21) + 1, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("nbins", [50, 500, 2048])
@pytest.mark.parametrize("ndim", range(1, 9))
def test_edge_routes_equal_on_card(ndim, nbins):
    """Both edge-lookup routes EQUAL to the plain version and to each
    other on uniformly random ids, over totals and offsets of every kind
    (EDGE_CASES), and on the stratified ids of a VEGAS chunk."""
    _card()
    assert cuda_lookup.edge_route(ndim, nbins) == "vector"
    for cubes, npg, offset in EDGE_CASES:
        cubes = min(cubes, (1 << 22) // (npg * ndim) + 1)
        r = kernel_check.check_edge_routes(ndim, cubes, npg, nbins,
                                           offset=offset, seed=ndim)
        assert r["routes"] == ["vector", "generic"]
    ng, ncubes = V.compute_ncubes(1e6, ndim)
    npg = V.samples_per_cube(1e6, ncubes)
    chunk = min(4096, ncubes)
    xn, _ = cuda_lookup.stratified_xn_plain(ndim, ng, npg, nbins, chunk, 0,
                                            ncubes, 0, 1, "cuda")
    ids = torch.clamp(xn.to(torch.int32), 1, nbins).T.contiguous()
    kernel_check.check_edge_routes(ndim, chunk, npg, nbins,
                                   ia=ids.view(chunk, npg, ndim))


@pytest.mark.gpu
def test_lookup_launches_are_counted_by_route_on_card():
    """The main path's shapes take the grouped and the sample routes; a
    named route runs that kernel; a route that lacks the shape raises."""
    _card()
    cuda_lookup.reset_launches()
    kernel_check.check_hist(6, 4096, 500)
    assert cuda_lookup.hist_route_launches == {"grouped": 2, "generic": 0}
    kernel_check.check_bin_resolve(6, 4096, 500)
    assert cuda_lookup.resolve_route_launches == {"sample": 1, "wide": 0,
                                                  "generic": 0}
    kernel_check.check_bin_resolve(12, 4096, 500)
    assert cuda_lookup.resolve_route_launches == {"sample": 1, "wide": 1,
                                                  "generic": 0}
    ia = torch.zeros((8, 64), dtype=torch.int32, device="cuda")
    f2 = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="does not take"):
        cuda_lookup.hist(ia, f2, 2048, route="grouped")
    xi = torch.zeros((9, 51), device="cuda")
    with pytest.raises(ValueError, match="does not take"):
        cuda_lookup.bin_resolve(xi, torch.ones((9, 64), device="cuda"), 50,
                                route="sample")
    with pytest.raises(ValueError, match="does not take"):
        cuda_lookup.bin_resolve(xi[:6], torch.ones((6, 64), device="cuda"),
                                50, route="wide")
    kernel_check.check_edge_lookup(6, 512, 2, 500)
    kernel_check.check_edge_lookup(6, 512, 2, 500, route="generic")
    assert cuda_lookup.edge_route_launches == {"vector": 1, "generic": 1}
    with pytest.raises(ValueError, match="does not take"):
        cuda_lookup.edge_lookup(torch.zeros((16, 2049), device="cuda"),
                                torch.ones((4, 16), dtype=torch.int32,
                                           device="cuda"), 2048,
                                route="vector")
    assert cuda_lookup.hist_launches == 2
    assert cuda_lookup.bin_resolve_launches == 2
    assert cuda_lookup.edge_lookup_launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("ndim", [9, 12, 16, 20, 24, 32])
def test_wide_resolve_matches_plain_on_card(ndim):
    """The wide route at the 1e9 runs' lattices (32D: 1e10, 2^32 cubes):
    drawing xn on the chunk shifted past the lattice's end, given xn over a
    ragged row (30011 samples), and drawing xn on a device counter as a
    replayed CUDA graph does (EQUAL to launches given the iteration)."""
    _card()
    chunk = {9: 1 << 16, 12: 1 << 14, 16: 1 << 12, 20: 64, 24: 1024,
             32: 1 << 13}[ndim]
    ncall = 1e10 if ndim == 32 else 1e9
    assert cuda_lookup.resolve_route(ndim, 500, 30_011) == "wide"
    cuda_lookup.reset_launches()
    kernel_check.check_bin_resolve(ndim, 30_011, 500)
    kernel_check.check_bin_resolve_stratified(ndim, ncall, chunk, 500)
    assert cuda_lookup.resolve_route_launches["wide"] == 2
    kernel_check.check_resolve_counter(ndim, ncall, chunk, 500, route="wide")


@pytest.mark.gpu
def test_wide_grid_run_on_card_matches_cpu():
    """A 9D grid-map run on the card equals the same run on the CPU (the
    same uniforms, another roundoff), with every bin-resolve launch on the
    wide route."""
    _card()
    g = genz.f4_gaussian(9, a=5.0)
    args = dict(epsrel=1e-2, ncall=2e5, total_iters=8, adjust_iters=5,
                seed=3, importance="grid")
    cuda_lookup.reset_launches()
    on_card = integrate(g, **args)
    assert cuda_lookup.bin_resolve_launches > 0
    assert cuda_lookup.resolve_route_launches == {
        "sample": 0, "wide": cuda_lookup.bin_resolve_launches, "generic": 0}
    on_cpu = integrate(g, device="cpu", **args)
    assert (on_card.status, on_card.iters, on_card.neval) == (
        on_cpu.status, on_cpu.iters, on_cpu.neval)
    assert on_card.estimate == pytest.approx(on_cpu.estimate, rel=1e-6)


@pytest.mark.gpu
def test_routes_at_17d_and_33d_on_card():
    """17D takes the wide sampler, the grouped histogram and the wide bin
    resolve; 33D the generic sampler (emit mode EQUAL to its plain
    version's words under the identity map, and within kernel_check's
    limits on a fitted map), whose fused mode refuses past 32 axes, and
    the generic lookups."""
    _card()
    for ndim, want in ((17, ("wide", "grouped", "wide")),
                       (33, ("generic", "generic", "generic"))):
        ncall = 2.1 * 2 ** ndim          # ng 2, npg 2
        case = kernel_check.sampler_case(ndim, ncall, 512, nbins=50,
                                         degree=8)
        pmap = case["pmap"]
        n = case["chunk_cubes"] * case["npg"]
        assert (cuda_vegas.sampler_route(ndim, pmap.kp, pmap.kq),
                cuda_lookup.hist_route(ndim, 50),
                cuda_lookup.resolve_route(ndim, 50, n)) == want
        cuda_vegas.reset_launches()
        kernel_check.check_stream(case)
        kernel_check.check_sampler(case, None, with_hist=True, rng="device")
        assert cuda_vegas.route_launches[want[0]] == 2
        kernel_check.check_bin_resolve_stratified(ndim, ncall, 512, 50)
    with pytest.raises(ValueError, match="1..32"):
        kernel_check.check_sampler(case, genz.f4_gaussian(33),
                                   with_hist=False, rng="device")


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,ids_route", [
    (30, 3e9, "generic"), (32, 1e10, "generic"), (28, 1e9, "wide"),
    (24, 2.1 * 2 ** 24, "wide")])
def test_emit_with_ids_at_two_samples_a_cube_leaves_nmax_32(ndim, ncall,
                                                             ids_route):
    """Emitting bin ids at npg <= 2, the NMAX 32 class (30D, 32D at npg 2)
    leaves the launch to the generic route; at npg 3 (28D), in the NMAX 24
    class (24D at npg 2) and without ids it keeps the wide route."""
    _card()
    case = kernel_check.sampler_case(ndim, ncall, 512, nbins=50, degree=8)
    cuda_vegas.reset_launches()
    kernel_check.check_sampler(case, None, with_hist=True, rng="device")
    assert cuda_vegas.route_launches[ids_route] == cuda_vegas.launches == 1
    kernel_check.check_sampler(case, None, with_hist=False, rng="device")
    assert cuda_vegas.route_launches["wide"] == (
        2 if ids_route == "wide" else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(), dict(importance="grid")])
def test_17d_run_on_card_draws_the_stream(kw):
    """vegas(f, ndim=17) with the card's defaults (the poly map on
    'hybrid') runs, every launch on the wide sampler and the grouped
    histogram (the grid map: the wide bin resolve), and takes the CPU
    run's decisions on the same uniforms: the card's words are
    stream_bits' (check_stream, word for word, beside it).  Genz F4 at
    a = 5, where 70 % of the first iteration's f^2 lie below f32's normal
    range: every histogram launch of the run is held, on its own inputs,
    within HIST_RTOL of hist_accum_plain (both round each f^2 to f32, the
    grouped route adds in its own order).  The poly map then gives the CPU
    run's estimate within 1e-6; the grid map's refinement amplifies the
    histograms' last-ulp differences (a 1-ulp change of 1 % of the bins
    moves its estimate by 2e-5 on the CPU:
    tests/test_torch_stream_layout.py), so its estimate is held within
    0.1 of the CPU run's errorest."""
    _card()
    g = genz.f4_gaussian(17, a=5.0)
    args = dict(epsrel=1e-2, ncall=2.7e5, total_iters=6, adjust_iters=4,
                seed=5, **kw)
    accum, gaps, subnormal = cuda_lookup.hist_accum, [], []

    def held(d, ia, f2, nbins, **kwargs):
        # before the launch: the kernel adds into d in place
        want = cuda_lookup.hist_accum_plain(d, ia, f2, nbins, **kwargs)
        out = accum(d, ia, f2, nbins, **kwargs)
        gaps.append(kernel_check._hist_rel(out, want))
        subnormal.append(float((f2.abs().to(torch.float32)
                                < torch.finfo(torch.float32).tiny)
                               .double().mean()))
        return out
    cuda_vegas.reset_launches()
    cuda_lookup.reset_launches()
    with mock.patch.object(cuda_lookup, "hist_accum", held):
        on_card = integrate(g, **args)
    if kw:
        assert cuda_lookup.resolve_route_launches["wide"] == \
            cuda_lookup.bin_resolve_launches > 0
    else:
        assert cuda_vegas.route_launches["wide"] == cuda_vegas.launches > 0
    assert cuda_lookup.hist_route_launches["grouped"] == \
        cuda_lookup.hist_launches == len(gaps) > 0
    assert subnormal[0] > 0.5
    assert max(gaps) <= kernel_check.HIST_RTOL
    on_cpu = integrate(g, device="cpu", **args)
    assert (on_card.iters, on_card.neval) == (on_cpu.iters, on_cpu.neval)
    if kw:
        assert abs(on_card.estimate - on_cpu.estimate) <= \
            0.1 * on_cpu.errorest
    else:
        assert on_card.estimate == pytest.approx(on_cpu.estimate, rel=1e-6)
    case = kernel_check.sampler_case(17, 2.7e5, 1 << 12, nbins=50)
    for route in ("wide", "generic"):
        kernel_check.check_stream(case, route=route)
