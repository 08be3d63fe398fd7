"""The generic route of the fused rule kernel (csrc/rule_eval.cuh
``rule_generic_kernel``) and the emitter's division and power forms
(``ops/integrand_gen.py``), on the CPU.

The kernel decodes a rule point's generators without a table of every
point: orbits 0-7 from ``pack_generators``' packed codes, the 2^n corners
from the point index (the high axes' bits from a block table, the low
axes' from the lane).  ``cuda_rule.generic_point_codes`` mirrors that
decoding, and must give the JAX package's rule points bit for bit at every
ndim the route takes; ``generic_orbit_bounds`` mirrors the segments the
kernel computes from ndim, and must be the reference's orbit counts.  The
emitter must spell each division and power as PyTorch's CUDA kernels
compute the call the step came from."""
import math

import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, integrand_gen as G
from gpuintegration_torch.ops import kernel_check, rule_eval
from gpuintegration_tpu.ops.genz_malik import genz_malik_rule

NDIMS = range(2, cuda_rule.MAX_NDIM + 1)
# a Genz family's class of its ndim, and a traced callable's library's
# class, its own ndim
CLASSES = ("genz", "generated")


def _nmax(ndim, kind):
    return None if kind == "genz" else ndim


@pytest.mark.parametrize("kind", CLASSES)
@pytest.mark.parametrize("ndim", NDIMS)
def test_generic_point_decoding_is_the_reference_rule(ndim, kind):
    """Every rule point as the kernel decodes it, the reference's
    ``genz_malik_rule(ndim).points`` bit for bit, in its order."""
    codes = cuda_rule.generic_point_codes(ndim, _nmax(ndim, kind))
    _, lam = cuda_rule.pack_generators(ndim)
    got = lam[codes]
    want = genz_malik_rule(ndim).points
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("ndim", NDIMS)
def test_generic_orbit_bounds_are_the_reference_set_counts(ndim):
    """The segments the kernel computes from ndim: points 0..8n (orbits
    0-4), orbits 5, 6, 7 and the corners, each ending where the
    reference's running count of its orbits ends; the corners are the
    last 2^n points."""
    bounds = cuda_rule.generic_orbit_bounds(ndim)
    counts = np.cumsum(genz_malik_rule(ndim).counts)
    assert bounds == (0, counts[4], counts[5], counts[6], counts[7],
                      counts[8])
    assert bounds[5] - bounds[4] == 1 << ndim
    assert bounds[1] == 8 * ndim + 1 == rule_eval.rule_tables(
        ndim).orbit_bounds[5]


@pytest.mark.parametrize("ndim", NDIMS)
def test_generic_tables_are_the_packed_codes_of_orbits_0_to_7(ndim):
    """The launch's code table: the first k8 packed codes (orbits 0-7) as
    int64 bit patterns, whose nibbles past ndim are 0 (the neutral rows
    of the axes past ndim in the kernel's class), and lam in the pool's
    type."""
    codes, lam = cuda_rule._generic_tables(ndim, torch.float32,
                                           torch.device("cpu"))
    k8 = cuda_rule.generic_orbit_bounds(ndim)[4]
    packed, lam64 = cuda_rule.pack_generators(ndim)
    assert codes.dtype == torch.int64 and codes.shape == (k8,)
    np.testing.assert_array_equal(codes.numpy().view(np.uint64), packed[:k8])
    if ndim < 16:
        assert not (packed >> np.uint64(4 * ndim)).any()
    np.testing.assert_array_equal(lam.numpy(), lam64.astype(np.float32))


@pytest.mark.parametrize("ndim", NDIMS)
def test_generic_class(ndim):
    """A Genz family's class holds its ndim; a group of lanes holds an
    axis a lane (the epilogue's lane d axis d); the class's tile is the
    one its shared memory was laid out for."""
    nmax, group, tile = cuda_rule.generic_class(ndim)
    assert nmax in cuda_rule.GENERIC_NMAX and ndim <= nmax
    assert group >= nmax and 32 % group == 0
    assert tile == {4: 32, 8: 32, 12: 16, 16: 8}[nmax]
    assert cuda_rule.generic_class(ndim, ndim)[1] == group


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("ndim", [2, 9, 12, 16])
@pytest.mark.parametrize("n", [0, 2, 36, 400, 5000, 1 << 20, 9098752])
def test_generic_plan(ndim, n, blocked):
    """Tiles of at most the class's regions, in steps of a warp's regions
    at once, cover every real slot once; a smaller tile only where the
    pool leaves warps of the card without a full one; no more blocks than
    SMs or than the tiles need."""
    sms = 132
    _, group, most = cuda_rule.generic_class(ndim)
    step = 32 // group
    tile, blocks = cuda_rule.generic_plan(ndim, n, blocked, sms)
    assert step <= tile <= most and tile % step == 0
    assert 1 <= blocks <= sms
    parts = 2 if blocked else 1
    tiles = parts * -(-(n // parts) // tile)
    if n <= 5000:
        slots = cuda_rule.tile_slots(2 * n + 2 if blocked else n, n, blocked,
                                     tile)
        assert len(slots) == tiles and sum(c for _, c in slots) == n
    assert -(-tiles // cuda_rule.GENERIC_WARPS) >= blocks or n == 0
    if tile < most:
        assert n <= tile * sms * cuda_rule.GENERIC_WARPS


# -- the emitter's division and power forms ----------------------------------

C0D = torch.tensor(0.3, dtype=torch.float64)        # a 0-d tensor on the CPU


def _three(x, y):
    return 3.0 / x + y


FORMS = {
    # x ** -0.5: PyTorch's pow sends -0.5 to rsqrt
    "rsqrt": (lambda x, y: x ** -0.5 + y, "gen_rsqrt(x[0])"),
    # true divisions
    "torch_div": (lambda x, y: torch.div(3.0, x) + y,
                  "gen_div(gen_const<T>(0x1.8000000000000p+1, "
                  "0x1.8000000000000p+1f), x[0])"),
    "true_divide": (lambda x, y: torch.true_divide(3.0, x) + y,
                    "gen_div(gen_const<T>(0x1.8000000000000p+1, "
                    "0x1.8000000000000p+1f), x[0])"),
    "tensor_numerator": (lambda x, y: C0D / x + y,
                         "gen_div(gen_const<T>(0x1.3333333333333p-2, "
                         "0x1.3333340000000p-2f), x[0])"),
    # Python's number / x is Tensor.__rtruediv__: reciprocal(x) * number
    "number_numerator": (_three,
                         "gen_mul(gen_recip(x[0]), gen_const<T>("
                         "0x1.8000000000000p+1, 0x1.8000000000000p+1f))"),
    # a host scalar divisor: a product by its reciprocal
    "cpu_tensor_divisor": (lambda x, y: x / C0D + y,
                           "gen_mul(x[0], gen_const<T>(0x1.aaaaaaaaaaaabp+1, "
                           "0x1.aaaaaa0000000p+1f))"),
}


@pytest.mark.parametrize("name", list(FORMS))
def test_emitted_division_and_power_forms(name):
    """Each form is emitted as PyTorch's CUDA kernels compute its call, and
    ``evaluate`` stays the callable's own calls (bit for bit here)."""
    f, want = FORMS[name]
    program = G.trace_axes(f, 2)
    header = G.emit_cuda(program)
    assert want in header, header
    assert "gen_pow" not in header
    if name in ("torch_div", "true_divide", "tensor_numerator"):
        assert "gen_recip" not in header
    rng = np.random.default_rng(3)
    for dtype in (np.float64, np.float32):
        xs = [torch.from_numpy(rng.uniform(0.1, 1.0, 257).astype(dtype))
              for _ in range(2)]
        got, ref = G.evaluate(program, xs), f(*xs)
        assert got.dtype == ref.dtype
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


def test_host_scalar_follows_the_divisor_device():
    """A number and a CPU 0-d tensor are host scalars (a product by the
    reciprocal); a 0-d tensor elsewhere is divided by."""
    assert G._host_scalar(3.0) and G._host_scalar(np.float32(3.0))
    assert G._host_scalar(C0D)
    assert not G._host_scalar(torch.tensor(0.3, device="meta"))


def test_reciprocal_and_true_division_differ_on_some_values():
    """The two forms are not the same function: on the CPU, reciprocal(x)
    * 3 and 3 / x part in the last bit on a share of values (so a wrong
    form would show in the card test's bit-for-bit check)."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 1.0, 4096))
    differ = (torch.reciprocal(x) * 3.0 != torch.div(3.0, x)).float().mean()
    assert 0.05 < float(differ) < 0.95
    assert math.isfinite(float(differ))


def test_generated_values_on_the_cpu_is_evaluate():
    """``cuda_rule.generated_values`` on CPU tensors runs the plain version
    (``integrand_gen.evaluate`` on the planes) and counts no launch; it
    refuses a callable that was not traced and points of another shape."""
    f = FORMS["rsqrt"][0]
    t = G.traced(f, 2)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 1.0, (2, 65)))
    cuda_rule.reset_launches()
    got = cuda_rule.generated_values(t, x)
    assert torch.equal(got.view(torch.uint8), f(x[0], x[1]).view(torch.uint8))
    assert cuda_rule.generated_value_launches == 0
    with pytest.raises(ValueError, match="traced callable"):
        cuda_rule.generated_values(f, x)
    with pytest.raises(ValueError, match="coordinate"):
        cuda_rule.generated_values(t, x.T)


@pytest.mark.parametrize("ndim", [9, 12])
def test_f32_rounding_scale_stays_finite_past_the_backward_overflow(ndim):
    """F2 (a = 50) in f32 from 9D on: autograd's backward of 1 / prod
    squares a prod of ~1e-25, which underflows, though the derivative is
    representable.  kernel_check's rounding scales stay finite there (the
    f64 pass fills the entries), so a second rounding of the same rule
    evaluation (the coordinates formed in f64 and rounded once, as the
    kernel's multiply-add forms them) passes the unchanged limits."""
    rng = np.random.default_rng(1)
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.uniform(0.0, 0.5, (ndim, 256)),
        rng.uniform(0.01, 0.5, (ndim, 256)),
        rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))]
    tables = rule_eval.rule_tables(ndim, "float32")
    g = genz.f2_product_peak(ndim)
    vals, u = kernel_check.value_scales(g, tables, *t)
    assert bool(torch.isfinite(vals).all()) and bool(torch.isfinite(u).all())
    x, _, _ = rule_eval.rule_points(
        rule_eval.rule_tables(ndim, "float64"), *(a.double() for a in t))
    other = rule_eval.rule_outputs(g(x.float()), tables, t[1], t[3])
    plain = rule_eval.apply_rule_plain(g, tables, *t)
    r = kernel_check.compare_outputs(other, plain, g, tables, *t,
                                     min_agree=0.0)
    assert r["regions"] == 256 and r["err_ulps"] <= kernel_check.ULPS["err"]


@pytest.mark.parametrize("scale", [1.0 + 1e-3, 1.0 - 1e-3])
def test_f32_rounding_scale_past_the_largest_f32_still_judges(scale):
    """F2 (a = 50) in f32 at 11D next to its peak: the values stay below
    f32's largest (2.4e37), their derivative does not (7.6e38).  The
    rounding scale then comes out in f64, finite, and an estimate moved by
    one part in a thousand still fails the check, as an infinite scale
    would let it pass."""
    ndim = 11
    lengths = np.full((ndim, 4), 0.2)
    lengths[0] = 0.11
    t = [torch.as_tensor(a, dtype=torch.float32) for a in (
        0.5 - lengths / 2, lengths, np.zeros(ndim), np.ones(ndim))]
    tables = rule_eval.rule_tables(ndim, "float32")
    g = genz.f2_product_peak(ndim)
    x, _, _ = rule_eval.rule_points(
        rule_eval.rule_tables(ndim, "float64"), *(a.double() for a in t))
    x = x.requires_grad_(True)
    (grad,) = torch.autograd.grad(g(x).sum(), x)
    assert float(grad.abs().amax()) > torch.finfo(torch.float32).max
    vals, u = kernel_check.value_scales(g, tables, *t)
    assert bool(torch.isfinite(vals).all()) and bool(torch.isfinite(u).all())
    plain = rule_eval.apply_rule_plain(g, tables, *t)
    assert bool(torch.isfinite(plain[0]).all())
    r = kernel_check.compare_outputs(plain, plain, g, tables, *t)
    assert r["est_ulps"] == 0.0
    moved = [plain[0] * scale, plain[1], plain[2]]
    with pytest.raises(AssertionError, match="est"):
        kernel_check.compare_outputs(moved, plain, g, tables, *t)


def test_route_bits_names_the_generic_kernel():
    """``tools/route_bits.py`` spells out the generic kernel's family, type
    and class, and still reads an older checkout's generic kernel."""
    from gpuintegration_torch.tools.route_bits import kernel_name
    assert kernel_name(
        "_ZN45_GLOBAL__N__8f4b2d87_12_rule_eval_cu_71dd8b824rule19rule_"
        "generic_kernelILi5EdLi12EEEvNS0_8RuleArgsIT0_EE") == \
        "rule_generic_kernel<5, double, 12>"
    assert kernel_name("_Z11rule_kernelILi4EdLb1EEv8RuleArgsIT0_E") == \
        "rule_kernel<4, double, true>"


def test_values_check_is_a_library_of_its_own():
    """The check of the emitted integrand alone (``gen_values_kernel``)
    lives in csrc/gen_values.cu, a library built from the same header
    only when a check asks for it: the library a user's run loads
    (csrc/gen_integrand.cu) holds none of it."""
    from gpuintegration_torch.ops import cuda_build
    header = G.header(G.traced(lambda x, y: x * y, 2).program)
    ours = cuda_build._target(cuda_build.GEN_SOURCE, header)
    check = cuda_build._target(cuda_build.GEN_VALUES_SOURCE, header)
    assert ours != check and check.name.startswith("libgen_values_")
    user = (cuda_build.CSRC / cuda_build.GEN_SOURCE).read_text()
    values = (cuda_build.CSRC / cuda_build.GEN_VALUES_SOURCE).read_text()
    for name in ("gen_values_kernel", "gen_values_launch"):
        assert name not in user and name in values


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("ndim", [2, 8, 16])
def test_rule_bound_counts_coordinate_work_once_a_region(kind, ndim):
    """``chip_smoke.bound_ms`` counts what the function needs: a point pays
    each axis' fold (``genz_fold``) and the finish, while the coordinates
    and ``genz_pre`` of their 11 values an axis are paid once a region.
    So the bound grows with feval by the fold alone."""
    import chip_smoke as C
    fold = {1: 2, 2: 1, 3: 2, 4: 2, 5: 1, 6: 2}[kind]
    per_point = C.ops_per_point(kind, ndim)
    assert ndim * fold < per_point <= ndim * fold + 2 + 2 * 6
    pre = {1: 0, 2: 3, 3: 0, 4: 2, 5: 1, 6: 0}[kind]
    assert C.ops_per_region(kind, ndim) == (11 * ndim * (2 + pre)
                                             + C.EPILOGUE_OPS)
    n = 1 << 20
    ms, by = C.bound_ms(kind, ndim, n, torch.float64)
    feval = rule_eval.rule_tables(ndim).feval
    ops = n * (feval * per_point + C.ops_per_region(kind, ndim))
    t_ops = 1e3 * ops / C.PEAK_OPS[torch.float64]
    assert ms >= t_ops * (1 - 1e-12)
    assert (ms == pytest.approx(t_ops)) == (by == "operations")
