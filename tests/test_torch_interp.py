"""The port's interpolators (gpuintegration_torch/ops/interp.py) against
the JAX package's (gpuintegration_tpu/ops/interp.py), on the CPU.

* f64 ``__call__`` against the reference's ``__call__`` within ndim + 1
  ulps of max|z| (2 at 1D, 3 at 2D, 4 at 3D), at 1D/2D/3D, on tables
  below the reference's dense ceilings (its hat-weight contraction: read
  <= 1 ulp) and above them (its two-level lookup, ndim nested lerps
  a + t (b - a), each rounding its corners' difference: read 1, 1 and 3
  ulps).
* EQUAL at every knot, the top one included (the hat weights: one weight
  exactly 1, the other 0).
* ``precision="f32"`` within 4 f32 ulps of max|z| of the f64 value.
* The text format EQUAL both ways; the legacy single-line 1D dump."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.ops import interp as JI
from gpuintegration_torch import convert
from gpuintegration_torch.ops import interp as TI

EPS = float(np.finfo(np.float64).eps)
EPS32 = float(np.finfo(np.float32).eps)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _knots(n, lo, hi, rng):
    """n strictly ascending, unevenly spaced knots from lo to hi."""
    steps = rng.uniform(0.2, 1.8, n - 1)
    return lo + (hi - lo) * np.concatenate([[0.0], np.cumsum(steps)]) / np.sum(
        steps)


def _tables(shape, seed):
    """Knots per axis (x fastest, reversed in ``shape``) and a smooth,
    sign-changing table of that shape."""
    rng = np.random.default_rng(seed)
    axes = [_knots(n, lo, lo + 3.0, rng)
            for n, lo in zip(shape[::-1], (-1.0, 0.5, 2.0))]
    grids = np.meshgrid(*axes[::-1], indexing="ij")
    vals = np.sin(sum((k + 1) * g for k, g in enumerate(grids[::-1]))) * 3.0
    return axes, vals


def _make(ndim, shape, seed, precision="f64"):
    axes, vals = _tables(shape, seed)
    ref = getattr(JI, f"Interp{ndim}D")(*axes, vals, precision=precision)
    got = getattr(TI, f"Interp{ndim}D")(*axes, vals, precision=precision,
                                        **CPU)
    return axes, vals, ref, got


def _queries(axes, n, seed):
    """Inside the domain, beyond both ends (clamped) and at random knots."""
    rng = np.random.default_rng(seed)
    cols = []
    for k in axes:
        q = rng.uniform(k[0] - 0.3, k[-1] + 0.3, n)
        q[:n // 8] = rng.choice(k, n // 8)
        cols.append(q)
    return cols


SHAPES = {
    # below the reference's dense ceilings (4096, 16384, 65536 cells)
    "1D dense": (1, (300,)),
    "2D dense": (2, (40, 64)),
    "3D dense": (3, (12, 20, 17)),
    # above them: its two-level lookup
    "1D two-level": (1, (5000,)),
    "2D two-level": (2, (150, 120)),
    "3D two-level": (3, (50, 40, 41)),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_call_matches_reference(case):
    ndim, shape = SHAPES[case]
    axes, vals, ref, got = _make(ndim, shape, 1)
    q = _queries(axes, 2048, 2)
    want = np.asarray(ref(*[jnp.asarray(c) for c in q]))
    have = got(*[torch.as_tensor(c) for c in q])
    assert have.dtype == torch.float64 and have.shape == (2048,)
    np.testing.assert_allclose(
        have.numpy(), want, rtol=0,
        atol=(ndim + 1) * np.spacing(np.abs(vals).max()))
    # broadcast shapes: (4, 1) against (1, 5) per axis
    cols = [c[:4].reshape(4, 1) if d == 0 else c[:5].reshape(1, 5)
            for d, c in enumerate(q)]
    if ndim > 1:
        b = got(*[torch.as_tensor(c) for c in cols])
        assert b.shape == (4, 5)


@pytest.mark.parametrize("case", list(SHAPES))
def test_exact_at_every_knot(case):
    ndim, shape = SHAPES[case]
    axes, vals, _, got = _make(ndim, shape, 3)
    mesh = np.meshgrid(*axes, indexing="ij")        # x, y, z order
    out = got(*[torch.as_tensor(m.ravel()) for m in mesh]).numpy()
    # vals is indexed [z, y, x]: transpose to the mesh's [x, y, z]
    want = np.transpose(vals).ravel()
    np.testing.assert_array_equal(out, want)
    assert out[-1] == want[-1]                      # the top knot


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_clamped_to_the_edge_values(ndim):
    shape = {1: (30,), 2: (9, 11), 3: (5, 6, 7)}[ndim]
    axes, vals, ref, got = _make(ndim, shape, 4)
    lo = [torch.full((3,), k[0] - 5.0, dtype=torch.float64) for k in axes]
    hi = [torch.full((3,), k[-1] + 5.0, dtype=torch.float64) for k in axes]
    first, last = vals.ravel()[0], vals.ravel()[-1]
    assert torch.all(got(*lo) == first) and torch.all(got(*hi) == last)
    inside = [torch.as_tensor(np.full(3, k[0])) for k in axes]
    assert torch.all(got(*inside) == first)
    if ndim == 1:
        assert float(got.min_x()) == axes[0][0]
        assert float(got.max_x()) == axes[0][-1]
        assert torch.equal(got.clamp(torch.tensor([-9.0, 99.0],
                                                  dtype=torch.float64)),
                           torch.tensor([axes[0][0], axes[0][-1]]))


def test_descending_flipped_and_non_monotone_rejected():
    rng = np.random.default_rng(5)
    xs = _knots(20, 0.0, 2.0, rng)
    ys = _knots(15, -1.0, 1.0, rng)
    zs = rng.normal(size=(15, 20))
    up = TI.Interp2D(xs, ys, zs, **CPU)
    down = TI.Interp2D(xs[::-1], ys[::-1], zs[::-1, ::-1], **CPU)
    ref = JI.Interp2D(xs[::-1], ys[::-1], zs[::-1, ::-1])
    assert torch.equal(down.xs, up.xs) and torch.equal(down.zs, up.zs)
    np.testing.assert_array_equal(down.xs.numpy(), np.asarray(ref.xs))
    np.testing.assert_array_equal(down.zs.numpy(), np.asarray(ref.zs))
    q = [torch.as_tensor(rng.uniform(0.0, 2.0, 64)),
         torch.as_tensor(rng.uniform(-1.0, 1.0, 64))]
    assert torch.equal(down(*q), up(*q))
    d1 = TI.Interp1D(xs[::-1], np.arange(20.0)[::-1], **CPU)
    assert torch.equal(d1.zs, torch.arange(20.0, dtype=torch.float64))
    bumpy = xs.copy()
    bumpy[[3, 4]] = bumpy[[4, 3]]
    for make in (lambda: TI.Interp1D(bumpy, np.ones(20), **CPU),
                 lambda: TI.Interp2D(xs, np.r_[ys[:5], ys[4:14]], zs, **CPU),
                 lambda: TI.Interp3D(xs[:3], ys[:2], np.array([0.0, 0.0]),
                                     np.ones((2, 2, 3)), **CPU)):
        with pytest.raises(ValueError, match="strictly monotone"):
            make()
    with pytest.raises(ValueError):
        TI.Interp2D(xs, ys, zs.T, **CPU)
    with pytest.raises(ValueError, match="precision"):
        TI.Interp1D(xs, np.ones(20), precision="bf16", **CPU)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_text_format_both_ways(ndim):
    shape = {1: (17,), 2: (9, 11), 3: (4, 5, 6)}[ndim]
    axes, vals, ref, got = _make(ndim, shape, 6)
    text = got.to_text()
    assert text == ref.to_text()
    back = getattr(TI, f"Interp{ndim}D").from_text(ref.to_text(), **CPU)
    assert back.to_text() == text
    jback = getattr(JI, f"Interp{ndim}D").from_text(text)
    assert jback.to_text() == text
    with pytest.raises(ValueError):
        getattr(TI, f"Interp{ndim}D").from_text(text + "0x1p+0\n", **CPU)


def test_legacy_single_line_1d_dump():
    xs = np.array([0.0, 0.5, 2.0])
    zs = np.array([1.0, -1.0, 3.0])
    line = " ".join(["3"] + [v.hex() for v in xs] + ["3"]
                    + [v.hex() for v in zs])
    got = TI.Interp1D.from_text(line, **CPU)
    ref = JI.Interp1D.from_text(line)
    assert got.to_text() == ref.to_text()
    with pytest.raises(ValueError, match="mismatch"):
        TI.Interp1D.from_text("2 0x0p+0 0x1p+0 1 0x1p+0", **CPU)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_f32_precision(ndim):
    """Values fetched and combined in f32, knots and weights f64: within 4
    f32 ulps of max|z| of the f64 value (a weight rounds once to f32, each
    product and the sum once; read: <= 1.6 ulps); EQUAL at the knots."""
    shape = {1: (300,), 2: (40, 64), 3: (12, 20, 17)}[ndim]
    axes, vals, ref, got = _make(ndim, shape, 7)
    g32 = got.with_precision("f32")
    assert g32.precision == "f32" and got.precision == "f64"
    q = [torch.as_tensor(c) for c in _queries(axes, 4096, 8)]
    hi, lo = got(*q), g32(*q)
    assert lo.dtype == torch.float64
    scale = np.abs(vals).max()
    assert float(torch.max(torch.abs(lo - hi))) <= 4 * EPS32 * scale
    r32 = np.asarray(ref.with_precision("f32")(*[jnp.asarray(c.numpy())
                                                 for c in q]))
    np.testing.assert_allclose(lo.numpy(), r32, rtol=0,
                               atol=8 * EPS32 * scale)
    mesh = np.meshgrid(*axes, indexing="ij")
    at = g32(*[torch.as_tensor(m.ravel()) for m in mesh]).numpy()
    np.testing.assert_array_equal(
        at, np.transpose(vals).ravel().astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_interp_from_reference(ndim):
    shape = {1: (17,), 2: (9, 11), 3: (4, 5, 6)}[ndim]
    axes, vals, ref, got = _make(ndim, shape, 9, precision="f32")
    carried = convert.interp_from_reference(ref, **CPU)
    assert type(carried) is type(got) and carried.precision == "f32"
    assert carried.to_text() == ref.to_text()
    q = [torch.as_tensor(c) for c in _queries(axes, 64, 10)]
    assert torch.equal(carried(*q), got(*q))
    with pytest.raises(ValueError, match="not a reference interpolator"):
        convert.interp_from_reference(object(), **CPU)


def test_device_mismatch_raises_and_query_is_not_moved():
    t = TI.Interp1D([0.0, 1.0], [0.0, 2.0], **CPU)
    meta = torch.empty(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="queried on meta"):
        t(meta)
    t2 = TI.Interp2D([0.0, 1.0], [0.0, 1.0], np.eye(2), **CPU)
    with pytest.raises(ValueError, match="queried on meta"):
        t2(torch.zeros(4, dtype=torch.float64), meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TI.Interp1D([0.0, 1.0], [0.0, 2.0])
