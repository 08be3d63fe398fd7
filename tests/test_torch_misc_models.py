"""The port's integrand zoo (``gpuintegration_torch.models.misc``) against
the JAX package's (``gpuintegration_tpu.models.misc``), on the CPU.

* Each integrand's values at the same seeded numpy points, f64: within
  1e-14 relative plus 1e-13 of the largest |value| (the two frameworks take
  their sums and products over the axes in their own order, an ulp apart;
  a cosine of a sum of ~30 carries that ulp, 3.6e-15, undamped to its zero
  crossings, where no relative bound holds); the truths EQUAL (the same
  NumPy arithmetic on both sides).
* The port's plain rule evaluation (``rule_eval.apply_rule_plain``, what the
  split route's kernels are held to on the card) against the JAX package's
  ``rule_eval._eval_chunk`` in f64, with tests/test_torch_rule_eval.py's
  tolerances: est/err within 1e-12 relative plus 1e-13 of the region's
  magnitude, split_dim EQUAL.
* In f32, per-axis forms through the Pallas kernel in interpret mode: est
  with tests/test_pallas_rule.py's tolerances (5e-5 relative plus 1e-10);
  err by ``ops.kernel_check``'s gate-aware reading in ulps of its rounding
  scale (ROADMAP C: an f32 error estimate of a smooth region is rounding
  noise that flips the (5,1,5) gate, so no relative tolerance holds; the
  largest reading was 0.29 ulps of the limit 1).  On sin_sum every region
  of such a pool is smooth, and the two frameworks' f32 sines put its
  errors 2.55 ulps apart: it is held in f64 only.

XLA on the CPU flushes subnormal f64 results; the port runs under
``torch.set_flush_denormal(True)``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.models import misc as jax_misc
from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_tpu.ops.pallas_rule import pallas_apply_rule
from gpuintegration_tpu.pagani import region_pool as jax_region_pool
from gpuintegration_torch.models import misc
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval

# name: (port factory, JAX factory, arguments, sampling box (lo, hi))
CASES = {
    "g_function_5": (misc.g_function, jax_misc.g_function, (5,), (0, 1)),
    "g_function_8": (misc.g_function, jax_misc.g_function, (8,), (0, 1)),
    "sin_sum_6": (misc.sin_sum, jax_misc.sin_sum, (6,), (0, 1)),
    "sin_sum_3_box": (misc.sin_sum, jax_misc.sin_sum,
                      (3, [-1.0, 0.0, 0.5], [1.0, 2.0, 1.5]), (-1, 1.5)),
    "addition_8": (misc.addition, jax_misc.addition, (8,), (0, 1)),
    "oscillatory_6": (misc.oscillatory, jax_misc.oscillatory, (6,), (0, 1)),
    "gauss9d": (misc.gauss9d, jax_misc.gauss9d, (), (-0.03, 0.03)),
    "abs_cos_sum_5d": (misc.abs_cos_sum_5d, jax_misc.abs_cos_sum_5d, (),
                       (0, 1)),
    "genz_1abs_5d": (misc.abs_cos_sum_5d, jax_misc.abs_cos_sum_5d, (True,),
                     (0, 1)),
    "cos_sum_plus1_5d": (misc.cos_sum_plus1_5d, jax_misc.cos_sum_plus1_5d,
                         (), (0, 1)),
    "diagonal_ridge_2d": (misc.diagonal_ridge_2d, jax_misc.diagonal_ridge_2d,
                          (), (-1, 1)),
    "fun6": (misc.fun6, jax_misc.fun6, (), (0, 1)),
    "xyz": (misc.xyz, jax_misc.xyz, (), (0, 1)),
    "box_8_15": (misc.box_integral, jax_misc.box_integral, (8, 15.0), (0, 1)),
    "box_8_25": (misc.box_integral, jax_misc.box_integral, (8, 25.0), (0, 1)),
    "box_5_4": (misc.box_integral, jax_misc.box_integral, (5, 4.0), (0, 1)),
    "box_3_1": (misc.box_integral, jax_misc.box_integral, (3, 1.0), (0, 1)),
    "box_4_1": (misc.box_integral, jax_misc.box_integral, (4, 1.0), (0, 1)),
}


def _make(name):
    """(port integrand, JAX integrand, port Volume or None, JAX Volume or
    None) of a case."""
    make, make_jax, args, _ = CASES[name]
    got, ref = make(*args), make_jax(*args)
    if isinstance(got, tuple):
        return got[0], ref[0], got[1], ref[1]
    return got, ref, None, None


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_values_and_truths_match_jax(name):
    g, g_jax, vol, vol_jax = _make(name)
    assert (g.name, g.ndim, g.truth_exact) == (g_jax.name, g_jax.ndim,
                                               g_jax.truth_exact)
    assert g.true_value == g_jax.true_value
    assert g.kind is None and g.params is None
    assert cuda_rule.rule_route(g.ndim, g) == "split"
    if vol is not None:
        np.testing.assert_array_equal(vol.lows, vol_jax.lows)
        np.testing.assert_array_equal(vol.highs, vol_jax.highs)
    lo, hi = CASES[name][3]
    x = np.random.default_rng(7).uniform(lo, hi, (4096, g.ndim))
    got = g(torch.as_tensor(x)).numpy()
    ref = np.asarray(g_jax(jnp.asarray(x)))
    assert got.dtype == np.float64 and got.shape == (4096,)
    np.testing.assert_allclose(got, ref, rtol=1e-14,
                               atol=1e-13 * np.abs(ref).max())


def _pool(ndim, cap, seed, vol):
    """Random sub-boxes of the unit cube, mapped into ``vol`` (the unit
    cube when None)."""
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0.0, 0.5, (ndim, cap))
    lengths = rng.uniform(0.01, 0.5, (ndim, cap))
    if vol is None:
        return lows, lengths, np.zeros(ndim), np.ones(ndim)
    return lows, lengths, vol.lows, vol.highs - vol.lows


def _assert_close(got, ref, mag, rtol=1e-12, floor=1e-13):
    bound = rtol * np.abs(ref) + floor * mag
    bad = ~(np.abs(got - ref) <= bound)
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("name", ["g_function_8", "sin_sum_6",
                                  "oscillatory_6", "gauss9d",
                                  "cos_sum_plus1_5d", "diagonal_ridge_2d",
                                  "fun6", "box_8_15"])
def test_plain_rule_matches_jax_f64(name):
    g, g_jax, vol, _ = _make(name)
    ndim = g.ndim
    lows, lengths, gl, gr = _pool(ndim, 128, 11, vol)
    jt = [jnp.asarray(a) for a in (lows, lengths, gl, gr)]
    ref = [np.asarray(o) for o in jax_rule_eval._eval_chunk(
        g_jax, jax_rule_eval.rule_tables(ndim, "float64"), *jt)]
    t = [torch.as_tensor(a) for a in (lows, lengths, gl, gr)]
    tables = rule_eval.rule_tables(ndim, "float64")
    got = [o.numpy() for o in rule_eval.apply_rule(g, tables, *t,
                                                   chunk_size=48)]
    vals = rule_eval.rule_values(g, tables, *t)
    mag = (np.prod(lengths, axis=0) * np.prod(gr)
           * vals.abs().amax(dim=1).numpy())
    _assert_close(got[0], ref[0], mag)
    _assert_close(got[1], ref[1], mag)
    np.testing.assert_array_equal(got[2], ref[2])


def _per_axis(f):
    """The scalar-per-axis form f(x0, ..., x{n-1}) the Pallas kernel takes."""
    def f_axes(*xs):
        return f(jnp.stack(xs, axis=-1))
    return f_axes


@pytest.mark.parametrize("name", ["fun6", "diagonal_ridge_2d", "xyz",
                                  "box_3_1"])
def test_plain_rule_matches_pallas_f32(name):
    """f32: the integrand's per-axis form through the Pallas kernel
    (interpret mode), the batched one through the port's plain rule."""
    g, g_jax, vol, _ = _make(name)
    ndim = g.ndim
    lo, ln, _ = jax_region_pool.uniform_split(ndim, 2 if ndim > 2 else 8,
                                              128, jnp.float32)
    gl = np.zeros(ndim) if vol is None else vol.lows
    gr = np.ones(ndim) if vol is None else vol.highs - vol.lows
    gl, gr = jnp.asarray(gl, jnp.float32), jnp.asarray(gr, jnp.float32)
    ref = pallas_apply_rule(_per_axis(g_jax), ndim, lo, ln, gl, gr,
                            interpret=True)
    t = [torch.as_tensor(np.array(a)) for a in (lo, ln, gl, gr)]
    tables = rule_eval.rule_tables(ndim, "float32")
    got = rule_eval.apply_rule(g, tables, *t)
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=5e-5, atol=1e-10)
    vals, u = kernel_check.value_scales(g, tables, *t)
    kernel_check.judge(kernel_check.region_readings(
        [torch.as_tensor(np.array(o)) for o in ref], got, vals, u, tables,
        t[1], t[3]), name=name, dtype=torch.float32, min_agree=0.95)
