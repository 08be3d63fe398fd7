"""The port's heuristic policies and one-shot rule application
(gpuintegration_torch/pagani/{heuristics,oneshot}.py) against the JAX
package's (gpuintegration_tpu/pagani/{heuristics,oneshot}.py), on the CPU.

* ``apply_heuristic``: the boolean verdicts EQUAL for every policy id.
* ``apply_cubature_rules``: per-region estimates and errors to
  reassociation roundoff (1e-12 relative plus 1e-13 of the region's
  magnitude, as tests/test_torch_rule_eval.py), split_dims EQUAL (random
  pools hold no near-tie), the totals to 1e-12 relative, neval and the
  result's fields EQUAL.
* ``capture_func_evals``: points to 4 ulps of their magnitude, values to
  1e-12 relative; ``to_csv`` EQUAL character for character on an
  integrand whose values are exact products.

The port runs with ``torch.set_flush_denormal(True)``, as XLA on the CPU
flushes subnormals."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.pagani import heuristics as JH
from gpuintegration_tpu.pagani import oneshot as JO
from gpuintegration_tpu.types import Volume as JVolume
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import heuristics as TH
from gpuintegration_torch.pagani import oneshot as TO
from gpuintegration_torch.types import Volume

EPS = float(np.finfo(np.float64).eps)
IDS = [0, 1, 2, 4, 7, 8, 9, 10]
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _policy_inputs(seed, n=512):
    """Per-region (self, parent) estimates and errors with negatives, zeros
    and a spread of magnitudes, and the batch-level ledger."""
    rng = np.random.default_rng(seed)
    est = rng.normal(1e-3, 2e-3, n)
    est[::17] = 0.0
    err = np.abs(rng.normal(0.0, 1e-4, n)) * rng.choice([1e-3, 1.0, 30.0], n)
    err[::23] = 0.0
    par_res = est * rng.uniform(1.5, 2.5, n)
    par_err = err * rng.uniform(0.5, 3.0, n)
    depth = rng.integers(1, 12, n).astype(np.float64)
    scalars = dict(leaves_estimate=float(est.sum()) + 0.25,
                   finished_estimate=0.25, queued_estimate=float(est.sum()),
                   finished_errorest=1e-6, queued_errorest=float(err.sum()),
                   curr_iter_regions=n, total_nregions=4 * n)
    return est, err, par_res, par_err, depth, scalars


@pytest.mark.parametrize("min_iter", [True, False])
@pytest.mark.parametrize("hid", IDS)
def test_apply_heuristic_verdicts_equal(hid, min_iter):
    est, err, par_res, par_err, depth, s = _policy_inputs(hid)
    for epsrel in (1e-3, 1e-1):
        args = (s["leaves_estimate"], s["finished_estimate"],
                s["queued_estimate"], s["finished_errorest"],
                s["queued_errorest"], s["curr_iter_regions"],
                s["total_nregions"])
        ref = np.asarray(JH.apply_heuristic(
            hid, *args, jnp.asarray(min_iter), jnp.asarray(par_res),
            jnp.asarray(par_err), jnp.asarray(depth), jnp.asarray(est),
            jnp.asarray(err), epsrel, 1e-12))
        got = TH.apply_heuristic(
            hid, *args, min_iter, torch.as_tensor(par_res),
            torch.as_tensor(par_err), torch.as_tensor(depth),
            torch.as_tensor(est), torch.as_tensor(err), epsrel, 1e-12)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)
    if hid in (0, 1):
        # only the zero-estimate, zero-error regions finish
        assert got.numpy().sum() == (min_iter * ((est == 0) & (err <= 1e-12))
                                     ).sum()


def test_apply_heuristic_rejects_unknown_ids():
    z = torch.zeros(3, dtype=torch.float64)
    for hid in (3, 5, 6, 11, -1):
        with pytest.raises(ValueError, match="unknown heuristic"):
            TH.apply_heuristic(hid, 1.0, 0.0, 1.0, 0.0, 0.0, 3, 3, True, z, z,
                               1.0, z, z, 1e-3, 1e-12)


def _pool(ndim, n, seed):
    """n random sub-regions of the unit cube, region-major (n, ndim)."""
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(0.02, 0.4, (n, ndim))
    lows = rng.random((n, ndim)) * (1.0 - lengths)
    return lows, lengths


def _magnitude(f_t, ndim, lows, lengths, gl, gr):
    """Per region: volume x jacobian x the largest |f| at its rule points,
    the scale of every rule sum and of their roundoff."""
    cap = TO.capture_func_evals(f_t, lows, lengths,
                                Volume(gl, gl + gr), ndim=ndim,
                                max_regions=len(lows), **CPU)
    return (np.prod(lengths, axis=1) * np.prod(gr)
            * np.abs(cap.values).max(axis=1))


def _close(got, ref, mag, rtol=1e-12, floor=1e-13):
    bound = rtol * np.abs(ref) + floor * mag
    bad = ~(np.abs(got - ref) <= bound)
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


FAMILY_CASES = [(fam, ndim) for fam in range(1, 7) for ndim in (3, 4, 5)]
_NAMES = {1: "f1_oscillatory", 2: "f2_product_peak", 3: "f3_corner_peak",
          4: "f4_gaussian", 5: "f5_c0_continuous", 6: "f6_discontinuous"}


@pytest.mark.parametrize("fam,ndim", FAMILY_CASES)
def test_apply_cubature_rules_genz(fam, ndim):
    lows, lengths = _pool(ndim, 96, 10 * fam + ndim)
    name = _NAMES[fam]
    f_t, f_j = getattr(genz, name)(ndim), getattr(jax_genz, name)(ndim)
    ref = JO.apply_cubature_rules(f_j, lows, lengths)
    got = TO.apply_cubature_rules(f_t, lows, lengths, **CPU)
    mag = _magnitude(f_t, ndim, lows, lengths, np.zeros(ndim), np.ones(ndim))
    _close(got[1].numpy(), np.asarray(ref[1]), mag)
    _close(got[2].numpy(), np.asarray(ref[2]), mag)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    r, j = got[0], ref[0]
    assert (r.nregions, r.neval, r.status) == (j.nregions, j.neval, j.status)
    assert r.neval == 96 * rule_eval.rule_tables(ndim).feval
    tot = float(np.sum(mag))
    assert abs(r.estimate - j.estimate) <= 1e-12 * abs(j.estimate) + 1e-13 * tot
    assert abs(r.errorest - j.errorest) <= 1e-12 * j.errorest + 1e-13 * tot


def test_apply_cubature_rules_orientations_and_volume():
    """Region-major and dims-major pools give the same outputs; the arity,
    the ``ndim`` attribute and ``ndim=`` orient them; a non-unit Volume."""
    ndim = 4
    lows, lengths = _pool(ndim, 40, 3)
    vol_t = Volume([-1.0, 0.5, 0.0, 2.0], [1.0, 1.5, 3.0, 2.5])
    vol_j = JVolume([-1.0, 0.5, 0.0, 2.0], [1.0, 1.5, 3.0, 2.5])

    def axes_t(x0, x1, x2, x3):
        return torch.exp(-(x0 * x0 + x1 * x1)) * torch.cos(x2 + 0.5 * x3)

    def axes_j(x0, x1, x2, x3):
        return jnp.exp(-(x0 * x0 + x1 * x1)) * jnp.cos(x2 + 0.5 * x3)

    ref = JO.apply_cubature_rules(axes_j, lows, lengths, vol_j)
    mag = _magnitude(axes_t, ndim, lows, lengths, vol_t.lows,
                     vol_t.highs - vol_t.lows)
    for lo, ln in ((lows, lengths), (lows.T, lengths.T)):
        got = TO.apply_cubature_rules(axes_t, lo, ln, vol_t, **CPU)
        _close(got[1].numpy(), np.asarray(ref[1]), mag)
        _close(got[2].numpy(), np.asarray(ref[2]), mag)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    # a single-argument callable: its ndim attribute, or ndim=
    g = genz.f4_gaussian(ndim, a=5.0)
    a = TO.apply_cubature_rules(g, lows, lengths, **CPU)
    b = TO.apply_cubature_rules(lambda x: g(x), lows.T, lengths.T, ndim=ndim,
                                **CPU)
    assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
    # 4 regions in 4D: no way to tell the axes apart
    with pytest.raises(ValueError, match="square region array"):
        TO.apply_cubature_rules(lambda x: x[..., 0], lows[:4], lengths[:4],
                                **CPU)
    with pytest.raises(ValueError, match="no axis of length"):
        TO.apply_cubature_rules(g, lows[:, :3], lengths[:, :3], **CPU)


def test_apply_cubature_rules_without_error():
    ndim = 3
    lows, lengths = _pool(ndim, 32, 4)
    g_t, g_j = genz.f2_product_peak(ndim, a=5.0), jax_genz.f2_product_peak(
        ndim, a=5.0)
    got = TO.apply_cubature_rules(g_t, lows, lengths, compute_error=False,
                                  **CPU)[0]
    ref = JO.apply_cubature_rules(g_j, lows, lengths, compute_error=False)[0]
    assert got.errorest == ref.errorest == float("inf")
    assert got.status == ref.status == -1
    assert got.neval == ref.neval == 32 * rule_eval.rule_tables(ndim).feval
    assert abs(got.estimate - ref.estimate) <= 1e-12 * abs(ref.estimate)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    lows, lengths = _pool(3, 4, 1)
    g = genz.f4_gaussian(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.apply_cubature_rules(g, lows, lengths)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.capture_func_evals(g, lows, lengths)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.apply_cubature_rules_vector(lambda x: x[..., :2], lows, lengths,
                                       ndim=3, ncomp=2)


def _rule_pool(seed, n=200):
    est_t = TO.apply_cubature_rules(genz.f4_gaussian(3, a=5.0),
                                    *_pool(3, n, seed), **CPU)
    return est_t[1].numpy(), est_t[2].numpy()


@pytest.mark.parametrize("hid", IDS)
def test_classify_with_heuristic_equal(hid):
    est, err = _rule_pool(5)
    rng = np.random.default_rng(hid)
    par_est = est * rng.uniform(1.5, 2.5, est.size)
    par_err = err * rng.uniform(0.5, 4.0, est.size)
    for eps in (1e-3, 1e-1):
        for parents in (None, (par_est, par_err)):
            kw = dict(depth=3, finished_estimate=1e-4,
                      finished_errorest=1e-7)
            if parents is not None:
                kw.update(parent_estimates=parents[0],
                          parent_errorests=parents[1])
            ref = np.asarray(JO.classify_with_heuristic(
                hid, jnp.asarray(est), jnp.asarray(err), eps,
                **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in kw.items()}))
            got = TO.classify_with_heuristic(
                hid, torch.as_tensor(est), torch.as_tensor(err), eps,
                **{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                       else v) for k, v in kw.items()})
            np.testing.assert_array_equal(got.numpy(), ref)
    # the default (own values as parents) and total_nregions / min_iter
    ref = np.asarray(JO.classify_with_heuristic(
        hid, jnp.asarray(est), jnp.asarray(err), 1e-2, total_nregions=5000,
        min_iter_reached=False))
    got = TO.classify_with_heuristic(hid, torch.as_tensor(est),
                                     torch.as_tensor(err), 1e-2,
                                     total_nregions=5000,
                                     min_iter_reached=False)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got.any()


def test_apply_cubature_rules_vector():
    ndim, ncomp = 3, 3
    lows, lengths = _pool(ndim, 48, 6)
    vol_t = Volume([0.0, -1.0, 0.5], [2.0, 1.0, 1.0])
    vol_j = JVolume([0.0, -1.0, 0.5], [2.0, 1.0, 1.0])

    def vec_t(x):
        r = torch.sum(x * x, dim=-1)
        return torch.stack([torch.exp(-r), torch.cos(x[..., 0]), r], dim=-1)

    def vec_j(x):
        r = jnp.sum(x * x, axis=-1)
        return jnp.stack([jnp.exp(-r), jnp.cos(x[..., 0]), r], axis=-1)

    ref_tot, ref_per = JO.apply_cubature_rules_vector(
        vec_j, lows, lengths, vol_j, ndim=ndim, ncomp=ncomp)
    for lo, ln in ((lows, lengths), (lows.T, lengths.T)):
        tot, per = TO.apply_cubature_rules_vector(
            vec_t, lo, ln, vol_t, ndim=ndim, ncomp=ncomp, **CPU)
        assert per.shape == (48, ncomp) and tot.shape == (ncomp,)
        # each component's region sums to reassociation roundoff
        scale = np.abs(ref_per).max(axis=0)
        np.testing.assert_allclose(per, np.asarray(ref_per), rtol=1e-12,
                                   atol=0)
        assert np.all(np.abs(tot - np.asarray(ref_tot))
                      <= 1e-12 * np.abs(ref_tot) + 1e-13 * 48 * scale)
    with pytest.raises(ValueError, match="expected"):
        TO.apply_cubature_rules_vector(vec_t, lows, lengths, ndim=ndim,
                                       ncomp=2, **CPU)


def _exact_product(x):
    # products only: the same bits in both packages (no FMA, no libm)
    return x[..., 0] * x[..., 1] * x[..., 2]


def test_capture_func_evals_and_csv():
    ndim = 3
    lows, lengths = _pool(ndim, 6, 8)
    vol_t = Volume([0.0, -1.0, 0.5], [2.0, 1.0, 1.5])
    vol_j = JVolume([0.0, -1.0, 0.5], [2.0, 1.0, 1.5])
    ref = JO.capture_func_evals(_exact_product, lows, lengths, vol_j)
    got = TO.capture_func_evals(_exact_product, lows, lengths, vol_t, **CPU)
    feval = rule_eval.rule_tables(ndim).feval
    assert got.points.shape == (6, feval, ndim)
    assert got.values.shape == (6, feval)
    # the reference's formula gl + (center - gen len) gr in f64, elementwise
    # in the same order: the same bits (held to 4 ulps of the magnitude)
    np.testing.assert_allclose(got.points, ref.points, rtol=0,
                               atol=4 * EPS * np.abs(ref.points).max())
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.values, ref.values)
    a, b = io.StringIO(), io.StringIO()
    got.to_csv(a)
    ref.to_csv(b)
    assert a.getvalue() == b.getvalue()
    lines = a.getvalue().splitlines()
    assert lines[0].startswith("reg,fid,dim0low") and len(lines) == 1 + 6 * feval
    # the printer alone on one record: EQUAL text
    rec = JO.FuncEvals(ref.points, ref.values, ref.region_lows,
                       ref.region_lengths)
    c, d = io.StringIO(), io.StringIO()
    TO.FuncEvals(ref.points, ref.values, ref.region_lows,
                 ref.region_lengths).to_csv(c)
    rec.to_csv(d)
    assert c.getvalue() == d.getvalue()


def test_capture_func_evals_genz_values_and_cap():
    ndim = 4
    lows, lengths = _pool(ndim, 10, 9)
    ref = JO.capture_func_evals(jax_genz.f4_gaussian(ndim, a=5.0), lows,
                                lengths)
    got = TO.capture_func_evals(genz.f4_gaussian(ndim, a=5.0), lows, lengths,
                                **CPU)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12, atol=0)
    big = np.zeros((1025, ndim)), np.full((1025, ndim), 0.1)
    with pytest.raises(ValueError, match="1024 regions"):
        TO.capture_func_evals(genz.f4_gaussian(ndim), *big, **CPU)
    with pytest.raises(ValueError):
        JO.capture_func_evals(jax_genz.f4_gaussian(ndim), *big)


def test_oneshot_outputs_held_by_kernel_check(monkeypatch):
    """The chip run's hold of the one-shot outputs against apply_rule_plain
    (``kernel_check.check_outputs_against_plain``): the CPU one-shot reads
    0 ulps beyond rtol and split_dim EQUAL; a planted est error fails."""
    from gpuintegration_torch.ops import kernel_check
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ndim = 5
    lows, lengths = _pool(ndim, 300, 12)
    g = genz.f4_gaussian(ndim, a=5.0)
    _, est, err, sdim = TO.apply_cubature_rules(g, lows, lengths, **CPU)
    t = [torch.as_tensor(np.ascontiguousarray(a.T)) for a in (lows, lengths)]
    gl, gr = torch.zeros(ndim, dtype=torch.float64), torch.ones(
        ndim, dtype=torch.float64)
    tables = rule_eval.rule_tables(ndim)
    bad = est.clone()
    bad[7] *= 1.0 + 1e-9
    r = kernel_check.check_outputs_against_plain(
        {"oneshot": (est, err, sdim)}, g, tables, *t, gl, gr, chunk=64)
    assert r["oneshot"]["regions"] == 300 and r["oneshot"]["agree"] == 1.0
    assert r["oneshot"]["est_ulps"] == r["oneshot"]["err_ulps"] == 0.0
    with pytest.raises(AssertionError, match="est"):
        kernel_check.check_outputs_against_plain(
            {"bad": (bad, err, sdim)}, g, tables, *t, gl, gr)
