"""The port's pool stages against the JAX package's: uniform split,
compaction, bisection, two-level refinement, the per-iteration reductions
and the heuristic classifier.  Real slots (by block_mask) are bitwise
equal; padding slots are finite."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.pagani import classifier as jax_classifier
from gpuintegration_tpu.pagani import region_pool as jax_pool
from gpuintegration_tpu.pagani import two_level as jax_two_level
from gpuintegration_tpu.pagani import workspace as jax_workspace
from gpuintegration_torch.pagani import classifier, region_pool, two_level
from gpuintegration_torch.pagani import workspace


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("ndim,parts,cap", [(2, 4, 16), (3, 4, 128),
                                            (5, 2, 64), (4, 3, 128)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_split_bitwise(ndim, parts, cap, dtype):
    ref_lo, ref_ln, ref_n = jax_pool.uniform_split(ndim, parts, cap,
                                                   jnp.dtype(dtype))
    lo, ln, n = region_pool.uniform_split(ndim, parts, cap,
                                          getattr(torch, dtype))
    assert n == ref_n
    assert lo.numpy().tobytes() == _np(ref_lo).tobytes()
    assert ln.numpy().tobytes() == _np(ref_ln).tobytes()


@pytest.mark.parametrize("blocked", [False, True])
def test_block_mask(blocked):
    for cap, n in ((16, 6), (64, 64), (64, 0), (128, 22)):
        np.testing.assert_array_equal(
            region_pool.block_mask(cap, n, blocked).numpy(),
            _np(jax_pool.block_mask(cap, jnp.asarray(n), blocked)))


def _random_pool(rng, ndim, cap):
    lows = rng.uniform(size=(ndim, cap))
    lengths = rng.uniform(0.01, 1.0, size=(ndim, cap))
    sdim = rng.integers(0, ndim, cap).astype(np.int32)
    est = rng.normal(size=cap)
    err = rng.uniform(size=cap)
    return lows, lengths, sdim, est, err


@pytest.mark.parametrize("seed", range(6))
def test_compact_split_bitwise(seed):
    """compact then split on random masks, in and out capacities as the
    Workspace picks them."""
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([16, 64, 256, 1024]))
    ndim = int(rng.integers(2, 6))
    n = int(rng.integers(1, cap // 2 + 1)) * 2
    mask = _np(jax_pool.block_mask(cap, jnp.asarray(n), True))
    active = ((rng.uniform(size=cap) < rng.uniform()) & mask).astype(float)
    pool = _random_pool(rng, ndim, cap)
    n_active = int(active.sum())
    out_cap = max(region_pool.next_pow2(2 * max(n_active, 1)), 16) // 2

    ref = jax_pool.compact(jnp.asarray(active), *map(jnp.asarray, pool),
                           out_capacity=out_cap)
    got = region_pool.compact(torch.as_tensor(active),
                              *map(torch.as_tensor, pool),
                              out_capacity=out_cap)
    assert int(ref[0]) == n_active
    for g, r in zip(got, ref[1:]):
        g, r = g.numpy(), _np(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g[..., :n_active], r[..., :n_active])
        assert np.isfinite(g).all()

    ref_split = jax_pool.split(ref[1], ref[2], ref[3], ref[0],
                               out_capacity=2 * out_cap)
    lo, ln, n_children = region_pool.split(got[0], got[1], got[2], n_active,
                                           out_capacity=2 * out_cap)
    assert n_children == int(ref_split[2]) == 2 * n_active
    real = region_pool.block_mask(2 * out_cap, n_children, True).numpy()
    for g, r in ((lo, ref_split[0]), (ln, ref_split[1])):
        np.testing.assert_array_equal(g.numpy()[:, real], _np(r)[:, real])
        assert np.isfinite(g.numpy()).all()


def test_split_refuses_wrong_capacity():
    lo = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="out_capacity"):
        region_pool.split(lo, lo, torch.zeros(4, dtype=torch.int32), 4,
                          out_capacity=16)


def _refine_inputs(rng, cap, n, dtype):
    est = rng.normal(size=cap).astype(dtype)
    err = np.abs(rng.normal(size=cap)).astype(dtype) * 1e-3
    err[rng.uniform(size=cap) < 0.1] = 0.0
    parents = (rng.normal(size=cap // 2) * 2).astype(dtype)
    return est, err, parents


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("abs_per_vol", [None, 0.05])
def test_refine_error_bitwise(dtype, abs_per_vol):
    rng = np.random.default_rng(3)
    cap, n = 256, 180
    est, err, parents = _refine_inputs(rng, cap, n, dtype)
    vols = rng.uniform(size=cap).astype(dtype)
    eps = np.asarray(1e-3, dtype)
    ref = jax_two_level.refine_error(
        jnp.asarray(est), jnp.asarray(err), jnp.asarray(parents),
        jnp.asarray(n), jnp.asarray(eps),
        volumes=None if abs_per_vol is None else jnp.asarray(vols),
        abs_per_vol=abs_per_vol)
    got = two_level.refine_error(
        torch.as_tensor(est), torch.as_tensor(err), torch.as_tensor(parents),
        n, float(eps),
        volumes=None if abs_per_vol is None else torch.as_tensor(vols),
        abs_per_vol=abs_per_vol)
    for g, r in zip(got, ref):
        assert g.numpy().tobytes() == _np(r).tobytes()


def test_f32_floor_is_tiny():
    """The 1e-200 retirement floor underflows in f32; finfo.tiny keeps a
    zero-estimate, zero-error region retirable."""
    z = torch.zeros(4, dtype=torch.float32)
    _, active = two_level.refine_error(z, z, z[:2], 4, 1e-3)
    assert not active.any()


@pytest.mark.parametrize("use_refine", [False, True])
def test_iteration_math(use_refine):
    rng = np.random.default_rng(4)
    cap, n = 128, 90
    est, err, parents = _refine_inputs(rng, cap, n, "float64")
    ref = jax_workspace.iteration_math(
        True, True, jnp.asarray(est), jnp.asarray(err), jnp.asarray(n),
        jnp.asarray(parents), jnp.asarray(use_refine), jnp.asarray(1e-3))
    got = workspace.iteration_math(
        True, True, torch.as_tensor(est), torch.as_tensor(err), n,
        torch.as_tensor(parents), use_refine, 1e-3)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), _np(r))
    scalars = got[3].numpy()
    assert scalars.dtype == np.float64
    np.testing.assert_allclose(scalars, [float(v) for v in ref[3:]],
                               rtol=1e-13, atol=1e-15)
    assert scalars[4] == float(ref[7])


def test_accuracy_and_partitions_match():
    for args in ((1e-3, 1e-12, 1.0, 1e-4), (1e-3, 1e-12, 0.0, 1e-13),
                 (1e-3, 1e-12, 1.0, 1e-2)):
        assert (workspace.accuracy_reached(*args)
                == jax_workspace.accuracy_reached(*args))
    for ndim in range(2, 13):
        assert (workspace.default_partitions_per_axis(ndim)
                == jax_workspace.default_partitions_per_axis(ndim))


@pytest.mark.parametrize("max_pool", [60, 400, 4000])
def test_classify_ladder_matches(max_pool):
    rng = np.random.default_rng(max_pool)
    cap, n = 512, 400
    err = np.exp(rng.uniform(-30, -5, cap))
    err[:7] = 0.0
    mask = np.arange(cap) < n
    iter_err = float(err[mask].sum())
    results = []
    for mod, to in ((jax_classifier, jnp.asarray),
                    (classifier, torch.as_tensor)):
        c = mod.HeuristicClassifier(1e-3, 1e-20, max_pool)
        for v in (1.23456, 1.23457, 1.23456):
            c.store_estimate(v)
        res = c.classify_ladder(to(err), to(mask), n, iter_err,
                                0.1 * iter_err, 0.0)
        flags = None if res.active_flags is None else np.asarray(
            res.active_flags)
        results.append((res.pass_mem, res.pass_errorest_budget,
                        res.threshold, res.num_active, flags,
                        c.classification_criteria_met(n), c.split_fits(n),
                        c.sig_digits_same()))
    (a, b) = results
    assert a[:4] == b[:4] and a[5:] == b[5:]
    if a[4] is None:
        assert b[4] is None
    else:
        np.testing.assert_array_equal(a[4], b[4])


def test_classify_bisection_matches():
    rng = np.random.default_rng(8)
    cap, n = 256, 200
    err = np.exp(rng.uniform(-20, -5, cap))
    mask = np.arange(cap) < n
    iter_err = float(err[mask].sum())
    out = []
    for mod, to in ((jax_classifier, jnp.asarray),
                    (classifier, torch.as_tensor)):
        c = mod.HeuristicClassifier(1e-3, 1e-20, 300)
        c.store_estimate(2.0)
        res = c.classify(to(err), to(mask), n, iter_err, 0.0, 0.0)
        out.append((res.pass_mem, res.pass_errorest_budget, res.threshold,
                    res.num_active, np.asarray(res.active_flags)))
    assert out[0][:4] == out[1][:4]
    np.testing.assert_array_equal(out[0][4], out[1][4])


@pytest.mark.parametrize("estimates", [
    (1.2345678, 1.2345679, 1.2345671), (0.001234, 0.0012341, 0.001234),
    (5.0, 5.0, 5.0), (float("nan"), 1.0, 1.0), (0.0, 0.0, 0.0)])
def test_sig_digits_same(estimates):
    a = jax_classifier.HeuristicClassifier(1e-4, 0.0, 100)
    b = classifier.HeuristicClassifier(1e-4, 0.0, 100)
    for v in estimates:
        a.store_estimate(v)
        b.store_estimate(v)
    assert a.sig_digits_same() == b.sig_digits_same()
    assert a.estimate_converged() == b.estimate_converged()
