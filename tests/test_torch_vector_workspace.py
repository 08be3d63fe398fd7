"""The port's vector PAGANI host loop (``Workspace._integrate_vector``,
``iteration_math_vector``, ``two_level.refine_error_vector``,
``region_pool.compact`` on (ncomp, cap) arrays) against the JAX package's
``fused=False`` vector loop, on the CPU.

Discrete outcomes (status, iterations, regions, finished regions, neval)
must be equal; estimates and errorests agree within 64 ulps of each
component's estimate, never relatively (F1's and F5's errorest lies far
below the estimate).  The port runs with ``torch.set_flush_denormal(True)``:
XLA on the CPU flushes subnormal results."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.pagani import region_pool as jax_region_pool
from gpuintegration_tpu.pagani import two_level as jax_two_level
from gpuintegration_tpu.pagani import workspace as jax_workspace
from gpuintegration_torch import Workspace, convert
from gpuintegration_torch.models import genz
from gpuintegration_torch.pagani import region_pool, two_level, workspace
from gpuintegration_torch.utils.checkpoint import PaganiCheckpoint

ND = 3
ULPS = 64
NAMES = ["f1_oscillatory", "f2_product_peak", "f4_gaussian", "f5_c0"]
JAX_MEMBERS = [jax_genz.f1_oscillatory(ND), jax_genz.f2_product_peak(ND),
               jax_genz.f4_gaussian(ND, a=5.0),
               jax_genz.f5_c0_continuous(ND)]
MEMBERS = [genz.f1_oscillatory(ND), genz.f2_product_peak(ND),
           genz.f4_gaussian(ND, a=5.0), genz.f5_c0_continuous(ND)]
TRUTHS = np.array([m.true_value for m in MEMBERS])


def fvec(x):
    return torch.stack([m(x) for m in MEMBERS], dim=-1)


def fvec_jax(x):
    return jnp.stack([m(x) for m in JAX_MEMBERS], axis=-1)


fvec.ndim = fvec_jax.ndim = ND


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _assert_same_run(got, ref):
    assert (got.status, got.iters, got.nregions, got.nFinishedRegions,
            got.neval) == (ref.status, ref.iters, ref.nregions,
                           ref.nFinishedRegions, ref.neval)
    limit = ULPS * np.finfo(np.float64).eps * np.abs(ref.estimates)
    assert np.all(np.abs(got.estimates - ref.estimates) <= limit)
    assert np.all(np.abs(got.errorests - ref.errorests) <= limit)
    assert got.estimate == got.estimates[0]
    assert got.errorest == got.errorests[0]


def test_vector_run_matches_jax():
    ref = JaxWorkspace(ND, chunk_size=1024).integrate(
        fvec_jax, epsrel=1e-6, epsabs=1e-40, fused=False)
    got = Workspace(ND, chunk_size=1024, device="cpu").integrate(
        fvec, epsrel=1e-6, epsabs=1e-40, fused=False)
    _assert_same_run(got, ref)
    assert got.status == 0 and got.estimates.shape == (4,)
    for i in range(4):
        assert abs(got.estimates[i] - TRUTHS[i]) <= max(
            5 * got.errorests[i], 1e-9 * abs(TRUTHS[i]))


def test_accuracy_needs_all_components():
    """The easy components converge long before the hard one: three
    iterations are not enough for all of them, so the run is status 1."""
    r = Workspace(ND, chunk_size=1024, device="cpu").integrate(
        fvec, epsrel=1e-7, epsabs=1e-40, max_iterations=3)
    assert r.status == 1 and r.iters == 3


def test_epsabs_driven_run_retires_regions():
    """The rollback's budget is max(epsrel |est|, epsabs): with epsrel 0 an
    epsabs-driven run still retires regions (the reference's
    test_pagani_vector_epsabs_driven_retires_regions)."""
    members = [genz.f4_gaussian(ND, a=5.0), genz.f4_gaussian(ND, a=8.0)]

    def g2(x):
        return torch.stack([m(x) for m in members], dim=-1)

    epsabs = 2e-8
    r = Workspace(ND, chunk_size=1024, device="cpu").integrate(
        g2, epsrel=0.0, epsabs=epsabs, finish_abs_per_vol=0.3 * epsabs)
    assert r.status == 0 and r.nFinishedRegions > 0
    for i, m in enumerate(members):
        assert abs(r.estimates[i] - m.true_value) <= epsabs


def test_vector_ledger_resumes(tmp_path):
    """A budget-limited vector run checkpoints (ncomp,) ledgers and (n,
    ncomp) region arrays, round-trips them through the file, and resumes
    to a tolerance the first round could not reach; a scalar ledger with
    a vector integrand is refused."""
    ws = Workspace(ND, chunk_size=1024, device="cpu")
    r1 = ws.integrate(fvec, epsrel=1e-7, epsabs=1e-40, max_iterations=4,
                      fused=False)
    assert r1.status == 1
    ck = ws.make_checkpoint()
    assert ck.estimate.shape == (4,)
    assert ck.region_errorests.shape == (ck.lows.shape[0], 4)
    ck.save(tmp_path / "ck")
    ck2 = PaganiCheckpoint.load(tmp_path / "ck")
    np.testing.assert_array_equal(ck.estimate, ck2.estimate)
    np.testing.assert_array_equal(ck.region_estimates, ck2.region_estimates)
    r2 = ws.integrate(fvec, epsrel=1e-7, epsabs=1e-40,
                      initial_regions=(ck2.lows, ck2.lengths),
                      ledger=ck2.ledger)
    assert r2.status == 0 and r2.iters > r1.iters
    assert np.all(np.abs(r2.estimates - TRUTHS) <= 1e-6 * np.abs(TRUTHS))
    with pytest.raises(ValueError, match="vector ledger"):
        ws.integrate(fvec, epsrel=1e-3, ledger=(0.0, 0.0, 0, 0, 0))


def test_jax_vector_pool_resumes_in_the_port():
    """A vector run the JAX package began, carried across by convert, is
    finished by both packages alike."""
    ws = JaxWorkspace(ND, chunk_size=1024)
    ws.integrate(fvec_jax, epsrel=1e-6, epsabs=1e-40, fused=False,
                 max_iterations=3)
    ck = convert.checkpoint_from_reference(ws.make_checkpoint())
    assert ck.estimate.shape == (4,) and ck.region_errorests.shape[1] == 4
    ledger = convert.ledger_from_reference(ws._ledger_excl_pool)
    np.testing.assert_array_equal(ledger[0], ck.estimate)
    ref = JaxWorkspace(ND, chunk_size=1024).integrate(
        fvec_jax, epsrel=1e-6, epsabs=1e-40, fused=False,
        initial_regions=(ck.lows, ck.lengths), ledger=ck.ledger)
    got = Workspace(ND, chunk_size=1024, device="cpu").integrate(
        fvec, epsrel=1e-6, epsabs=1e-40, fused=False,
        initial_regions=(ck.lows, ck.lengths), ledger=ledger)
    _assert_same_run(got, ref)


def test_two_equal_components_are_the_scalar_run():
    g = genz.f2_product_peak(ND, a=5.0)

    def gg(x):
        return torch.stack([g(x), g(x)], dim=-1)

    for kw in ({}, {"max_pool_regions": 4096}):
        s = Workspace(ND, chunk_size=1024, device="cpu", **kw).integrate(
            g, epsrel=1e-7, epsabs=1e-40)
        v = Workspace(ND, chunk_size=1024, device="cpu", **kw).integrate(
            gg, epsrel=1e-7, epsabs=1e-40)
        assert (v.status, v.iters, v.nregions, v.nFinishedRegions,
                v.neval) == (s.status, s.iters, s.nregions,
                             s.nFinishedRegions, s.neval)
        assert list(v.estimates) == [s.estimate] * 2
        assert list(v.errorests) == [s.errorest] * 2


def _vector_sweep(seed, ncomp=3, cap=64, n=48):
    rng = np.random.default_rng(seed)
    est = rng.normal(1.0, 0.3, (ncomp, cap))
    err = rng.uniform(1e-8, 1e-4, (ncomp, cap))
    parents = rng.normal(2.0, 0.5, (ncomp, cap // 2))
    lengths = rng.uniform(0.05, 0.5, (ND, cap))
    return est, err, parents, lengths, n


@pytest.mark.parametrize("relerr", [True, False])
@pytest.mark.parametrize("apv", [None, 1e-4])
def test_refine_and_iteration_math_match_jax(relerr, apv):
    est, err, parents, lengths, n = _vector_sweep(3)
    vol = np.prod(lengths, axis=0)
    ref = jax_two_level.refine_error_vector(
        jnp.asarray(est), jnp.asarray(err), jnp.asarray(parents), n, 1e-5,
        relerr_classification=relerr,
        volumes=None if apv is None else jnp.asarray(vol), abs_per_vol=apv)
    got = two_level.refine_error_vector(
        torch.as_tensor(est), torch.as_tensor(err), torch.as_tensor(parents),
        n, 1e-5, relerr_classification=relerr,
        volumes=None if apv is None else torch.as_tensor(vol),
        abs_per_vol=apv)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-15, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for blocked, use_refine in ((True, True), (False, False)):
        ref = jax_workspace.iteration_math_vector(
            relerr, blocked, jnp.asarray(est), jnp.asarray(err), n,
            jnp.asarray(parents), use_refine, 1e-5,
            lengths=jnp.asarray(lengths), abs_per_vol=apv)
        e, r, a, scalars = workspace.iteration_math_vector(
            relerr, blocked, torch.as_tensor(est), torch.as_tensor(err), n,
            torch.as_tensor(parents), use_refine, 1e-5,
            lengths=torch.as_tensor(lengths), abs_per_vol=apv)
        np.testing.assert_array_equal(e.numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(r.numpy(), np.asarray(ref[1]),
                                   rtol=1e-15, atol=0)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref[2]))
        want = np.concatenate([np.asarray(x).reshape(-1) for x in ref[3:]])
        assert scalars.dtype == torch.float64 and scalars.shape == (13,)
        np.testing.assert_allclose(scalars.numpy(), want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want[:3]).max())


def test_compact_moves_components():
    """compact moves (ncomp, cap) estimates and errorests with the regions,
    as the reference's; each component as the scalar compaction moves it."""
    est, err, _, lengths, _ = _vector_sweep(5)
    cap = est.shape[1]
    rng = np.random.default_rng(6)
    active = (rng.random(cap) < 0.4).astype(np.float64)
    lows = rng.uniform(0, 0.5, (ND, cap))
    sdim = rng.integers(0, ND, cap).astype(np.int32)
    t = [torch.as_tensor(a) for a in (active, lows, lengths, sdim, est, err)]
    got = region_pool.compact(*t, out_capacity=32)
    ref = jax_region_pool.compact(
        *[jnp.asarray(a) for a in (active, lows, lengths, sdim, est, err)],
        out_capacity=32)
    k = int(active.sum())
    for g, r in zip(got, ref[1:]):
        np.testing.assert_array_equal(g.numpy()[..., :k],
                                      np.asarray(r)[..., :k])
    assert got[3].shape == got[4].shape == (3, 32)
    for c in range(3):
        one = region_pool.compact(*t[:4], t[4][c], t[5][c], out_capacity=32)
        assert torch.equal(one[3], got[3][c]) and torch.equal(one[4],
                                                              got[4][c])
