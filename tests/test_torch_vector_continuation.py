"""The port's vector continuation (``integrate_to_convergence`` and
``_partitioned_continuation`` on (ncomp,) ledgers and (n, ncomp)
stashes, ``ContinuationState`` and ``PaganiCheckpoint`` of a vector run)
against the JAX package's, on the CPU.

The split-starved case is the reference's own
(``test_split_starved_vector_continuation_slices``): two components at
3D, epsrel 1e-8, a 4096-region pool, ``finish_epsrel_scale=0.4``.  Both
packages must take the same rounds, iterations, regions and neval, with
estimates and errorests within 64 ulps of each component's estimate.  The
port runs with ``torch.set_flush_denormal(True)``: XLA on the CPU flushes
subnormal results."""
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.utils import checkpoint as jck
from gpuintegration_tpu.utils.profiling import StageTimer as JaxStageTimer
from gpuintegration_torch import Workspace, convert
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils.checkpoint import (ContinuationState,
                                                   PaganiCheckpoint)
from gpuintegration_torch.utils.profiling import StageTimer

ND, EPS, ULPS = 3, 1e-8, 64
WS = dict(chunk_size=256, max_pool_regions=4096)
KW = dict(finish_epsrel_scale=0.4)
PKW = dict(KW, fused=False)         # the port's calls: the host loop
COMPS = [genz.f4_gaussian(ND, a=8.0), genz.f2_product_peak(ND)]
JAX_COMPS = [jax_genz.f4_gaussian(ND, a=8.0), jax_genz.f2_product_peak(ND)]
TRUTHS = np.array([c.true_value for c in COMPS])


def fv(x):
    return torch.stack([c(x) for c in COMPS], dim=-1)


def fv_jax(x):
    return jnp.stack([c(x) for c in JAX_COMPS], axis=-1)


fv.ndim = fv_jax.ndim = ND


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


def test_split_starved_vector_continuation_matches_jax():
    """Round 1 walls at the 4096-region pool; the partitioned continuation
    slices the survivors by their worst component and certifies every
    component, in both packages alike."""
    tj, tp = JaxStageTimer(), StageTimer()
    ref = JaxWorkspace(ND, **WS).integrate_to_convergence(
        fv_jax, epsrel=EPS, epsabs=1e-40, max_rounds=40, fused=False,
        stage_timer=tj, **KW)
    ws = Workspace(ND, device="cpu", **WS)
    runs, integrate = [0], ws.integrate

    def counted(*a, **k):
        runs[0] += 1
        return integrate(*a, **k)

    ws.integrate = counted
    got = ws.integrate_to_convergence(fv, epsrel=EPS, epsabs=1e-40,
                                      max_rounds=40, stage_timer=tp, **PKW)
    _assert_same_run(got, ref)
    assert sorted(tp.times) == sorted(tj.times) == ["round1", "slices"]
    assert got.status == 0 and runs[0] > 2        # round 1 and the slices
    assert np.all(got.errorests <= EPS * np.abs(got.estimates) * (1 + 1e-12))
    assert np.all(np.abs(got.estimates - TRUTHS) <= 10 * EPS * TRUTHS)


def test_vector_state_files_cross_both_ways(tmp_path):
    """A vector run's PaganiCheckpoint and ContinuationState written by one
    package load in the other with the same arrays."""
    ws = Workspace(ND, device="cpu", **WS)
    r1 = ws.integrate(fv, epsrel=EPS, epsabs=1e-40, **PKW)
    ck = ws.make_checkpoint()
    assert ck.region_errorests.shape == (ck.lows.shape[0], 2)
    ck.save(tmp_path / "ck")
    back = jck.PaganiCheckpoint.load(str(tmp_path / "ck"))
    for name in ("lows", "estimate", "errorest", "region_estimates",
                 "region_errorests"):
        np.testing.assert_array_equal(getattr(back, name), getattr(ck, name))
    back.save(str(tmp_path / "ck_jax"))
    mine = PaganiCheckpoint.load(tmp_path / "ck_jax")
    np.testing.assert_array_equal(mine.region_errorests, ck.region_errorests)
    np.testing.assert_array_equal(mine.estimate, ck.estimate)
    assert convert.checkpoint_from_reference(back).estimate.shape == (2,)

    ws.final_pool = ws.final_pool_errors = None
    sp = str(tmp_path / "state")
    ws._partitioned_continuation(fv, EPS, 1e-40, None, ck, r1, 39,
                                 deadline=time.monotonic() - 1.0,
                                 state_path=sp, **PKW)
    st = ContinuationState.load(sp)
    assert st.vec and st.work_est.shape == (len(st.work_counts), 2)
    j = jck.ContinuationState.load(sp)
    for a, b in zip(st.to_queue(), j.to_queue()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    j.save(str(tmp_path / "state_jax"))
    again = ContinuationState.load(tmp_path / "state_jax")
    np.testing.assert_array_equal(again.work_err, st.work_err)
    np.testing.assert_array_equal(again.fin_est, st.fin_est)


def test_vector_stop_save_resume_gives_the_same_bits(tmp_path):
    """A vector continuation stopped before its first slice saves its
    queue; resumed from the file it gives the uninterrupted run's bits,
    and the spent file is removed."""
    ws = Workspace(ND, device="cpu", **WS)
    full = ws.integrate_to_convergence(fv, epsrel=EPS, epsabs=1e-40,
                                       max_rounds=40, **PKW)
    ws = Workspace(ND, device="cpu", **WS)
    r1 = ws.integrate(fv, epsrel=EPS, epsabs=1e-40, **PKW)
    ck = ws.make_checkpoint()
    ws.final_pool = ws.final_pool_errors = None
    sp = str(tmp_path / "state")
    cut = ws._partitioned_continuation(fv, EPS, 1e-40, None, ck, r1, 39,
                                       deadline=time.monotonic() - 1.0,
                                       state_path=sp, **PKW)
    assert cut.status == 1 and os.path.exists(sp + ".npz")
    np.testing.assert_allclose(cut.estimates, r1.estimates, rtol=1e-12)
    resumed = Workspace(ND, device="cpu", **WS).integrate_to_convergence(
        fv, epsrel=EPS, epsabs=1e-40, max_rounds=40, state_path=sp, **PKW)
    assert resumed.status == full.status == 0
    assert list(resumed.estimates) == list(full.estimates)
    assert list(resumed.errorests) == list(full.errorests)
    assert (resumed.neval, resumed.iters, resumed.nregions) == (
        full.neval, full.iters, full.nregions)
    assert not os.path.exists(sp + ".npz")


def test_vector_whole_pool_exit_saves_a_vector_state(tmp_path):
    """An unconverged exit before the pool is split-starved saves the
    survivors as a vector slice queue, which a later call resumes."""
    sp = str(tmp_path / "wp")
    ws = Workspace(ND, chunk_size=1024, device="cpu")
    r = ws.integrate_to_convergence(fv, epsrel=1e-8, epsabs=1e-40,
                                    max_rounds=1, max_iterations=3,
                                    fused=False, state_path=sp)
    assert r.status == 1 and os.path.exists(sp + ".npz")
    st = ContinuationState.load(sp)
    assert st.vec and st.fin_est.shape == (2,) and st.work_exact.all()
    r = ws.integrate_to_convergence(fv, epsrel=1e-8, epsabs=1e-40,
                                    fused=False, state_path=sp)
    assert r.estimates.shape == (2,) and r.iters > 0
    assert np.all(np.abs(r.estimates - TRUTHS) <= np.maximum(
        5 * r.errorests, 1e-9 * TRUTHS))
