"""The port's PAGANI continuation (``Workspace.integrate_to_convergence``,
``_partitioned_continuation``, ``utils.checkpoint.ContinuationState``,
``utils.profiling.StageTimer``) against the JAX package's, on the CPU.

The reference runs its ``fused=False`` host loop.  Both packages must end
with the same status, rounds (the stage timers' stage names), iterations,
regions, finished regions and neval; estimate and errorest within 64 ulps
of the estimate (ROADMAP C: an errorest far below the estimate agrees in
absolute terms only; the largest reading here was 0.37 ulps).

The integrands are asymmetric, Genz F3 and an off-centre Gaussian (b =
0.3): the continuation sorts slices by refined error with ``np.argsort``
(an unstable sort), and a centred Gaussian's exactly tied errors can be
ordered differently by the two packages.

The port runs with ``torch.set_flush_denormal(True)``: XLA on the CPU
flushes subnormal results, and the comparison is of the algorithm."""
import math
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.utils import checkpoint as jck
from gpuintegration_tpu.utils.profiling import StageTimer as JaxStageTimer
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils import profiling
from gpuintegration_torch.utils.checkpoint import ContinuationState
from gpuintegration_torch.utils.profiling import StageTimer

ULPS = 64
# the partitioned case: a 4D off-centre Gaussian whose single run walls at
# a 4096-region pool
PART = dict(ndim=4, params=dict(a=15.0, b=0.3), epsrel=1e-6,
            ws=dict(max_pool_regions=4096, chunk_size=128))


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
    limit = ULPS * np.finfo(np.float64).eps * abs(ref.estimate)
    assert abs(got.estimate - ref.estimate) <= limit
    assert abs(got.errorest - ref.errorest) <= limit


def _both(make, make_jax, ndim, epsrel, ws_kw, **kw):
    """The same integrate_to_convergence in both packages, each with its
    stage timer."""
    tj, tp = JaxStageTimer(), StageTimer()
    ref = JaxWorkspace(ndim, **ws_kw).integrate_to_convergence(
        make_jax(), epsrel=epsrel, epsabs=1e-40, fused=False, stage_timer=tj,
        **kw)
    got = Workspace(ndim, device="cpu", **ws_kw).integrate_to_convergence(
        make(), epsrel=epsrel, epsabs=1e-40, fused=False, stage_timer=tp,
        **kw)
    return got, ref, sorted(tp.times), sorted(tj.times)


def test_rounds_with_an_iteration_budget_match_jax():
    """Rounds of 4 iterations each stitched into a converged 3D run: the
    seeded ledger keeps the accuracy test honest across rounds."""
    got, ref, stages, ref_stages = _both(
        lambda: genz.f3_corner_peak(3), lambda: jax_genz.f3_corner_peak(3),
        3, 1e-9, dict(chunk_size=1024), max_iterations=4)
    _assert_same_run(got, ref)
    assert stages == ref_stages == ["resume_round2", "round1"]
    assert got.status == 0 and got.iters > 4
    truth = genz.f3_corner_peak(3).true_value
    assert abs(got.estimate - truth) <= max(got.errorest, 1e-9 * truth)


def test_no_progress_guard_matches_jax():
    """A round that does not bring the error below min_err_reduction times
    the previous round's ends the run unconverged."""
    got, ref, stages, ref_stages = _both(
        lambda: genz.f3_corner_peak(3), lambda: jax_genz.f3_corner_peak(3),
        3, 1e-12, dict(chunk_size=1024), max_iterations=2,
        min_err_reduction=1e-3)
    _assert_same_run(got, ref)
    # stopped by the guard, long before max_rounds (16) rounds
    assert stages == ref_stages and 2 <= len(stages) < 16
    assert got.status == 1


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """The JAX package's partitioned continuation of PART, written to a
    ContinuationState file before its first slice (a deadline already
    passed) and then resumed from that file by the JAX package itself."""
    d = tmp_path_factory.mktemp("continuation")
    g = jax_genz.f4_gaussian(PART["ndim"], **PART["params"])
    ws = JaxWorkspace(PART["ndim"], **PART["ws"])
    r1 = ws.integrate(g, epsrel=PART["epsrel"], epsabs=1e-40, fused=False)
    ck = ws.make_checkpoint()
    ws.final_pool = ws.final_pool_errors = None
    ws._partitioned_continuation(
        g, PART["epsrel"], 1e-40, None, ck, r1, 15,
        deadline=time.monotonic() - 1.0, state_path=str(d / "jax"),
        fused=False)
    shutil.copy(d / "jax.npz", d / "for_port.npz")
    timer = JaxStageTimer()
    ref = JaxWorkspace(PART["ndim"], **PART["ws"]).integrate_to_convergence(
        g, epsrel=PART["epsrel"], epsabs=1e-40, fused=False,
        state_path=str(d / "jax"), stage_timer=timer)
    assert not os.path.exists(d / "jax.npz")   # certified: spent
    return r1, ref, d / "for_port.npz", sorted(timer.times)


def _port_part():
    return (genz.f4_gaussian(PART["ndim"], **PART["params"]),
            Workspace(PART["ndim"], device="cpu", **PART["ws"]))


def test_partitioned_continuation_matches_jax(partitioned):
    """The single run walls at the 4096-region pool; the survivors go to
    hottest-first slices of 256 regions, and the global certificate ends the
    run.  The same run in both packages."""
    r1_ref, ref, _, _ = partitioned
    g, ws = _port_part()
    r1 = ws.integrate(g, epsrel=PART["epsrel"], epsabs=1e-40, fused=False)
    _assert_same_run(r1, r1_ref)
    assert r1.status == 1 and 4 * ws.make_checkpoint().lows.shape[0] > 4096
    timer = StageTimer()
    got = _port_part()[1].integrate_to_convergence(
        g, epsrel=PART["epsrel"], epsabs=1e-40, fused=False,
        stage_timer=timer)
    _assert_same_run(got, ref)
    assert sorted(timer.times) == ["round1", "slices"]
    assert timer.times["slices"] > 0
    assert got.status == 0 and got.iters > r1.iters
    assert abs(got.estimate - g.true_value) <= max(
        got.errorest, 1e-7 * g.true_value)


def test_jax_written_state_resumes_in_the_port(partitioned):
    """A ContinuationState file the JAX package wrote, loaded and resumed
    by the port, against the JAX package's own resume of it."""
    _, ref, path, ref_stages = partitioned
    st = ContinuationState.load(path)
    assert not st.vec and st.epsrel == PART["epsrel"]
    g, ws = _port_part()
    timer = StageTimer()
    got = ws.integrate_to_convergence(g, epsrel=PART["epsrel"], epsabs=1e-40,
                                      fused=False, state_path=str(path),
                                      stage_timer=timer)
    _assert_same_run(got, ref)
    assert sorted(timer.times) == ref_stages == ["slices"]
    assert not os.path.exists(path)   # certified: spent


def test_interrupt_and_resume_equals_the_uninterrupted_run(tmp_path):
    """A continuation stopped at a deadline saves its queue; resumed from
    the file it certifies the same bits as the run never stopped."""
    g, ws = _port_part()
    r1 = ws.integrate(g, epsrel=PART["epsrel"], epsabs=1e-40, fused=False)
    ck = ws.make_checkpoint()
    ws.final_pool = ws.final_pool_errors = None
    sp = str(tmp_path / "state")
    cut = ws._partitioned_continuation(
        g, PART["epsrel"], 1e-40, None, ck, r1, 15,
        deadline=time.monotonic() - 1.0, state_path=sp)
    assert cut.status == 1 and os.path.exists(sp + ".npz")
    # the stored sums make the cut result the whole integral already
    assert math.isclose(cut.estimate, r1.estimate, rel_tol=1e-12)
    resumed = ws.integrate_to_convergence(g, epsrel=PART["epsrel"],
                                          epsabs=1e-40, fused=False,
                                          state_path=sp)
    full = _port_part()[1]._partitioned_continuation(
        g, PART["epsrel"], 1e-40, None, ck, r1, 15, fused=False)
    assert resumed.status == full.status == 0
    assert (resumed.estimate, resumed.errorest, resumed.nregions,
            resumed.neval, resumed.iters) == (
        full.estimate, full.errorest, full.nregions, full.neval, full.iters)
    assert not os.path.exists(sp + ".npz")
    # a state answers only the tolerances it was built for
    ws._partitioned_continuation(g, PART["epsrel"], 1e-40, None, ck, r1, 15,
                                 deadline=time.monotonic() - 1.0,
                                 state_path=sp)
    with pytest.raises(ValueError, match="built for"):
        ws.integrate_to_convergence(g, epsrel=1e-5, epsabs=1e-40,
                                    state_path=sp)


def test_whole_pool_exit_saves_a_state_that_resumes(tmp_path):
    """An unconverged exit before the pool is split-starved saves its
    survivors as a slice queue; the resumed run certifies."""
    g = genz.f3_corner_peak(3)
    sp = str(tmp_path / "wp")
    ws = Workspace(3, chunk_size=1024, device="cpu")
    r = ws.integrate_to_convergence(g, epsrel=1e-9, epsabs=1e-40,
                                    max_rounds=1, max_iterations=3,
                                    fused=False, state_path=sp)
    assert r.status == 1 and os.path.exists(sp + ".npz")
    st = ContinuationState.load(sp)
    assert st.work_counts.sum() > 0 and st.work_exact.all()
    r = ws.integrate_to_convergence(g, epsrel=1e-9, epsabs=1e-40,
                                    fused=False, state_path=sp)
    assert r.status == 0 and not os.path.exists(sp + ".npz")
    assert abs(r.estimate - g.true_value) <= max(r.errorest,
                                                 1e-9 * g.true_value)


def test_continuation_state_files_cross_and_refuse_vectors(tmp_path):
    """A queue round-trips exactly and the port's file loads in the JAX
    package; a vector queue, which the port refused before it took vector
    integrands, now crosses both ways with its (nw, ncomp) sums."""
    rng = np.random.default_rng(3)
    work = [(rng.random((5, 3)), rng.random((5, 3)), 1.5, 0.25, 0, True),
            (rng.random((2, 3)), rng.random((2, 3)), -0.5, 0.125, 2, False)]
    st = ContinuationState.from_queue(work, 2.0, 0.5, 7, 1000, 64, 60, False,
                                      1e-6, 1e-40)
    st.save(tmp_path / "st")
    for back in (ContinuationState.load(tmp_path / "st"),
                 jck.ContinuationState.load(str(tmp_path / "st"))):
        q = back.to_queue()
        assert len(q) == 2 and not back.vec
        for a, b in zip(work, q):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2:] == tuple(b[2:])
        assert (back.iters, back.neval, back.nregions, back.nfinished) == (
            7, 1000, 64, 60)
    vwork = [(rng.random((4, 2)), rng.random((4, 2)), np.array([1.0, 2.0]),
              np.array([0.1, 0.2]), 1, True)]
    args = (np.array([3.0, 4.0]), np.array([0.3, 0.4]), 1, 10, 8, 8, True,
            1e-5, 1e-40)
    jck.ContinuationState.from_queue(vwork, *args).save(str(tmp_path / "j"))
    ContinuationState.from_queue(vwork, *args).save(tmp_path / "p")
    for back in (ContinuationState.load(tmp_path / "j"),
                 jck.ContinuationState.load(str(tmp_path / "p"))):
        assert back.vec and back.work_est.shape == (1, 2)
        np.testing.assert_array_equal(back.fin_est, args[0])
        (lo, ln, e, r, depth, exact), = back.to_queue()
        np.testing.assert_array_equal(lo, vwork[0][0])
        np.testing.assert_array_equal(ln, vwork[0][1])
        np.testing.assert_array_equal(e, vwork[0][2])
        np.testing.assert_array_equal(r, vwork[0][3])
        assert (depth, exact) == (1, True)
    assert ContinuationState.from_queue([], np.zeros(2), np.zeros(2), 0, 0,
                                        0, 0, True, 1e-5,
                                        1e-40).work_est.shape == (0, 2)


def test_stage_timer_adds_up_stages(monkeypatch):
    """On a scripted clock (the ``time`` that utils/profiling.py reads, not
    the global one): each stage takes its end tick minus its start tick, a
    repeated stage adds up, and the report is longest first.  Stage "a"
    (0.625 s) is longer than either run of "b" (0.25 s, 0.5 s) but shorter
    than their sum, so the order shows that the runs were added."""
    ticks = [1.0, 1.625, 2.0, 2.25, 3.0, 3.5]
    clock = iter(ticks)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=lambda: next(clock)))
    timer = StageTimer()
    for name in ("a", "b", "b"):
        with timer.stage(name):
            pass
    assert next(clock, None) is None           # two ticks a stage, no more
    assert timer.times == {"a": 0.625, "b": 0.75}
    rep = timer.report()
    assert list(rep) == ["b", "a"] and rep == {"b": 0.75, "a": 0.625}


def test_continuation_refuses_what_is_not_ported():
    """``mesh`` takes a DeviceMesh only; ``fused``, ``crease_split`` and
    ``vegas_assisted`` pass through to every round, and a vector refuses
    ``crease_split`` and ``vegas_assisted`` with the reference's reasons."""
    ws = Workspace(3, chunk_size=1024, device="cpu")
    g = genz.f3_corner_peak(3)
    # vegas_assisted's per-region Monte Carlo errors reach 1e-2 on F4 at
    # a = 5 in one round (a tight tolerance is out of a CPU test's reach)
    g4 = genz.f4_gaussian(3, a=5.0)
    r = ws.integrate_to_convergence(g4, epsrel=1e-2, epsabs=1e-40,
                                    vegas_assisted=True)
    assert r.status == 0 and abs(r.estimate - g4.true_value) <= 5 * r.errorest
    for name in ("fused", "crease_split"):
        r = ws.integrate_to_convergence(g, epsrel=1e-6, **{name: True})
        assert r.status == 0
        assert abs(r.estimate - g.true_value) <= 1e-6 * g.true_value

    def vector(x):
        return torch.stack([x[..., 0], x[..., 1]], dim=-1)

    # a vector integrand's continuation runs (both closed forms are 1/2),
    # fused too, and refuses what a vector refuses
    for fused in (False, True):
        r = ws.integrate_to_convergence(vector, epsrel=1e-6, fused=fused)
        assert r.status == 0 and np.allclose(r.estimates, 0.5, rtol=1e-12)
    with pytest.raises(ValueError, match="vegas_assisted"):
        ws.integrate_to_convergence(vector, vegas_assisted=True)
    with pytest.raises(ValueError, match="crease_split"):
        ws.integrate_to_convergence(vector, crease_split=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Workspace(3, device="cpu", mesh=object())
