"""Crease/jump-aware splitting in the port's host loop
(``Workspace.integrate(crease_split=True, fused=False)``) against the JAX
package's, on the CPU.

The runs are the reference's (tests/test_crease_split.py): the 3D C0 kink
off the dyadic grid, ``f5_c0_continuous(3, a=10, b=0.37)`` at 1e-9, and
Genz F6's jumps in 2D and 3D.  Discrete outcomes (status, iterations,
regions, finished regions, neval) must be equal; the estimate within 64
ulps of itself, the errorest within ``ERR_ULPS`` ulps of the estimate
(ROADMAP C's second reading: an errorest far below the estimate agrees
only in absolute terms; F6's is the cancelling null-rule residue of a
discontinuous integrand's values, which the packages' rule sums
reassociate, some 7000 ulps of the estimate apart at 2D).  The port runs
with ``torch.set_flush_denormal(True)``: XLA on the CPU flushes subnormal
results."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz

ULPS = 64
ERR_ULPS = 1 << 14
RUNS = {
    "f5_3d_kink": (lambda m: m.f5_c0_continuous(3, a=10.0, b=0.37), 3, 1e-9),
    "f6_2d_jump": (lambda m: m.f6_discontinuous(2), 2, 1e-6),
    "f6_3d_jump": (lambda m: m.f6_discontinuous(3), 3, 1e-5),
}
KW = dict(epsabs=1e-40, fused=False, max_iterations=80)


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


@pytest.fixture(scope="module")
def crease_runs():
    """Each case's crease run in both packages, host loop, chunk 1024."""
    out = {}
    for name, (make, ndim, eps) in RUNS.items():
        ref = JaxWorkspace(ndim, chunk_size=1024).integrate(
            make(jax_genz), epsrel=eps, crease_split=True, **KW)
        got = Workspace(ndim, chunk_size=1024, device="cpu").integrate(
            make(genz), epsrel=eps, crease_split=True, **KW)
        out[name] = (got, ref)
    return out


def _assert_same_run(got, ref):
    assert (got.status, got.iters, got.nregions, got.nFinishedRegions,
            got.neval) == (ref.status, ref.iters, ref.nregions,
                           ref.nFinishedRegions, ref.neval)
    ulp = np.spacing(abs(ref.estimate))
    assert abs(got.estimate - ref.estimate) <= ULPS * ulp
    assert abs(got.errorest - ref.errorest) <= ERR_ULPS * ulp


@pytest.mark.parametrize("name", sorted(RUNS))
def test_crease_runs_match_jax(crease_runs, name):
    got, ref = crease_runs[name]
    _assert_same_run(got, ref)
    assert got.status == 0
    g = RUNS[name][0](genz)
    eps = RUNS[name][2]
    assert abs(got.estimate - g.true_value) <= 3 * eps * abs(g.true_value)


def test_crease_cuts_neval_and_stays_honest(crease_runs):
    """The off-grid kink: both splittings certify honestly (the true error
    within 3x the tolerance), and the crease cut needs under 0.8 of the
    midpoint run's evaluations, as the reference's test asserts."""
    crease, _ = crease_runs["f5_3d_kink"]
    g = genz.f5_c0_continuous(3, a=10.0, b=0.37)
    mid = Workspace(3, chunk_size=1024, device="cpu").integrate(
        g, epsrel=1e-9, **KW)
    for r in (mid, crease):
        assert r.status == 0
        assert abs(r.estimate - g.true_value) / g.true_value < 3e-9
    assert crease.neval < 0.8 * mid.neval, (crease.neval, mid.neval)


def test_smooth_integrand_is_bit_identical():
    """No confident kink: every fraction is 0.5 and the trajectory is the
    midpoint path's bit for bit."""
    g = genz.f4_gaussian(3, a=5.0)
    runs = [Workspace(3, chunk_size=1024, device="cpu").integrate(
        g, epsrel=1e-6, crease_split=crease, **KW) for crease in (False,
                                                                  True)]
    a, b = runs
    assert (a.status, a.iters, a.neval, a.nregions, a.estimate,
            a.errorest) == (b.status, b.iters, b.neval, b.nregions,
                            b.estimate, b.errorest)


def test_guards_match_jax():
    """crease_split refuses vegas_assisted and a vector integrand with a
    ValueError in both packages."""
    g, g_jax = genz.f4_gaussian(2), jax_genz.f4_gaussian(2)
    for ws, f in ((Workspace(2, chunk_size=256, device="cpu"), g),
                  (JaxWorkspace(2, chunk_size=256), g_jax)):
        with pytest.raises(ValueError, match="crease_split"):
            ws.integrate(f, epsrel=1e-3, crease_split=True,
                         vegas_assisted=True)
    for ws, f in ((Workspace(2, chunk_size=256, device="cpu"),
                   lambda x: torch.stack([x[..., 0], x[..., 1]], -1)),
                  (JaxWorkspace(2, chunk_size=256),
                   lambda x: jnp.stack([x[..., 0], x[..., 1]], -1))):
        with pytest.raises(ValueError, match="crease_split"):
            ws.integrate(f, epsrel=1e-3, crease_split=True)


def test_continuation_passes_crease_split_through():
    """integrate_to_convergence forwards crease_split into every round:
    2D off-grid kink at 1e-8, six iterations a round, in both packages."""
    kw = dict(epsrel=1e-8, epsabs=1e-40, max_iterations=6,
              crease_split=True, fused=False)
    ref = JaxWorkspace(2, chunk_size=256).integrate_to_convergence(
        jax_genz.f5_c0_continuous(2, a=10.0, b=0.37), **kw)
    g = genz.f5_c0_continuous(2, a=10.0, b=0.37)
    got = Workspace(2, chunk_size=256, device="cpu").integrate_to_convergence(
        g, **kw)
    assert got.status == ref.status == 0
    assert (got.iters, got.neval, got.nregions) == (ref.iters, ref.neval,
                                                    ref.nregions)
    assert math.isclose(got.estimate, ref.estimate, rel_tol=1e-13)
    assert abs(got.estimate - g.true_value) / g.true_value < 3e-8
    mid = Workspace(2, chunk_size=256, device="cpu").integrate_to_convergence(
        g, **dict(kw, crease_split=False))
    assert got.neval < mid.neval
