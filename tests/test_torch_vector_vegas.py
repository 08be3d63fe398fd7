"""The port's vector VEGAS (``mcubes.vegas`` on an integrand (..., ncomp):
(ncomp,) accumulators, the grid adapted to component 0) against the JAX
package's, on the CPU.

* One iteration on injected uniforms (tests/test_torch_vegas_iteration.py's
  pattern: ``jax.random.uniform`` or ``jax.random.bits`` patched, the same
  words handed to the port through ``bits=``), the grid map and the poly
  map ('torch' against the reference's 'xla', run eagerly under
  ``jax.disable_jit``; 'hybrid' against the reference's 'hybrid' kernel in
  interpret mode): ti and tsi per component to 1e-12 (1e-5 for 'hybrid',
  whose Chebyshev recurrence the kernel may contract differently, as in
  the scalar test), the histogram the scalar run's of component 0 bit for
  bit, and the reference's as the scalar test holds it.
* Whole runs, statistically: on the reference's 3D members each component
  within 5 errorests of its closed form; ``probs``, ``prob`` and
  ``chi_sq`` by the reference's rules.
"""
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.mcubes.poly_importance import fit_importance_poly
from gpuintegration_tpu.mcubes.vegas import VegasState as JaxVegasState
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch import convert, mcubes
from gpuintegration_torch.mcubes import debug
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils.checkpoint import (load_vegas_state,
                                                   save_vegas_state)
from gpuintegration_torch.utils.stats import chi2_prob

NDIM, NG, NPG, NBINS = 3, 6, 2, 50
NCUBES = NG ** NDIM                      # 216 cubes in a chunk of 256
CHUNK = 256
MEMBERS = [genz.f1_oscillatory(NDIM), genz.f2_product_peak(NDIM),
           genz.f4_gaussian(NDIM, a=5.0), genz.f5_c0_continuous(NDIM)]
TRUTHS = np.array([m.true_value for m in MEMBERS])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fvec(x):
    return torch.stack([m(x) for m in MEMBERS], dim=-1)


fvec.ndim = NDIM
# the iteration tests' pair: two Gaussians of other widths
PAIR = [(genz.f4_gaussian(NDIM, a=3.0), jax_genz.f4_gaussian(NDIM, a=3.0)),
        (genz.f4_gaussian(NDIM, a=5.0, b=0.4),
         jax_genz.f4_gaussian(NDIM, a=5.0, b=0.4))]


def _pair():
    def ft(x):
        return torch.stack([t(x) for t, _ in PAIR], dim=-1)

    def fj(x):
        return jnp.stack([j(x) for _, j in PAIR], axis=-1)

    return ft, fj


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((NDIM, NBINS)) + 0.05
    xi = np.concatenate([np.zeros((NDIM, 1)), np.cumsum(w, axis=1)], axis=1)
    xi /= xi[:, -1:]
    bits = rng.integers(0, 2 ** 32, (NPG * NDIM, CHUNK),
                        dtype=np.uint64).astype(np.uint32)
    lo, hi = np.array([0.1, -0.5, 0.2]), np.array([0.9, 1.0, 1.4])
    xjac = float(np.prod(hi - lo)) / (NPG * NCUBES)
    return xi, bits, lo, hi - lo, xjac


def _ran(bits):
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return jnp.asarray(np.moveaxis(u.reshape(NPG, NDIM, CHUNK), -1, 0))


def _check(sums, d, ref, scalar_d, rtol):
    ti, tsi, d_ref = (np.asarray(r) for r in ref)
    assert tuple(sums.shape) == (2, 2)
    np.testing.assert_allclose(sums[0].numpy(), ti, rtol=rtol, atol=0)
    np.testing.assert_allclose(sums[1].numpy(), tsi, rtol=rtol, atol=0)
    assert d_ref.sum() > 0 and torch.equal(d, scalar_d)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=max(rtol, 1e-6),
                               atol=1e-6 * d_ref.max())


def test_grid_iteration_matches_reference():
    xi, bits, lo, dx, xjac = _setup()
    ft, fj = _pair()
    with mock.patch("jax.random.uniform", return_value=_ran(bits)), \
            jax.disable_jit():
        ref = JV._vegas_iteration.__wrapped__(
            fj, NDIM, NG, NPG, CHUNK, 1, NBINS, True, "float64",
            jax.random.PRNGKey(0), jnp.asarray(xi), jnp.asarray(lo),
            jnp.asarray(dx), jnp.asarray(xjac), jnp.asarray(NCUBES, jnp.int64),
            ncomp=2)
    args = (NDIM, NG, NPG, CHUNK, 1, NBINS, True, torch.float64, 0, 1,
            torch.as_tensor(xi), torch.as_tensor(lo), torch.as_tensor(dx),
            xjac, NCUBES)
    b = torch.as_tensor(bits.view(np.int32))
    sums, d = V._vegas_iteration(ft, *args, bits=b, ncomp=2)
    s0, d0 = V._vegas_iteration(PAIR[0][0], *args, bits=b)
    _check(sums, d, ref, d0, 1e-12)
    assert float(sums[0, 0]) == pytest.approx(float(s0[0]), rel=1e-14)


@pytest.mark.parametrize("sampler", ["torch", "hybrid"])
def test_poly_iteration_matches_reference(sampler):
    xi, bits, lo, dx, xjac = _setup(seed=1)
    ft, fj = _pair()
    p, q = fit_importance_poly(xi, 8)
    p32, q32 = p.astype(np.float32), q.astype(np.float32)
    jargs = (fj, NDIM, NG, NPG, CHUNK, 1, NBINS, True, "float64",
             jax.random.PRNGKey(0), jnp.asarray(p32), jnp.asarray(q32),
             jnp.asarray(lo), jnp.asarray(dx), jnp.asarray(xjac),
             jnp.asarray(NCUBES, jnp.int64))
    if sampler == "torch":
        with mock.patch("jax.random.uniform", return_value=_ran(bits)), \
                jax.disable_jit():
            ref = JV._vegas_iteration_poly.__wrapped__(*jargs, ncomp=2)
        rtol = 1e-12
    else:
        ref_bits = jnp.asarray(bits.reshape(NPG * NDIM, CHUNK // 128, 128))
        with mock.patch("jax.random.bits", return_value=ref_bits):
            ref = JV._vegas_iteration_poly.__wrapped__(
                *jargs, ncomp=2, sampler="hybrid", tile_a=1)
        rtol = 1e-5
    args = (NDIM, NG, NPG, CHUNK, 1, NBINS, True, torch.float64, 0, 1,
            torch.as_tensor(p32), torch.as_tensor(q32), torch.as_tensor(lo),
            torch.as_tensor(dx), xjac, NCUBES)
    b = torch.as_tensor(bits.view(np.int32))
    sums, d = V._vegas_iteration_poly(ft, None, *args, sampler=sampler,
                                      bits=b, ncomp=2)
    _, d0 = V._vegas_iteration_poly(PAIR[0][0], PAIR[0][0], *args,
                                    sampler=sampler, bits=b)
    _check(sums, d, ref, d0, rtol)


@pytest.mark.parametrize("importance", ["poly", "grid"])
def test_vector_runs_are_statistically_correct(importance):
    """One pass integrates every component with honest errors; probs per
    component, prob and chi_sq their largest, as the reference sets
    them."""
    log = debug.VegasDebugLogger()
    r = mcubes.integrate(fvec, epsrel=5e-3, ncall=5e4, total_iters=15,
                         adjust_iters=8, seed=2, device="cpu",
                         importance=importance, debug_logger=log)
    assert r.estimates.shape == r.errorests.shape == r.probs.shape == (4,)
    for i in range(4):
        assert abs(r.estimates[i] - TRUTHS[i]) <= max(
            5 * r.errorests[i], 1e-3 * abs(TRUTHS[i])), i
    chi2a = log.records[-1].chi2a
    n_acc = r.iters - 5
    want = [chi2_prob(float(c) * (n_acc - 0.9999), float(n_acc - 1))
            for c in chi2a]
    np.testing.assert_array_equal(r.probs, want)
    assert np.all((r.probs >= 0.0) & (r.probs < 1.0))
    assert r.prob == float(np.max(r.probs))
    assert r.chi_sq == float(np.max(chi2a))
    assert (r.estimate, r.errorest) == (r.estimates[0], r.errorests[0])
    out = io.StringIO()
    log.dump_iters(out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("iter,component,estimate")
    assert len(lines) == 1 + 4 * r.iters


def test_status_needs_every_component():
    """Status 0 only when every component passes: a run whose second
    component is far noisier than its first stays status 1."""
    g = genz.f4_gaussian(NDIM, a=5.0)

    def f(x):
        return torch.stack([g(x), g(x) * (1.0 + 50.0 * torch.cos(
            200.0 * x.sum(-1)))], dim=-1)

    f.ndim = NDIM
    r = mcubes.integrate(f, epsrel=2e-3, ncall=5e4, seed=4, device="cpu")
    s = mcubes.integrate(g, epsrel=2e-3, ncall=5e4, seed=4, device="cpu")
    assert s.status == 0 and r.status == 1 and r.iters > s.iters


def test_two_equal_components_are_the_scalar_run():
    g = genz.f4_gaussian(NDIM, a=5.0)

    def gg(x):
        return torch.stack([g(x), g(x)], dim=-1)

    gg.ndim = NDIM
    for kw in ({}, {"importance": "grid"}, {"sampler": "hybrid"}):
        st_s = V.VegasState(xi=V.vgrid.uniform_grid(NDIM, 64, torch.float64,
                                                    "cpu"))
        st_v = V.VegasState(xi=st_s.xi.clone())
        s = mcubes.integrate(g, epsrel=1e-3, ncall=5e4, seed=3, nbins=64,
                             device="cpu", state=st_s, **kw)
        v = mcubes.integrate(gg, epsrel=1e-3, ncall=5e4, seed=3, nbins=64,
                             device="cpu", state=st_v, **kw)
        assert (v.iters, v.status) == (s.iters, s.status)
        assert torch.equal(st_v.xi, st_s.xi)
        assert v.estimates[0] == v.estimates[1]
        assert v.errorests[0] == v.errorests[1]
        assert abs(v.estimates[0] - s.estimate) <= 1e-12 * abs(s.estimate)
        assert abs(v.errorests[0] - s.errorest) <= 1e-12 * s.errorest


def test_vector_state_saves_loads_and_converts(tmp_path):
    """A vector run's VegasState holds (ncomp,) accumulators, round-trips
    through its file, continues a run, and the reference's vector state
    comes across by convert."""
    st = V.VegasState(xi=V.vgrid.uniform_grid(NDIM, 64, torch.float64,
                                              "cpu"))
    mcubes.integrate(fvec, epsrel=1e-9, ncall=2e4, total_iters=6, seed=1,
                     nbins=64, device="cpu", state=st)
    assert st.si.shape == st.swgt.shape == st.schi.shape == (4,)
    save_vegas_state(st, tmp_path / "v")
    back = load_vegas_state(tmp_path / "v")
    np.testing.assert_array_equal(back.si, st.si)
    assert torch.equal(back.xi, st.xi) and back.it0 == st.it0 == 6
    r = mcubes.integrate(fvec, epsrel=1e-9, ncall=2e4, total_iters=3, seed=1,
                         nbins=64, device="cpu", state=back, skip_iters=0)
    assert back.it0 == 9 and back.n_acc == st.n_acc + 3
    assert r.estimates.shape == (4,) and np.all(back.swgt > st.swgt)
    ref = JaxVegasState(xi=jnp.asarray(st.xi.numpy()), si=np.array(st.si),
                        swgt=np.array(st.swgt), schi=np.array(st.schi),
                        it0=st.it0, n_acc=st.n_acc)
    got = convert.vegas_state_from_reference(
        np.asarray(ref.xi), ref.si, ref.swgt, ref.schi, ref.it0, ref.n_acc)
    np.testing.assert_array_equal(got.swgt, st.swgt)
    assert torch.equal(got.xi, st.xi)


def test_fused_refuses_a_vector():
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(fvec, ncall=2e3, sampler="fused", device="cpu")
    assert V._resolve_sampler(None, "poly", "cuda", torch.float32, fvec,
                              4) == "hybrid"
    assert V._resolve_sampler(None, "poly", "cuda", torch.float32,
                              MEMBERS[2], 1) == "fused"
