"""The port's differentiable estimates (``gpuintegration_torch.diff``) and
PAGANI checkpoints against the JAX package's, on the CPU.

* The frozen-grid estimator fed JAX's own draws (``jax.random`` as
  ``gpuintegration_tpu/diff.py`` makes them): estimate and error within
  1e-11 relative, ``torch.func.grad`` against ``jax.grad`` within 1e-10.
  Both sides do the same f32 lookups and the same f64 arithmetic, each
  operation rounded on its own (JAX run eagerly, without ``jit``, which
  would contract f32 multiply-adds); what is left is the order of the sums
  of 2e4 positive terms, n eps = 2.2e-12 at worst (XLA's threaded CPU
  reduction was read 2.6e-12 off torch's once).
* The fixed-mesh rule estimate and its gradient within 1e-12 relative; its
  error, a cancelling null-rule difference, within 1e-12 relative plus
  1e-13 of the estimate's magnitude (``tests/test_torch_rule_eval.py``
  reads rule sums the same way).
* The statistical checks of ``tests/test_diff.py`` on the port alone.
* Checkpoints: the same 3D run in both packages gives the same pool,
  ledger and per-region sweep (errors read as the rule's are); npz files
  load in either package.  The run is Genz F3: on a Gaussian centred or
  not, near-tied fourth differences in flat regions pick other split axes
  in the two packages (ROADMAP C), and the pools differ in layout.

The PAGANI runs use ``torch.set_flush_denormal(True)``: XLA on the CPU
flushes subnormal results, and the comparison is of the algorithm."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuintegration_tpu as J
from gpuintegration_tpu import diff as jdiff
from gpuintegration_tpu.mcubes import vegas as jvegas
from gpuintegration_tpu.models import genz as jgenz
from gpuintegration_tpu.utils import checkpoint as jck
from gpuintegration_torch import (Volume, Workspace, convert, diff,
                                  fixed_mesh_integral, frozen_grid_estimate,
                                  mesh_from_checkpoint, train_grid)
from gpuintegration_torch.mcubes import cuda_lookup, kernel_check, stream
from gpuintegration_torch.mcubes import grid as vgrid
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils import checkpoint as tck

F64 = torch.float64


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


def gauss(x, a):
    """f(x, a) = exp(-a sum((x - 1/2)^2)); on [0,1]^d
    I(a) = (sqrt(pi/a) erf(sqrt(a)/2))^d."""
    return torch.exp(-a * torch.sum((x - 0.5) ** 2, dim=-1))


def jgauss(x, a):
    return jnp.exp(-a * jnp.sum((x - 0.5) ** 2, axis=-1))


def gauss_truth(a, ndim):
    return (math.sqrt(math.pi / a) * math.erf(math.sqrt(a) / 2.0)) ** ndim


def gauss_dtruth(a, ndim, h=1e-6):
    return (gauss_truth(a + h, ndim) - gauss_truth(a - h, ndim)) / (2 * h)


def t64(v):
    return torch.tensor(v, dtype=F64)


def t64i(v):
    return torch.tensor(v, dtype=torch.int64)


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# -- the frozen grid, fed the reference's draws -------------------------------------

def _jax_draws(key, n, ndim, nbins):
    """The draws of ``gpuintegration_tpu/diff.py``'s est_fn, as NumPy."""
    kb, ku = jax.random.split(jnp.asarray(key))
    ia = jax.random.randint(kb, (1, n, ndim), 1, nbins + 1, dtype=jnp.int32)
    u = jax.random.uniform(ku, (1, n, ndim), jnp.float32)
    return np.asarray(ia)[0], np.asarray(u)[0]


def _port_on_draws(xi, ia, u, vol):
    """est_fn(theta) of the port's estimator on given draws."""
    xi32 = torch.as_tensor(np.asarray(xi, np.float32))
    ia_t, u_t = torch.as_tensor(np.array(ia)), torch.as_tensor(np.array(u))
    kw = dict(regn_lo=torch.as_tensor(vol.lows, dtype=F64),
              dx=torch.as_tensor(vol.highs - vol.lows, dtype=F64),
              jac=vol.jacobian)
    return lambda a: diff.estimate_from_draws(gauss, a, xi32, ia_t, u_t, **kw)


def _against_reference_draws(xi, ndim, n, theta, vol=None):
    vol_j = None if vol is None else J.Volume(*vol)
    vol_t = Volume(ndim=ndim) if vol is None else Volume(*vol)
    key = jax.random.PRNGKey(7)
    ref = jdiff.frozen_grid_estimate(jgauss, xi, ndim, ncall=n, vol=vol_j)
    est_j, err_j = ref(theta, key)
    grad_j = jax.grad(lambda a: ref(a, key)[0])(theta)
    nbins = np.asarray(xi).shape[1] - 1
    est_fn = _port_on_draws(xi, *_jax_draws(key, n, ndim, nbins), vol_t)
    est, err = est_fn(t64(theta))
    grad = torch.func.grad(lambda a: est_fn(a)[0])(t64(theta))
    assert rel(est, est_j) <= 1e-11
    assert rel(err, err_j) <= 1e-11
    assert rel(grad, grad_j) <= 1e-10


@pytest.mark.parametrize("nbins", [50, 500])
@pytest.mark.parametrize("ndim", [2, 5])
def test_frozen_estimate_on_reference_draws(ndim, nbins):
    xi = kernel_check.random_grid(ndim, nbins, ndim)
    _against_reference_draws(xi, ndim, 20000, 3.0)


def test_frozen_estimate_on_reference_draws_in_a_volume():
    xi = kernel_check.random_grid(3, 50, 1)
    _against_reference_draws(xi, 3, 20000, 2.0,
                             vol=([0.0, -1.0, 0.5], [2.0, 1.0, 1.0]))


def test_reference_trained_grid_carried_across():
    """A grid the JAX package trained, carried across bit for bit: the
    same estimate on the same draws, and the port's own draws give an
    estimate of the truth."""
    xi = np.asarray(jdiff.train_grid(jgauss, 2, theta=6.0, ncall=2e4,
                                     adjust_iters=6, seed=3))
    _against_reference_draws(xi, 2, 20000, 6.0)
    xi_t = convert.vegas_state_from_reference(xi, 0, 0, 0, 0, 0).xi
    assert np.array_equal(xi_t.numpy(), xi)
    est, err = frozen_grid_estimate(gauss, xi_t, 2, ncall=2e5,
                                    device="cpu")(t64(6.0), 11)
    truth = gauss_truth(6.0, 2)
    assert abs(float(est) - truth) <= 5 * float(err)


# -- the port alone: the statistical checks of tests/test_diff.py -------------------

def test_unbiased_estimate_and_crn_gradient():
    xi = train_grid(gauss, 2, theta=6.0, ncall=2e4, adjust_iters=6, seed=3,
                    device="cpu")
    est_fn = frozen_grid_estimate(gauss, xi, 2, ncall=2e5, device="cpu")
    est, err = est_fn(t64(6.0), 7)
    truth = gauss_truth(6.0, 2)
    assert abs(float(est) - truth) <= max(5 * float(err), 5e-3 * truth)
    # autodiff == common-random-number finite difference (same seed)
    g = float(torch.func.grad(lambda a: est_fn(a, 7)[0])(t64(6.0)))
    h = 1e-4
    fd = (float(est_fn(t64(6.0 + h), 7)[0])
          - float(est_fn(t64(6.0 - h), 7)[0])) / (2 * h)
    assert abs(g - fd) < 1e-5 * max(1.0, abs(g))
    # and the gradient estimates the analytic derivative
    d_truth = gauss_dtruth(6.0, 2)
    assert abs(g - d_truth) < 0.05 * abs(d_truth)


def test_uniform_grid_plain_mc():
    """On a uniform grid the estimator is plain Monte Carlo (weights 1)."""
    xi = vgrid.uniform_grid(2, 50)
    est, err = frozen_grid_estimate(gauss, xi, 2, ncall=1e5,
                                    device="cpu")(1.0, 0)
    truth = gauss_truth(1.0, 2)
    assert abs(float(est) - truth) <= max(5 * float(err), 1e-2 * truth)


def test_frozen_scan_by_vmap_equals_the_loop():
    """``torch.func.vmap`` over theta draws nothing at random inside the
    transform (the draws are integer arithmetic on the seed), so it gives
    the loop's numbers; 1e-14 relative leaves room for a batched sum's
    other order."""
    xi = kernel_check.random_grid(3, 50, 2)
    est_fn = frozen_grid_estimate(gauss, xi, 3, ncall=5000, device="cpu")
    thetas = t64([1.0, 3.0, 9.0, 20.0])
    ests, errs = torch.func.vmap(lambda a: est_fn(a, 5))(thetas)
    for i, a in enumerate(thetas):
        e, r = est_fn(a, 5)
        assert rel(ests[i], e) <= 1e-14 and rel(errs[i], r) <= 1e-14


def test_frozen_draws_repeat_and_cover_every_bin():
    ia, u = diff.frozen_draws(3, 20000, 4, 50, "cpu")
    ia2, u2 = diff.frozen_draws(3, 20000, 4, 50, "cpu")
    assert torch.equal(ia, ia2) and torch.equal(u, u2)
    assert ia.dtype == torch.int32 and u.dtype == torch.float32
    assert int(ia.min()) == 1 and int(ia.max()) == 50
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    # 80000 draws over 50 bins: 1600 a bin, sd 40
    counts = torch.bincount(ia.reshape(-1).long(), minlength=51)[1:]
    assert int((counts - 1600).abs().max()) < 200
    other, _ = diff.frozen_draws(4, 20000, 4, 50, "cpu")
    assert not torch.equal(ia, other)


@pytest.mark.parametrize("ndim", [1, 4, 5])
def test_frozen_draws_follow_their_words(ndim):
    """Each id and uniform from its Philox words, in Python integers:
    dimension 2p + k of a sample takes words 2k (id) and 2k + 1 (u) of the
    block at counter (sample, 0, p, FROZEN_STREAM); the id is the 40-bit
    fraction (id word, u word's low 8 bits) times nbins, plus 1."""
    seed, n, nbins = 11, 9, 500
    ia, u = diff.frozen_draws(seed, n, ndim, nbins, "cpu")
    k0, k1 = stream.seed_key(seed)
    for i in range(n):
        for d in range(ndim):
            words = [int(w) for w in stream.philox4x32(
                t64i(i), t64i(0), t64i(d // 2), t64i(diff.FROZEN_STREAM),
                k0, k1)]
            w_id, w_u = words[2 * (d % 2)], words[2 * (d % 2) + 1]
            assert int(ia[i, d]) == ((w_id << 8 | w_u & 0xFF) * nbins
                                     >> 40) + 1
            assert float(u[i, d]) == (w_u >> 8) * 2.0 ** -24


def test_frozen_points_refuse_a_transformed_input():
    """The draws, edges and points run with torch.func's transforms off; a
    volume or draw that a transform has wrapped raises rather than lose its
    derivative or batch."""
    xi32 = torch.as_tensor(kernel_check.random_grid(2, 50, 0))
    ia, u = diff.frozen_draws(1, 100, 2, 50, "cpu")
    kw = dict(regn_lo=torch.zeros(2, dtype=F64), jac=1.0)

    def est(dx):
        return diff.estimate_from_draws(gauss, t64(2.0), xi32, ia, u, dx=dx,
                                        **kw)[0]

    assert math.isfinite(float(est(torch.ones(2, dtype=F64))))
    with pytest.raises(ValueError, match="dx depend"):
        torch.func.grad(est)(torch.ones(2, dtype=F64))
    with pytest.raises(ValueError, match="dx depend"):
        torch.func.vmap(est)(torch.ones(3, 2, dtype=F64))


def test_frozen_estimate_rejects_a_grid_of_other_dimensions():
    with pytest.raises(ValueError, match="xi must be"):
        frozen_grid_estimate(gauss, vgrid.uniform_grid(3, 50), 2,
                             device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Every diff entry point builds on the card by default; without one it
    raises and names device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xi = vgrid.uniform_grid(2, 50)
    for build in (lambda: train_grid(gauss, 2, theta=1.0, ncall=1e3),
                  lambda: frozen_grid_estimate(gauss, xi, 2),
                  lambda: fixed_mesh_integral(gauss, 2,
                                              partitions_per_axis=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_edge_lookup_counts_no_launch_on_the_cpu():
    cuda_lookup.reset_launches()
    xi = kernel_check.random_grid(2, 50, 0)
    est_fn = frozen_grid_estimate(gauss, xi, 2, ncall=1000, device="cpu")
    torch.func.grad(lambda a: est_fn(a, 1)[0])(t64(2.0))
    assert cuda_lookup.edge_lookup_launches == 0
    assert cuda_lookup.edge_route_launches == {"vector": 0, "generic": 0}


# -- the fixed mesh ----------------------------------------------------------------

def _close_rule(got, ref, mag):
    """|got - ref| <= 1e-12 |ref| + 1e-13 mag."""
    assert abs(float(got) - float(ref)) <= (1e-12 * abs(float(ref))
                                            + 1e-13 * abs(float(mag)))


@pytest.mark.parametrize("parts", [3, 6])
@pytest.mark.parametrize("ndim", [2, 3])
def test_fixed_mesh_matches_reference(ndim, parts):
    ref = jdiff.fixed_mesh_integral(jgauss, ndim, partitions_per_axis=parts)
    est_fn = fixed_mesh_integral(gauss, ndim, partitions_per_axis=parts,
                                 device="cpu")
    est_j, err_j = ref(4.0)
    est, err = est_fn(t64(4.0))
    assert rel(est, est_j) <= 1e-12
    _close_rule(err, err_j, est_j)
    g_j = jax.grad(lambda a: ref(a)[0])(4.0)
    ge_j = jax.grad(lambda a: ref(a)[1])(4.0)
    g = torch.func.grad(lambda a: est_fn(a)[0])(t64(4.0))
    ge = torch.func.grad(lambda a: est_fn(a)[1])(t64(4.0))
    assert rel(g, g_j) <= 1e-12
    _close_rule(ge, ge_j, g_j)
    assert abs(float(g) - gauss_dtruth(4.0, ndim)) < 1e-4 * abs(
        gauss_dtruth(4.0, ndim))


@pytest.mark.parametrize("parts", [3, 6])
def test_fixed_mesh_pytree_theta_and_volume(parts):
    """theta as a dict; a non-unit volume through the same transform as
    Workspace and vegas; d/dscale = est/scale exactly (linearity)."""
    def f(x, th):
        return th["scale"] * torch.exp(
            -th["a"] * torch.sum((x - 0.5) ** 2, dim=-1))

    def jf(x, th):
        return th["scale"] * jnp.exp(
            -th["a"] * jnp.sum((x - 0.5) ** 2, axis=-1))

    est_fn = fixed_mesh_integral(f, 2, partitions_per_axis=parts,
                                 vol=Volume([0.0, -0.5], [2.0, 1.5]),
                                 device="cpu")
    ref = jdiff.fixed_mesh_integral(jf, 2, partitions_per_axis=parts,
                                    vol=J.Volume([0.0, -0.5], [2.0, 1.5]))
    th = {"a": t64(2.0), "scale": t64(3.0)}
    th_j = {"a": 2.0, "scale": 3.0}
    est, err = est_fn(th)
    est_j, err_j = ref(th_j)
    assert rel(est, est_j) <= 1e-12
    _close_rule(err, err_j, est_j)
    grads = torch.func.grad(lambda t: est_fn(t)[0])(th)
    grads_j = jax.grad(lambda t: ref(t)[0])(th_j)
    for k in ("a", "scale"):
        assert rel(grads[k], grads_j[k]) <= 1e-12
    assert rel(grads["scale"], float(est) / 3.0) <= 1e-12


def test_fixed_mesh_scan_by_vmap_equals_the_loop():
    est_fn = fixed_mesh_integral(gauss, 2, partitions_per_axis=4,
                                 device="cpu")
    thetas = t64([1.0, 3.0, 9.0])
    ests, errs = torch.func.vmap(est_fn)(thetas)
    for i, a in enumerate(thetas):
        e, r = est_fn(a)
        assert rel(ests[i], e) <= 1e-14
        assert abs(float(errs[i]) - float(r)) <= 1e-13 * float(e)


def test_fixed_mesh_grad_is_exact_derivative_of_estimator():
    est_fn = fixed_mesh_integral(gauss, 2, partitions_per_axis=3,
                                 device="cpu")
    g = float(torch.func.grad(lambda a: est_fn(a)[0])(t64(5.0)))
    h = 1e-5
    fd = (float(est_fn(t64(5.0 + h))[0])
          - float(est_fn(t64(5.0 - h))[0])) / (2 * h)
    assert abs(g - fd) < 1e-7 * abs(g)


def test_fixed_mesh_rejects_bad_region_shapes():
    with pytest.raises(ValueError, match="region-major"):
        fixed_mesh_integral(gauss, 3, regions=(np.zeros((4, 2)),
                                               np.ones((4, 2))),
                            device="cpu")
    with pytest.raises(ValueError, match="region-major"):
        fixed_mesh_integral(gauss, 3, regions=(np.zeros((4, 3)),
                                               np.ones(4)), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        fixed_mesh_integral(gauss, 3, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        fixed_mesh_integral(gauss, 3, regions=(np.zeros((4, 3)),
                                               np.ones((4, 3))),
                            partitions_per_axis=2, device="cpu")


# -- checkpoints -------------------------------------------------------------------

def _checkpoints():
    """The same 3D run of Genz F3 in both packages, six iterations at
    tolerances out of reach."""
    kw = dict(epsrel=1e-12, epsabs=1e-200, max_iterations=6)
    ws_j = J.Workspace(3, chunk_size=1024)
    ws_j.integrate(jgenz.f3_corner_peak(3), fused=False, **kw)
    ws = Workspace(3, chunk_size=1024, device="cpu")
    ws.integrate(genz.f3_corner_peak(3), fused=False, **kw)
    return ws_j.make_checkpoint(), ws.make_checkpoint()


@pytest.fixture(scope="module")
def checkpoints():
    torch.set_flush_denormal(True)
    try:
        return _checkpoints()
    finally:
        torch.set_flush_denormal(False)


def _same_checkpoint(got, ref):
    np.testing.assert_array_equal(got.lows, ref.lows)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    assert (got.nregions, got.iters, got.neval) == (ref.nregions, ref.iters,
                                                    ref.neval)
    assert math.isclose(got.estimate, ref.estimate, rel_tol=1e-10)
    # the ledger's error sums the retired regions' null-rule errors, read
    # as those are: 1e-10 relative plus 1e-13 of the estimate
    assert abs(got.errorest - ref.errorest) <= (1e-10 * abs(ref.errorest)
                                                + 1e-13 * abs(ref.estimate))
    np.testing.assert_allclose(got.region_estimates, ref.region_estimates,
                               rtol=1e-12)
    # the errors are cancelling null-rule differences: 1e-12 relative plus
    # 1e-13 of the region's estimate
    assert np.all(np.abs(got.region_errorests - ref.region_errorests)
                  <= 1e-12 * np.abs(ref.region_errorests)
                  + 1e-13 * np.abs(ref.region_estimates))


def test_make_checkpoint_matches_reference(checkpoints):
    ck_j, ck = checkpoints
    assert ck.lows.shape[1] == 3 and ck.lows.shape[0] > 1000
    assert ck.iters == 5      # the ledger holds the iterations before the pool
    assert ck.nregions > 0    # and the regions retired before it
    _same_checkpoint(ck, ck_j)
    _same_checkpoint(convert.checkpoint_from_reference(ck_j), ck_j)


def test_make_checkpoint_before_a_run_raises():
    with pytest.raises(ValueError, match="run integrate"):
        Workspace(3, device="cpu").make_checkpoint()


def test_checkpoint_files_load_in_either_package(checkpoints, tmp_path):
    ck_j, ck = checkpoints
    ck.save(tmp_path / "port")                 # .npz appended
    _same_checkpoint(jck.PaganiCheckpoint.load(str(tmp_path / "port")), ck)
    ck_j.save(str(tmp_path / "ref.npz"))
    back = tck.PaganiCheckpoint.load(tmp_path / "ref.npz")
    _same_checkpoint(back, ck_j)
    assert back.ledger == (back.estimate, back.errorest, back.nregions,
                           back.iters, back.neval)


def test_resume_from_a_checkpoint_finishes_the_run(checkpoints):
    """A checkpoint's pool and ledger resume the run: the ledger plus the
    resumed sweep is the integral, as from the JAX package's checkpoint."""
    ck_j, ck = checkpoints
    g = genz.f3_corner_peak(3)
    a = Workspace(3, chunk_size=1024, device="cpu").integrate(
        g, epsrel=1e-6, epsabs=1e-40, initial_regions=(ck.lows, ck.lengths),
        ledger=ck.ledger)
    ck_c = convert.checkpoint_from_reference(ck_j)
    b = Workspace(3, chunk_size=1024, device="cpu").integrate(
        g, epsrel=1e-6, epsabs=1e-40,
        initial_regions=(ck_c.lows, ck_c.lengths), ledger=ck_c.ledger)
    assert a.status == b.status == 0
    assert (a.iters, a.neval, a.nregions) == (b.iters, b.neval, b.nregions)
    assert math.isclose(a.estimate, b.estimate, rel_tol=1e-10)
    assert abs(a.estimate - g.true_value) <= 1e-5 * g.true_value


def test_checkpoint_mesh_pipeline():
    """The adapted mesh of a checkpoint drives the fixed-mesh estimator
    (tests/test_diff.py's pipeline): accurate at the training theta, with a
    gradient.  Tolerances out of reach: no region retires, and the
    checkpoint is a complete partition."""
    ws = Workspace(3, chunk_size=1024, device="cpu")
    ws.integrate(genz.f4_gaussian(3, a=5.0), epsrel=1e-12, epsabs=1e-200,
                 max_iterations=6)
    regions = mesh_from_checkpoint(ws.make_checkpoint())
    assert regions[0].shape[1] == 3
    assert np.isclose(np.prod(regions[1], axis=1).sum(), 1.0, rtol=1e-14)
    # Genz F4 with a = 5 is exp(-25 sum (x - 1/2)^2): theta = 25
    est_fn = fixed_mesh_integral(gauss, 3, regions=regions, device="cpu")
    est, err = est_fn(t64(25.0))
    truth = gauss_truth(25.0, 3)
    assert abs(float(est) - truth) <= max(3 * float(err), 1e-5 * truth)
    g = torch.func.grad(lambda a: est_fn(a)[0])(t64(25.0))
    assert math.isfinite(float(g))


def test_fixed_mesh_on_a_reference_checkpoint(checkpoints):
    """The JAX package's checkpoint mesh, carried across: the port's
    fixed-mesh estimate and gradient on it equal the JAX package's."""
    ck_j, _ = checkpoints
    ck = convert.checkpoint_from_reference(ck_j)
    est_fn = fixed_mesh_integral(gauss, 3, regions=mesh_from_checkpoint(ck),
                                 device="cpu")
    ref = jdiff.fixed_mesh_integral(jgauss, 3,
                                    regions=jdiff.mesh_from_checkpoint(ck_j))
    est, err = est_fn(t64(25.0))
    est_j, err_j = ref(25.0)
    assert rel(est, est_j) <= 1e-12
    _close_rule(err, err_j, est_j)
    g = torch.func.grad(lambda a: est_fn(a)[0])(t64(25.0))
    assert rel(g, jax.grad(lambda a: ref(a)[0])(25.0)) <= 1e-12


def test_vegas_state_files_load_in_either_package(tmp_path):
    st = jvegas.VegasState(xi=jnp.asarray(kernel_check.random_grid(2, 50, 0)),
                           si=1.5, swgt=2.5, schi=3.5, it0=4, n_acc=2)
    jck.save_vegas_state(st, str(tmp_path / "ref"))
    got = tck.load_vegas_state(tmp_path / "ref")
    assert np.array_equal(got.xi.numpy(), np.asarray(st.xi))
    assert (got.si, got.swgt, got.schi, got.it0, got.n_acc) == (
        1.5, 2.5, 3.5, 4, 2)
    tck.save_vegas_state(got, tmp_path / "port.npz")
    back = jck.load_vegas_state(str(tmp_path / "port.npz"))
    assert np.array_equal(np.asarray(back.xi), np.asarray(st.xi))
    assert (back.si, back.swgt, back.schi, back.it0, back.n_acc) == (
        1.5, 2.5, 3.5, 4, 2)
