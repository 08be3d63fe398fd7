"""The physics likelihood (gpuintegration_torch/models/physics.py) against
the JAX package's (gpuintegration_tpu/models/physics.py and
tests/test_physics_model.py), on the CPU.

* Pointwise: against the reference's ``__call__`` and against its own
  ``numpy_pointwise`` at 1e-12 relative (the test_cpu_vs_gpu.cu:12-23
  contract).
* ``Workspace(6, chunk_size=1024)`` against the reference's at epsrel 1e-3
  (the reference's run takes ~6 s here; its own case, 3e-4, is marked slow
  there): f64 throughout, so the decisions coincide and status,
  iterations, regions and neval are held EQUAL, the estimate and errorest
  to 1e-12 relative.
* ``interp_precision="f32"`` within 1e-6 relative of the f64 run; a table
  read back from the reference's text dump gives the same bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JWorkspace
from gpuintegration_tpu.models import physics as JP
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import physics as TP
from gpuintegration_torch.ops.interp import Interp2D

CPU = {"device": "cpu"}
EPSREL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """The reference's host loop and the port's host loop and fused phase
    on the same case."""
    ref = JWorkspace(6, chunk_size=1024).integrate(
        JP.ClusterLikelihood(), epsrel=EPSREL, epsabs=1e-40, fused=False)
    model = TP.ClusterLikelihood(**CPU)
    host = Workspace(6, chunk_size=1024, **CPU).integrate(
        model, epsrel=EPSREL, epsabs=1e-40, fused=False)
    fused = Workspace(6, chunk_size=1024, **CPU).integrate(
        model, epsrel=EPSREL, epsabs=1e-40)
    return ref, host, fused


def test_table_is_the_references():
    got, ref = TP.make_hmf_table(**CPU), JP.make_hmf_table()
    assert got.to_text() == ref.to_text()
    small = TP.make_hmf_table(8, 5, **CPU)
    assert small.zs.shape == (5, 8)


def test_pointwise_against_reference_and_numpy_twin():
    rng = np.random.default_rng(0)
    xs = rng.random((400, 6))
    xs[:20] = rng.choice([0.0, 1.0], (20, 6))     # the domain's corners
    model = TP.ClusterLikelihood(**CPU)
    got = model(torch.as_tensor(xs)).numpy()
    ref = np.asarray(JP.ClusterLikelihood()(jnp.asarray(xs)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    f_np = model.numpy_pointwise()
    twin = np.array([f_np(x) for x in xs])
    np.testing.assert_allclose(got, twin, rtol=1e-12, atol=0)
    # another cosmology: the same contract
    m2 = TP.ClusterLikelihood(omega_m=0.25, **CPU)
    r2 = np.asarray(JP.ClusterLikelihood(omega_m=0.25)(jnp.asarray(xs)))
    np.testing.assert_allclose(m2(torch.as_tensor(xs)).numpy(), r2,
                               rtol=1e-12, atol=0)
    assert model.volume.ndim == 6 and model.device == torch.device("cpu")


def test_workspace_against_reference(runs):
    ref, host, fused = runs
    for got in (host, fused):
        assert (got.status, got.iters, got.nregions, got.neval) == (
            ref.status, ref.iters, ref.nregions, ref.neval)
        assert got.status == 0
        assert got.estimate == pytest.approx(ref.estimate, rel=1e-12, abs=0)
        assert got.errorest == pytest.approx(ref.errorest, rel=1e-12, abs=0)
    # the fused phase takes the host loop's decisions, bit for bit
    assert (fused.estimate, fused.errorest) == (host.estimate,
                                                host.errorest)


def test_f32_table_precision(runs):
    _, host, _ = runs
    m32 = TP.ClusterLikelihood(interp_precision="f32", **CPU)
    assert m32.hmf.precision == "f32"
    r = Workspace(6, chunk_size=1024, **CPU).integrate(
        m32, epsrel=EPSREL, epsabs=1e-40, fused=False)
    assert r.status == 0
    assert abs(r.estimate - host.estimate) <= 1e-6 * abs(host.estimate)


def test_table_from_text():
    text = JP.make_hmf_table().to_text()
    hmf = Interp2D.from_text(text, **CPU)
    a = TP.ClusterLikelihood(hmf=hmf, **CPU)
    b = TP.ClusterLikelihood(**CPU)
    x = torch.as_tensor(np.random.default_rng(1).random((256, 6)))
    assert torch.equal(a(x), b(x))
    r = Workspace(6, chunk_size=1024, **CPU).integrate(
        a, epsrel=1e-2, epsabs=1e-40, fused=False)
    s = Workspace(6, chunk_size=1024, **CPU).integrate(
        b, epsrel=1e-2, epsabs=1e-40, fused=False)
    assert (r.estimate, r.neval) == (s.estimate, s.neval)
    with pytest.raises(ValueError, match="lies on"):
        TP.ClusterLikelihood(hmf=hmf, device="meta")


def test_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.ClusterLikelihood()
