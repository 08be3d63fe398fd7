"""``Workspace(rule_backend='fused')`` and ``vegas(sampler='fused')`` on a
scalar-per-axis callable (the generated kernels' entry points, whose plain
versions run here) against the JAX package's ``rule_backend='pallas'`` and
``sampler='pallas'`` (Pallas in interpret mode, as its own tests run it).

* f32 PAGANI on g3 (``tests/test_workspace_features.py:160-172``): the
  same status, iterations, regions and neval as the reference's Pallas
  run, the estimates within 1e-5 of each other (that test's own bound
  between its Pallas and XLA runs; ROADMAP C: f32 runs may part in
  decisions, which these do not).
* The same run against the port's own rule_backend='cuda' run bit for
  bit: on the CPU both are the plain rule, the traced program giving the
  callable's bits.
* The fused phase against the host loop: the same iterations, neval and
  regions (reference ``:360-372``).
* f64 against the reference's default 'xla' host loop to roundoff: the
  same decisions, estimate and errorest within 64 ulps of the estimate.
* The refusals: the reference's (``:174-184``), a vector, crease, the
  mesh (in ``test_torch_mesh_stages.py::test_refusals``, whose ranks
  already run).
* VEGAS g5 (``tests/test_pallas_vegas.py:135-150``) statistically against
  the reference's Pallas run (the samplers draw different streams); the
  same seed repeats bit for bit.

The port runs with ``torch.set_flush_denormal(True)``: XLA on the CPU
flushes subnormal results."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.ops import integrand_gen

ULPS = 64
G3_KW = dict(epsrel=1e-4, epsabs=1e-30)
G5_TRUTH = (math.sqrt(math.pi / 25.0) * math.erf(2.5)) ** 5


def g3(x, y, z):
    return torch.exp(-25.0 * ((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2))


def g3_jax(x, y, z):
    return jnp.exp(-25.0 * ((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2))


def g5(x0, x1, x2, x3, x4):
    s = 0.0
    for u in (x0, x1, x2, x3, x4):
        s = s + (u - 0.5) ** 2
    return torch.exp(-25.0 * s)


def g5_jax(x0, x1, x2, x3, x4):
    s = 0.0
    for u in (x0, x1, x2, x3, x4):
        s = s + (u - 0.5) ** 2
    return jnp.exp(-25.0 * s)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
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
def refs():
    """The reference's runs, once: its f32 Pallas host loop on g3 and its
    f64 XLA host loop at 1e-6."""
    pallas = JaxWorkspace(3, dtype=jnp.float32, chunk_size=1024,
                          rule_backend="pallas").integrate(
        g3_jax, fused=False, **G3_KW)
    xla64 = JaxWorkspace(3, chunk_size=1024).integrate(
        g3_jax, epsrel=1e-6, epsabs=1e-30, fused=False)
    return {"pallas": pallas, "xla64": xla64}


def _ws(dtype=torch.float32, **kw):
    return Workspace(3, dtype=dtype, chunk_size=1024, device="cpu", **kw)


def _decisions(r):
    return (r.status, r.iters, r.nregions, r.nFinishedRegions, r.neval)


def test_f32_against_the_reference_pallas_backend(refs):
    ref = refs["pallas"]
    got = _ws(rule_backend="fused").integrate(g3, fused=False, **G3_KW)
    assert got.status == ref.status == 0
    assert (got.iters, got.nregions, got.neval) == \
        (ref.iters, ref.nregions, ref.neval)
    assert abs(got.estimate - ref.estimate) < 1e-5 * abs(ref.estimate)


def test_fused_backend_is_the_cuda_backend_bit_for_bit():
    got = _ws(rule_backend="fused").integrate(g3, fused=False, **G3_KW)
    plain = _ws().integrate(g3, fused=False, **G3_KW)
    assert _decisions(got) == _decisions(plain)
    assert got.estimate == plain.estimate
    assert got.errorest == plain.errorest


def test_fused_phase_matches_the_host_loop():
    ws = _ws(rule_backend="fused")
    rh = ws.integrate(g3, fused=False, **G3_KW)
    rf = ws.integrate(g3, fused=True, **G3_KW)
    assert rf.status == 0
    assert (rh.status, rh.iters, rh.neval, rh.nregions) == \
        (rf.status, rf.iters, rf.neval, rf.nregions)
    assert abs(rh.estimate - rf.estimate) <= 1e-6 * abs(rh.estimate)


def test_f64_against_the_reference_xla_loop(refs):
    ref = refs["xla64"]
    got = _ws(torch.float64, rule_backend="fused").integrate(
        g3, epsrel=1e-6, epsabs=1e-30, fused=False)
    assert _decisions(got) == _decisions(ref)
    limit = ULPS * np.finfo(np.float64).eps * abs(ref.estimate)
    assert abs(got.estimate - ref.estimate) <= limit
    assert abs(got.errorest - ref.errorest) <= limit


def test_refusals_match_the_reference():
    ws = _ws(rule_backend="fused")
    # a callable that is not per-axis (test_workspace_features.py:178-184)
    with pytest.raises(ValueError, match="scalar-per-axis"):
        ws.integrate(lambda x: x[..., 0], epsrel=1e-3)
    # one that does not trace
    with pytest.raises(ValueError, match="rule_backend='cuda'"):
        ws.integrate(lambda x, y, z: torch.sum(x) * y * z, epsrel=1e-3)
    with pytest.raises(ValueError, match="scalar-only"):
        ws.integrate(lambda x, y, z: torch.stack([x, y * z], dim=-1),
                     epsrel=1e-3)
    with pytest.raises(ValueError, match="crease_split needs"):
        ws.integrate(g3, epsrel=1e-3, crease_split=True)
    with pytest.raises(ValueError, match="rule_backend"):
        Workspace(3, device="cpu", rule_backend="pallas")
    # unlike the reference's Pallas backend, f64 is taken (above)


def test_traced_integrand_takes_the_fused_routes():
    """On the card a traced callable takes the fused tile or generic route,
    never the split one; the default backend's callables stay on the split
    route."""
    from gpuintegration_torch.ops import cuda_rule
    t = integrand_gen.traced(g3, 3)
    assert cuda_rule.rule_route(3, t) == "tile"
    assert cuda_rule.rule_route(12, integrand_gen.traced(
        eval("lambda " + ", ".join(f"x{d}" for d in range(12))
             + ": x0 * x11"), 12)) == "generic"
    assert cuda_rule.rule_route(3, g3) == "split"
    assert cuda_rule.kernel_params(t)[0] == integrand_gen.KIND


def test_vegas_fused_against_the_reference_pallas_sampler():
    ref = JV.vegas(g5_jax, epsrel=1e-3, ncall=2e5, ndim=5, total_iters=20,
                   seed=3, sampler="pallas")
    got = mcubes.integrate(g5, epsrel=1e-3, ncall=2e5, total_iters=20,
                           seed=3, sampler="fused", device="cpu")
    again = mcubes.integrate(g5, epsrel=1e-3, ncall=2e5, total_iters=20,
                             seed=3, sampler="fused", device="cpu")
    assert got.status == ref.status == 0
    for r in (got, ref):
        assert abs(r.estimate - G5_TRUTH) < 5 * max(r.errorest,
                                                    1e-3 * G5_TRUTH)
    # the two estimates within their combined standard errors
    assert abs(got.estimate - ref.estimate) <= 5 * math.hypot(
        got.errorest, ref.errorest)
    assert (got.estimate, got.errorest) == (again.estimate, again.errorest)


def test_vegas_fused_refuses_what_does_not_trace():
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(lambda x0, x1: torch.sum(x0) * x1, ncall=2e3,
                         sampler="fused", device="cpu")
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        V._resolve_sampler("fused", "poly", "cuda", torch.float32,
                           lambda x: x.sum(-1))
    # AUTO on the card: the traced callable in f32, else 'hybrid'
    assert V._resolve_sampler(None, "poly", "cuda", torch.float32,
                              g5) == "fused"
    assert V._resolve_sampler(None, "poly", "cuda", torch.float64,
                              g5) == "hybrid"
