"""The port's rule evaluation against the JAX package's.

* The plain PyTorch version against ``rule_eval.apply_rule`` (f64) on
  random pools, F1-F6 at 2D/3D/5D, unit and non-unit volumes: est/err to
  reassociation roundoff, split_dim exactly.
* The same function in f32 against the Pallas kernel in interpret mode.
* Dispatch: a CPU pool runs the plain version, any other pool the CUDA
  kernels: a Genz family the fused kernel, any other callable the split
  route.  No fallback anywhere.

XLA on the CPU flushes subnormal f64 results to zero (F4 far from its
peak underflows into that range); the f64 comparisons run the port with
``torch.set_flush_denormal(True)`` so both sides compute the same values.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.integrand import make_integrand as jax_make_integrand
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_tpu.ops.pallas_rule import pallas_apply_rule
from gpuintegration_tpu.pagani import region_pool as jax_region_pool
from gpuintegration_torch import Workspace
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import (cuda_build, cuda_rule, integrand_gen,
                                      rule_eval)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["f1_oscillatory", "f2_product_peak", "f3_corner_peak",
            "f4_gaussian", "f5_c0", "f6_discontinuous"]
_JAX_FAMILIES = {
    "f1_oscillatory": jax_genz.f1_oscillatory,
    "f2_product_peak": jax_genz.f2_product_peak,
    "f3_corner_peak": jax_genz.f3_corner_peak,
    "f4_gaussian": jax_genz.f4_gaussian,
    "f5_c0": jax_genz.f5_c0_continuous,
    "f6_discontinuous": jax_genz.f6_discontinuous,
}


@pytest.fixture
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _pool(ndim, cap, seed, unit_volume):
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0.0, 0.5, (ndim, cap))
    lengths = rng.uniform(0.01, 0.5, (ndim, cap))
    if unit_volume:
        gl, gr = np.zeros(ndim), np.ones(ndim)
    else:
        gl, gr = rng.uniform(-1.0, 0.0, ndim), rng.uniform(0.5, 2.0, ndim)
    return lows, lengths, gl, gr


def _jax_rule(f_batched, ndim, dtype_name, lows, lengths, gl, gr):
    out = jax_rule_eval.apply_rule(
        f_batched, jax_rule_eval.rule_tables(ndim, dtype_name),
        jnp.asarray(lows), jnp.asarray(lengths), jnp.asarray(gl),
        jnp.asarray(gr))
    return [np.asarray(o) for o in out]


def _torch_rule(f, ndim, lows, lengths, gl, gr):
    t = [torch.as_tensor(a) for a in (lows, lengths, gl, gr)]
    tables = rule_eval.rule_tables(ndim, "float64")
    out = rule_eval.apply_rule(f, tables, *t)
    vals = rule_eval.rule_values(make_integrand(f, ndim)[0], tables, *t)
    # per-region magnitude: volume x jacobian x the largest |f| at its
    # points -- the scale of every rule sum, and of their roundoff
    mag = (np.prod(lengths, axis=0) * np.prod(gr)
           * vals.abs().amax(dim=1).numpy())
    return [o.numpy() for o in out], mag


def _assert_close(got, ref, mag, rtol=1e-12, floor=1e-13):
    """|got - ref| <= rtol |ref| + floor * mag: reassociation of the point
    sums moves each rule sum by a few ulps of its magnitude, which the
    cancelling null-rule errors do not scale down with."""
    bound = rtol * np.abs(ref) + floor * mag
    bad = ~(np.abs(got - ref) <= bound)
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("unit_volume", [True, False])
@pytest.mark.parametrize("ndim", [2, 3, 5])
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_matches_jax_f64(family, ndim, unit_volume, flush_denormal):
    lows, lengths, gl, gr = _pool(ndim, 256, 10 * ndim + unit_volume,
                                  unit_volume)
    f_jax, _ = jax_make_integrand(_JAX_FAMILIES[family](ndim), ndim)
    ref = _jax_rule(f_jax, ndim, "float64", lows, lengths, gl, gr)
    got, mag = _torch_rule(genz.FAMILIES[family](ndim), ndim, lows, lengths,
                           gl, gr)
    _assert_close(got[0], ref[0], mag)
    _assert_close(got[1], ref[1], mag)
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("kind", ["zero", "nan"])
def test_tie_rule_all_zero_and_nan(kind):
    """Every fourth difference 0 (or NaN): the widest dimension wins."""
    ndim = 3
    lows, lengths, gl, gr = _pool(ndim, 64, 5, True)
    value = 0.0 if kind == "zero" else float("nan")

    def f_torch(x0, x1, x2):
        return x0 * value if kind == "nan" else value

    def f_jax(x):
        return jnp.full(x.shape[:-1], value)

    ref = _jax_rule(f_jax, ndim, "float64", lows, lengths, gl, gr)
    got, _ = _torch_rule(f_torch, ndim, lows, lengths, gl, gr)
    widest = np.argmax(lengths, axis=0)
    np.testing.assert_array_equal(got[2], widest)
    np.testing.assert_array_equal(got[2], ref[2])
    if kind == "zero":
        assert not got[0].any() and not got[1].any()
    else:
        assert np.isnan(got[0]).all() and np.isnan(got[1]).all()
        assert np.isnan(ref[0]).all() and np.isnan(ref[1]).all()


def test_plain_chunks_and_real_slots():
    """Chunking and the blocked real-slot selection change nothing in the
    real slots; padding slots get est = err = 0 and split_dim 0."""
    ndim, cap, n = 3, 512, 300
    lows, lengths, gl, gr = _pool(ndim, cap, 3, False)
    t = [torch.as_tensor(a) for a in (lows, lengths, gl, gr)]
    tables = rule_eval.rule_tables(ndim, "float64")
    g = genz.f2_product_peak(ndim, a=5.0)
    full = rule_eval.apply_rule(g, tables, *t)
    part = rule_eval.apply_rule(g, tables, *t, chunk_size=64, n=n,
                                blocked=True)
    real = np.zeros(cap, bool)
    real[:n // 2] = real[cap // 2:cap // 2 + n // 2] = True
    for a, b in zip(full, part):
        np.testing.assert_array_equal(a.numpy()[real], b.numpy()[real])
        assert not b.numpy()[~real].any()


def _gauss4_jax(x0, x1, x2, x3):
    s = (x0 - .5) ** 2 + (x1 - .5) ** 2 + (x2 - .5) ** 2 + (x3 - .5) ** 2
    return jnp.exp(-25.0 * s)


def _gauss4_torch(x0, x1, x2, x3):
    s = (x0 - .5) ** 2 + (x1 - .5) ** 2 + (x2 - .5) ** 2 + (x3 - .5) ** 2
    return torch.exp(-25.0 * s)


def _osc4_jax(x0, x1, x2, x3):
    return jnp.cos(x0 + 2 * x1 + 3 * x2 + 4 * x3)


def _osc4_torch(x0, x1, x2, x3):
    return torch.cos(x0 + 2 * x1 + 3 * x2 + 4 * x3)


@pytest.mark.parametrize("pair", [(_gauss4_jax, _gauss4_torch),
                                  (_osc4_jax, _osc4_torch)])
def test_plain_matches_pallas_f32(pair):
    """f32: the plain version against the Pallas kernel (interpret mode),
    with tests/test_pallas_rule.py's tolerances."""
    f_jax, f_torch = pair
    ndim = 4
    lo, ln, _ = jax_region_pool.uniform_split(ndim, 2, 256, jnp.float32)
    gl = jnp.zeros(ndim, jnp.float32)
    gr = jnp.ones(ndim, jnp.float32)
    est_p, err_p, sd_p = pallas_apply_rule(f_jax, ndim, lo, ln, gl, gr,
                                           interpret=True)
    t = [torch.as_tensor(np.array(a)) for a in (lo, ln, gl, gr)]
    assert t[0].dtype == torch.float32
    est, err, sd = rule_eval.apply_rule(
        f_torch, rule_eval.rule_tables(ndim, "float32"), *t)
    assert est.dtype == err.dtype == torch.float32
    np.testing.assert_allclose(est.numpy(), np.asarray(est_p),
                               rtol=5e-5, atol=1e-10)
    np.testing.assert_allclose(err.numpy(), np.asarray(err_p),
                               rtol=5e-3, atol=1e-8)
    assert np.mean(sd.numpy() == np.asarray(sd_p)) > 0.95


def _meta_pool(ndim=3, cap=8):
    lows = torch.empty((ndim, cap), dtype=torch.float64, device="meta")
    gl = torch.empty((ndim,), dtype=torch.float64, device="meta")
    return lows, lows, gl, gl


def test_device_pool_goes_to_kernel(monkeypatch):
    """A pool that is not on the CPU is handed to the CUDA kernel's wrapper
    (a meta tensor stands in for the card here)."""
    calls = []

    def fake_kernel(f, tables, lows, lengths, gl, gr, *, n, blocked):
        calls.append((lows.device.type, n, blocked))
        return "kernel"

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", fake_kernel)
    out = rule_eval.apply_rule(genz.f4_gaussian(3),
                               rule_eval.rule_tables(3), *_meta_pool(),
                               n=6, blocked=True)
    assert out == "kernel" and calls == [("meta", 6, True)]


def test_kernel_refuses_callable_and_non_cuda():
    """A callable on a pool off the CPU reaches the split route, whose
    wrapper refuses a pool that is not on the card (no plain fallback);
    the fused wrapper refuses it too, and a traced callable past 16D
    (past 16D only a Genz family's wide route runs)."""
    tables = rule_eval.rule_tables(3)
    with pytest.raises(ValueError,
                       match="cuda_apply_rule_split needs CUDA tensors"):
        rule_eval.apply_rule(lambda x, y, z: x * y * z, tables, *_meta_pool())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(3), tables, *_meta_pool())
    names = ", ".join(f"x{d}" for d in range(17))
    traced = integrand_gen.traced(eval(f"lambda {names}: x0 * x1"), 17)
    with pytest.raises(ValueError, match="ndim 2..16"):
        cuda_rule.cuda_apply_rule(traced, rule_eval.rule_tables(17),
                                  *_meta_pool(17))


def test_kernel_params_of_each_family():
    kind, p = cuda_rule.kernel_params(genz.f2_product_peak(3, a=4.0, b=0.25))
    assert kind == 2 and p[32] == 1.0 / 16.0 and p[33] == 0.25
    kind, p = cuda_rule.kernel_params(genz.f6_discontinuous(3))
    assert kind == 6
    np.testing.assert_array_equal(p[:3], [3.0, 4.0, 5.0])
    np.testing.assert_array_equal(p[16:19], [0.2, 0.3, 0.4])
    assert [cuda_rule.kernel_params(g)[0] for g in genz.genz_suite(4)] == [
        1, 2, 3, 4, 5, 6]


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such architecture' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no such architecture"):
        cuda_rule.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def test_workspace_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Workspace(3)
    assert Workspace(3, device="cpu").device.type == "cpu"


def test_package_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with jax and
    the JAX package unavailable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["gpuintegration_tpu"] = None
        import gpuintegration_torch
        names = [m.name for m in pkgutil.walk_packages(
            gpuintegration_torch.__path__, "gpuintegration_torch.")]
        for name in names:
            importlib.import_module(name)
        from gpuintegration_torch.models import misc
        from gpuintegration_torch.utils.checkpoint import ContinuationState
        from gpuintegration_torch.utils.profiling import StageTimer
        assert {"gpuintegration_torch.models.misc",
                "gpuintegration_torch.utils.profiling",
                "gpuintegration_torch.ops.cuda_rule"} <= set(names)
        assert misc.sin_sum(3).kind is None and StageTimer().times == {}
        assert ContinuationState.from_queue(
            [], 0.0, 0.0, 0, 0, 0, 0, False, 1e-3, 0.0).to_queue() == []
        import chip_smoke
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        print("imported", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")
