"""kernel_check, the judge of the CUDA rule kernel against its plain
version, on the CPU: a second rounding of the same rule evaluation passes,
and a wrong error model, estimate or split_dim fails.

A "kernel" here is the plain version computed with the coordinates x
rounded once (formed in f64, then rounded to f32), as the kernel's fused
multiply-add forms them, or with them formed as
gl + ((.5+g) lower + (.5-g) upper) range in f64.
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval

NDIM = 5


def _pool(dtype, cap=384, seed=3):
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0.0, 0.5, (NDIM, cap))
    lengths = rng.uniform(0.01, 0.5, (NDIM, cap))
    gl, gr = rng.uniform(0.0, 0.5, NDIM), rng.uniform(0.5, 1.5, NDIM)
    return [torch.as_tensor(a, dtype=dtype) for a in (lows, lengths, gl, gr)]


def _rerounded(g, tables, lows, lengths, gl, gr):
    """The rule outputs with the rule points rounded another way."""
    dtype = lows.dtype
    if dtype == torch.float32:
        x, _, _ = rule_eval.rule_points(
            rule_eval.rule_tables(NDIM, "float64"), lows.double(),
            lengths.double(), gl.double(), gr.double())
        x = x.float()
    else:
        gen, _, _, _ = rule_eval.device_tables(NDIM, dtype, lows.device)
        lo, up = lows.T[:, None, :], (lows + lengths).T[:, None, :]
        x = gl + ((0.5 + gen) * lo + (0.5 - gen) * up) * gr
    return rule_eval.rule_outputs(g(x).to(dtype), tables, lengths, gr)


def _mutant(how, g, tables, lows, lengths, gl, gr):
    """The plain outputs with one part of the error model changed."""
    vals = rule_eval.rule_values(g, tables, lows, lengths, gl, gr)
    est, _, sdim = rule_eval.rule_outputs(vals, tables, lengths, gr)
    sums = rule_eval.rule_sums(vals, tables, gr)
    e = rule_eval.null_errors(sums, tables)
    _, _, scale, norm = rule_eval.device_tables(NDIM, lows.dtype, lows.device)
    if how == "gate_e1":
        gated = e[:, 0]
    elif how == "gate_max":
        gated = 5.0 * e.amax(dim=1)
    else:
        if how == "norm_1e-3":
            norm = norm * (1.0 + 1e-3)
        else:           # "scale_f32": the scale table rounded to f32
            scale = scale.float().to(scale.dtype)
        e = torch.amax(torch.abs(sums[:, None, 2:5] + scale[None, :, 1:4]
                                 * sums[:, None, 1:4]) * norm[None, :, 1:4],
                       dim=1)
        gated = rule_eval.gate_errors(e)
    return est, torch.prod(lengths, dim=0) * gated, sdim


def _judge(kernel, plain, g, tables, t):
    return kernel_check.compare_outputs(kernel, plain, g, tables, *t,
                                        min_agree=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", sorted(genz.FAMILIES))
def test_rerounded_rule_passes(family, dtype):
    t = _pool(dtype)
    tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
    g = genz.FAMILIES[family](NDIM)
    plain = rule_eval.apply_rule_plain(g, tables, *t)
    r = _judge(_rerounded(g, tables, *t), plain, g, tables, t)
    assert r["regions"] == t[0].shape[1]


@pytest.mark.parametrize("dtype,how", [
    (torch.float64, "gate_e1"), (torch.float64, "gate_max"),
    (torch.float64, "norm_1e-3"), (torch.float64, "scale_f32"),
    (torch.float32, "gate_e1"), (torch.float32, "gate_max"),
    (torch.float32, "norm_1e-3")])
def test_wrong_error_model_fails(dtype, how):
    """Each change to the error model fails on some family of the suite
    (a family whose err stands above f32 roundoff, for f32)."""
    t = _pool(dtype)
    tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
    caught = []
    for g in genz.genz_suite(NDIM):
        plain = rule_eval.apply_rule_plain(g, tables, *t)
        try:
            _judge(_mutant(how, g, tables, *t), plain, g, tables, t)
        except AssertionError as e:
            assert " err: " in str(e)
            caught.append(g.name)
    assert caught, how


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrong_estimate_and_nan_fail(dtype):
    t = _pool(dtype)
    tables = rule_eval.rule_tables(NDIM, rule_eval.dtype_name(dtype))
    g = genz.f4_gaussian(NDIM, a=5.0)
    plain = rule_eval.apply_rule_plain(g, tables, *t)
    # 1.5 times the limit of region 7
    vals, u = kernel_check.value_scales(g, tables, *t)
    s_est, _ = kernel_check.roundoff_scales(u, tables, t[1], t[3])
    fi = torch.finfo(dtype)
    est = plain[0].clone()
    est[7] += 1.5 * (kernel_check.RTOL[dtype] * est[7].abs() + fi.tiny
                     + kernel_check.ULPS["est"] * fi.eps * s_est[7])
    with pytest.raises(AssertionError, match=" est: 1 of"):
        _judge((est, plain[1], plain[2]), plain, g, tables, t)
    err = plain[1].clone()
    err[3] = float("nan")
    with pytest.raises(AssertionError, match=" err: 1 of"):
        _judge((plain[0], err, plain[2]), plain, g, tables, t)


def test_split_dim_off_a_tie_fails():
    t = _pool(torch.float64)
    tables = rule_eval.rule_tables(NDIM)
    g = genz.f2_product_peak(NDIM, a=5.0)
    plain = rule_eval.apply_rule_plain(g, tables, *t)
    assert _judge(plain, plain, g, tables, t)["agree"] == 1.0
    sdim = plain[2].clone()
    sdim[0] = (sdim[0] + 1) % NDIM
    with pytest.raises(AssertionError, match="not a near-tie"):
        _judge((plain[0], plain[1], sdim), plain, g, tables, t)


def test_check_against_plain_real_and_padding_slots(monkeypatch):
    """check_against_plain reads only the real slots of a blocked pool, in
    chunks, and fails a kernel that writes into the padding slots (the
    plain version stands in for the kernel here)."""
    t = _pool(torch.float64, cap=256)
    tables = rule_eval.rule_tables(NDIM)
    g = genz.f5_c0_continuous(NDIM)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def plain_kernel(f, tables, *pool, n, blocked):
        return rule_eval.apply_rule_plain(f, tables, *pool, n=n,
                                          blocked=blocked)

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", plain_kernel)
    r = kernel_check.check_against_plain(g, tables, *t, n=200, blocked=True,
                                         chunk=48)
    assert r["regions"] == 200 and r["est_ulps"] == r["err_ulps"] == 0.0

    def padding_writer(f, tables, *pool, n, blocked):
        est, err, sdim = plain_kernel(f, tables, *pool, n=n, blocked=blocked)
        est = est.clone()
        est[120] = 1.0            # slots 100..127 are padding
        return est, err, sdim

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", padding_writer)
    with pytest.raises(AssertionError, match="padding"):
        kernel_check.check_against_plain(g, tables, *t, n=200, blocked=True)
