"""The CUDA rule kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_rule.py
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval
from gpuintegration_torch.pagani import region_pool


def _pool(ndim, cap, seed):
    """Random sub-boxes of a non-unit volume [gl, gl + gr] inside the
    positive orthant (F3's pole 1 + sum a_i x_i = 0 stays outside)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 0.5, (ndim, cap)),
            rng.uniform(0.01, 0.5, (ndim, cap)),
            rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """Runs on a CUDA card only: the kernel against the plain version on a
    blocked 5D pool, every family, with the tolerances and the near-tie
    rule of kernel_check.check_against_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ndim, cap, n = 5, 2048, 1500
    lows, lengths, gl, gr = _pool(ndim, cap, 1)
    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in (lows, lengths, gl, gr)]
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    for g in genz.genz_suite(ndim):
        kernel_check.check_against_plain(g, tables, *t, n=n, blocked=True,
                                         min_agree=0.0)


def _card_pool(ndim, cap, dtype, seed=1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in _pool(ndim, cap, seed)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", cuda_rule.TILE_NDIMS)
def test_both_routes_match_plain_and_each_other_on_card(ndim, dtype):
    """Every dimension the tile route is compiled for, every family: each
    route against the plain version with kernel_check's unchanged limits,
    and against the other route (split_dim EQUAL, each twice the same
    bits), on plain and blocked pools with ragged tiles and with none."""
    cap = 1024
    t = _card_pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    for g in genz.genz_suite(ndim):
        for n, blocked in ((cap, False), (771, False), (900, True),
                           (6, True), (0, False)):
            for route in cuda_rule.ROUTES:
                kernel_check.check_against_plain(
                    g, tables, *t, n=n, blocked=blocked, min_agree=0.0,
                    route=route)
            r = kernel_check.check_routes(g, tables, *t, n=n,
                                          blocked=blocked)
            assert r["split_dim_equal"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [2, 9, 10, 12, 16])
def test_generic_route_takes_the_other_dimensions_on_card(ndim, dtype):
    """A dimension outside the tile route's set goes through the generic
    kernel (each of its classes of dimensions), every family within
    kernel_check's limits, is counted there, and naming the tile route
    raises.  16D on a small pool (71585 points a region)."""
    cap, n = (64, 48) if ndim == 16 else (512, 400)
    t = _card_pool(ndim, cap, dtype)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    assert cuda_rule.rule_route(ndim) == "generic"
    cuda_rule.reset_launches()
    for g in genz.genz_suite(ndim):
        kernel_check.check_against_plain(g, tables, *t, n=n, blocked=True,
                                         min_agree=0.0)
    assert cuda_rule.route_launches == {"tile": 0, "generic": 6}
    with pytest.raises(ValueError, match="does not take ndim"):
        cuda_rule.cuda_apply_rule(genz.f4_gaussian(ndim), tables, *t,
                                  route="tile")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [2, 3, 9, 12, 16])
def test_generic_route_blocked_nan_and_fraction_on_card(ndim, dtype):
    """The generic kernel on a blocked pool with padding slots (est = err
    = 0, split_dim 0 there) holding a NaN region (NaN estimate, the plain
    version's split axis) and a region where F4 underflows (no positive
    fourth difference: the widest axis): within kernel_check's limits,
    the same bits from two launches, and its crease form
    (check_fused_frac: est and err the bits without the fraction, the
    fraction and split axis EQUAL to the plain version on the collinear
    values it writes out, padding 0.5) on F5 and F6."""
    cap, n = (32, 20) if ndim == 16 else (256, 200)
    lows, lengths, gl, gr = _card_pool(ndim, cap, dtype, seed=4)
    lows[ndim - 1, 3] = float("nan")
    lows[:, cap // 2 + 1] = 40.0
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    g = genz.f4_gaussian(ndim)
    pool = (lows, lengths, gl, gr)
    a, b = (cuda_rule.cuda_apply_rule(g, tables, *pool, n=n, blocked=True,
                                      route="generic") for _ in range(2))
    plain = rule_eval.apply_rule_plain(g, tables, *pool, n=n, blocked=True)
    for x, y in zip(a, b):
        assert kernel_check.same_bits(x, y)
    assert torch.isnan(a[0][3]) and torch.isnan(plain[0][3])
    assert int(a[2][3]) == int(plain[2][3])
    far = cap // 2 + 1
    assert float(a[0][far]) == 0.0 and int(a[2][far]) == int(plain[2][far])
    pad = ~region_pool.block_mask(cap, n, True, lows.device)
    assert not bool(a[0][pad].any() | a[1][pad].any() | a[2][pad].any())
    lows[ndim - 1, 3] = 0.25        # the plain version's scales need values
    lows[:, far] = 0.25
    kernel_check.check_against_plain(g, tables, *pool, n=n, blocked=True,
                                     min_agree=0.0, route="generic")
    for f in (genz.f5_c0_continuous(ndim), genz.f6_discontinuous(ndim)):
        r = kernel_check.check_fused_frac(f, tables, *pool, n=n,
                                          blocked=True, route="generic")
        assert r["regions"] == n


@pytest.mark.gpu
def test_unaligned_pool_takes_ordinary_loads_on_card():
    """A pool whose rows are not 16-byte aligned (an odd capacity) cannot
    be fetched by bulk copies; the tile route reads it by ordinary loads
    and gives the same answers."""
    ndim, cap = 5, 1021
    t = _card_pool(ndim, cap, torch.float64)
    tables = rule_eval.rule_tables(ndim, "float64")
    g = genz.f4_gaussian(ndim)
    kernel_check.check_against_plain(g, tables, *t, n=1000, blocked=False,
                                     min_agree=0.0, route="tile")
    kernel_check.check_routes(g, tables, *t, n=1000, blocked=False)


@pytest.mark.gpu
def test_nan_and_inf_values_take_the_same_branch_on_card():
    """A pool holding a NaN corner and a region far outside the peak (an
    integrand that underflows to 0 everywhere: no positive fourth
    difference): both routes give the plain version's split axis there
    (the widest axis) and NaN estimates where it has them."""
    ndim, cap = 5, 256
    lows, lengths, gl, gr = _card_pool(ndim, cap, torch.float64)
    lows[2, 7] = float("nan")
    lows[:, 9] = 40.0
    lengths[:, 9] = torch.tensor([0.1, 0.3, 0.2, 0.25, 0.05],
                                 dtype=torch.float64, device="cuda")
    tables = rule_eval.rule_tables(ndim, "float64")
    g = genz.f4_gaussian(ndim)
    plain = rule_eval.apply_rule_plain(g, tables, lows, lengths, gl, gr)
    for route in cuda_rule.ROUTES:
        k = cuda_rule.cuda_apply_rule(g, tables, lows, lengths, gl, gr,
                                      route=route)
        assert torch.isnan(k[0][7]) and torch.isnan(plain[0][7])
        assert int(k[2][7]) == int(plain[2][7])
        assert float(k[0][9]) == 0.0 and int(k[2][9]) == int(plain[2][9]) == 1
