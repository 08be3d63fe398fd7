"""The generated kernels on the card: a traced per-axis callable inside the
fused rule kernels (``Workspace(rule_backend='fused')``) and the fused
sampler (``vegas(sampler='fused')``), each held against its plain version
(``ops/kernel_check.py``, ``mcubes/kernel_check.py``: ulps of each
output's rounding scale), and the entry points' routes, launches and
decisions.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_generated.py
"""
import math

import pytest
import torch

from gpuintegration_torch import Workspace, mcubes
from gpuintegration_torch.mcubes import cuda_vegas
from gpuintegration_torch.mcubes import kernel_check as vkc
from gpuintegration_torch.ops import (cuda_build, cuda_rule, integrand_gen,
                                      kernel_check, rule_eval)
from gpuintegration_torch.pagani import fused_loop, region_pool


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _key(r):
    return (r.status, r.iters, r.nregions, r.nFinishedRegions, r.neval)


def g3(x, y, z):
    return torch.exp(-25.0 * ((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2))


def gauss(ndim, a2):
    """exp(-a2 sum (x_d - 1/2)^2) as a per-axis callable of ndim
    arguments."""
    names = ", ".join(f"x{d}" for d in range(ndim))
    terms = " + ".join(f"(x{d} - 0.5) ** 2" for d in range(ndim))
    return eval(f"lambda {names}: torch.exp(-{a2!r} * ({terms}))",
                {"torch": torch})


def _pool(ndim, cap, dtype, dev):
    parts = 4 if ndim <= 4 else 2
    lows, lengths, n = region_pool.uniform_split(ndim, parts, cap, dtype,
                                                 dev)
    return lows, lengths, n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,route", [(3, "tile"), (3, "generic"),
                                        (9, "generic")])
def test_generated_rule_kernel_against_plain(ndim, route, dtype):
    dev = _card()
    t = integrand_gen.traced(gauss(ndim, 9.0), ndim)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths, n = _pool(ndim, 4096 if ndim == 3 else 512, dtype, dev)
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.ones(ndim, dtype=dtype, device=dev)
    cuda_rule.reset_launches()
    r = kernel_check.check_against_plain(t, tables, lows, lengths, gl, gr,
                                         n=n, route=route)
    assert r["regions"] == n
    assert cuda_rule.generated_launches[route] == 1
    with pytest.raises(ValueError, match="crease"):
        cuda_rule.cuda_apply_rule(t, tables, lows, lengths, gl, gr,
                                  with_split_frac=True)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,route", [(5, "paired"), (5, "generic"),
                                        (9, "generic")])
def test_generated_sampler_against_plain(ndim, route):
    dev = _card()
    t = integrand_gen.traced(gauss(ndim, 25.0), ndim)
    case = vkc.sampler_case(ndim, 2e5, 1 << 14, device=dev)
    cuda_vegas.reset_launches()
    r = vkc.check_sampler(case, t, with_hist=True, rng="device",
                          route=route)
    assert r["ia_equal"]
    assert cuda_vegas.generated_launches[route] == 1


@pytest.mark.gpu
def test_workspace_fused_backend_on_card():
    """rule_backend='fused' on the card takes the generated tile kernel
    only, never the split route, and the CPU run's decisions; f64 too."""
    _card()
    for dtype in (torch.float32, torch.float64):
        kw = dict(epsrel=1e-4 if dtype == torch.float32 else 1e-7,
                  epsabs=1e-30, fused=False)
        cuda_rule.reset_launches()
        card = Workspace(3, dtype=dtype, chunk_size=1024,
                         rule_backend="fused").integrate(g3, **kw)
        assert cuda_rule.launches > 0
        assert cuda_rule.generated_launches["tile"] == cuda_rule.launches
        assert cuda_rule.split_launches == {"points": 0, "contract": 0}
        cpu = Workspace(3, dtype=dtype, chunk_size=1024, device="cpu",
                        rule_backend="fused").integrate(g3, **kw)
        assert card.status == 0
        if dtype == torch.float64:
            assert _key(card) == _key(cpu)
            assert math.isclose(card.estimate, cpu.estimate, rel_tol=1e-10)
        else:
            assert abs(card.estimate - cpu.estimate) < 1e-5 * cpu.estimate


@pytest.mark.gpu
def test_library_loads_before_the_capture():
    """The generated library is built and loaded by the fused phase's first,
    eager iteration, never inside a CUDA graph's capture: a fresh callable
    runs captured bursts and takes the host loop's decisions."""
    _card()

    def peak(x, y, z):     # F2 at a = 50, a constant no other test uses
        return 1.0 / ((0.000401 + (x - 0.5) ** 2) * (0.000401 + (y - 0.5) ** 2)
                      * (0.000401 + (z - 0.5) ** 2))

    header = integrand_gen.emit_cuda(integrand_gen.trace_axes(peak, 3))
    assert header not in cuda_build._libs
    ws_kw = dict(chunk_size=1024, max_pool_regions=20000,
                 rule_backend="fused")
    fused_loop.reset_stats()
    got = Workspace(3, **ws_kw).integrate(peak, epsrel=1e-8, epsabs=1e-40)
    assert header in cuda_build._libs
    assert fused_loop.stats["captures"] >= 1 and got.status == 0
    host = Workspace(3, **ws_kw).integrate(peak, epsrel=1e-8, epsabs=1e-40,
                                           fused=False)
    assert _key(got) == _key(host)
    assert math.isclose(got.estimate, host.estimate, rel_tol=1e-12)


@pytest.mark.gpu
def test_vegas_fused_per_axis_on_card():
    """sampler='fused' on a per-axis callable runs the generated sampler
    (a frozen phase too); AUTO picks it in f32; an untraceable callable is
    refused under 'fused' and takes 'hybrid' under AUTO."""
    _card()
    g = gauss(5, 25.0)
    truth = (math.sqrt(math.pi / 25.0) * math.erf(2.5)) ** 5
    for kw in (dict(sampler="fused"), dict(eval_dtype=torch.float32),
               dict(sampler="fused", adjust_iters=3, total_iters=12)):
        cuda_vegas.reset_launches()
        r = mcubes.integrate(g, epsrel=1e-3, ncall=2e5, seed=3, **kw)
        assert r.status == 0 and abs(r.estimate - truth) <= 5 * r.errorest
        assert cuda_vegas.generated_launches["paired"] == \
            cuda_vegas.launches > 0
    with pytest.raises(ValueError, match="sampler='hybrid'"):
        mcubes.integrate(lambda x, y: torch.sum(x) * y, ncall=1e4,
                         sampler="fused")
    cuda_vegas.reset_launches()
    mcubes.integrate(lambda x, y: torch.sum(x) * y + 0 * y, ncall=1e4,
                     eval_dtype=torch.float32, total_iters=6)
    assert cuda_vegas.generated_launches["paired"] == 0
