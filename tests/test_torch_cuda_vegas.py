"""The four VEGAS kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_vegas.py

The checks themselves (gpuintegration_torch/mcubes/kernel_check.py) are
rehearsed on the CPU by tests/test_torch_vegas_kernels.py.
"""
import math

import pytest
import torch

from gpuintegration_torch.mcubes import integrate, kernel_check
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.models import genz


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("rng", ["input", "device"])
@pytest.mark.parametrize("with_hist", [False, True])
@pytest.mark.parametrize("position", ["end", "middle"])
def test_sampler_matches_plain_on_card(position, with_hist, rng):
    """Emit mode and every fused Genz family, 5D in a non-unit volume: the
    chunk whose last cubes lie beyond the lattice, and the one around the
    volume's centre."""
    _card()
    case = kernel_check.sampler_case(
        5, 2e5, 4096, nbins=50, degree=8, seed=3, position=position,
        lows=[0.1, -1.0, 0.0, 0.0, 0.2], highs=[0.9, 2.0, 1.0, 0.5, 1.2])
    kernel_check.check_sampler(case, None, with_hist=with_hist, rng=rng)
    for g in genz.genz_suite(5):
        kernel_check.check_sampler(case, g, with_hist=with_hist, rng=rng)


# (ndim, ncall, chunk): one dimension; sixteen (ng 2, 152 samples a cube,
# four generator blocks a sample); a lattice of 20^8 > 2^32 cubes
EXTREME_SHAPES = [(1, 2e4, 4096), (16, 1e7, 256), (8, 5.2e10, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,chunk", [(6, 1e6, 1 << 14)]
                         + EXTREME_SHAPES)
def test_stream_matches_plain_on_card(ndim, ncall, chunk):
    _card()
    kernel_check.check_stream(kernel_check.sampler_case(ndim, ncall, chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,ncall,chunk", EXTREME_SHAPES)
def test_extreme_shapes_match_plain_on_card(ndim, ncall, chunk):
    """Run-time sample and dimension loops and 64-bit cube ids: no shape
    needs another route than the kernels."""
    _card()
    case = kernel_check.sampler_case(ndim, ncall, chunk, nbins=100)
    if ndim == 8:
        assert case["cube0"] > 2 ** 32
    kernel_check.check_sampler(case, None, with_hist=True, rng="device")
    kernel_check.check_sampler(case, genz.f5_c0_continuous(ndim),
                               with_hist=True, rng="device")
    kernel_check.check_bin_resolve_stratified(ndim, ncall, chunk, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,nbins", [(1, 11), (6, 500), (16, 500)])
def test_lookup_kernels_match_plain_on_card(ndim, nbins):
    _card()
    kernel_check.check_hist(ndim, 30_011, nbins)
    kernel_check.check_bin_resolve(ndim, 30_011, nbins)
    kernel_check.check_bin_resolve_stratified(ndim, 1e7, 1 << 13, nbins)
    kernel_check.check_edge_lookup(ndim, 1009, 3, nbins)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,cpu_sampler,counts", [
    (dict(), "hybrid", (True, True, False)),
    (dict(eval_dtype=torch.float32), "fused", (True, True, False)),
    (dict(importance="grid"), None, (False, True, True)),
])
def test_run_on_card_matches_cpu_and_launches_kernels(kw, cpu_sampler, counts):
    """A 3D run on the card equals the same run on the CPU (the same
    uniforms, another roundoff), repeats bitwise, and went through the
    kernels it should."""
    _card()
    g = genz.f4_gaussian(3, a=5.0)
    args = dict(epsrel=1e-3, ncall=5e4, total_iters=10, adjust_iters=6,
                seed=2, **kw)
    cuda_vegas.launches = 0
    cuda_lookup.hist_launches = cuda_lookup.bin_resolve_launches = 0
    on_card = integrate(g, **args)
    got = (cuda_vegas.launches > 0, cuda_lookup.hist_launches > 0,
           cuda_lookup.bin_resolve_launches > 0)
    assert got == counts
    again = integrate(g, **args)
    assert (again.estimate, again.errorest) == (on_card.estimate,
                                                on_card.errorest)
    on_cpu = integrate(g, device="cpu", sampler=cpu_sampler, **args)
    assert (on_card.status, on_card.iters, on_card.neval) == (
        on_cpu.status, on_cpu.iters, on_cpu.neval)
    assert on_card.estimate == pytest.approx(on_cpu.estimate, rel=1e-6)
    assert on_card.status == 0


@pytest.mark.gpu
def test_other_routes_on_card():
    """A callable without a kernel twin goes through the emit-mode sampler;
    ``sampler='torch'`` keeps a card run on the plain versions; one
    dimension works; 'fused' refuses the callable."""
    _card()

    def peak(x, y):
        return torch.exp(-9.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))

    truth = (math.sqrt(math.pi) / 3.0 * math.erf(1.5)) ** 2
    kw = dict(epsrel=2e-3, ncall=5e4, seed=4)
    for extra, launched in ((dict(), True),
                            (dict(eval_dtype=torch.float32), True),
                            (dict(sampler="torch"), False),
                            (dict(importance="grid", sampler="torch"), False)):
        cuda_vegas.launches = 0
        cuda_lookup.hist_launches = cuda_lookup.bin_resolve_launches = 0
        r = integrate(peak, **kw, **extra)
        assert r.status == 0 and abs(r.estimate - truth) <= 5 * r.errorest
        assert (cuda_vegas.launches > 0) == launched
        assert (cuda_lookup.hist_launches > 0) == launched
        assert cuda_lookup.bin_resolve_launches == 0
    with pytest.raises(NotImplementedError, match="sampler='hybrid'"):
        integrate(peak, sampler="fused", **kw)
    r = integrate(lambda x: torch.cos(x[..., 0]), ndim=1, epsrel=1e-3,
                  ncall=2e4, seed=5)
    assert abs(r.estimate - math.sin(1.0)) <= 5 * r.errorest
