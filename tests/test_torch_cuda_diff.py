"""The differentiable estimates (``gpuintegration_torch.diff``) on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_diff.py

The same seed draws the same bits on the CPU and on the card
(``diff.frozen_draws``), and the edge lookup gives copies of table entries
on both, so the frozen estimate on the card is the CPU's to the roundoff of
the f64 sums and of ``exp`` (1e-12 relative).  The fixed-mesh estimate runs
the plain rule on both devices (1e-12 relative)."""
import math

import pytest
import torch

from gpuintegration_torch import diff
from gpuintegration_torch.mcubes import cuda_lookup, kernel_check

F64 = torch.float64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def gauss(x, a):
    return torch.exp(-a * torch.sum((x - 0.5) ** 2, dim=-1))


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.gpu
@pytest.mark.parametrize("ndim,nbins,n", [(2, 50, 20001), (6, 500, 1 << 16)])
def test_frozen_estimate_on_card_matches_cpu(ndim, nbins, n):
    """The same seed on both devices: the same estimate, error and
    gradient; on the card every edge lookup goes through the vector route,
    inside ``torch.func.grad`` and ``vmap`` as well."""
    _card()
    xi = kernel_check.random_grid(ndim, nbins, 1)
    on_cpu = diff.frozen_grid_estimate(gauss, xi, ndim, ncall=n,
                                       device="cpu")
    on_card = diff.frozen_grid_estimate(gauss, xi, ndim, ncall=n)
    a_cpu = torch.tensor(3.0, dtype=F64)
    a = a_cpu.cuda()
    for got, want in zip(on_card(a, 9), on_cpu(a_cpu, 9)):
        assert rel(got, want) <= 1e-12
    cuda_lookup.reset_launches()
    g = torch.func.grad(lambda t: on_card(t, 9)[0])(a)
    assert cuda_lookup.edge_route_launches == {"vector": 1, "generic": 0}
    assert rel(g, torch.func.grad(lambda t: on_cpu(t, 9)[0])(a_cpu)) <= 1e-12
    thetas = torch.tensor([1.0, 3.0, 9.0], dtype=F64, device="cuda")
    ests, _ = torch.func.vmap(lambda t: on_card(t, 9))(thetas)
    assert cuda_lookup.edge_route_launches["vector"] == 2
    for i, t in enumerate(thetas):
        assert rel(ests[i], on_card(t, 9)[0]) <= 1e-12


@pytest.mark.gpu
def test_train_grid_and_frozen_estimate_on_card():
    _card()
    xi = diff.train_grid(gauss, 3, theta=9.0, ncall=1e5, adjust_iters=6,
                         seed=2)
    assert xi.device.type == "cuda" and tuple(xi.shape) == (3, 501)
    est, err = diff.frozen_grid_estimate(gauss, xi, 3, ncall=1e6)(9.0, 4)
    truth = (math.sqrt(math.pi / 9.0) * math.erf(1.5)) ** 3
    assert abs(float(est) - truth) <= 5 * float(err)


@pytest.mark.gpu
def test_fixed_mesh_on_card_matches_cpu():
    _card()
    a_cpu = torch.tensor(4.0, dtype=F64)
    on_cpu = diff.fixed_mesh_integral(gauss, 3, partitions_per_axis=6,
                                      device="cpu")
    on_card = diff.fixed_mesh_integral(gauss, 3, partitions_per_axis=6)
    est, err = on_card(a_cpu.cuda())
    est_c, err_c = on_cpu(a_cpu)
    assert rel(est, est_c) <= 1e-12
    assert abs(float(err) - float(err_c)) <= 1e-13 * float(est_c)
    g = torch.func.grad(lambda t: on_card(t)[0])(a_cpu.cuda())
    assert rel(g, torch.func.grad(lambda t: on_cpu(t)[0])(a_cpu)) <= 1e-12
