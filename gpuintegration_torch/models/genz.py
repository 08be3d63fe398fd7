"""Genz integrand family battery with analytic truths (PyTorch port of
``gpuintegration_tpu/models/genz.py``).

Each family is a batched torch callable over (..., ndim) tensors plus a
closed-form ``true_value``.  The arithmetic forms follow the reference
(F2 takes one division of the denominator product, F3 an integer power),
so the port and the JAX package evaluate the same expressions.  Every
family's ``GenzIntegrand`` also carries its ``kind`` (1..6) and parameters,
from which the fused CUDA rule kernel (ops/cuda_rule.py) builds the same
function on the card; one that carries none (``kind=None``, the integrands
of ``models.misc``) takes the rule's split route there.

Default parameters match the reference's 8D/7D/6D/5D instances:
  F1 oscillatory:   cos(offset + sum a_i x_i), a_i = i+1
  F2 product peak:  prod 1/(a^-2 + (x_i-b)^2), a=50, b=.5
  F3 corner peak:   (1 + sum a_i x_i)^-(n+1), a_i = i+1
  F4 gaussian:      exp(-sum a^2 (x_i-b)^2), a=25, b=.5
  F5 c0-continuous: exp(-a sum |x_i-b|), a=10, b=.5
  F6 discontinuous: exp(sum a_i x_i) on x_i <= b_i else 0,
                    a_i = i+3, b_i = (i+2)/10
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GenzIntegrand:
    """A batched integrand, its exact integral over [0,1]^n, and the
    family id and parameters the fused CUDA kernel needs (None for an
    integrand of no Genz family).

    ``params``: ``coeffs`` (per-axis a_i, F1/F3/F6), ``offset`` (F1),
    ``a``/``b`` (scalar F2/F4/F5), ``bounds`` (per-axis b_i, F6).
    ``truth_exact``: False when ``true_value`` is a high-accuracy numeric
    estimate rather than a closed form."""

    name: str
    ndim: int
    f: Callable
    true_value: float
    kind: int | None = None
    params: dict | None = None
    truth_exact: bool = True

    def __call__(self, x):
        return self.f(x)


# ---------------------------------------------------------------------------
# closed forms (unit cube)

def _phase_integral(coeffs: np.ndarray, offset: float) -> complex:
    """Integral of e^{i (offset + sum a_i x_i)} over [0,1]^n:
    e^{i offset} prod_j (e^{i a_j} - 1)/(i a_j)."""
    z = np.exp(1j * offset)
    for a in coeffs:
        z = z * (np.exp(1j * a) - 1.0) / (1j * a)
    return z


def _osc_truth(coeffs: np.ndarray, offset: float = 0.0) -> float:
    """Integral of cos(offset + sum a_i x_i) over [0,1]^n."""
    return float(_phase_integral(coeffs, offset).real)


def _sin_sum_truth(coeffs: np.ndarray, offset: float = 0.0) -> float:
    """Integral of sin(offset + sum a_i x_i) over [0,1]^n."""
    return float(_phase_integral(coeffs, offset).imag)


def _product_peak_truth(a: float, b: float, ndim: int) -> float:
    per_dim = a * (math.atan(a * (1.0 - b)) - math.atan(a * (0.0 - b)))
    return per_dim ** ndim


def _corner_peak_truth(coeffs: np.ndarray) -> float:
    """Integral of (1 + sum a_i x_i)^-(n+1) over [0,1]^n by
    inclusion-exclusion:
      1/(n! prod a_i) * sum_{S subset [n]} (-1)^{|S|} / (1 + sum_{i in S} a_i)
    """
    n = len(coeffs)
    total = 0.0
    for mask in range(1 << n):
        s = 1.0 + sum(coeffs[i] for i in range(n) if mask >> i & 1)
        sign = -1.0 if bin(mask).count("1") % 2 else 1.0
        total += sign / s
    return total / (math.factorial(n) * float(np.prod(coeffs)))


def _gaussian_truth(a: float, b: float, ndim: int) -> float:
    per_dim = (math.sqrt(math.pi) / (2 * a)) * (
        math.erf(a * (1.0 - b)) + math.erf(a * b))
    return per_dim ** ndim


def _c0_truth(a: float, b: float, ndim: int) -> float:
    per_dim = (2.0 - math.exp(-a * b) - math.exp(-a * (1.0 - b))) / a
    return per_dim ** ndim


def _discontinuous_truth(coeffs: np.ndarray, bounds: np.ndarray) -> float:
    total = 1.0
    for a, b in zip(coeffs, bounds):
        # the domain is [0,1]: a bound past 1 contributes only up to 1
        total *= (math.exp(a * min(b, 1.0)) - 1.0) / a
    return total


_AXIS_TENSORS: dict = {}


def _axis_tensor(values: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of x's type on x's device, made once for each
    array, type and device: a copy from the host costs a transfer a call,
    and the fused phase's CUDA graph cannot capture one."""
    key = (id(values), x.dtype, x.device)
    hit = _AXIS_TENSORS.get(key)
    if hit is None or hit[0] is not values:
        hit = (values, torch.as_tensor(values, dtype=x.dtype,
                                       device=x.device))
        _AXIS_TENSORS[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# families

def f1_oscillatory(ndim: int, coeffs: Sequence[float] | None = None,
                   offset: float = 0.0) -> GenzIntegrand:
    a = np.asarray(coeffs if coeffs is not None
                   else np.arange(1, ndim + 1), dtype=np.float64)

    def f(x):
        return torch.cos(offset + torch.sum(x * _axis_tensor(a, x), dim=-1))

    return GenzIntegrand("f1_oscillatory", ndim, f, _osc_truth(a, offset),
                         1, {"coeffs": a, "offset": float(offset)})


def f2_product_peak(ndim: int, a: float = 50.0, b: float = 0.5) -> GenzIntegrand:
    def f(x):
        # one division of the denominator product instead of ndim
        return 1.0 / torch.prod(1.0 / a ** 2 + (x - b) ** 2, dim=-1)

    return GenzIntegrand("f2_product_peak", ndim, f,
                         _product_peak_truth(a, b, ndim),
                         2, {"a": float(a), "b": float(b)})


def f3_corner_peak(ndim: int, coeffs: Sequence[float] | None = None) -> GenzIntegrand:
    a = np.asarray(coeffs if coeffs is not None
                   else np.arange(1, ndim + 1), dtype=np.float64)

    def f(x):
        # integer exponent: a multiply chain and one divide, not exp/log
        return (1.0 + torch.sum(x * _axis_tensor(a, x), dim=-1)) ** (-(ndim + 1))

    return GenzIntegrand("f3_corner_peak", ndim, f, _corner_peak_truth(a),
                         3, {"coeffs": a})


def f4_gaussian(ndim: int, a: float = 25.0, b: float = 0.5) -> GenzIntegrand:
    def f(x):
        return torch.exp(-torch.sum((a * a) * (x - b) ** 2, dim=-1))

    return GenzIntegrand("f4_gaussian", ndim, f, _gaussian_truth(a, b, ndim),
                         4, {"a": float(a), "b": float(b)})


def f5_c0_continuous(ndim: int, a: float = 10.0, b: float = 0.5) -> GenzIntegrand:
    def f(x):
        return torch.exp(-a * torch.sum(torch.abs(x - b), dim=-1))

    return GenzIntegrand("f5_c0", ndim, f, _c0_truth(a, b, ndim),
                         5, {"a": float(a), "b": float(b)})


def f6_discontinuous(ndim: int, coeffs: Sequence[float] | None = None,
                     bounds: Sequence[float] | None = None) -> GenzIntegrand:
    a = np.asarray(coeffs if coeffs is not None
                   else np.arange(3, ndim + 3), dtype=np.float64)
    b = np.asarray(bounds if bounds is not None
                   else (np.arange(2, ndim + 2)) / 10.0, dtype=np.float64)

    def f(x):
        inside = torch.all(x <= _axis_tensor(b, x), dim=-1)
        val = torch.exp(torch.sum(x * _axis_tensor(a, x), dim=-1))
        return torch.where(inside, val, torch.zeros_like(val))

    return GenzIntegrand("f6_discontinuous", ndim, f,
                         _discontinuous_truth(a, b),
                         6, {"coeffs": a, "bounds": b})


FAMILIES = {
    "f1_oscillatory": f1_oscillatory,
    "f2_product_peak": f2_product_peak,
    "f3_corner_peak": f3_corner_peak,
    "f4_gaussian": f4_gaussian,
    "f5_c0": f5_c0_continuous,
    "f6_discontinuous": f6_discontinuous,
}


def genz_suite(ndim: int) -> list[GenzIntegrand]:
    """The full F1..F6 battery at a given dimension."""
    return [make(ndim) for make in FAMILIES.values()]
