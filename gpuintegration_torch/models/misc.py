"""Miscellaneous benchmark integrands from the reference's zoo (PyTorch port
of ``gpuintegration_tpu/models/misc.py``).

(reference: common/cuda/integrands.cuh -- G_func_5..10D:562-760,
SinSum_3..8D:1236-1302, Addition_3..8D:1169-1235, Oscillatory_2..10D:987-1168;
cuda/mcubes/demos/Gauss9D.cu:6-45; test/cuda/pagani/BoxIntegrals.cu:16-51.)
All are batched torch callables over (..., ndim), evaluated in the type of
their input; truths are closed forms for the stated volumes, computed in
NumPy as the JAX package computes them.  None carries a Genz family id, so
on the card every one of them takes the rule's split route
(``ops.cuda_rule.cuda_apply_rule_split``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpuintegration_torch.models.genz import (
    GenzIntegrand, _axis_tensor, _osc_truth, _sin_sum_truth)
from gpuintegration_torch.types import Volume


def g_function(ndim: int) -> GenzIntegrand:
    """Sobol G-function with the reference's coefficients a_i = trunc((i-1)/2)
    for 1-based i (C integer division (i-2)/2, G_func_10D integrands.cuh:576-585).
    Every factor integrates to 1 over [0,1], so the truth is exactly 1."""
    a = np.array([int((i - 2) / 2) if i >= 2 else 0
                  for i in range(1, ndim + 1)], dtype=np.float64)

    def f(x):
        at = _axis_tensor(a, x)
        return torch.prod((torch.abs(4.0 * x - 2.0) + at) / (1.0 + at),
                          dim=-1)

    return GenzIntegrand("g_function", ndim, f, 1.0)


def sin_sum(ndim: int, lows=None, highs=None) -> GenzIntegrand:
    """sin(x_1 + ... + x_n) (SinSum_6D integrands.cuh:1263-1270).  Truth over
    a general box [a,b]^n: Im prod_j (e^{i b_j} - e^{i a_j}) / i."""
    if lows is None:
        truth = _sin_sum_truth(np.ones(ndim))
    else:
        z = 1.0 + 0.0j
        for lo, hi in zip(np.atleast_1d(lows), np.atleast_1d(highs)):
            z *= (np.exp(1j * hi) - np.exp(1j * lo)) / 1j
        truth = float(z.imag)

    def f(x):
        return torch.sin(torch.sum(x, dim=-1))

    return GenzIntegrand("sin_sum", ndim, f, truth)


def addition(ndim: int) -> GenzIntegrand:
    """sum x_i over the unit cube (Addition_8D integrands.cuh:1169-1184);
    truth = n/2."""

    def f(x):
        return torch.sum(x, dim=-1)

    return GenzIntegrand("addition", ndim, f, ndim / 2.0)


def oscillatory(ndim: int) -> GenzIntegrand:
    """cos(sum x_i) over the unit cube (Oscillatory_6D
    integrands.cuh:1055-1070): Genz F1 with unit coefficients, here as a
    plain callable."""
    truth = _osc_truth(np.ones(ndim))

    def f(x):
        return torch.cos(torch.sum(x, dim=-1))

    return GenzIntegrand("oscillatory", ndim, f, truth)


def gauss9d(sigma: float = 0.01):
    """Normalised 9D Gaussian, sigma=0.01, over [-1,1]^9 with truth ~1
    (reference: cuda/mcubes/demos/Gauss9D.cu:6-45).

    Returns (integrand, Volume)."""
    ndim = 9
    norm = 1.0 / (sigma * math.sqrt(2.0 * math.pi)) ** ndim

    def f(x):
        return norm * torch.exp(-torch.sum(x * x, dim=-1)
                                / (2.0 * sigma ** 2))

    vol = Volume(lows=[-1.0] * ndim, highs=[1.0] * ndim)
    truth = math.erf(1.0 / (sigma * math.sqrt(2.0))) ** ndim
    return GenzIntegrand("gauss9d", ndim, f, truth), vol


_W5 = np.array([4.0, 5.0, 6.0, 7.0, 8.0])


def abs_cos_sum_5d(normalized: bool = False) -> GenzIntegrand:
    """|cos(4v + 5w + 6x + 7y + 8z)| over the unit 5-cube (reference:
    cuda/pagani/demos/function.cuh:83-91 absCosSum5DWithoutK;
    genz_1abs_5d.cuh:14-23 is the same integrand scaled by 1/0.6371054).
    No closed form; the reference's stated estimate is 0.6371054."""
    truth = 0.6371054
    norm = 1.0 / truth if normalized else 1.0

    def f(x):
        return norm * torch.abs(torch.cos(torch.sum(_axis_tensor(_W5, x) * x,
                                                    dim=-1)))

    name = "genz_1abs_5d" if normalized else "abs_cos_sum_5d"
    return GenzIntegrand(name, 5, f, 1.0 if normalized else truth)


def cos_sum_plus1_5d() -> GenzIntegrand:
    """cos(4v + 5w + 6x + 7y + 8z) + 1 over the unit 5-cube (reference:
    function.cuh:93-101 absCosSum5DWithoutKPlus1).  Exact truth:
    the Genz-oscillatory closed form plus the unit-cube volume."""
    truth = _osc_truth(_W5) + 1.0

    def f(x):
        return torch.cos(torch.sum(_axis_tensor(_W5, x) * x, dim=-1)) + 1.0

    return GenzIntegrand("cos_sum_plus1_5d", 5, f, truth)


def diagonal_ridge_2d():
    """4k u^2 / (0.01 + (u - v - 1/3)^2) over [-1,1]^2, a narrow diagonal
    ridge; k chosen so the integral is 1 (reference:
    cuda/pagani/demos/diagonalRidge2D.cu:10-25).

    Returns (integrand, Volume)."""
    k = 0.01890022674239546529975841

    def f(x):
        u, v = x[..., 0], x[..., 1]
        return 4.0 * k * u * u / (0.01 + (u - v - 1.0 / 3.0) ** 2)

    vol = Volume(lows=[-1.0, -1.0], highs=[1.0, 1.0])
    return GenzIntegrand("diagonal_ridge_2d", 2, f, 1.0), vol


def fun6() -> GenzIntegrand:
    """fun6(u,v,w,x,y,z) = N (uv + w^y x y / (1+u) + z^2), normalised to
    integrate to 1 over the unit 6-cube (reference:
    cuda/pagani/demos/fun6.cuh:9-17, normalization from Mathematica)."""
    norm = 12.0 / (7.0 - 6.0 * math.log(2.0) ** 2 + math.log(64.0))

    def f(x):
        u, v, w, xx, y, z = (x[..., i] for i in range(6))
        return norm * (u * v + (w ** y) * xx * y / (1.0 + u) + z * z)

    return GenzIntegrand("fun6", 6, f, 1.0)


def xyz() -> GenzIntegrand:
    """x*y*z over the unit cube, truth 1/8 (reference:
    cuda/pagani/demos/XYZ.cu:9-23)."""

    def f(x):
        return torch.prod(x, dim=-1)

    return GenzIntegrand("xyz", 3, f, 0.125)


# published box-integral values (Bailey-Borwein-Crandall box-integral
# literature; the reference pins its demos/tests to the same constants,
# test/cuda/pagani/BoxIntegrals.cu:25,42)
_BOX_PUBLISHED = {
    (8, 15): 8879.851175413485,
    (8, 25): 14996089.096112404019,
}


def box_integral(ndim: int, s: float) -> GenzIntegrand:
    """Box integral B_n(s) = integral of (sum x_i^2)^(s/2) over [0,1]^n
    (reference: test/cuda/pagani/BoxIntegrals.cu and the B8_* demos).
    Truths: exact for even integer s (moment recursion in n); published
    constants for the reference's odd-s cases; otherwise a deterministic
    numeric estimate flagged ``truth_exact=False``."""
    key = (ndim, int(s)) if s == int(s) else None
    if key in _BOX_PUBLISHED:
        truth, exact = _BOX_PUBLISHED[key], True
    else:
        truth = _box_truth(ndim, s)
        exact = bool((s == int(s) and int(s) % 2 == 0) or ndim <= 3)

    def f(x):
        return torch.sum(x * x, dim=-1) ** (s / 2.0)

    return GenzIntegrand(f"box_{ndim}d_s{s}", ndim, f, truth,
                         truth_exact=exact)


def _box_truth(ndim: int, s: float) -> float:
    """Exact for even s (moments of sums of squares); high-accuracy numeric
    (tensor Gauss-Legendre for ndim <= 3, else a Halton quasi-Monte-Carlo
    mean) otherwise."""
    if s == int(s) and int(s) % 2 == 0:
        # E[(u_1 + ... + u_n)^k] with u_i = x_i^2 independent, k = s/2,
        # built dimension by dimension from the moments E[u^j] = 1/(2j+1)
        k = int(s) // 2
        dp = [1.0] + [0.0] * k
        for _ in range(ndim):
            new = [0.0] * (k + 1)
            for j in range(k + 1):
                for t in range(j + 1):
                    new[j] += math.comb(j, t) * dp[j - t] / (2 * t + 1)
            dp = new
        return dp[k]
    if ndim <= 3:
        nodes, wts = np.polynomial.legendre.leggauss(64)
        nodes = 0.5 * (nodes + 1.0)
        wts = 0.5 * wts
        grids = np.meshgrid(*([nodes] * ndim), indexing="ij")
        w = np.ones_like(grids[0])
        for g in np.meshgrid(*([wts] * ndim), indexing="ij"):
            w = w * g
        r2 = sum(g * g for g in grids)
        return float(np.sum(w * r2 ** (s / 2.0)))
    n_pts = 1 << 21
    primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47][:ndim]
    idx = np.arange(1, n_pts + 1, dtype=np.int64)
    cols = []
    for p_ in primes:
        h = np.zeros(n_pts)
        f_, i_ = 1.0 / p_, idx.copy()
        while i_.max() > 0:
            h += f_ * (i_ % p_)
            i_ //= p_
            f_ /= p_
        cols.append(h)
    x = np.stack(cols, axis=1)
    return float(np.mean(np.sum(x * x, axis=1) ** (s / 2.0)))
