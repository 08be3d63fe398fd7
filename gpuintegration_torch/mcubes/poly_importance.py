"""Polynomial inverse-CDF importance sampling (PyTorch port of
``gpuintegration_tpu/mcubes/poly_importance.py``).

The per-dimension VEGAS importance map is represented as a polynomial:

    q_d(s)  ~ sqrt(G_d'(s))      least-squares Chebyshev-basis fit
    P_d(s)  = int_0^s q_d^2 / int_0^1 q_d^2

``P_d`` is monotone by construction (derivative q^2 >= 0), P(0)=0,
P(1)=1.  Sampling x = P(s) for stratified-uniform s with weight P'(s) is
*exactly* unbiased for ANY such P -- the polynomial only approximates the
grid's variance-optimal shape, never the answer.  On the card the series
are evaluated inside the fused sampler kernel (mcubes/cuda_vegas.py); the
tensor functions here are the plain PyTorch chunk body's.

The adaptation loop is unchanged: the f^2 histogram is still accumulated
in s-bins and refined with the standard smoothing+rebin; each iteration
re-fits the polynomial from the refined grid: on the host in NumPy
(``fit_importance_poly``, bit for bit the JAX package's fit), or, under
``refine='device'``, on the device as one fixed linear map
(``fit_importance_poly_device``, equal to the host fit to lstsq roundoff).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_DEGREE = 14


def fit_importance_poly(xi: np.ndarray, degree: int = DEFAULT_DEGREE):
    """Fit per-dimension polynomials to the grid's importance map.

    xi: (ndim, nbins+1) bin right-edges with xi[:,0]=0.
    Returns (p_cheb (ndim, 2*degree+2), q_cheb (ndim, degree+1)):
    CHEBYSHEV-series coefficients (lowest order first, domain [0,1]) of
    the normalised map P and of q/sqrt(norm), whose SQUARE is the map
    derivative P' -- the sampler evaluates the degree-``degree`` q chain
    and squares it instead of evaluating the degree-``2*degree`` P'
    series (half the per-sample arithmetic, algebraically identical).
    The Chebyshev basis is kept end-to-end -- converting the
    squared/integrated series to the power basis is catastrophically
    ill-conditioned beyond ~degree 15 and destroys f32 evaluation.
    """
    xi = np.asarray(xi, np.float64)
    ndim, nbp1 = xi.shape
    nbins = nbp1 - 1
    widths = np.diff(xi, axis=1)                 # (ndim, nbins)
    s_mid = (np.arange(nbins) + 0.5) / nbins

    C = np.polynomial.chebyshev
    p_list, q_list = [], []
    for d in range(ndim):
        # G'(s) = width * nbins; fit sqrt to compress dynamic range
        gprime = np.maximum(widths[d] * nbins, 1e-30)
        q = np.sqrt(gprime)
        cheb = C.Chebyshev.fit(s_mid, q, degree, domain=[0.0, 1.0])
        q2 = cheb * cheb                         # P' (unnormalised), Cheb
        P = q2.integ()                           # antiderivative, Cheb
        p0 = P(0.0)
        norm = P(1.0) - p0
        p_coef = P.coef / norm
        p_coef[0] -= p0 / norm                   # P(0) = 0 exactly-ish
        p_list.append(p_coef)
        q_list.append(cheb.coef / np.sqrt(norm))
    return np.stack(p_list), np.stack(q_list)


@functools.lru_cache(maxsize=8)
def _fit_tables(nbins: int, degree: int):
    """NumPy constants that make the Chebyshev fit a LINEAR map, built
    through numpy.polynomial so the convention (domain [0,1], window
    [-1,1], integration scaling) is the host fit's by definition:

    * PINV (kq, nbins): pseudo-inverse of the Chebyshev pseudo-Vandermonde
      at the bin midpoints; ``PINV @ q`` is the least-squares fit;
    * SQ (kq, kq, kq2): the product tensor T_i T_j = (T_{i+j} +
      T_{|i-j|}) / 2, which squares a series;
    * INTEG (kp, kq2): the antiderivative map, domain scaling included;
    * E0, E1 (kp,): evaluation at s = 0 and s = 1.

    Cached as NumPy; ``fit_tables`` holds them as device tensors."""
    C = np.polynomial.chebyshev
    kq = degree + 1
    kq2 = 2 * degree + 1
    kp = kq2 + 1
    s_mid = (np.arange(nbins) + 0.5) / nbins
    V = C.chebvander(2.0 * s_mid - 1.0, degree)          # (nbins, kq)
    pinv = np.linalg.pinv(V)                             # (kq, nbins)
    sq = np.zeros((kq, kq, kq2))
    for i in range(kq):
        for j in range(kq):
            sq[i, j, i + j] += 0.5
            sq[i, j, abs(i - j)] += 0.5
    integ = np.zeros((kp, kq2))
    for k in range(kq2):
        e = np.zeros(kq2)
        e[k] = 1.0
        col = C.Chebyshev(e, domain=[0.0, 1.0]).integ().coef
        integ[:len(col), k] = col
    e0 = np.array([C.Chebyshev(np.eye(kp)[k], domain=[0.0, 1.0])(0.0)
                   for k in range(kp)])
    e1 = np.array([C.Chebyshev(np.eye(kp)[k], domain=[0.0, 1.0])(1.0)
                   for k in range(kp)])
    return pinv, sq, integ, e0, e1


_device_tables: dict = {}


def fit_tables(nbins: int, degree: int, device) -> tuple:
    """``_fit_tables`` as f64 tensors on ``device``, copied there once per
    (nbins, degree, device): a caller about to capture a CUDA graph
    calls this first, since a host-to-device copy inside a capture breaks
    it."""
    device = torch.device(device)
    key = (nbins, degree, device.type, device.index)
    if key not in _device_tables:
        _device_tables[key] = tuple(
            torch.as_tensor(m, dtype=torch.float64, device=device)
            for m in _fit_tables(nbins, degree))
    return _device_tables[key]


def fit_importance_poly_device(xi, degree: int = DEFAULT_DEGREE):
    """The device twin of ``fit_importance_poly``: the same fit as one small
    f64 product and fixed bilinear and linear maps (``_fit_tables``), with
    no host read, so it runs inside a captured adjustment iteration.
    Equal to the host fit to lstsq roundoff (~1e-12 on the coefficients).

    xi: (ndim, nbins+1) tensor (any float dtype).
    Returns (p (ndim, 2*degree+2), q (ndim, degree+1)) f64 on xi's device."""
    ndim, nbp1 = xi.shape
    nbins = nbp1 - 1
    pinv, sq, integ, e0, e1 = fit_tables(nbins, degree, xi.device)
    w = torch.diff(xi.to(torch.float64), dim=1) * nbins
    q = torch.sqrt(torch.clamp(w, min=1e-30))            # (ndim, nbins)
    cheb = q @ pinv.T                                    # (ndim, kq)
    q2 = torch.einsum("di,dj,ijk->dk", cheb, cheb, sq)
    P = q2 @ integ.T                                     # (ndim, kp)
    p0 = P @ e0
    norm = P @ e1 - p0
    p = P / norm[:, None]
    p[:, 0] -= p0 / norm
    return p, cheb / torch.sqrt(norm)[:, None]


def clenshaw(coeff_row, k: int, t):
    """Clenshaw evaluation of a Chebyshev series c_0..c_{k-1} at t in
    [-1,1]; coeff_row a (k,) tensor."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for i in range(k - 1, 0, -1):
        b1, b2 = coeff_row[i] + 2.0 * t * b1 - b2, b1
    return coeff_row[0] + t * b1 - b2


def eval_map_and_weight(p_coeffs, q_coeffs, s):
    """Vectorised per-dim map evaluation.

    p_coeffs: (ndim, kp), q_coeffs: (ndim, kq) Chebyshev-series tensors on
    domain [0,1]; s: (..., ndim) in [0,1].
    Returns (coords (...,ndim), weight (...)) with
    weight = prod_d P_d' = prod_d (q_d)^2.

    One joint T_i recurrence per dim accumulates BOTH dot products
    (coords from the kp-term P series, the weight's q from its first kq
    terms), as the kernel does.
    """
    ndim, kp = p_coeffs.shape
    kq = q_coeffs.shape[1]
    coords = []
    wgt = None
    for d in range(ndim):
        t = 2.0 * s[..., d] - 1.0                # domain [0,1] -> [-1,1]
        t2 = t + t
        p = p_coeffs[d]
        q = q_coeffs[d]
        acc_p = p[0] + p[1] * t                  # T_0 = 1, T_1 = t
        acc_q = q[0] + (q[1] * t if kq > 1 else torch.zeros_like(t))
        t_prev, t_cur = torch.ones_like(t), t
        for i in range(2, kp):
            t_next = t2 * t_cur - t_prev
            acc_p = acc_p + p[i] * t_next
            if i < kq:
                acc_q = acc_q + q[i] * t_next
            t_prev, t_cur = t_cur, t_next
        # clamp: the f32-cast coefficients put P(0) ~ -5e-8 and
        # P(1) ~ 1+1e-7, so an ~1e-7-measure band of samples would land
        # OUTSIDE the unit cube -- one NaN from a domain-edge integrand
        # (sqrt, log1p) poisons the whole iteration.  The clip's bias is
        # below f32 coordinate granularity
        coords.append(torch.clamp(acc_p, 0.0, 1.0))
        w = acc_q * acc_q
        wgt = w if wgt is None else wgt * w
    return torch.stack(coords, dim=-1), wgt
