"""VEGAS importance-sampling grid: smoothing and rebinning (PyTorch port of
``gpuintegration_tpu/mcubes/grid.py``; reference: cuda/mcubes/vegasT.cuh
:621-642 rebin, :890-927 bin smoothing and damped redistribution).

The grid is tiny (ndim x NDMX+1 edges, ~32 KB), so -- like the reference,
which round-trips xi/d through the host every adjustment iteration
(vegasT.cuh:797-846) -- it is refined in exact-f64 NumPy on the host.  The
arithmetic is the JAX package's, operation for operation, so a grid refined
here equals the one refined there bit for bit.

Grid representation: xi has shape (ndim, NDMX+1) with xi[:, 0] = 0 and
xi[:, NDMX] = 1; entry k is the right edge of bin k (1-based bins, matching
the NR layout where xi[j][0] is implicitly zero).
"""
from __future__ import annotations

import numpy as np
import torch

NDMX = 500          # bins per dimension (vegas_utils.cuh:137)
ALPH = 1.5          # damping exponent   (vegas_utils.cuh:139)
TINY = 1.0e-30      # variance floor     (vegas_utils.cuh:140)

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def as_numpy(a) -> np.ndarray:
    """A tensor (any device) or array as a NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def uniform_grid(ndim: int, nbins: int = NDMX, dtype=torch.float64,
                 device=None) -> torch.Tensor:
    """Initial equal-width grid: the reference reaches the same state via
    rebin of all-ones weights (vegasT.cuh:742-746).  Edge k is
    k * (1 / nbins) in ``dtype``, a multiply by the rounded reciprocal: the
    bits XLA gives the reference's ``linspace`` on the CPU."""
    npd = _NP_DTYPE[dtype]
    edges = np.arange(nbins + 1, dtype=npd) * (npd(1) / npd(nbins))
    edges[-1] = 1.0
    return torch.as_tensor(np.broadcast_to(edges, (ndim, nbins + 1)).copy(),
                           device=device)


def rebin_row(row_xi: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Redistribute one dimension's bin edges so each new bin holds an equal
    share of the weight ``r`` (vegasT.cuh:621-642), vectorised.

    row_xi: (nbins+1,) current edges with [0]=0; r: (nbins,) weights.
    """
    nbins = r.shape[0]
    cum = np.cumsum(r)                         # cum[k] = r_1 + ... + r_{k+1}
    total = cum[-1]
    targets = np.arange(1, nbins) * (total / nbins)
    # first k with cum[k] >= target  (the reference's while(rc > dr) loop)
    k = np.searchsorted(cum, targets, side="left")
    k = np.clip(k, 0, nbins - 1)
    dr = cum[k] - targets
    xo = row_xi[k]          # left edge of bin k (xi[k-1] in 1-based terms)
    xn = row_xi[k + 1]
    rk = np.where(r[k] > 0, r[k], 1.0)
    inner = xn - (xn - xo) * dr / rk
    out = np.empty_like(row_xi)
    out[0] = 0.0
    out[1:nbins] = inner
    out[nbins] = 1.0
    return out


def smooth_and_refine(xi, d) -> np.ndarray:
    """One grid-adjustment step: 3-bin smoothing of the importance
    histogram, log-damped weights, and rebin -- per dimension
    (vegasT.cuh:890-927).

    xi: (ndim, nbins+1) edges; d: (ndim, nbins) accumulated f^2 mass
    (tensors or numpy arrays).  Returns refined edges as a numpy array;
    dimensions with zero total mass keep their previous edges (the
    reference's ``if (dt[j] > 0.0)`` guard).
    """
    xi = as_numpy(xi)
    # Smooth in f64 and sanitize: the device histogram is f32 and can
    # arrive saturated near f32 max on huge-magnitude integrands
    # (cuda_lookup.HIST_CAP) -- smoothing (left+d+right) in f32 would
    # overflow to inf and NaN the grid.  The f32->f64 cast is exact, so
    # in-range runs are bit-identical.
    d = np.nan_to_num(np.asarray(as_numpy(d), np.float64), nan=0.0,
                      posinf=1e300, neginf=0.0)
    ndim, nbins = d.shape
    if nbins < 2:
        return xi.copy()          # nothing to redistribute

    left = np.concatenate([d[:, :1], d[:, :-1]], axis=1)
    right = np.concatenate([d[:, 1:], d[:, -1:]], axis=1)
    sm = (left + d + right) / 3.0
    sm[:, 0] = (d[:, 0] + d[:, 1]) / 2.0
    sm[:, -1] = (d[:, -2] + d[:, -1]) / 2.0
    # all-zero dims keep their edges exactly (the reference's dt > 0
    # guard); the floor below only matters when SOME mass exists
    dt_raw = sm.sum(axis=1, keepdims=True)
    # NR's TINY floor (vegasT.cuh:897-899): zero-mass bins keep a small
    # rebin weight.  Without it every edge collapses into the bins a
    # narrow early peak touched, starving the rest of the domain of
    # resolution forever (a second mode may never be found)
    sm = np.maximum(sm, TINY)

    dt = sm.sum(axis=1, keepdims=True)                  # (ndim, 1)
    frac = sm / np.where(dt > 0, dt, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        # damped weight ((1-f)/ln(1/f))^ALPH
        r = np.where(frac > 0,
                     ((1.0 - frac) / (-np.log(np.clip(frac, 1e-300, None))))
                     ** ALPH,
                     0.0)
    r = np.nan_to_num(r, nan=0.0, posinf=0.0)

    out = xi.copy()
    for j in range(ndim):
        if dt_raw[j, 0] > 0.0:
            out[j] = rebin_row(xi[j], r[j])
    return out
