"""State carried across from the JAX package (``gpuintegration_tpu``), so
the port can resume a run that the reference began.

Everything comes in as NumPy arrays and Python numbers (the caller converts
with ``np.asarray``); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.models import genz


def pool_from_reference(lows, lengths, n: int, blocked: bool, *,
                        dtype=torch.float64, device=None):
    """The real regions of a reference ``Workspace.final_pool``
    ``(lows, lengths, n, blocked)``, dims-major (ndim, cap) arrays, as the
    region-major (n, ndim) tensors that ``Workspace.integrate`` takes as
    ``initial_regions``.  A blocked pool holds its real regions in the
    first n/2 slots of each static half (region_pool.block_mask)."""
    lows = np.asarray(lows)
    lengths = np.asarray(lengths)
    if blocked:
        half = lows.shape[1] // 2
        keep = np.concatenate([np.arange(n // 2), half + np.arange(n // 2)])
    else:
        keep = np.arange(n)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a[:, keep].T),
                               dtype=dtype, device=device)

    return put(lows), put(lengths)


def ledger_from_reference(ledger) -> tuple:
    """A reference ledger ``(estimate, errorest, nregions, iters, neval)``
    (``Workspace._ledger_excl_pool``) as the ``ledger=`` seed of
    ``Workspace.integrate``."""
    est, err, nregions, iters, neval = ledger
    return float(est), float(err), int(nregions), int(iters), int(neval)


def genz_from_reference(name: str, ndim: int, **params) -> genz.GenzIntegrand:
    """The port's Genz integrand of the reference family ``name``
    (``GenzIntegrand.name``: "f1_oscillatory", ..., "f6_discontinuous")
    with the same parameters (``coeffs``/``offset``, ``a``/``b``,
    ``bounds``)."""
    try:
        make = genz.FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown Genz family {name!r}; "
                         f"one of {sorted(genz.FAMILIES)}") from None
    return make(ndim, **params)
