"""State carried across from the JAX package (``gpuintegration_tpu``), so
the port can resume a run that the reference began.

Everything comes in as NumPy arrays and Python numbers (the caller converts
with ``np.asarray``); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.mcubes.vegas import VegasState
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils.checkpoint import (PaganiCheckpoint,
                                                   scalar_or_array)


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
    ``Workspace.integrate``: floats, or (ncomp,) arrays for a vector
    integrand's."""
    est, err, nregions, iters, neval = ledger
    return (scalar_or_array(est), scalar_or_array(err), int(nregions),
            int(iters), int(neval))


def checkpoint_from_reference(ck) -> PaganiCheckpoint:
    """The port's ``PaganiCheckpoint`` of a reference one
    (``Workspace.make_checkpoint()`` of the JAX package, its arrays as
    NumPy): the same pool, ledger and per-region sweep, so that
    ``Workspace.integrate(initial_regions=..., ledger=ck.ledger)`` and
    ``diff.mesh_from_checkpoint`` take it as they take the port's own.  A
    vector run's (ncomp,) ledger and (n, ncomp) region arrays come across
    as they are."""
    def arr(a):
        return None if a is None else np.array(a)

    return PaganiCheckpoint(
        lows=arr(ck.lows), lengths=arr(ck.lengths),
        estimate=scalar_or_array(ck.estimate),
        errorest=scalar_or_array(ck.errorest), nregions=int(ck.nregions),
        iters=int(ck.iters), neval=int(ck.neval),
        region_estimates=arr(ck.region_estimates),
        region_errorests=arr(ck.region_errorests))


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


def vegas_state_from_reference(xi, si, swgt, schi, it0, n_acc, *,
                               dtype=torch.float64, device=None) -> VegasState:
    """The port's ``VegasState`` from the fields of a reference
    ``mcubes.VegasState`` (``xi`` as a NumPy array, the rest Python
    numbers, or (ncomp,) arrays for a vector integrand's accumulators), so
    that ``mcubes.vegas(state=...)`` continues a run the reference
    adapted: the grid is taken bit for bit, and ``it0`` keeps the
    continuation's streams apart from the iterations already counted."""
    return VegasState(
        xi=torch.as_tensor(np.array(xi), dtype=dtype, device=device),
        si=scalar_or_array(si), swgt=scalar_or_array(swgt),
        schi=scalar_or_array(schi), it0=int(it0), n_acc=int(n_acc))


def poly_from_reference(p_coeffs, q_coeffs, *, device=None):
    """Chebyshev coefficients of a reference importance map
    (``poly_importance.fit_importance_poly``, f64 NumPy) as the f32 tensors
    the port's samplers take; the cast is the reference's own."""
    return (torch.as_tensor(np.array(p_coeffs), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.array(q_coeffs), dtype=torch.float32,
                            device=device))


def interp_from_reference(jax_interp, *, device=None):
    """The port's ``ops.interp`` interpolator of a reference one
    (``Interp1D``/``2D``/``3D`` of the JAX package): its knots and table
    (``xs/zs``, ``xs/ys/zs`` or ``xs/ys/zs/vals``) as NumPy, already
    ascending, and its ``precision``; the tables placed on ``device``."""
    from gpuintegration_torch.ops import interp
    kind = type(jax_interp).__name__
    fields = {"Interp1D": ("xs", "zs"), "Interp2D": ("xs", "ys", "zs"),
              "Interp3D": ("xs", "ys", "zs", "vals")}.get(kind)
    if fields is None:
        raise ValueError(f"not a reference interpolator: {kind}")
    arrays = [np.array(getattr(jax_interp, name)) for name in fields]
    return getattr(interp, kind)(
        *arrays, precision=getattr(jax_interp, "precision", "f64"),
        device=device)
