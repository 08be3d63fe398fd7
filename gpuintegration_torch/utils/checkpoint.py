"""Checkpoints of integrator state (PyTorch port of
``gpuintegration_tpu/utils/checkpoint.py``, its PAGANI snapshot and VEGAS
state files).

* ``PaganiCheckpoint``: the active region pool and the cumulative ledger of
  a ``Workspace`` run (``Workspace.make_checkpoint``); resume feeds the
  pool back into ``Workspace.integrate(initial_regions=..., ledger=...)``,
  and ``diff.mesh_from_checkpoint`` takes the pool as a fixed mesh.
* ``save_vegas_state`` / ``load_vegas_state``: a ``mcubes.VegasState``.

Files are plain ``numpy.savez`` archives with the JAX package's field
names, so a file that one package writes the other loads.  The fields are
NumPy arrays and Python numbers; nothing here depends on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpuintegration_torch.mcubes.vegas import VegasState


def _norm(path) -> str:
    """``np.savez`` appends .npz on save but ``np.load`` does not on load:
    ``save('/x/ck')`` and ``load('/x/ck')`` name the same file."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def scalar_or_array(v):
    """A stored scalar as a float; a vector ledger stays an array."""
    a = np.asarray(v)
    return np.array(a) if a.ndim else float(a)


@dataclasses.dataclass
class PaganiCheckpoint:
    """Resumable PAGANI state: the active region pool and the ledger.

    ``lows``/``lengths`` are region-major (n, ndim) in unit space.
    ``estimate``/``errorest`` are the cumulative ledger EXCLUDING the saved
    pool's own sweep (resuming re-evaluates the pool: the complete integral
    is ``ckpt.estimate + resumed.estimate``).  ``region_estimates`` and
    ``region_errorests`` are that sweep per region, in pool order, where
    the run kept them."""

    lows: np.ndarray
    lengths: np.ndarray
    estimate: float | np.ndarray
    errorest: float | np.ndarray
    nregions: int
    iters: int
    neval: int = 0
    region_estimates: np.ndarray | None = None
    region_errorests: np.ndarray | None = None

    @property
    def ledger(self) -> tuple:
        """The ``ledger=`` seed of ``Workspace.integrate``: resume with the
        true cumulative totals driving every decision."""
        return (self.estimate, self.errorest, self.nregions, self.iters,
                self.neval)

    def save(self, path):
        extra = {}
        if self.region_errorests is not None:
            extra = dict(region_estimates=self.region_estimates,
                         region_errorests=self.region_errorests)
        np.savez(_norm(path), lows=self.lows, lengths=self.lengths,
                 estimate=self.estimate, errorest=self.errorest,
                 nregions=self.nregions, iters=self.iters, neval=self.neval,
                 **extra)

    @classmethod
    def load(cls, path) -> "PaganiCheckpoint":
        z = np.load(_norm(path))
        return cls(lows=z["lows"], lengths=z["lengths"],
                   estimate=scalar_or_array(z["estimate"]),
                   errorest=scalar_or_array(z["errorest"]),
                   nregions=int(z["nregions"]), iters=int(z["iters"]),
                   neval=int(z["neval"]) if "neval" in z else 0,
                   region_estimates=(z["region_estimates"]
                                     if "region_estimates" in z else None),
                   region_errorests=(z["region_errorests"]
                                     if "region_errorests" in z else None))


def save_vegas_state(state: VegasState, path):
    """A ``VegasState`` as an npz file (the grid as a NumPy array)."""
    np.savez(_norm(path), xi=state.xi.detach().cpu().numpy(), si=state.si,
             swgt=state.swgt, schi=state.schi, it0=state.it0,
             n_acc=state.n_acc)


def load_vegas_state(path, *, device=None) -> VegasState:
    """The ``VegasState`` of an npz file, its grid on ``device`` (the CPU
    when None) in the type it was stored in."""
    z = np.load(_norm(path))
    return VegasState(xi=torch.as_tensor(z["xi"], device=device),
                      si=scalar_or_array(z["si"]),
                      swgt=scalar_or_array(z["swgt"]),
                      schi=scalar_or_array(z["schi"]),
                      it0=int(z["it0"]) if "it0" in z else 0,
                      n_acc=int(z["n_acc"]) if "n_acc" in z else 0)
