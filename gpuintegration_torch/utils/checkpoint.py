"""Checkpoints of integrator state (PyTorch port of
``gpuintegration_tpu/utils/checkpoint.py``, its PAGANI snapshot and VEGAS
state files).

* ``PaganiCheckpoint``: the active region pool and the cumulative ledger of
  a ``Workspace`` run (``Workspace.make_checkpoint``); resume feeds the
  pool back into ``Workspace.integrate(initial_regions=..., ledger=...)``,
  and ``diff.mesh_from_checkpoint`` takes the pool as a fixed mesh.
* ``ContinuationState``: the banked ledger and the slice queue of
  ``Workspace.integrate_to_convergence``'s partitioned continuation, so a
  deep-tolerance run stops at a wall-clock budget and resumes in a later
  process where it left off (``state_path=``).
* ``save_vegas_state`` / ``load_vegas_state``: a ``mcubes.VegasState``.

Files are plain ``numpy.savez`` archives with the JAX package's field
names, so a file that one package writes the other loads.  The fields are
NumPy arrays and Python numbers; nothing here depends on a device.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpuintegration_torch.mcubes.vegas import VegasState


def npz_path(path) -> str:
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
    the run kept them.  A vector integrand's run stores (ncomp,) ledgers
    and (n, ncomp) region arrays, as the JAX package's file does."""

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
        np.savez(npz_path(path), lows=self.lows, lengths=self.lengths,
                 estimate=self.estimate, errorest=self.errorest,
                 nregions=self.nregions, iters=self.iters, neval=self.neval,
                 **extra)

    @classmethod
    def load(cls, path) -> "PaganiCheckpoint":
        z = np.load(npz_path(path))
        return cls(lows=z["lows"], lengths=z["lengths"],
                   estimate=scalar_or_array(z["estimate"]),
                   errorest=scalar_or_array(z["errorest"]),
                   nregions=int(z["nregions"]), iters=int(z["iters"]),
                   neval=int(z["neval"]) if "neval" in z else 0,
                   region_estimates=(z["region_estimates"]
                                     if "region_estimates" in z else None),
                   region_errorests=(z["region_errorests"]
                                     if "region_errorests" in z else None))


@dataclasses.dataclass
class ContinuationState:
    """Disk-resumable state of ``Workspace._partitioned_continuation``: the
    banked ledger and the remaining, error-sorted slice queue.  Integral
    additivity makes the recombination exact, so a resumed run certifies
    the same global test it would have reached in one sitting.

    The queue is stored flattened: region blocks concatenated with
    per-slice counts, per-slice stored (est, err) sums as (nw, ncomp)
    arrays (ncomp = 1 for a scalar integrand), depth and exactness flags
    (an inexact slice carries apportioned totals that the global
    certificate must never fire off).  The fields and their npz names are
    the JAX package's, so a state crosses between the packages both
    ways."""

    fin_est: np.ndarray       # (ncomp,) banked ledger (f64)
    fin_err: np.ndarray       # (ncomp,)
    iters: int
    neval: int
    nregions: int
    nfinished: int
    vec: bool                 # a vector-integrand run's state (its result
                              #   carries estimates/errorests)
    epsrel: float             # the tolerances the state was built under,
    epsabs: float             #   checked on resume
    work_lows: np.ndarray     # (sum n_i, ndim) concatenated slice blocks
    work_lengths: np.ndarray  # (sum n_i, ndim)
    work_counts: np.ndarray   # (nw,) regions per slice, in queue order
                              #   (coldest first: the queue pops the
                              #   hottest from its end)
    work_est: np.ndarray      # (nw, ncomp) stored slice estimate sums
    work_err: np.ndarray      # (nw, ncomp)
    work_depth: np.ndarray    # (nw,) int
    work_exact: np.ndarray    # (nw,) bool

    @classmethod
    def from_queue(cls, work: list, fin_est, fin_err, iters, neval,
                   nregions, nfinished, vec, epsrel, epsabs
                   ) -> "ContinuationState":
        """Package the live queue, a list of (lows, lengths, s_est, s_err,
        depth, exact) in queue order, and the banked ledger (floats for a
        scalar run, (ncomp,) arrays for a vector one; the JAX package's
        signature)."""
        fin_est = np.atleast_1d(np.asarray(fin_est, np.float64)).copy()
        fin_err = np.atleast_1d(np.asarray(fin_err, np.float64)).copy()
        ncomp = fin_est.shape[0]
        ndim = work[0][0].shape[1] if work else 0

        def cat(i):
            return (np.concatenate([np.asarray(w[i]) for w in work])
                    if work else np.zeros((0, ndim)))

        def sums(i):
            return np.array([np.atleast_1d(np.asarray(w[i], np.float64))
                             for w in work],
                            np.float64).reshape(len(work), ncomp)

        return cls(
            fin_est=fin_est, fin_err=fin_err,
            iters=int(iters), neval=int(neval), nregions=int(nregions),
            nfinished=int(nfinished), vec=bool(vec),
            epsrel=float(epsrel), epsabs=float(epsabs),
            work_lows=cat(0), work_lengths=cat(1),
            work_counts=np.array([w[0].shape[0] for w in work], np.int64),
            work_est=sums(2), work_err=sums(3),
            work_depth=np.array([w[4] for w in work], np.int64),
            work_exact=np.array([w[5] for w in work], bool))

    def to_queue(self) -> list:
        """The live queue list (queue order preserved): its stored sums as
        floats for a scalar run, (ncomp,) arrays for a vector one."""
        out, off = [], 0
        for i, n in enumerate(self.work_counts.tolist()):
            est, err = self.work_est[i], self.work_err[i]
            if not self.vec:
                est, err = float(est[0]), float(err[0])
            out.append((self.work_lows[off:off + n],
                        self.work_lengths[off:off + n], est, err,
                        int(self.work_depth[i]), bool(self.work_exact[i])))
            off += n
        return out

    def save(self, path):
        """Write the npz file atomically: a crash mid-write leaves the
        previous state in place."""
        path = npz_path(path)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **dataclasses.asdict(self))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path) -> "ContinuationState":
        z = np.load(npz_path(path))
        kw = {f.name: z[f.name] for f in dataclasses.fields(cls)}
        for k in ("iters", "neval", "nregions", "nfinished"):
            kw[k] = int(kw[k])
        kw["vec"] = bool(kw["vec"])
        kw["epsrel"], kw["epsabs"] = float(kw["epsrel"]), float(kw["epsabs"])
        return cls(**kw)


def save_vegas_state(state: VegasState, path):
    """A ``VegasState`` as an npz file (the grid as a NumPy array)."""
    np.savez(npz_path(path), xi=state.xi.detach().cpu().numpy(), si=state.si,
             swgt=state.swgt, schi=state.schi, it0=state.it0,
             n_acc=state.n_acc)


def load_vegas_state(path, *, device=None) -> VegasState:
    """The ``VegasState`` of an npz file, its grid on ``device`` (the CPU
    when None) in the type it was stored in."""
    z = np.load(npz_path(path))
    return VegasState(xi=torch.as_tensor(z["xi"], device=device),
                      si=scalar_or_array(z["si"]),
                      swgt=scalar_or_array(z["swgt"]),
                      schi=scalar_or_array(z["schi"]),
                      it0=int(z["it0"]) if "it0" in z else 0,
                      n_acc=int(z["n_acc"]) if "n_acc" in z else 0)
