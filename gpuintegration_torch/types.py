"""Core result/volume types.

A copy of ``gpuintegration_tpu/types.py`` (NumPy only; the port does not
import the JAX package).  Re-expression of the reference's universal
result type
(reference: common/integration_result.hh:11-21) and integration volume
(reference: common/cuda/Volume.cuh:12-51, cubacpp/integration_volume.hh:26-105).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class IntegrationResult:
    """Universal return type for all integration routines.

    Field-for-field parity with numint::integration_result
    (reference: common/integration_result.hh:11-21). Not all members are
    filled by all algorithms.
    """

    estimate: float = 0.0
    errorest: float = 0.0
    neval: int = 0
    nregions: int = 0
    nFinishedRegions: int = 0
    status: int = -1  # 0 = converged, 1 = not converged, -1 = not run
    lastPhase: int = -1
    chi_sq: float = 0.0
    iters: int = 0
    # chi-squared probability (cubacpp integration_result::prob,
    # cubacpp/integration_result.hh:88 — CUBA convention: the CDF of the
    # inter-iteration chi-squared, values near 1 flag an UNRELIABLE
    # errorest).  Filled by the Monte-Carlo integrators (vegas, suave,
    # CPU oracles); 0.0 where no chi-squared exists (PAGANI mirrors
    # numint::integration_result, which has no prob member).
    prob: float = 0.0
    # vector-valued integrands (cubacpp integration_results<N>,
    # cubacpp/integration_result.hh:66-124): per-component estimates and
    # errors; ``estimate``/``errorest`` then hold component 0.  None for
    # scalar integrands.
    estimates: np.ndarray | None = None
    errorests: np.ndarray | None = None
    probs: np.ndarray | None = None  # per-component prob (MC integrators)

    def __str__(self) -> str:
        # CSV layout parity with operator<< (integration_result.hh:26-32).
        return (
            f"{self.estimate},{self.errorest},{self.nregions},"
            f"{self.chi_sq},{self.status}"
        )

    def pretty(self) -> str:
        # cubacpp's human-readable operator<< layout
        # (cubacpp/integration_result.hh:103-124): header line, then one
        # "Value: v +/- e prob: p" line per component.
        head = (f"neval: {self.neval} nregions: {self.nregions} "
                f"status: {self.status}")
        if self.estimates is None:
            return f"{head}\nValue: {self.estimate} +/- {self.errorest} " \
                   f"prob: {self.prob}"
        probs = (self.probs if self.probs is not None
                 else [0.0] * len(self.estimates))
        lines = [f"Value: {v} +/- {e} prob: {p}"
                 for v, e, p in zip(self.estimates, self.errorests, probs)]
        return "\n".join([head, *lines])

    @property
    def converged(self) -> bool:
        return self.status == 0


class Volume:
    """Axis-aligned hyper-rectangular integration volume.

    Mirrors quad::Volume<T, NDIM> (reference: common/cuda/Volume.cuh:12-51):
    defaults to the unit cube, stores per-dim lower/upper bounds.
    """

    def __init__(
        self,
        lows: Sequence[float] | None = None,
        highs: Sequence[float] | None = None,
        ndim: int | None = None,
    ):
        if lows is None and highs is None:
            if ndim is None:
                raise ValueError("Volume() needs lows/highs or ndim")
            lows = np.zeros(ndim)
            highs = np.ones(ndim)
        lows = np.asarray(lows, dtype=np.float64)
        highs = np.asarray(highs, dtype=np.float64)
        if lows.shape != highs.shape or lows.ndim != 1:
            raise ValueError("lows/highs must be 1-D and the same length")
        if ndim is not None and ndim != lows.shape[0]:
            raise ValueError(f"ndim={ndim} inconsistent with bounds of "
                             f"length {lows.shape[0]}")
        self.lows = lows
        self.highs = highs

    @property
    def ndim(self) -> int:
        return self.lows.shape[0]

    @property
    def jacobian(self) -> float:
        """Product of axis ranges (the global volume scale factor)."""
        return float(np.prod(self.highs - self.lows))

    def __repr__(self) -> str:
        return f"Volume(lows={self.lows.tolist()}, highs={self.highs.tolist()})"


def unit_volume(ndim: int) -> Volume:
    return Volume(ndim=ndim)
