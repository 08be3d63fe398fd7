"""mcubes debug/observability: per-iteration data capture (PyTorch port of
``gpuintegration_tpu/mcubes/debug.py``).

Re-expression of the reference's IterDataLogger<DEBUG, NDIM>
(reference: cuda/mcubes/util/verbose_utils.cuh:7-181), which captures bin
bounds, random numbers, function evaluations and iteration results into
managed memory and dumps five CSVs (pmcubes_{bin_bounds,random_nums,
funcevals,intevals,iters}.csv).

The grid and histogram are tiny and read by the host every iteration
anyway; sample-level captures (points, values, randoms) are supported for
small ncall by re-running one iteration with a capturing variant --
capture is an observability tool, not a production path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpuintegration_torch.mcubes import cuda_lookup, stream


@dataclasses.dataclass
class VegasIterationRecord:
    """One iteration's numbers: floats, or (ncomp,) arrays for a vector
    integrand."""
    it: int
    ti: float | np.ndarray    # raw iteration estimate
    tsi: float | np.ndarray   # scaled variance
    tgral: float | np.ndarray  # running weighted estimate
    sd: float | np.ndarray    # running error
    chi2a: float | np.ndarray
    xi: np.ndarray            # (ndim, nbins+1) grid after refinement
    d: np.ndarray | None      # (ndim, nbins) histogram (adjust phase only)


class VegasDebugLogger:
    """Collects VegasIterationRecord per iteration; CSV dumpers mirror the
    reference's file set."""

    def __init__(self):
        self.records: list[VegasIterationRecord] = []

    def record(self, **kw):
        self.records.append(VegasIterationRecord(**kw))

    # -- CSV dumpers (reference file-name parity) ---------------------------
    def dump_iters(self, outfile):
        """One row an iteration; a vector integrand's records one row a
        component, with a ``component`` column after ``iter``."""
        vector = any(np.ndim(r.ti) for r in self.records)
        print("iter," + ("component," if vector else "")
              + "estimate,errorest,chi_sq,iter_estimate,iter_variance",
              file=outfile)
        for r in self.records:
            cols = [np.broadcast_to(np.asarray(v, np.float64),
                                    np.shape(r.ti)).reshape(-1)
                    for v in (r.tgral, r.sd, r.chi2a, r.ti, r.tsi)]
            for c, (tg, sd, chi, ti, tsi) in enumerate(zip(*cols)):
                head = f"{r.it},{c}," if vector else f"{r.it},"
                print(f"{head}{tg:.15e},{sd:.15e},{chi:.5f},{ti:.15e},"
                      f"{tsi:.15e}", file=outfile)

    def dump_bin_bounds(self, outfile):
        print("iter,dim,bin,right_edge", file=outfile)
        for r in self.records:
            ndim, nb1 = r.xi.shape
            for dim in range(ndim):
                for b in range(nb1):
                    print(f"{r.it},{dim},{b},{r.xi[dim, b]:.17e}",
                          file=outfile)

    def dump_bin_contributions(self, outfile):
        print("iter,dim,bin,f2_mass", file=outfile)
        for r in self.records:
            if r.d is None:
                continue
            ndim, nb = r.d.shape
            for dim in range(ndim):
                for b in range(nb):
                    print(f"{r.it},{dim},{b},{r.d[dim, b]:.10e}",
                          file=outfile)


def capture_samples(f, ndim, ng, npg, nbins, xi, regn_lo, dx, xjac,
                    ncubes, seed=0, it=1, max_samples=100_000):
    """Sample-level capture (points, weights, values, cube ids) of one
    VEGAS iteration with the grid map -- the funcevals/random_nums CSVs of
    the reference.  Limited to runs that fit one chunk; returns a dict of
    numpy arrays, sample-major (cube, slot[, dim]).

    Reproduces absolute iteration ``it``'s actual sampling stream
    (mcubes/stream.py, keyed on ``seed``) and arithmetic
    (vegas._vegas_iteration: f32 sampling machinery, f64 points), so
    captured points/values match what the integration evaluated, not a
    lookalike stream.  ``xi``, ``regn_lo``, ``dx`` are tensors on one
    device; ``f`` is the batched integrand."""
    total = ncubes * npg
    if total > max_samples:
        raise ValueError(f"capture limited to {max_samples} samples, "
                         f"got {total}")
    f32, dtype = torch.float32, torch.float64
    dev = xi.device
    cube_ids = torch.arange(ncubes, dtype=torch.int64, device=dev)
    bits = stream.stream_bits(seed, it, cube_ids, npg, ndim)
    xi32 = xi.to(f32)
    xn, _ = cuda_lookup.stratified_xn_plain(
        ndim, ng, npg, nbins, ncubes, 0, ncubes, seed, it, dev, bits=bits)
    rc, xo, ia = cuda_lookup.bin_resolve_plain(xi32, xn, nbins, with_ia=True)
    x = (regn_lo[:, None] + rc.to(dtype) * dx[:, None]).T       # (N, ndim)
    wgt = xjac * torch.prod((xo * float(nbins)).to(dtype), dim=0)
    fx = f(x).to(dtype) * wgt

    def out(t, *shape):
        return t.reshape(ncubes, npg, *shape).cpu().numpy()

    ran = stream.bits_to_uniform(bits).reshape(npg, ndim, ncubes)
    return {
        "points": out(x, ndim),
        "weights": out(wgt),
        "values": out(fx),
        "bins": out(ia.T, ndim),
        "randoms": ran.permute(2, 0, 1).cpu().numpy(),
        "cube_ids": cube_ids.cpu().numpy(),
    }
