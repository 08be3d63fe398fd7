"""CSV iteration recorder and region-pool dump (PyTorch port of
``gpuintegration_tpu/utils/recorder.py``; the reference's Recorder CSV
sink, common/cuda/cudaDebugUtil.h:18-37, and the iteration ledger it
writes, cuda_pagani_iters.csv, Workspace.cuh:171-241).

``Workspace.integrate(recorder=...)`` hands the recorder one row an
iteration of its host loop; a recorder turns the fused phase off.
"""
from __future__ import annotations

import sys
from typing import IO

import numpy as np
import torch


class IterationRecorder:
    """Collects one row per adaptive iteration; optionally streams CSV to
    ``sink`` (a file object, or a path it opens and closes) and echoes
    each row to stderr."""

    COLUMNS = ("it", "estimate", "errorest", "festimate", "ferrorest",
               "nregions", "fnregions", "time_ms")

    def __init__(self, sink: IO | str | None = None, echo: bool = False):
        self.rows: list[dict] = []
        self.echo = echo
        self._own = isinstance(sink, str)
        self._fh = open(sink, "w") if self._own else sink
        if self._fh is not None:
            print(",".join(self.COLUMNS), file=self._fh)

    def record(self, **kw):
        self.rows.append(kw)
        line = ",".join(str(kw.get(c, "")) for c in self.COLUMNS)
        if self._fh is not None:
            print(line, file=self._fh)
        if self.echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._own and self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dump_regions_csv(lows, lengths, n: int, outfile: IO,
                     blocked: bool = False):
    """A region pool's population as CSV, one row per real region:
    ``id, low_0..low_{d-1}, length_0..length_{d-1}`` (the reference's
    Snapshot region dumper, quad.h:78-152).  ``lows``/``lengths``:
    dims-major (ndim, cap) tensors or arrays; ``blocked`` selects the
    post-split layout (the real regions are the first n/2 slots of each
    half of the pool, region_pool.block_mask).  A Workspace's live pool,
    single device or mesh, is ``ws.make_checkpoint()``'s lows/lengths."""
    lo = lows.cpu().numpy() if isinstance(lows, torch.Tensor) else \
        np.asarray(lows)
    ln = lengths.cpu().numpy() if isinstance(lengths, torch.Tensor) else \
        np.asarray(lengths)
    ndim, cap = lo.shape
    if blocked:
        half = cap // 2
        keep = np.concatenate([np.arange(n // 2), half + np.arange(n // 2)])
    else:
        keep = np.arange(n)
    cols = ([f"low_{d}" for d in range(ndim)]
            + [f"length_{d}" for d in range(ndim)])
    print("id," + ",".join(cols), file=outfile)
    for j, i in enumerate(keep):
        vals = [f"{lo[d, i]:.17e}" for d in range(ndim)]
        vals += [f"{ln[d, i]:.17e}" for d in range(ndim)]
        print(f"{j}," + ",".join(vals), file=outfile)
