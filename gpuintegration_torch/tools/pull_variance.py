"""The variance of VEGAS's pulls over seeds: does the error estimate hold?

    python3 -m gpuintegration_torch.tools.pull_variance [ndim] [seeds] [device]

One grid-map iteration (``total_iters=1, adjust_iters=1, skip_iters=0``,
ncall 2.7e5, 50 bins) of f = x_0 + x_{ndim-1} over the unit cube (truth 1)
for seeds 1..``seeds`` (default 17D, 40 seeds, the CPU): prints the
variance of the pulls (estimate - 1) / errorest, which is near 1 when the
error estimate is honest.  A stream that repeats its uniforms inside a
sample (the counter fault repaired at 17D and up, mcubes/stream.py) makes
it larger.  Run it with ``PYTHONPATH`` at another checkout to read that
one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from gpuintegration_torch.mcubes import vegas as V


def pull_variance(ndim: int = 17, seeds: int = 40, device: str = "cpu",
                  ncall: float = 2.7e5) -> float:
    last = ndim - 1

    def f(x):
        return x[..., 0] + x[..., last]
    pulls = []
    for seed in range(1, seeds + 1):
        r = V.vegas(f, ndim=ndim, ncall=ncall, nbins=50, total_iters=1,
                    adjust_iters=1, skip_iters=0, seed=seed,
                    importance="grid", device=device)
        pulls.append((r.estimate - 1.0) / r.errorest)
    return float(np.var(pulls))


def main(argv) -> int:
    ndim = int(argv[0]) if argv else 17
    seeds = int(argv[1]) if len(argv) > 1 else 40
    device = argv[2] if len(argv) > 2 else "cpu"
    torch.set_num_threads(1)
    print(f"{ndim}D, {seeds} seeds, {device}: pull variance "
          f"{pull_variance(ndim, seeds, device)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
