"""Which relative tolerance an 8D vector integrand certifies at on the
card, within a wall-clock budget.

    python3 -m gpuintegration_torch.tools.vector_probe [members] [seconds]

Runs ``Workspace(8).integrate`` of four Genz members as one vector
integrand at epsrel 1e-3, 3e-3 and 1e-2 in turn (epsabs 1e-40, the
default pool budget), each stopped at ``seconds`` of wall clock (default
90) by ``deadline=``, until one certifies.  ``members``:

* ``reference``: the JAX package's own vector members
  (tests/test_vector_integrands.py) at 8D, default parameters:
  f1_oscillatory(8), f2_product_peak(8) (a = 50), f4_gaussian(8, a=5),
  f5_c0_continuous(8);
* ``moderate`` (default): the same families, F1 with every coefficient
  1/2 (its integral is not the near-cancellation of coefficients 1..8)
  and F2 at a = 5, as F4.

Prints the card's name and power limit, then per tolerance the status,
the wall, iterations, regions, neval, and per component the error and the
errorest relative to its closed form.  Needs a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz

NDIM = 8
EPSRELS = (1e-3, 3e-3, 1e-2)


def members(which: str) -> list:
    if which == "reference":
        return [genz.f1_oscillatory(NDIM), genz.f2_product_peak(NDIM),
                genz.f4_gaussian(NDIM, a=5.0), genz.f5_c0_continuous(NDIM)]
    if which == "moderate":
        return [genz.f1_oscillatory(NDIM, np.full(NDIM, 0.5)),
                genz.f2_product_peak(NDIM, a=5.0),
                genz.f4_gaussian(NDIM, a=5.0), genz.f5_c0_continuous(NDIM)]
    raise ValueError(f"members {which!r}: 'reference' or 'moderate'")


def vector(ms):
    """Genz members of one dimension as one vector integrand, (..., ndim)
    -> (..., ncomp), and their closed forms."""
    def f(x):
        return torch.stack([m(x) for m in ms], dim=-1)

    f.ndim = ms[0].ndim
    return f, np.array([m.true_value for m in ms])


def main(which: str = "moderate", seconds: float = 90.0) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    f, truths = vector(members(which))
    for eps in EPSRELS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Workspace(NDIM).integrate(f, eps, 1e-40,
                                      deadline=time.monotonic() + seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{which} epsrel {eps:g}: status {r.status} wall {wall:.2f} s "
              f"iters {r.iters} nregions {r.nregions} neval {r.neval}; "
              f"|est - truth| / |truth| "
              f"{np.abs(r.estimates - truths) / np.abs(truths)}; "
              f"errorest / |truth| {r.errorests / np.abs(truths)}",
              flush=True)
        if r.status == 0:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(*(sys.argv[1:2] or ["moderate"]),
                  *[float(a) for a in sys.argv[2:3]]))
