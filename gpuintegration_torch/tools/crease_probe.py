"""Which relative tolerance 8D Genz F5 (an off-grid C0 kink) and F6 (jumps)
certify at on the card with crease/jump-aware splits, within a wall-clock
budget, beside midpoint splits.

    python3 -m gpuintegration_torch.tools.crease_probe [seconds]

Runs ``Workspace(8).integrate`` of ``f5_c0_continuous(8, a=10, b=0.37)``
and ``f6_discontinuous(8)`` (bounds 0.2-0.9) at each tolerance of
``EPSRELS`` in turn, crease_split=True and False (host loop), each stopped
at ``seconds`` of wall clock (default 30) by ``deadline=``; a family's
ladder stops at the first tolerance its crease run does not certify.
Prints the card's name and power limit, then per run the status, the wall,
iterations, regions, neval, the true relative error, the errorest
relative to the truth and the split fraction kernel's launches.  Needs a
CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_rule

NDIM = 8
EPSRELS = (1e-2, 3e-3, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5)


def integrands():
    return [genz.f5_c0_continuous(NDIM, a=10.0, b=0.37),
            genz.f6_discontinuous(NDIM)]


def run(g, eps: float, crease: bool, seconds: float, **kw):
    """One timed ``Workspace(8).integrate``; returns (result, wall,
    split fraction launches)."""
    cuda_rule.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = Workspace(NDIM).integrate(g, eps, 1e-40, crease_split=crease,
                                  deadline=time.monotonic() + seconds, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, cuda_rule.split_frac_launches


def line(g, eps, crease, r, wall, launches) -> str:
    truth = abs(g.true_value)
    return (f"{g.name} epsrel {eps:g} {'crease' if crease else 'midpoint'}: "
            f"status {r.status} wall {wall:.2f} s iters {r.iters} nregions "
            f"{r.nregions} neval {r.neval} rel.err "
            f"{abs(r.estimate - g.true_value) / truth:.3e} errorest/truth "
            f"{r.errorest / truth:.3e} split_frac launches {launches}")


def main(seconds: float = 30.0) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for g in integrands():
        for eps in EPSRELS:
            out = {}
            for crease in (True, False):
                out[crease] = run(g, eps, crease, seconds, fused=False)
                print(line(g, eps, crease, *out[crease]), flush=True)
            if out[True][0].status != 0:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main(*[float(a) for a in sys.argv[1:2]]))
