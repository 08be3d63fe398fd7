"""Which relative tolerance 8D Genz F4 (a = 25) certifies at on the card
with PAGANI's ``vegas_assisted`` hybrid, within a wall-clock budget.

    python3 -m gpuintegration_torch.tools.assisted_probe [seconds]
    python3 -m gpuintegration_torch.tools.assisted_probe --ulp

Runs ``Workspace(8).integrate(f4_gaussian(8), epsrel, vegas_assisted=True)``
at each tolerance of ``EPSRELS``, loosest first, each stopped at
``seconds`` of wall clock (default 60) by ``deadline=``; the ladder stops at
the first tolerance that does not certify.  Prints the card's name and
power limit, then per run the status, the wall, iterations, regions, the
true relative error, errorest relative to the truth and the share of the
wall in the in-region sampling passes.  Needs a CUDA card.

``--ulp`` (on the CPU): how far one iteration's in-region adaptation
carries a one-ulp move of every inner edge, on the 8D initial pool (256
regions, F4 a = 25): per pass, the largest edge difference and the largest
relative difference of the regions' running sums, against the unmoved run.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.pagani import region_pool, vegas_assisted

NDIM = 8
EPSRELS = (1e-1, 3e-2, 1e-2, 3e-3, 1e-3)


def run(g, eps: float, seconds: float | None = None, **kw):
    """One timed ``Workspace(8).integrate(g, eps, vegas_assisted=True,
    **kw)``, stopped at ``seconds`` of wall clock if given; returns
    (result, wall, seconds in the sampling passes, their calls), each pass
    synchronised before and after."""
    estimates = vegas_assisted.vegas_assisted_estimates
    spent = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = estimates(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    vegas_assisted.vegas_assisted_estimates = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if seconds is not None:
            kw["deadline"] = time.monotonic() + seconds
        r = Workspace(NDIM).integrate(g, eps, 1e-40, vegas_assisted=True,
                                      **kw)
        torch.cuda.synchronize()
    finally:
        vegas_assisted.vegas_assisted_estimates = estimates
    return r, time.perf_counter() - t0, sum(spent), len(spent)


def main(seconds: float = 60.0) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = genz.f4_gaussian(NDIM)
    truth = g.true_value
    for eps in EPSRELS:
        r, wall, sampling, _ = run(g, eps, seconds)
        print(f"{g.name} vegas_assisted epsrel {eps:g}: status {r.status} "
              f"wall {wall:.2f} s iters {r.iters} nregions {r.nregions} "
              f"rel.err {abs(r.estimate - truth) / truth:.3e} errorest/truth "
              f"{r.errorest / truth:.3e} sampling {sampling:.2f} s "
              f"({100 * sampling / wall:.1f}% of the wall)", flush=True)
        if r.status != 0:
            break
    return 0


def ulp_sensitivity(passes: int = 10, spp: int = 320):
    """Yields (pass, largest edge difference, largest relative difference
    of the regions' running sums) between the 8D pool's adaptation from
    the uniform grids and from them moved one ulp up, on the CPU."""
    g = genz.f4_gaussian(NDIM)
    lows, lengths, n = region_pool.uniform_split(NDIM, 2, 2 ** NDIM)
    ids = torch.arange(n)
    span = (torch.zeros(NDIM, dtype=torch.float64),
            torch.ones(NDIM, dtype=torch.float64))
    grids = vegas_assisted.uniform_grids(n, NDIM, vegas_assisted.NBINS, "cpu")
    moved = grids.clone()
    moved[..., 1:-1] = torch.nextafter(moved[..., 1:-1],
                                       torch.ones_like(moved[..., 1:-1]))
    sums = [torch.zeros(n, dtype=torch.float64) for _ in range(2)]
    for p in range(passes):
        draws = vegas_assisted.region_draws(0, 1, p, ids, spp, NDIM)
        out = [vegas_assisted._sample_regions_pass(
            g, draws, gr, lows, lengths, *span, vegas_assisted.NBINS,
            torch.float64) for gr in (grids, moved)]
        for k in range(2):
            sums[k] = sums[k] + out[k][1].sum(dim=1)
        grids, moved = out[0][2], out[1][2]
        yield (p, float(torch.max(torch.abs(grids - moved))),
               float(torch.max(torch.abs(sums[1] - sums[0])
                               / torch.abs(sums[0]))))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ulp"]:
        for p, edge, rel in ulp_sensitivity():
            print(f"pass {p}: edges {edge:.3e} apart, running sums "
                  f"{rel:.3e} relative", flush=True)
        sys.exit(0)
    sys.exit(main(*[float(a) for a in sys.argv[1:2]]))
