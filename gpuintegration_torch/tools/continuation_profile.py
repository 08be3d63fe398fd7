"""Where the time of ``Workspace.integrate_to_convergence`` goes, on the card.

    python3 -m gpuintegration_torch.tools.continuation_profile [pool]

Runs the 8D Genz F4 continuation at epsrel 1e-5 with a pool budget of
``pool`` regions (default 2^22, where round 1 walls and the partitioned
continuation carries the run) after one warm-up run, three times: plain,
for the wall and the ``utils.profiling.StageTimer`` stages; under
cProfile, for the host functions that take the wall; under
``utils.profiling.trace`` (torch.profiler), for the device's busy time,
the sum of its kernels' and copies' self times, and so its idle share.
Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType

from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils.profiling import StageTimer, trace

EPSREL = 1e-5


def run(pool: int):
    """(result, wall seconds, stage times) of one continuation."""
    ws = Workspace(8, max_pool_regions=pool)
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ws.integrate_to_convergence(genz.f4_gaussian(8), epsrel=EPSREL,
                                      epsabs=1e-40, stage_timer=timer)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(timer.times)


def main(pool: int = 1 << 22) -> int:
    if not torch.cuda.is_available():
        print("continuation_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    run(pool)                                       # warm-up
    res, wall, stages = run(pool)
    print(f"plain: status {res.status} iters {res.iters} neval {res.neval} "
          f"wall {wall:.3f} s; stages {stages}; outside them "
          f"{wall - sum(stages.values()):.3f} s", flush=True)

    prof = cProfile.Profile()
    prof.enable()
    _, wall, _ = run(pool)
    prof.disable()
    print(f"under cProfile: wall {wall:.3f} s; the host functions by their "
          "own time:", flush=True)
    pstats.Stats(prof).sort_stats("tottime").print_stats(15)

    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as p:
            _, wall, _ = run(pool)
        # the device's own events (kernels, copies, memsets), as the
        # profiler's "Self CUDA time total" sums them
        busy = sum(e.self_device_time_total for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation) / 1e6
    print(f"under torch.profiler: wall {wall:.3f} s, the device busy "
          f"{busy:.3f} s (kernels and copies, self time), idle "
          f"{100 * (1 - busy / wall):.1f} % of the wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
