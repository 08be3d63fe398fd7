"""Walls of a phase-29 VEGAS run in a process of its own.

    python3 gpuintegration_torch/tools/high_dim_walls.py [NDIM]

Builds the VEGAS libraries, then runs ``chip_smoke.HIGH_RUNS``' poly-map
'hybrid' run at NDIM (default 28: Genz F4, b = 0.5, epsrel 1e-3, ncall
1e9, f64) five times in this process: on the sampler's own route (the
process's first run), again, then with the sampler forced to its generic
route twice, then on its own route again (the histogram on its own route
throughout).  For each run it prints the wall, status, iterations, the
seconds of each iteration (the card synchronised after each) and the
card's memory reserved after it; for the first run also the seconds of
the first sampler launch, the first integrand pass and the first
histogram launch, each synchronised, which hold a process's first-call
costs.  Run it from the repository's root.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time


def main(argv) -> int:
    sys.path.insert(0, ".")
    import torch

    import chip_smoke as C
    from gpuintegration_torch import mcubes
    from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
    from gpuintegration_torch.mcubes import vegas as V
    from gpuintegration_torch.models import genz
    from gpuintegration_torch.ops import cuda_build

    ndim = int(argv[0]) if argv else 28
    label, _, a, kw = next(r for r in C.HIGH_RUNS if r[1] == ndim
                           and r[3].get("sampler") == "hybrid")
    t0 = time.perf_counter()
    cuda_build.build_many(["vegas_sample.cu", "vegas_lookup.cu"])
    print(f"{label}, Genz F4 a = {a:g}: libraries built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    g = genz.f4_gaussian(ndim, a=a, b=C.HIGH_F4["b"])

    def first_call(fn, name, first):
        def timed(*args, **kwargs):
            if name in first:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            first[name] = time.perf_counter() - t
            return out
        return timed

    iteration = V._vegas_iteration_poly

    def run(form, first=None):
        iters = []

        def timed_iteration(*args, **kwargs):
            t = time.perf_counter()
            out = iteration(*args, **kwargs)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t)
            return out
        kept = (cuda_vegas.sampler_route, cuda_vegas.sample_chunk,
                cuda_lookup.hist_accum)
        V._vegas_iteration_poly = timed_iteration
        if form == "generic":
            cuda_vegas.sampler_route = lambda *args: "generic"
        f = g
        if first is not None:
            cuda_vegas.sample_chunk = first_call(kept[1], "sampler", first)
            cuda_lookup.hist_accum = first_call(kept[2], "histogram", first)
            f = first_call(g, "integrand", first)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = mcubes.integrate(f, ndim=ndim, epsrel=C.HIGH_EPSREL,
                                   epsabs=1e-40, ncall=C.HIGH_NCALL, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            V._vegas_iteration_poly = iteration
            (cuda_vegas.sampler_route, cuda_vegas.sample_chunk,
             cuda_lookup.hist_accum) = kept
        print(f"{form} sampler route: wall {wall:.3f} s, status "
              f"{res.status}, iterations {res.iters}, each "
              + ", ".join(f"{s:.3f}" for s in iters)
              + f" s; memory reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB"
              + ("" if first is None else "; first calls " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in first.items())), flush=True)

    run("own", first={})
    for form in ("own", "generic", "generic", "own"):
        run(form)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
