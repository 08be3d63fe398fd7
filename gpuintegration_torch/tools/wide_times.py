"""Times of the sampler's wide route past 24D against its generic route.

    python3 gpuintegration_torch/tools/wide_times.py [CHECKOUT]

Builds csrc/vegas_sample.cu of the ``gpuintegration_torch`` package at
the checkout's root (default: this one), prints the registers, spill
bytes and stack frames of its NMAX 24 and 32 wide instances (nvcc's
report), and runs ``chip_smoke.high_sampler_rows`` (the four modes, the
wide and the generic route in turns) on the chunk ``vegas`` takes around
the volume's centre at 28D (ncall 1e9, npg 3), 30D (3e9), 31D (5e9) and
32D (1e10), the last three at npg 2: 2^30 and 2^31 cubes take the 32-bit
decode, 2^32 the 64-bit one.  Run it from the repository's root, once for
each checkout in one call to the card to compare them.  Needs a CUDA card.
"""
from __future__ import annotations

import sys

ROWS = ((28, 1e9), (30, 3e9), (31, 5e9), (32, 1e10))


def main(argv) -> int:
    sys.path.insert(0, argv[0] if argv else ".")
    sys.path.insert(1, ".")
    import torch

    import chip_smoke as C
    import gpuintegration_torch
    from gpuintegration_torch.ops import cuda_build
    from gpuintegration_torch.tools import route_bits

    print(f"package: {gpuintegration_torch.__file__}", flush=True)
    lib = cuda_build.build_many(["vegas_sample.cu"])[0]
    for name, v in sorted(route_bits.ptxas_kernels(
            lib.with_suffix(".log").read_text()).items()):
        if name.startswith("sample_wide_kernel") and name.endswith(
                (" 24>", " 32>")):
            print(f"ptxas: {name}: {v[0]} registers, {v[1]} spill bytes, "
                  f"{v[2]} bytes stack frame", flush=True)
    dev = torch.device("cuda")
    for ndim, ncall in ROWS:
        C.high_sampler_rows(C.high_case(ndim, ncall, "middle", dev))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
