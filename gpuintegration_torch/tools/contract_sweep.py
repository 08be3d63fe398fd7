"""The split route's cluster contractions at other launch shapes, on the card.

    python3 -m gpuintegration_torch.tools.contract_sweep [scalar|vector]

``scalar`` (and no argument) times the contraction kernel's cluster route
with its stage size, ring depth and target CTA count
(``cuda_rule.CLUSTER_STAGE_BYTES``, ``CLUSTER_RING``, ``CLUSTER_CTAS``) set
to each of ``CONFIGS`` in turn, beside the generic route, at the
Workspace's 8D f64, 12D and 16D chunks with the values laid out as rows (a
callable that reduces over the axes) and as planes (a per-axis callable);
each configuration's outputs are checked against the generic route's
(split_dim EQUAL, est within 1e-10).  ``vector`` (and no argument) times
the components cluster route with its stage size and ring
(``COMP_STAGE_BYTES``, ``COMP_RING``) set to each of ``COMP_CONFIGS``,
beside the components route, at the Workspace's 8D, 12D and 16D f64 chunks
of four components (and 2 and 8 at 8D, 2 at 12D: the time against the
bytes), component-minor; the stage size leaves the summation
order alone, so every configuration's outputs must be EQUAL to the
shipped one's.  Each time is the best of 5 series of 20 launches queued
behind a blocker, beside the clusters' residency
(cudaOccupancyMaxActiveClusters).  Prints the card's name and power limit
first.  Needs a CUDA card.
"""
from __future__ import annotations

import math
import subprocess
import sys

import torch

from gpuintegration_torch.ops import cuda_rule, rule_eval

# (stage bytes, ring stages, target CTAs); the first is the first design's
# (small copies), the last the shipped one
CONFIGS = ((8192, 6, 256), (16384, 4, 224), (32768, 2, 256),
           (65536, 2, 160), (32768, 2, 224))
SHAPES = ((8, 4096, "rows"), (8, 4096, "planes"), (12, 1024, "rows"),
          (16, 1024, "rows"), (16, 1024, "planes"))
# the components cluster route: (stage bytes, ring stages); the last the
# shipped one
COMP_CONFIGS = ((8192, 2), (16384, 2), (16384, 3), (65536, 2), (32768, 3),
                (32768, 2))
COMP_SHAPES = ((8, 4096, 2), (8, 4096, 4), (8, 4096, 8), (12, 1024, 2),
               (12, 1024, 4), (16, 1024, 4))


def queued_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Best of ``reps`` series of ``inner`` calls, CUDA events around each
    series, the calls queued behind a matrix product so that they run back
    to back."""
    blocker = torch.zeros((6144, 6144), device="cuda")
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(blocker, blocker)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def sweep_shape(ndim: int, count: int, layout: str) -> str:
    dtype, dev = torch.float64, torch.device("cuda")
    tables = rule_eval.rule_tables(ndim, "float64")
    gen = torch.Generator(device=dev).manual_seed(ndim)
    lows = torch.rand((ndim, count), generator=gen, dtype=dtype,
                      device=dev) * 0.5
    lengths = lows * 0 + 0.25
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.ones(ndim, dtype=dtype, device=dev)
    vals = torch.rand((count, tables.feval), generator=gen, dtype=dtype,
                      device=dev) + 0.5
    if layout == "planes":
        vals = vals.T.contiguous().T
    args = (vals, tables, lows, lengths, gl, gr, 0)
    ref = cuda_rule.split_contract(*args, route="generic")
    nbytes = 8 * count * (tables.feval + ndim + 2) + 4 * count
    line = (f"{ndim}D f64 {count} x {tables.feval} {layout}: bound "
            f"{1e3 * nbytes / 3.35e12:.4f} ms, generic "
            f"{queued_ms(lambda: cuda_rule.split_contract(*args, route='generic')):.4f}")
    kept = (cuda_rule.CLUSTER_STAGE_BYTES, cuda_rule.CLUSTER_RING,
            cuda_rule.CLUSTER_CTAS)
    try:
        for config in CONFIGS:
            (cuda_rule.CLUSTER_STAGE_BYTES, cuda_rule.CLUSTER_RING,
             cuda_rule.CLUSTER_CTAS) = config
            out = cuda_rule.split_contract(*args, route="cluster")
            torch.cuda.synchronize()
            ok = torch.equal(out[2], ref[2]) and torch.allclose(
                out[0], ref[0], rtol=1e-10, atol=0.0)
            ms = queued_ms(lambda: cuda_rule.split_contract(*args,
                                                            route="cluster"))
            k = cuda_rule.cluster_plan(dtype, ndim, count, tables.feval)[0]
            resident = cuda_rule.cluster_occupancy(
                dtype, layout == "rows", ndim, count, tables.feval)
            line += (f" | {config[0] // 1024} KB x {config[1]}, "
                     f"{-(-count // 32) * k} CTAs in clusters of {k} "
                     f"({resident} clusters resident): {ms:.4f}"
                     f"{'' if ok else ' DISAGREES'}")
    finally:
        (cuda_rule.CLUSTER_STAGE_BYTES, cuda_rule.CLUSTER_RING,
         cuda_rule.CLUSTER_CTAS) = kept
    return line


def sweep_vector_shape(ndim: int, count: int, ncomp: int) -> str:
    dtype, dev = torch.float64, torch.device("cuda")
    tables = rule_eval.rule_tables(ndim, "float64")
    gen = torch.Generator(device=dev).manual_seed(ndim)
    lows = torch.rand((ndim, count), generator=gen, dtype=dtype,
                      device=dev) * 0.5
    lengths = lows * 0 + 0.25
    gl = torch.zeros(ndim, dtype=dtype, device=dev)
    gr = torch.ones(ndim, dtype=dtype, device=dev)
    vals = torch.rand((count, tables.feval, ncomp), generator=gen,
                      dtype=dtype, device=dev) + 0.5
    args = (vals, tables, lows, lengths, gl, gr, 0)
    ref = cuda_rule.split_contract_components(*args,
                                              route="components_cluster")
    nbytes = 8 * count * (tables.feval * ncomp + ndim + 2 * ncomp) + 4 * count
    line = (f"{ndim}D f64 {count} x {tables.feval} x {ncomp} "
            f"component-minor: bound {1e3 * nbytes / 3.35e12:.4f} ms, "
            f"components "
            f"{queued_ms(lambda: cuda_rule.split_contract_components(*args, route='components')):.4f}")
    kept = (cuda_rule.COMP_STAGE_BYTES, cuda_rule.COMP_RING)
    try:
        for config in COMP_CONFIGS:
            cuda_rule.COMP_STAGE_BYTES, cuda_rule.COMP_RING = config
            out = cuda_rule.split_contract_components(
                *args, route="components_cluster")
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(out, ref))
            ms = queued_ms(lambda: cuda_rule.split_contract_components(
                *args, route="components_cluster"))
            k, _, points, ring = cuda_rule.comp_cluster_plan(
                dtype, ndim, count, tables.feval, ncomp)
            smem = cuda_rule.comp_cluster_smem(dtype, ndim, ncomp, points,
                                               ring)
            resident = cuda_rule.comp_cluster_occupancy(
                dtype, ndim, count, tables.feval, ncomp)
            line += (f" | {config[0] // 1024} KB x {config[1]} ({points} "
                     f"points a stage, {smem // 1024} KB a CTA, "
                     f"{resident} clusters of {k} resident): {ms:.4f}"
                     f"{'' if same else ' NOT EQUAL'}")
    finally:
        cuda_rule.COMP_STAGE_BYTES, cuda_rule.COMP_RING = kept
    return line


def main(which: str = "both") -> int:
    if not torch.cuda.is_available():
        raise SystemExit("contract_sweep needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if which in ("scalar", "both"):
        for shape in SHAPES:
            print(sweep_shape(*shape), flush=True)
            torch.cuda.empty_cache()
    if which in ("vector", "both"):
        for shape in COMP_SHAPES:
            print(sweep_vector_shape(*shape), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:2]))
