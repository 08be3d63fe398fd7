"""Times of the fused rule kernel's generic route, for comparing checkouts.

    python3 gpuintegration_torch/tools/generic_times.py [out.json]

Times ``cuda_rule.cuda_apply_rule(..., route='generic')`` of the
``gpuintegration_torch`` package that ``import`` finds (run it with
``PYTHONPATH`` set to another checkout's root to time that one's) at the
shapes the route serves: phase 4's 8D pool of 2^21 random sub-regions
(F1-F6, f64 and f32, with and without the crease fraction on F4 and F5),
the PAGANI main path's last pool (``Workspace(8).integrate(f4_gaussian(8),
1e-3, 1e-40, fused=False)``), 2D, 10D, 12D and 16D pools that give the
kernel some milliseconds (F4 and F5, f64 and f32) and a traced 12D
callable's generated kernel (cos of the sum of the axes, f64, 2^14 and
2^18 regions).  Each time is the best of ``REPS`` launches by CUDA
events (``chip_smoke.time_ms``) beside its bound (``chip_smoke.bound_ms``
and ``generated_bound_ms``, operations at 34/67 TFLOP/s or bytes at
3.35 TB/s).  Prints a line a shape and, last, one JSON object of every
row; with a path, also writes that object there.  Run once from each
checkout, alternating, in one call to the card.  Needs a CUDA card.
The bounds are those of the checkout's ``chip_smoke``.

``chip_smoke.py`` times the 2D-16D shapes and the generated kernel by
``other_dims`` and ``generated``, which take its module as ``C``.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

REPS = 3
# (ndim, regions): pools each some milliseconds of the redesigned kernel;
# chip_smoke's phase 4 times the same shapes by ``other_dims``.
SHAPES = ((2, 1 << 24), (10, 1 << 20), (12, 1 << 19), (16, 1 << 15))
GEN_POOLS = (1 << 14, 1 << 18)   # the 12D generated generic kernel


def _row(label, ms, bound, prefix=""):
    b, by = bound
    print(f"{prefix}{label}: {ms:.3f} ms, bound {b:.3f} ms ({by}, "
          f"{100 * b / ms:.1f}% of it)", flush=True)
    return {"shape": label, "ms": ms, "bound_ms": b, "bound_by": by}


def _time(C, g, tables, pool, kw=None, reps=REPS):
    from gpuintegration_torch.ops import cuda_rule
    return C.time_ms(lambda: cuda_rule.cuda_apply_rule(
        g, tables, *pool, route="generic", **(kw or {})), reps)


def _unit(ndim, dtype, dev):
    return (torch.zeros(ndim, dtype=dtype, device=dev),
            torch.ones(ndim, dtype=dtype, device=dev))


def other_dims(C, dev, reps=REPS, plain=False, prefix=""):
    """The generic route at ``SHAPES``, F4 and F5, f64 and f32, each the
    best of ``reps`` launches (``C.time_ms``) beside ``C.bound_ms``; with
    ``plain``, the plain version once (``C.once_ms``) on F4 f64 (chunks of
    4096 regions, 256 past 12D).  ``C`` is a checkout's chip_smoke module.
    Returns the rows."""
    from gpuintegration_torch.models import genz
    from gpuintegration_torch.ops import rule_eval
    rows = []
    for ndim, n in SHAPES:
        for dtype in (torch.float64, torch.float32):
            name = rule_eval.dtype_name(dtype)
            tables = rule_eval.rule_tables(ndim, name)
            lows, lengths = C.random_pool(ndim, n, 3, dtype, dev)
            pool = (lows, lengths, *_unit(ndim, dtype, dev))
            for g in (genz.f4_gaussian(ndim), genz.f5_c0_continuous(ndim)):
                rows.append(_row(f"{ndim}D {g.name} {name} {n}",
                                 _time(C, g, tables, pool, reps=reps),
                                 C.bound_ms(g.kind, ndim, n, dtype), prefix))
                if plain and g.kind == 4 and dtype == torch.float64:
                    rows[-1]["plain_ms"] = C.once_ms(
                        lambda: rule_eval.apply_rule_plain(
                            g, tables, *pool,
                            chunk_size=256 if ndim > 12 else 4096))
                    print(f"{prefix}{rows[-1]['shape']}: plain "
                          f"{rows[-1]['plain_ms']:.1f} ms", flush=True)
            del lows, lengths, pool
            torch.cuda.empty_cache()
    return rows


def generated(C, dev, reps=REPS, prefix=""):
    """The generated generic kernel of a traced 12D callable (cos of the
    sum of the axes, ``C.GEN_COS12``), f64, at ``GEN_POOLS`` regions,
    beside ``C.generated_bound_ms``.  Returns the rows."""
    from gpuintegration_torch.ops import rule_eval
    gen = C.GEN_COS12
    tables = rule_eval.rule_tables(12, "float64")
    rows = []
    for n in GEN_POOLS:
        lows, lengths = C.random_pool(12, n, 4, torch.float64, dev)
        pool = (lows, lengths, *_unit(12, torch.float64, dev))
        rows.append(_row(f"12D generated cos_sum12 float64 {n}",
                         _time(C, gen, tables, pool, reps=reps),
                         C.generated_bound_ms(gen.program, 12, n,
                                              torch.float64), prefix))
        del lows, lengths, pool
    return rows


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    import chip_smoke as C
    import gpuintegration_torch
    from gpuintegration_torch import Workspace
    from gpuintegration_torch.models import genz
    from gpuintegration_torch.ops import rule_eval
    print(f"package: {gpuintegration_torch.__file__}\ncard: {card}",
          flush=True)
    rows = []
    big = 1 << 21
    for dtype in (torch.float64, torch.float32):
        name = rule_eval.dtype_name(dtype)
        tables = rule_eval.rule_tables(C.NDIM, name)
        lows, lengths = C.random_pool(C.NDIM, big, 2, dtype, dev)
        pool = (lows, lengths, *_unit(C.NDIM, dtype, dev))
        for g in genz.genz_suite(C.NDIM):
            rows.append(_row(f"8D {g.name} {name} 2^21",
                             _time(C, g, tables, pool),
                             C.bound_ms(g.kind, C.NDIM, big, dtype)))
            if g.kind in (4, 5):
                rows.append(_row(
                    f"8D {g.name} {name} 2^21 with the fraction",
                    _time(C, g, tables, pool, {"with_split_frac": True}),
                    C.bound_ms(g.kind, C.NDIM, big, dtype, frac=True)))
        del lows, lengths, pool
        torch.cuda.empty_cache()

    g4 = genz.f4_gaussian(C.NDIM)
    ws = Workspace(C.NDIM)
    ws.integrate(g4, 1e-3, 1e-40, fused=False)
    lows, lengths, n, blocked = ws.final_pool
    tables = rule_eval.rule_tables(C.NDIM, "float64")
    pool = (lows, lengths, *_unit(C.NDIM, torch.float64, dev))
    rows.append(_row(f"8D f4_gaussian float64 main path's last pool ({n})",
                     _time(C, g4, tables, pool,
                           {"n": n, "blocked": blocked}),
                     C.bound_ms(4, C.NDIM, n, torch.float64)))
    del ws, lows, lengths, pool
    torch.cuda.empty_cache()
    rows += other_dims(C, dev)
    rows += generated(C, dev)
    out = {"package": gpuintegration_torch.__file__, "card": card,
           "rows": rows}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
