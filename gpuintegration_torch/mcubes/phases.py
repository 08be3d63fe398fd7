"""VEGAS's device-resident phases (PyTorch port of the reference's
``_frozen_phase`` and ``_adjust_phase``, gpuintegration_tpu/mcubes/
vegas.py:721-827 and :836-977, their ``mesh`` forms included).

A phase runs whole VEGAS iterations with the iteration-weighted
combination and the convergence test on the device: the carry (iteration,
stream counter, si, swgt, schi, done) stays in device tensors, f64, and
the host reads one packed f64 vector [it, done, si, swgt, schi] back.  The
frozen phase samples with the histogram off on a fixed map; the adjustment
phase (``refine='device'``) samples with it on, rebins the grid in f32
(``pagani.vegas_assisted._refine_grids``) and, for the polynomial map,
re-fits p and q (``poly_importance.fit_importance_poly_device``).

The combination is the host loop's, operation for operation: ti and tsi
widened to f64, tsi times dv2g, wgt = 1 / tsi (floored at 1e-300),
si += wgt ti, schi += wgt ti ti, swgt += wgt while ``it > skip_iters``; the
status test of ``get_status`` over every component; divisions by tensors,
not by host scalars (PyTorch on the card divides by a host scalar as a
product with its rounded reciprocal).  So a frozen phase gives the host
loop's iterations, neval and estimate bits.  An iteration whose ``run``
(not done, it <= end) is false changes nothing: a phase may run past its
end, and only the iterations before it count.

Every iteration is read back as it ends, so no iteration runs past
convergence (reading one iteration behind while the next runs would waste
a whole masked iteration at the end of every phase).  The first iteration
runs eagerly (it fills every lazy cache and table a capture must not
create).  On the card a phase that goes on then chooses its form from
what it has seen (``graph_pays``): one iteration (every chunk's launches,
the ordered sums and the combination) captured as a CUDA graph
(``torch.cuda.CUDAGraph``, ``capture_begin``/``capture_end`` on a side
stream, as pagani/fused_loop.py) and replayed, the kernels reading the
iteration word from the carry's counter (``stream.counter``), which the
graph advances; or the same loop eagerly.  A capture costs about two eager
iterations of host time and a replay saves only the card's idle gaps of an
eager one, so the graph is taken only for a phase expected to run
``GRAPH_MIN_ITERS`` more iterations.  (Against the host loop, a long eager
frozen phase saves more: the host loop fits the poly map and copies it to
the card every iteration, the phase once.)  ``capture=False``
(``sampler='torch'``) and the CPU always run eagerly.  A capture that
fails raises RuntimeError naming its cause, with no eager fallback.

A capture launches nothing, and each replay launches what it recorded:
the kernel wrappers' launch counts (``cuda_vegas.launches``,
``cuda_lookup.*_launches``) are taken back after a capture and advanced by
the recorded launches at each replay, so they count launches that ran.
``FORM`` pins the form for tests and measurements.

On a mesh (reference ``vegas.py:785-788``, ``:812-830``, ``:923-927``,
``:962-980``) each rank samples its own chunks and the iteration
SUM-all-reduces ti and tsi (and, adjusting, the f32 histogram before the
rebin), so the carry and the grid stay the same on every rank.  Whether a
phase on the card may capture is decided from the group's backend before it
starts: an NCCL all-reduce is captured with the iteration, gloo's cannot be
(it copies through the host), so under gloo the phase runs eagerly and
``stats["uncaptured"]`` counts such phases.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.pagani import vegas_assisted
from gpuintegration_torch.parallel import mesh as pmesh

# Counts since ``reset_stats``: phases run, eager iterations, graph
# captures, replays, packed reads; and seconds on the host's clock in the
# first, eager iteration of a phase on the card (its read included), in
# captures (instantiation included) and in the iterations after the first
# (replayed or eager) with their reads.
# ``uncaptured`` counts phases on the card that run eagerly because their
# mesh's backend cannot be captured (gloo).
stats = {"phases": 0, "eager": 0, "captures": 0, "replays": 0, "reads": 0,
         "first_s": 0.0, "capture_s": 0.0, "rest_s": 0.0, "uncaptured": 0}
TINY = 1e-300
# The fewest further iterations, after its first, for which a phase on the
# card captures a graph: a capture repaid itself after 14 to 26 replays on
# VEGAS runs 1-3 on an H100 (chip_smoke.py phase 18 prints it).
GRAPH_MIN_ITERS = 24
# The form a phase takes, for tests and measurements: None chooses
# (``graph_pays``); 'eager' or 'graph' pin it on the card ('graph' where a
# capture is allowed); 'host' runs vegas's frozen iterations through its
# host loop instead of a phase.
FORM = None
# The kernel wrappers' launch counts: (module, name) of an int or of a
# {route: int} dict.
_COUNTS = ((cuda_vegas, "launches"), (cuda_vegas, "route_launches"),
           (cuda_vegas, "generated_launches"),
           (cuda_lookup, "hist_launches"),
           (cuda_lookup, "hist_route_launches"),
           (cuda_lookup, "bin_resolve_launches"),
           (cuda_lookup, "resolve_route_launches"),
           (cuda_lookup, "edge_lookup_launches"),
           (cuda_lookup, "edge_route_launches"))


def reset_stats():
    for k in stats:
        stats[k] = 0


def _launch_counts() -> dict:
    out = {}
    for module, name in _COUNTS:
        value = getattr(module, name)
        if isinstance(value, dict):
            out.update({(module, name, k): n for k, n in value.items()})
        else:
            out[module, name, None] = value
    return out


def _add_launches(delta: dict, times: int):
    """Add ``times`` x ``delta`` (keys of ``_launch_counts``) to the counts."""
    for (module, name, key), n in delta.items():
        if key is None:
            setattr(module, name, getattr(module, name) + times * n)
        else:
            getattr(module, name)[key] += times * n


def expected_iters(packed, swgt0, left: int, *, epsrel: float,
                   epsabs: float) -> int:
    """The iterations a phase is expected to run after its first, at most
    ``left``, from its packed carry after that iteration and the weights
    ``swgt0`` ((ncomp,)) before it: each further iteration adds the first
    one's weight until sd = swgt^-1/2 meets epsrel |tgral| or epsabs in
    every component, and none converges before iteration 5.  ``left`` when
    the first iteration accumulated nothing (the skip window)."""
    ncomp = (len(packed) - 2) // 3
    it = int(packed[0])
    si, swgt = packed[2:2 + ncomp], packed[2 + ncomp:2 + 2 * ncomp]
    added = swgt - swgt0
    if not np.all(added > 0):
        return left
    with np.errstate(divide="ignore", invalid="ignore"):
        target = np.maximum(epsrel * np.abs(si / swgt), epsabs)
        need = np.max((1.0 / (target * target) - swgt) / added)
    if not np.isfinite(need):
        return left
    return int(min(left, max(np.ceil(need), 5 - it + 1, 1)))


def combine(c, sums, *, dv2g: float, skip_iters: int, epsrel: float,
            epsabs: float):
    """One iteration's (ti, tsi) sums ((2,) or (2, ncomp)) folded into the
    carry's f64 accumulators: the new (it, si, swgt, schi, done), unmasked."""
    f64 = torch.float64
    ncomp = c["si"].shape[0]
    one = torch.ones((), dtype=f64, device=c["si"].device)
    ti = sums[0].to(f64).reshape(ncomp)
    tsi = sums[1].to(f64).reshape(ncomp) * dv2g
    wgt = one / torch.clamp(tsi, min=TINY)
    acc = c["it"] > skip_iters
    si = torch.where(acc, c["si"] + wgt * ti, c["si"])
    schi = torch.where(acc, c["schi"] + wgt * ti * ti, c["schi"])
    swgt = torch.where(acc, c["swgt"] + wgt, c["swgt"])
    tgral = si / torch.clamp(swgt, min=TINY)
    sd = torch.sqrt(one / torch.clamp(swgt, min=TINY))
    # get_status over every component (vegas_utils.cuh:225-248)
    ok = torch.where(tgral == 0.0, sd <= epsabs,
                     (torch.abs(sd / tgral) <= epsrel) | (sd <= epsabs))
    done = acc & torch.all(ok) & (c["it"] >= 5)
    return {"it": c["it"] + 1, "si": si, "swgt": swgt, "schi": schi,
            "done": done}


class Phase:
    """One device-resident phase of a ``vegas`` call.

    ``iterate(word, accumulate_hist, xi, p, q)``: one VEGAS iteration
    drawing the stream of the 0-d counter ``word`` on the map (xi: the grid;
    p, q: the polynomial's coefficients), returning (sums, d) as
    ``vegas._vegas_iteration`` does.  ``adjust``: refine the grid (and,
    given ``refit(xi) -> (p, q)``, re-fit the map) after each iteration.
    ``capture``: on the card, a CUDA graph of one iteration may be
    replayed (``graph_pays``).  ``mesh``: a ``parallel.mesh`` mesh whose
    ranks' sums the iteration all-reduces; under a backend other than NCCL
    the phase never captures."""

    def __init__(self, iterate, *, adjust: bool, capture: bool, dv2g: float,
                 skip_iters: int, epsrel: float, epsabs: float, refit=None,
                 label: str = "frozen", mesh=None):
        self.iterate = iterate
        self.adjust = adjust
        self.mesh = mesh
        self.uncaptured = (capture and mesh is not None
                           and pmesh.backend(mesh) != "nccl")
        self.capture = capture and not self.uncaptured
        self.refit = refit
        self.label = label
        self.kw = dict(dv2g=dv2g, skip_iters=skip_iters, epsrel=epsrel,
                       epsabs=epsabs)

    def _carry(self, dev, start_it, it_offset, si, swgt, schi, xi, p, q):
        f64 = torch.float64

        def acc(v):
            return torch.as_tensor(np.atleast_1d(np.asarray(v, np.float64)),
                                   dtype=f64, device=dev).clone()

        c = {"it": torch.full((), start_it, dtype=torch.int64, device=dev),
             "word": torch.full((), it_offset + start_it, dtype=torch.int64,
                                device=dev),
             "si": acc(si), "swgt": acc(swgt), "schi": acc(schi),
             "done": torch.zeros((), dtype=torch.bool, device=dev)}
        c["packed"] = torch.zeros(2 + 3 * c["si"].shape[0], dtype=f64,
                                  device=dev)
        if self.adjust:
            c["xi"] = xi.to(torch.float32).clone()
            if self.refit is not None:
                p, q = self.refit(c["xi"])
                c["p"], c["q"] = p.clone(), q.clone()
        else:
            c["map"] = (xi, p, q)
        return c

    def _step(self, c, end_it: int, it_offset: int):
        """One iteration in place on the carry, and the packed vector."""
        if self.adjust:
            sums, d = self.iterate(c["word"], True, c["xi"], c.get("p"),
                                   c.get("q"))
        else:
            sums, _ = self.iterate(c["word"], False, *c["map"])
        if self.mesh is not None:
            sums = pmesh.all_reduce_sum(self.mesh, sums)
            if self.adjust:
                d = pmesh.all_reduce_sum(self.mesh, d)
        run = ~c["done"] & (c["it"] <= end_it)
        new = combine(c, sums, **self.kw)
        if self.adjust:
            new["xi"] = vegas_assisted._refine_grids(c["xi"][None],
                                                     d[None])[0]
            if self.refit is not None:
                new["p"], new["q"] = self.refit(new["xi"])
        for k, v in new.items():
            c[k].copy_(torch.where(run, v, c[k]))
        c["word"].copy_(c["it"] + it_offset)
        c["packed"].copy_(torch.cat([
            c["it"].to(torch.float64)[None], c["done"].to(torch.float64)[None],
            c["si"], c["swgt"], c["schi"]]))

    def graph_pays(self, packed, swgt0, left: int) -> bool:
        """Whether a phase on the card replays a graph for its ``left``
        iterations at most after the first (packed carry ``packed``, the
        weights ``swgt0`` before it): where a capture is allowed, by
        ``FORM`` or, unpinned, when at least ``GRAPH_MIN_ITERS`` are
        expected (``expected_iters``)."""
        if not self.capture or FORM == "eager":
            return False
        if FORM == "graph":
            return True
        return expected_iters(packed, swgt0, left, epsrel=self.kw["epsrel"],
                              epsabs=self.kw["epsabs"]) >= GRAPH_MIN_ITERS

    def _capture(self, c, end_it, it_offset, side):
        """One iteration on the carry captured as a CUDA graph on ``side``;
        returns (graph, the launch counts it records)."""
        counts = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        failed = None
        with torch.cuda.stream(side):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                self._step(c, end_it, it_offset)
            except Exception as e:   # noqa: BLE001 - any failure to capture
                failed = e
            try:
                graph.capture_end()
            except Exception as e:   # noqa: BLE001
                failed = failed or e
        torch.cuda.current_stream().wait_stream(side)
        if failed is not None:
            raise RuntimeError(
                f"vegas could not capture one {self.label} iteration into a "
                "CUDA graph: the integrand (or an option) does something a "
                "graph cannot hold, such as reading the card from the host "
                "(.item(), .cpu(), a data-dependent shape) or copying host "
                "data to the card; sampler='torch' runs the device-resident "
                f"phases uncaptured ({type(failed).__name__}: {failed})"
            ) from failed
        stats["captures"] += 1
        # the capture ran nothing: its launches count at each replay
        after = _launch_counts()
        recorded = {k: after[k] - n for k, n in counts.items()
                    if after[k] != n}
        _add_launches(recorded, -1)
        return graph, recorded

    def run(self, start_it: int, end_it: int, it_offset: int, si, swgt, schi,
            *, xi=None, p=None, q=None):
        """Iterations ``start_it..end_it`` (stream counter it_offset + it)
        from the accumulators (si, swgt, schi), host floats or (ncomp,)
        arrays.  Returns (next it, si, swgt, schi as f64 arrays (ncomp,),
        done, the refined f32 grid on the device or None)."""
        dev = (xi if xi is not None else p).device
        stats["phases"] += 1
        stats["uncaptured"] += int(self.uncaptured)
        c = self._carry(dev, start_it, it_offset, si, swgt, schi, xi, p, q)
        swgt0 = np.atleast_1d(np.asarray(swgt, np.float64))
        n_max = end_it - start_it + 1
        if dev.type == "cpu":
            packed = None
            for _ in range(n_max):
                self._step(c, end_it, it_offset)
                stats["eager"] += 1
                packed = self._read(c)
                if packed[1]:
                    break
        else:
            packed = self._run_on_card(c, n_max, end_it, it_offset, swgt0)
        ncomp = c["si"].shape[0]
        return (int(packed[0]), packed[2:2 + ncomp].copy(),
                packed[2 + ncomp:2 + 2 * ncomp].copy(),
                packed[2 + 2 * ncomp:].copy(), bool(packed[1]),
                c.get("xi"))

    def _run_on_card(self, c, n_max, end_it, it_offset, swgt0):
        t0 = time.perf_counter()
        self._step(c, end_it, it_offset)
        stats["eager"] += 1
        packed = self._read(c)
        t1 = time.perf_counter()
        stats["first_s"] += t1 - t0
        if packed[1] or n_max == 1:
            return packed
        graph = None
        if self.graph_pays(packed, swgt0, n_max - 1):
            side = torch.cuda.Stream(device=c["it"].device)
            with torch.cuda.stream(side):
                # per-stream state the capture must find, not create
                cuda_lookup.stream_tickets(c["it"].device)
            graph, recorded = self._capture(c, end_it, it_offset, side)
        t2 = time.perf_counter()
        stats["capture_s"] += t2 - t1
        for _ in range(n_max - 1):
            if graph is not None:
                graph.replay()
                _add_launches(recorded, 1)
                stats["replays"] += 1
            else:
                self._step(c, end_it, it_offset)
                stats["eager"] += 1
            packed = self._read(c)
            if packed[1]:
                break
        stats["rest_s"] += time.perf_counter() - t2
        return packed

    def _read(self, c):
        """The packed vector, the one transfer of an iteration."""
        stats["reads"] += 1
        return c["packed"].cpu().numpy().copy()
