"""PAGANI's device-resident phase: bursts of whole adaptive iterations with
no host decision between them (PyTorch port of
``gpuintegration_tpu/pagani/fused_loop.py``, its ``mesh`` forms included;
the Pallas form is the reference's TPU kernel route, whose counterpart
here is the rule evaluation's own CUDA route).

Below the classification gate (2 n <= 0.1 max_pool_regions) the host loop's
classifier never fires, so an iteration is a fixed pipeline: rule
evaluation, two-level refinement (``workspace.iteration_math``, the host
loop's own code), the accuracy test, the error-budget rollback, the
finished-region ledger, compaction and split.  The phase keeps the pool,
its region count, the f64 ledger and an exit status in device tensors (the
carry) and runs that pipeline without reading anything back, until it
leaves with a status:

  *  0  accuracy reached;
  *  2  every region finished;
  *  1  the next split would overflow the bucket: the sweep IS applied and
     the compacted survivors are returned (n = their count, ``sdim`` and,
     in a crease run, ``frac`` theirs); the host splits them into twice the
     capacity without evaluating anything again;
  * -1  the pool crossed the gate or the iteration budget ran out: the
     host runs one iteration with its classifier and may come back.

Every iteration a burst takes is applied to the ledger, in f64 as the host
loop's Python floats add (the iteration's sums are reduced in the pool
type and widened, which is exact); the per-region pipeline is the same code
as the host loop's, so a burst's decisions are the host loop's.  The host
reads ONE packed f64 vector a burst (``SCALAR_LAYOUT``, ``vector_layout``),
which also holds the ledger without the last sweep (``prev_*``, what
``Workspace._ledger_excl_pool`` keeps for a checkpoint) and that sweep's
in-flight part (``last_inflight_*``, folded in at a max-iterations exit).

On the card one iteration at a bucket capacity is captured once as a CUDA
graph (``torch.cuda.CUDAGraph``) and replayed; the carry's tensors are the
graph's fixed inputs and each replay copies its results back into them.  A
replay after the burst has ended is a no-op: every carried value is
``torch.where(run, new, old)`` with ``run`` the loop's condition (status
-1, 2 n <= gate, iterations left), as the reference's ``while_loop`` cond.
So the host reads the packed vector every ``REPLAYS`` replays and the
result does not depend on that count.  The first iteration at a capacity
runs eagerly (it fills every lazy cache and table the capture must not
create) and is read at once: a burst that ends there (a growing pool's
usual case) captures nothing.  Graphs are cached per capacity for one
``integrate`` call, share one memory pool (``torch.cuda.graph_pool_handle``)
and are freed when the call returns (``Phase.close``).  On the card the
rule evaluation inside a graph covers the whole bucket (the region count
lives on the card, and the kernels' launches take their shape from the
host); the padding slots' outputs are masked by ``block_mask(cap, n,
True)`` as the host loop masks them.  A callable that reads the card from
the host cannot be captured: RuntimeError, naming ``fused=False``, and no
eager fallback.

On the CPU the same body runs eagerly on the same carry (the evaluation
then walks the real regions only, as the host loop's does).

On a mesh (``parallel.mesh``; reference ``fused_loop.py:159-170``,
``:319-355``, ``:423-433``, ``:556-580``) each rank runs the phase on its own
blocked shard of per-shard capacity ``cap``: the carry holds the rank's
count ``n`` and the global count ``n_glob``; the iteration's f64 partials
(``scalars``) are SUM-all-reduced inside the body, so the accuracy test, the
rollback, the ledger and every exit are decided on the same global values on
every rank; the gate reads ``2 n_glob <= gate``, and the bucket-overflow
exit fires when the hottest shard (the MAX all-reduce of the ranks' survivor
counts) would overflow its bucket.  The packed vector carries ``n_glob`` as
``n`` and the rank's count last (``n_local``).  Whether a burst on the card
replays a graph is decided from the group's backend before it starts: an
NCCL all-reduce is captured with the iteration (on the capture stream),
gloo's cannot be (it copies through the host), so under gloo every
iteration runs eagerly and ``stats["uncaptured"]`` counts those iterations.

The reference also ends a burst at an evaluation ceiling per dispatch
(``neval_cap``, ``_burst_evals``): a limit of the TPU runtime that changes
no decision (a -1 exit resumes identically), left out here.
"""
from __future__ import annotations

import torch

from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.parallel import mesh as pmesh

# The packed vector of a scalar phase (the reference's layout).
SCALAR_LAYOUT = ("n", "cum_est", "cum_err", "result_nregions", "iters",
                 "neval", "status", "last_inflight_est", "last_inflight_err",
                 "prev_est", "prev_err", "prev_nregions", "prev_iters",
                 "hist0", "hist1", "hist2", "prev_neval")

# Counts of the phases since ``reset_stats``: bursts (phases entered),
# eager iterations, graph captures, graph replays and packed reads
# (device-to-host transfers); and each burst's exit status, in order.
# ``uncaptured`` counts the eager iterations of bursts on the card whose
# mesh's backend cannot be captured (gloo); ``split_past_16d`` the
# ``Workspace.integrate`` calls with ``fused`` that ran the host loop
# instead, a callable or a vector on the card's split route past 16D.
stats = {"bursts": 0, "eager": 0, "captures": 0, "replays": 0, "reads": 0,
         "uncaptured": 0, "split_past_16d": 0}
exits: list[int] = []
# Iterations between two reads of the packed vector (graph replays on the
# card); no result depends on it.
REPLAYS = 4


def reset_stats():
    for k in stats:
        stats[k] = 0
    exits.clear()


def vector_layout(ncomp: int) -> tuple:
    """The packed vector of a vector phase (the reference's layout):
    [n, result_nregions, iters, neval, status, prev_nregions, prev_iters,
    prev_neval, hist (3), cum_est, cum_err, last_inflight_est,
    last_inflight_err, prev_est, prev_err (ncomp each)]."""
    head = ("n", "result_nregions", "iters", "neval", "status",
            "prev_nregions", "prev_iters", "prev_neval", "hist0", "hist1",
            "hist2")
    return head + tuple(f"{name}{k}" for name in (
        "cum_est", "cum_err", "last_inflight_est", "last_inflight_err",
        "prev_est", "prev_err") for k in range(ncomp))


class Phase:
    """The fused phases of one ``Workspace.integrate`` call: the carry and
    the CUDA graph of each bucket capacity met, and the burst driver.

    ``evaluate(lows, lengths, n)``: the rule over a pool, returning (est,
    err, split_dim[, frac]) as ``rule_eval.apply_rule`` does, est and err
    (ncomp, cap) for a vector; ``n`` is the device count on the card (the
    whole bucket is evaluated) and a host integer on the CPU.
    ``iteration_math``: ``workspace.iteration_math`` (scalar) or
    ``workspace.iteration_math_vector``.  ``ncomp`` None marks a scalar
    integrand.  ``mesh``: a ``parallel.mesh`` mesh, the pool being this
    rank's shard (``n`` its count; ``load`` takes the global one)."""

    def __init__(self, evaluate, iteration_math, *, relerr_classification,
                 gate, feval, eps_work, epsrel, epsabs, abs_per_vol,
                 ncomp=None, with_split_frac=False, mesh=None):
        self.evaluate = evaluate
        self.iteration_math = iteration_math
        self.relerr_classification = relerr_classification
        self.gate = int(gate)
        self.feval = int(feval)
        self.eps_work = eps_work
        self.epsrel = float(epsrel)
        self.epsabs = float(epsabs)
        self.abs_per_vol = abs_per_vol
        self.ncomp = ncomp
        self.with_split_frac = with_split_frac
        self.mesh = mesh
        # a graph may hold the iteration's collective only under NCCL
        self.capturable = mesh is None or pmesh.backend(mesh) == "nccl"
        self.carries = {}
        self.graphs = {}
        self.pool = None

    def close(self):
        """Free the graphs, their memory pool and the carries."""
        self.graphs.clear()
        self.carries.clear()
        self.pool = None

    # -- the carry ---------------------------------------------------------

    def _carry(self, lows, lengths):
        """The carry tensors of this capacity: allocated once, then reused
        (a graph's fixed inputs)."""
        cap = lows.shape[1]
        if cap not in self.carries:
            dev, dtype = lows.device, lows.dtype
            nc = 1 if self.ncomp is None else self.ncomp
            pshape = (cap,) if self.ncomp is None else (nc, cap)

            def f64(*shape):
                return torch.zeros(shape, dtype=torch.float64, device=dev)

            def i64():
                return torch.zeros((), dtype=torch.int64, device=dev)

            c = {"lows": torch.empty_like(lows),
                 "lengths": torch.empty_like(lengths),
                 "parent": torch.zeros(pshape, dtype=dtype, device=dev),
                 "sdim": torch.zeros(cap, dtype=torch.int32, device=dev),
                 "n": i64(), "status": i64(), "iters": i64(),
                 "prev_iters": i64(), "max_iters": i64(),
                 "cum_est": f64(nc), "cum_err": f64(nc),
                 "result_nregions": f64(), "neval": f64(), "hist": f64(3),
                 "last_inflight_est": f64(nc), "last_inflight_err": f64(nc),
                 "prev_est": f64(nc), "prev_err": f64(nc),
                 "prev_nregions": f64(), "prev_neval": f64()}
            if self.with_split_frac:
                c["frac"] = torch.full((cap,), 0.5, dtype=dtype, device=dev)
            if self.mesh is not None:
                c["n_glob"] = i64()
            c["packed"] = f64(len(self.layout()))
            self.carries[cap] = c
        return self.carries[cap]

    def layout(self):
        lay = (SCALAR_LAYOUT if self.ncomp is None
               else vector_layout(self.ncomp))
        return lay if self.mesh is None else lay + ("n_local",)

    def _pack(self, c):
        packed = self._pack_ledger(c)
        if self.mesh is None:
            return packed
        return torch.cat([packed, c["n"].to(torch.float64)[None]])

    def _pack_ledger(self, c):
        f64 = torch.float64
        n = c["n"] if self.mesh is None else c["n_glob"]
        if self.ncomp is None:
            parts = [n.to(f64), c["cum_est"][0], c["cum_err"][0],
                     c["result_nregions"], c["iters"].to(f64), c["neval"],
                     c["status"].to(f64), c["last_inflight_est"][0],
                     c["last_inflight_err"][0], c["prev_est"][0],
                     c["prev_err"][0], c["prev_nregions"],
                     c["prev_iters"].to(f64), c["hist"][0], c["hist"][1],
                     c["hist"][2], c["prev_neval"]]
            return torch.stack(parts)
        head = torch.stack([
            n.to(f64), c["result_nregions"], c["iters"].to(f64),
            c["neval"], c["status"].to(f64), c["prev_nregions"],
            c["prev_iters"].to(f64), c["prev_neval"]])
        return torch.cat([head, c["hist"], c["cum_est"], c["cum_err"],
                          c["last_inflight_est"], c["last_inflight_err"],
                          c["prev_est"], c["prev_err"]])

    # -- one iteration -----------------------------------------------------

    def body(self, c):
        """One adaptive iteration on the carry ``c``, as new tensors, each
        the old one where the loop's condition does not hold (a no-op).  On a
        mesh ``n`` is the rank's count and every decision reads all-reduced
        values."""
        lo_c, ln_c, n, par_c = c["lows"], c["lengths"], c["n"], c["parent"]
        mesh = self.mesh
        n_glob = n if mesh is None else c["n_glob"]
        cap = lo_c.shape[1]
        dtype, dev = lo_c.dtype, lo_c.device
        f64 = torch.float64
        run = ((c["status"] == -1) & (2 * n_glob <= self.gate)
               & (c["iters"] < c["max_iters"]))

        ev = self.evaluate(lo_c, ln_c, n)
        est_raw, err_raw, sdim = ev[:3]
        sfrac = ev[3] if self.with_split_frac else None
        # the host loop's own per-region pipeline
        est, refined, active, scalars = self.iteration_math(
            self.relerr_classification, True, est_raw, err_raw, n, par_c,
            True, self.eps_work,
            lengths=None if self.abs_per_vol is None else ln_c,
            abs_per_vol=self.abs_per_vol)
        nc = scalars.shape[0] // 4
        n_active = scalars[4 * nc].to(torch.int64)    # this rank's
        if mesh is not None:
            scalars = pmesh.all_reduce_sum(mesh, scalars)
        iter_est, iter_err = scalars[0:nc], scalars[nc:2 * nc]
        fin_est, fin_err = scalars[2 * nc:3 * nc], scalars[3 * nc:4 * nc]
        n_active_glob = scalars[4 * nc].to(torch.int64)

        cum_e, cum_r = c["cum_est"], c["cum_err"]
        tot_est, tot_err = cum_e + iter_est, cum_r + iter_err
        # accuracy_reached (PaganiUtils.cuh:387-394), every component
        comp_ok = torch.where(
            torch.abs(tot_est) > 0,
            (tot_err / torch.abs(tot_est) <= self.epsrel)
            | (tot_err <= self.epsabs),
            tot_err <= self.epsabs)
        done = torch.all(comp_ok)
        # the error-budget rollback (Workspace.cuh:121-146) when any
        # component's banked error would overflow max(epsrel |est|, epsabs)
        overflow = torch.any((cum_r + fin_err) > torch.clamp(
            torch.abs(tot_est) * self.epsrel, min=self.epsabs))
        mask = region_pool.block_mask(cap, n, True, dev)
        active = torch.where(overflow, mask.to(dtype), active)
        zero = torch.zeros_like(fin_est)
        fin_est = torch.where(overflow, zero, fin_est)
        fin_err = torch.where(overflow, zero, fin_err)
        n_active = torch.where(overflow, n, n_active)
        if mesh is None:
            n_active_glob, hottest = n_active, n_active
        else:
            n_active_glob = torch.where(overflow, n_glob, n_active_glob)
            hottest = pmesh.all_reduce_max(mesh, n_active)
        all_fin = ~done & (n_active_glob == 0)
        # grow when the hottest shard's split would overflow its bucket
        grow = ~done & ~all_fin & (2 * hottest > cap)

        # compaction at the full capacity (a grow exit keeps up to cap
        # survivors), the split into the same bucket from its first half
        cres = region_pool.compact(active, lo_c, ln_c, sdim, est, refined,
                                   out_capacity=cap, extra=sfrac)
        c_lo, c_ln, c_sd, par_new = cres[:4]
        c_fr = cres[5] if self.with_split_frac else None
        lo2, ln2, _ = region_pool.split(
            c_lo[:, :cap // 2], c_ln[:, :cap // 2], c_sd[:cap // 2],
            n_active, out_capacity=cap,
            frac=None if c_fr is None else c_fr[:cap // 2])

        keep = done | all_fin
        n_f = n_glob.to(f64)
        drop = torch.where(done, torch.zeros_like(n_f),
                           torch.where(all_fin, n_f,
                                       n_f - n_active_glob.to(f64)))
        status = torch.full_like(n, -1)
        for cond, code in ((grow, 1), (all_fin, 2), (done, 0)):
            status = torch.where(cond, torch.full_like(n, code), status)
        # the worst component (largest relative error) feeds the
        # classifier's estimate history, as the host loops store it
        w = torch.argmax(tot_err / torch.clamp(torch.abs(tot_est),
                                               min=1e-300))
        # (index_select: indexing by a 0-d tensor would read it on the host)
        hist = torch.where(done, c["hist"],
                           torch.cat([c["hist"][1:],
                                      tot_est.index_select(0, w[None])]))
        new = {
            "lows": torch.where(keep, lo_c, torch.where(grow, c_lo, lo2)),
            "lengths": torch.where(keep, ln_c, torch.where(grow, c_ln, ln2)),
            "parent": torch.where(keep, par_c, par_new),
            "sdim": c_sd,
            "n": torch.where(keep, n, torch.where(grow, n_active,
                                                  2 * n_active)),
            "status": status,
            "iters": c["iters"] + 1,
            "prev_iters": c["iters"],
            "max_iters": c["max_iters"],
            "cum_est": cum_e + torch.where(done, iter_est, fin_est),
            "cum_err": cum_r + torch.where(done, iter_err, fin_err),
            "result_nregions": c["result_nregions"] + drop,
            "neval": c["neval"] + n_f * self.feval,
            "hist": hist,
            "last_inflight_est": iter_est - fin_est,
            "last_inflight_err": iter_err - fin_err,
            "prev_est": cum_e, "prev_err": cum_r,
            "prev_nregions": c["result_nregions"],
            "prev_neval": c["neval"],
        }
        if self.with_split_frac:
            new["frac"] = c_fr
        if mesh is not None:
            new["n_glob"] = torch.where(
                keep, n_glob, torch.where(grow, n_active_glob,
                                          2 * n_active_glob))
        return {k: torch.where(run, v, c[k]) for k, v in new.items()}

    def _step(self, c):
        """One iteration in place on the carry, and the packed vector."""
        new = self.body(c)
        for k, v in new.items():
            c[k].copy_(v)
        c["packed"].copy_(self._pack(c))

    def _capture(self, cap, c):
        """One iteration on the carry captured as a CUDA graph, on a side
        stream that waits for the current one.  ``capture_begin`` and
        ``capture_end`` directly, not ``torch.cuda.graph``, whose entry
        empties the allocator's cache: the host loop's next large pools
        would then allocate from the driver again."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=c["lows"].device)
        side.wait_stream(torch.cuda.current_stream())
        failed = None
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool)
            try:
                self._step(c)
            except Exception as e:   # noqa: BLE001 - any failure to capture
                failed = e
            try:
                graph.capture_end()
            except Exception as e:   # noqa: BLE001
                failed = failed or e
        torch.cuda.current_stream().wait_stream(side)
        if failed is not None:
            raise RuntimeError(
                "the fused phase could not capture one PAGANI iteration "
                "into a CUDA graph: the integrand (or an option) does "
                "something a graph cannot hold, such as reading the card "
                "from the host (.item(), .cpu(), a data-dependent shape) or "
                "copying host data to the card; run it with fused=False "
                f"({type(failed).__name__}: {failed})") from failed
        stats["captures"] += 1
        self.graphs[cap] = graph
        return graph

    # -- a burst -----------------------------------------------------------

    def load(self, lows, lengths, n: int, parent, *, cum_est, cum_err,
             result_nregions, iters, neval, hist, max_iters, n_glob=None):
        """The carry of this capacity holding a blocked (post-split) pool of
        ``n`` real regions, its parents' estimates ``parent`` ((cap//2,) or
        wider; (ncomp, ...) for a vector) and the host ledger; status -1.
        On a mesh ``n_glob`` is the global count."""
        cap = lows.shape[1]
        self._max = int(max_iters)
        c = self._carry(lows, lengths)
        c["lows"].copy_(lows)
        c["lengths"].copy_(lengths)
        m = min(parent.shape[-1], cap)
        par = parent[..., :m].clone()
        c["parent"].zero_()
        c["parent"][..., :m].copy_(par)
        for k, v in (("n", n), ("iters", iters), ("prev_iters", iters),
                     ("max_iters", max_iters), ("status", -1),
                     ("result_nregions", float(result_nregions)),
                     ("prev_nregions", float(result_nregions)),
                     ("neval", float(neval)), ("prev_neval", float(neval))):
            c[k].fill_(v)
        for k, v in (("cum_est", cum_est), ("cum_err", cum_err),
                     ("prev_est", cum_est), ("prev_err", cum_err),
                     ("hist", hist)):
            c[k].copy_(torch.as_tensor(v, dtype=torch.float64).reshape(
                c[k].shape))
        c["last_inflight_est"].zero_()
        c["last_inflight_err"].zero_()
        if self.with_split_frac:
            c["frac"].fill_(0.5)
        if self.mesh is not None:
            c["n_glob"].fill_(n_glob)
        return c

    def run(self, lows, lengths, n: int, parent, **ledger):
        """One burst from the pool and ledger ``load`` takes.  Returns
        (lows, lengths, parent (full capacity), sdim, frac or None, packed
        as a NumPy f64 vector).  On the card the burst replays a graph
        unless its mesh's backend cannot be captured (``capturable``): then
        it runs eagerly, as on the CPU."""
        cap = lows.shape[1]
        c = self.load(lows, lengths, n, parent, **ledger)
        stats["bursts"] += 1
        on_card = lows.device.type == "cuda" and self.capturable
        if lows.device.type == "cuda" and not self.capturable:
            eager_before = stats["eager"]
        packed = None
        if not on_card or cap not in self.graphs:
            # the first iteration at this capacity, eager; on the CPU every
            # one, read in groups of ``REPLAYS`` as the card's
            self._step(c)
            stats["eager"] += 1
            packed = self._read(c)
        while packed is None or self._running(packed):
            if on_card:
                graph = self.graphs.get(cap) or self._capture(cap, c)
                for _ in range(REPLAYS):
                    graph.replay()
                stats["replays"] += REPLAYS
            else:
                for _ in range(REPLAYS):
                    self._step(c)
                stats["eager"] += REPLAYS
            packed = self._read(c)
        if lows.device.type == "cuda" and not self.capturable:
            stats["uncaptured"] += stats["eager"] - eager_before
        exits.append(int(packed[self.layout().index("status")]))
        frac = c["frac"] if self.with_split_frac else None
        return c["lows"], c["lengths"], c["parent"], c["sdim"], frac, packed

    def _read(self, c):
        stats["reads"] += 1
        return c["packed"].cpu().numpy()        # the one transfer

    def _running(self, packed) -> bool:
        lay = self.layout()
        status = int(packed[lay.index("status")])
        n = int(packed[lay.index("n")])
        iters = int(packed[lay.index("iters")])
        return status == -1 and 2 * n <= self.gate and iters < self._max
