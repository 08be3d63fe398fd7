"""PAGANI's device-resident phase (``pagani/fused_loop.py``, the default
``fused=True``) against the port's host loop (``fused=False``) and the JAX
package's ``fused=True``, on the CPU, where the same iteration body runs
eagerly on the same device-scalar carry as the card's CUDA graph.

Each run must give the host loop's and the reference's discrete outcomes
(status, iterations, regions, finished regions, neval) and estimate and
errorest within 64 ulps of the estimate.  The exits covered: 0 (accuracy),
1 (the bucket overflows: the host splits the survivors, with their cut
fractions in a crease run), 2 (every region finished, from a seeded ledger
at the edge of its budget) and -1 (the classifier's gate, a small pool
budget; the iteration budget inside a burst).  Also: f32 (the final pool
read by ``kernel_check``'s gate-aware reading), the vector phase against
``fused_adaptive_phase_vector``, ``_ledger_excl_pool`` and
``make_checkpoint`` after a fused exit, ``integrate_to_convergence``
resuming from fused exits, the packed vector read every replay against
every third, and ``predict_split``, which runs the host loop.  The port runs
with ``torch.set_flush_denormal(True)``: XLA on the CPU flushes subnormal
results."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import kernel_check, rule_eval
from gpuintegration_torch.pagani import fused_loop

ULPS = 64
# a constant integrand on a ledger seeded at the edge of its budget: the
# second sweep finishes every region and the total stays unconverged
EDGE_LEDGER = (3.0, 0.30000000000000004, 0, 0, 0)
CASES = {
    # name: (integrand maker, ndim, epsrel, Workspace kw, integrate kw)
    "gate": (lambda m: m.f2_product_peak(3), 3, 1e-8,
             dict(max_pool_regions=20000), {}),
    "budget": (lambda m: m.f4_gaussian(3, a=5.0), 3, 1e-9, {},
               dict(max_iterations=9)),
    "crease": (lambda m: m.f5_c0_continuous(3, a=10.0, b=0.37), 3, 1e-7, {},
               dict(crease_split=True, max_iterations=60)),
    "all_finished": (None, 3, 0.1, {}, dict(ledger=EDGE_LEDGER)),
    "f32": (lambda m: m.f4_gaussian(3, a=5.0), 3, 1e-3,
            dict(dtype="float32"), {}),
}


def _constant(x):
    return torch.full(x.shape[:-1], 1e-30, dtype=x.dtype)


def _constant_jax(x):
    return jnp.full(x.shape[:-1], 1e-30)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _workspaces(ndim, ws_kw):
    t_kw = dict(ws_kw)
    j_kw = dict(ws_kw)
    if ws_kw.get("dtype") == "float32":
        t_kw["dtype"], j_kw["dtype"] = torch.float32, jnp.float32
    return (Workspace(ndim, chunk_size=1024, device="cpu", **t_kw),
            JaxWorkspace(ndim, chunk_size=1024, **j_kw))


@pytest.fixture(scope="module")
def runs():
    """Each case: the port fused (with its bursts' exits), the port's host
    loop and the reference fused, and the workspaces after them."""
    out = {}
    for name, (make, ndim, eps, ws_kw, kw) in CASES.items():
        f = _constant if make is None else make(genz)
        f_jax = _constant_jax if make is None else make(jax_genz)
        ws, ws_j = _workspaces(ndim, ws_kw)
        fused_loop.reset_stats()
        got = ws.integrate(f, epsrel=eps, epsabs=1e-40, **kw)
        exits, stats = list(fused_loop.exits), dict(fused_loop.stats)
        host = _workspaces(ndim, ws_kw)[0].integrate(
            f, epsrel=eps, epsabs=1e-40, fused=False, **kw)
        ref = ws_j.integrate(f_jax, epsrel=eps, epsabs=1e-40, fused=True,
                             **kw)
        out[name] = dict(got=got, host=host, ref=ref, ws=ws, ws_j=ws_j,
                         exits=exits, stats=stats)
    return out


def _key(r):
    return (r.status, r.iters, r.nregions, r.nFinishedRegions, r.neval)


def _assert_close(got, ref):
    ulp = np.spacing(np.abs(np.atleast_1d(ref.estimates if ref.estimates
                                          is not None else ref.estimate)))
    for a, b in (("estimate", "estimate"), ("errorest", "errorest")):
        x = np.atleast_1d(getattr(got, a + "s", None)
                          if getattr(got, a + "s", None) is not None
                          else getattr(got, a))
        y = np.atleast_1d(getattr(ref, b + "s", None)
                          if getattr(ref, b + "s", None) is not None
                          else getattr(ref, b))
        assert (np.abs(x - y) <= ULPS * ulp).all(), (a, x, y)


@pytest.mark.parametrize("name", ["gate", "budget", "crease",
                                  "all_finished"])
def test_fused_matches_host_loop_and_jax(runs, name):
    r = runs[name]
    assert _key(r["got"]) == _key(r["host"]) == _key(r["ref"])
    _assert_close(r["got"], r["host"])
    _assert_close(r["got"], r["ref"])
    assert r["stats"]["bursts"] >= 1


def test_every_exit_is_taken(runs):
    """Across the cases the bursts leave by every status: the gate and the
    iteration budget (-1), accuracy (0), a bucket overflow (1) and every
    region finished (2)."""
    # the gate, host iterations with the classifier, a burst to the end
    assert runs["gate"]["exits"] == [-1, 0]
    assert runs["gate"]["got"].status == 0
    assert runs["budget"]["exits"][-1] == -1
    assert runs["budget"]["got"].status == 1
    assert runs["budget"]["got"].iters == 9
    assert 1 in runs["crease"]["exits"] and runs["crease"]["exits"][-1] == 0
    assert runs["all_finished"]["exits"] == [2]
    assert runs["all_finished"]["got"].status == 1
    taken = set().union(*(r["exits"] for r in runs.values()))
    assert taken == {-1, 0, 1, 2}


@pytest.mark.parametrize("name", ["gate", "budget", "crease",
                                  "all_finished"])
def test_ledger_and_checkpoint_after_a_fused_exit(runs, name):
    """The ledger without the final pool's sweep is the reference's after
    each final exit (accuracy and every region finished: the carry's
    prev_*; the iteration budget: the ledger as it stands), and the
    checkpoint keeps the pool in its order, with no per-region errors.
    (The pools hold the same number of regions; not the same ones, since
    a Gaussian's or F5's near-tied split axes fall apart between the
    packages, ROADMAP C.)"""
    r = runs[name]
    got, ref = r["ws"]._ledger_excl_pool, r["ws_j"]._ledger_excl_pool
    assert tuple(got[2:]) == tuple(int(v) for v in ref[2:])
    ulp = np.spacing(abs(r["ref"].estimate))
    assert abs(got[0] - ref[0]) <= ULPS * ulp
    assert abs(got[1] - ref[1]) <= ULPS * ulp
    assert r["ws"].final_pool_errors is None
    ck = r["ws"].make_checkpoint()
    ck_j = r["ws_j"].make_checkpoint()
    assert ck.region_estimates is None and ck_j.region_estimates is None
    assert ck.lows.shape == np.asarray(ck_j.lows).shape
    assert ck.ledger[2:] == tuple(int(v) for v in ck_j.ledger[2:])
    vol = np.prod(ck.lengths, axis=1).sum()
    assert 0.0 < vol <= 1.0 + 1e-12


def test_f32_fused_run(runs):
    """f32: the fused run is the host loop's; against the reference's the
    same decisions, the estimate within f32 resolution, and the final
    pool's per-region outputs held by kernel_check's gate-aware reading
    (an f32 errorest is rounding noise that can flip the (5,1,5) gate)."""
    r = runs["f32"]
    got, ref = r["got"], r["ref"]
    assert _key(got) == _key(r["host"]) == _key(ref)
    assert (got.estimate, got.errorest) == (r["host"].estimate,
                                            r["host"].errorest)
    assert abs(got.estimate - ref.estimate) <= 1e-6 * abs(ref.estimate)
    lows, lengths, n, blocked = r["ws"].final_pool
    keep = np.nonzero(np.asarray(
        fused_loop.region_pool.block_mask(lows.shape[1], n, blocked)))[0]
    lo, ln = lows[:, keep].contiguous(), lengths[:, keep].contiguous()
    tables = rule_eval.rule_tables(3, "float32")
    t = (lo, ln, torch.zeros(3, dtype=torch.float32),
         torch.ones(3, dtype=torch.float32))
    g = genz.f4_gaussian(3, a=5.0)
    mine = rule_eval.apply_rule_plain(g, tables, *t)
    theirs = jax_rule_eval.apply_rule(
        jax_genz.f4_gaussian(3, a=5.0),
        jax_rule_eval.rule_tables(3, "float32"),
        *(jnp.asarray(a.numpy()) for a in t))
    vals, u = kernel_check.value_scales(g, tables, *t)
    kernel_check.judge(kernel_check.region_readings(
        [torch.as_tensor(np.array(o)) for o in theirs], mine, vals, u,
        tables, t[1], t[3]), name="f4 f32 final pool", dtype=torch.float32,
        min_agree=0.95)


def test_vector_phase_matches_jax():
    """The vector phase against the host vector loop and the reference's
    ``fused_adaptive_phase_vector``: every component's ledger, the worst
    component's history, the same exits."""
    members = [genz.f2_product_peak(3), genz.f4_gaussian(3, a=5.0)]
    jmembers = [jax_genz.f2_product_peak(3), jax_genz.f4_gaussian(3, a=5.0)]

    def f(x):
        return torch.stack([m(x) for m in members], dim=-1)

    def f_jax(x):
        return jnp.stack([m(x) for m in jmembers], axis=-1)

    f.ndim = f_jax.ndim = 3
    kw = dict(epsrel=1e-6, epsabs=1e-40)
    fused_loop.reset_stats()
    got = Workspace(3, chunk_size=1024, device="cpu").integrate(f, **kw)
    assert fused_loop.stats["bursts"] >= 1 and fused_loop.exits[-1] == 0
    host = Workspace(3, chunk_size=1024, device="cpu").integrate(
        f, fused=False, **kw)
    ref = JaxWorkspace(3, chunk_size=1024).integrate(f_jax, fused=True,
                                                     **kw)
    assert _key(got) == _key(host) == _key(ref)
    _assert_close(got, host)
    _assert_close(got, ref)
    assert got.status == 0 and got.estimates.shape == (2,)


def test_continuation_resumes_from_fused_exits():
    """integrate_to_convergence with a small iteration budget: every round
    ends inside a burst, and the next resumes from that fused exit's
    checkpoint, in both packages alike."""
    kw = dict(epsrel=1e-9, epsabs=1e-40, max_iterations=5, fused=True)
    ref = JaxWorkspace(3, chunk_size=1024).integrate_to_convergence(
        jax_genz.f4_gaussian(3, a=5.0), **kw)
    fused_loop.reset_stats()
    got = Workspace(3, chunk_size=1024, device="cpu").integrate_to_convergence(
        genz.f4_gaussian(3, a=5.0), **kw)
    assert -1 in fused_loop.exits and got.iters > 5
    assert _key(got) == _key(ref) and got.status == 0
    _assert_close(got, ref)


def test_results_do_not_depend_on_the_replays_between_reads(monkeypatch):
    """The packed vector read after every iteration or after every third
    (the no-op iterations after a burst's exit change nothing): the same
    bits, exits and iterations, fewer reads."""
    out = []
    for replays in (1, 3):
        monkeypatch.setattr(fused_loop, "REPLAYS", replays)
        fused_loop.reset_stats()
        ws = Workspace(3, chunk_size=1024, device="cpu",
                       max_pool_regions=1 << 15)
        r = ws.integrate(genz.f5_c0_continuous(3, a=10.0, b=0.37),
                         epsrel=1e-7, epsabs=1e-40, crease_split=True)
        out.append((r, list(fused_loop.exits), fused_loop.stats["reads"]))
    (a, ea, reads_a), (b, eb, reads_b) = out
    assert (a.estimate, a.errorest, _key(a)) == (b.estimate, b.errorest,
                                                 _key(b))
    assert ea == eb and reads_b < reads_a


def test_predict_split_matches_jax():
    """predict_split runs the host loop throughout (no bursts), with the
    reference's decisions and its snapshot at iteration 15."""
    kw = dict(epsrel=1e-7, epsabs=1e-40, predict_split=True)
    fused_loop.reset_stats()
    ws = Workspace(3, chunk_size=1024, device="cpu")
    got = ws.integrate(genz.f4_gaussian(3, a=5.0), **kw)
    assert fused_loop.stats["bursts"] == 0
    ws_j = JaxWorkspace(3, chunk_size=1024)
    ref = ws_j.integrate(jax_genz.f4_gaussian(3, a=5.0), **kw)
    assert _key(got) == _key(ref)
    _assert_close(got, ref)
    plain = Workspace(3, chunk_size=1024, device="cpu").integrate(
        genz.f4_gaussian(3, a=5.0), epsrel=1e-7, epsabs=1e-40)
    assert got.neval != plain.neval        # classification held back
    if hasattr(ws_j, "last_snapshot"):
        assert hasattr(ws, "last_snapshot")
        assert ws.last_snapshot[2:] == (int(ws_j.last_snapshot[2]),
                                        bool(ws_j.last_snapshot[3]))
