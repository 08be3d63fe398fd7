"""VEGAS's device-resident phases (gpuintegration_torch/mcubes/phases.py) on
the CPU: the f32 rebin and the device fit against the JAX package's, the
frozen phase against the port's own host loop bit for bit, and
``refine='device'`` as the JAX package's own tests hold it
(tests/test_vegas.py::TestDeviceRefine).

On the CPU the phases run eagerly, the same body a CUDA graph replays on
the card (tests/test_torch_cuda_vegas_phases.py holds the replay's bits
there).  The host loop is reached as the reference reaches it, through a
``debug_logger``, or through ``phases.FORM = 'host'``, which keeps the
logger's own work out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes.poly_importance import (
    fit_importance_poly_device as jax_fit_device)
from gpuintegration_tpu.pagani.vegas_assisted import (
    _refine_grids as jax_refine)
from gpuintegration_torch import mcubes
from gpuintegration_torch.mcubes import grid, phases, poly_importance, stream
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.mcubes.cuda_lookup import HIST_CAP
from gpuintegration_torch.mcubes.debug import VegasDebugLogger
from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.pagani.vegas_assisted import _refine_grids

EPS32 = float(np.finfo(np.float32).eps)
# edges within this many f32 ulps of their rounding scale (see
# ``_edge_scale``); the largest reading on these cases is 1.44
EDGE_ULPS = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (many small tensor operations; the test workers
    side by side would otherwise oversubscribe the cores), and subnormals
    flushed as XLA on the CPU flushes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the rebin

def _rebin_parts(grids, hist, cumsum):
    """(k, r_k, total, xo, xn, cum, targets) of the rebin by its formulas,
    with ``cumsum`` the package's own (jnp or torch, as numpy arrays)."""
    h = np.asarray(hist, np.float32)
    nb = h.shape[-1]
    left = np.concatenate([h[..., :1], h[..., :-1]], axis=-1)
    right = np.concatenate([h[..., 1:], h[..., -1:]], axis=-1)
    sm = (left + h + right) / np.float32(3.0)
    sm[..., 0] = (h[..., 0] + h[..., 1]) / np.float32(2.0)
    sm[..., -1] = (h[..., -2] + h[..., -1]) / np.float32(2.0)
    sm = np.maximum(sm, np.float32(1e-30))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        frac = sm / np.sum(sm, axis=-1, keepdims=True)
        r = ((np.float32(1) - frac)
             / -np.log(np.clip(frac, np.float32(1e-30), np.float32(1))))
        r = (r ** np.float32(1.5)).astype(np.float32)
    cum = cumsum(r)
    total = cum[..., -1:]
    targets = np.arange(1, nb, dtype=np.float32) * (total / np.float32(nb))
    k = np.clip((cum[..., None, :] < targets[..., :, None]).sum(-1), 0,
                nb - 1)
    pick = lambda a: np.take_along_axis(a, k, axis=-1)  # noqa: E731
    return (k, pick(r), total, pick(grids[..., :nb]), pick(grids[..., 1:]),
            cum, targets)


def _edge_scale(edges, parts):
    """The rounding scale of each inner edge xn - (xn - xo) dr / r_k: an
    ulp of the edge, and the cancellation in dr = cum_k - target, whose
    rounding is that of the cumulative sum (~ total) over r_k."""
    k, rk, total, xo, xn = parts[:5]
    rk = np.where(rk > 0, rk, 1.0)
    return EPS32 * (np.abs(edges[..., 1:-1])
                    + np.abs(xn - xo) * np.abs(total) / rk)


def _ties(parts, tol_ulps=64.0):
    """Where a target lies within rounding of a cumulative sum's entry, so
    that k may move between two summation orders."""
    k, _, total, _, _, cum, targets = parts
    tol = tol_ulps * EPS32 * np.abs(total)
    lo = np.take_along_axis(cum, np.clip(k - 1, 0, None), axis=-1)
    hi = np.take_along_axis(cum, k, axis=-1)
    return (np.abs(hi - targets) <= tol) | (np.abs(lo - targets) <= tol)


def _grids(rng, lead, nb):
    g = np.sort(rng.random(lead + (nb + 1,)).astype(np.float32), axis=-1)
    g[..., 0], g[..., -1] = 0.0, 1.0
    return g


def _hist_cases():
    rng = np.random.default_rng(7)
    # VEGAS-style: one (1, ndim, 500) grid, f^2 sums spanning decades,
    # some bins at the histogram's cap
    h = (rng.random((1, 5, 500)) ** 6 * 1e6).astype(np.float32)
    h[0, 2, 100:140] = HIST_CAP
    yield "vegas clamped", _grids(rng, (1, 5), 500), h
    # per-region max-normalised sums in [0, spp] (vegas_assisted)
    h = (rng.random((48, 4, 100)) ** 3 * 320).astype(np.float32)
    yield "per-region normalised", _grids(rng, (48, 4), 100), h
    # a dimension with no mass keeps its edges
    h = rng.random((6, 3, 100)).astype(np.float32)
    h[2, 1] = 0.0
    h[4, :] = 0.0
    yield "zero-mass dimension", _grids(rng, (6, 3), 100), h
    # all the mass in one bin
    h = np.zeros((4, 2, 100), np.float32)
    h[:, 0, 37] = 5.0
    h[:, 1, 0] = 1.0
    h[:, 1, 99] = 1e-3
    yield "single-bin peak", _grids(rng, (4, 2), 100), h


@pytest.mark.parametrize("label,grids,hist", list(_hist_cases()),
                         ids=[c[0] for c in _hist_cases()])
def test_refine_grids_matches_reference(label, grids, hist):
    ref = np.asarray(jax_refine(jnp.asarray(grids), jnp.asarray(hist)))
    got = _refine_grids(torch.as_tensor(grids), torch.as_tensor(hist)).numpy()
    assert got.dtype == np.float32 and got.shape == grids.shape
    assert np.all(got[..., 0] == 0.0) and np.all(got[..., -1] == 1.0)
    assert np.all(np.diff(got, axis=-1) >= 0.0)
    # a dimension whose smoothed histogram is 0 keeps its edges bitwise
    empty = hist.sum(-1) == 0
    assert np.array_equal(got[empty], grids[empty])
    assert np.array_equal(ref[empty], grids[empty])
    # each package's k: the reference's compare-count on its own cumsum,
    # the port's searchsorted on torch.cumsum; equal away from ties
    ref_parts = _rebin_parts(grids, hist, lambda r: np.asarray(
        jnp.cumsum(jnp.asarray(r), axis=-1)))
    parts = _rebin_parts(grids, hist, lambda r: torch.cumsum(
        torch.as_tensor(r), -1).numpy())
    live = ~empty[..., None].repeat(hist.shape[-1] - 1, -1)
    ties = _ties(parts) | _ties(ref_parts)
    assert np.array_equal(ref_parts[0][live & ~ties], parts[0][live & ~ties])
    reading = np.abs(got - ref)[..., 1:-1] / _edge_scale(got, parts)
    assert float(reading.max()) <= EDGE_ULPS, float(reading.max())


def test_refine_grids_matches_host_rebin_shape():
    """A VEGAS grid refined on the device lands where the host's f64 rebin
    puts it, up to the f32 weights' rounding: edges within 1e-4 of each
    other on a smooth histogram."""
    rng = np.random.default_rng(3)
    xi = grid.uniform_grid(3, 64, torch.float64).numpy()
    d = (1.0 + np.sin(np.linspace(0, 6, 64)) ** 2)[None].repeat(3, 0)
    d = (d * rng.uniform(0.9, 1.1, d.shape))
    host = grid.smooth_and_refine(xi, d)
    dev = _refine_grids(torch.as_tensor(xi, dtype=torch.float32)[None],
                        torch.as_tensor(d, dtype=torch.float32)[None])[0]
    assert np.max(np.abs(dev.numpy() - host)) < 1e-4


# ---------------------------------------------------------------------------
# the device fit

def _fit_grids():
    rng = np.random.default_rng(11)
    yield grid.uniform_grid(3, 500, torch.float64).numpy()
    yield grid.smooth_and_refine(
        grid.uniform_grid(4, 200, torch.float64).numpy(),
        rng.random((4, 200)) ** 4)
    widths = np.exp(-((np.arange(100) - 40.0) / 8.0) ** 2) + 1e-3
    xi = np.concatenate([[0.0], np.cumsum(widths)])
    yield (xi / xi[-1])[None].repeat(2, 0)


@pytest.mark.parametrize("degree", [6, 14])
@pytest.mark.parametrize("case", range(3))
def test_device_fit_matches_reference_and_host_fit(case, degree):
    xi = list(_fit_grids())[case]
    p, q = poly_importance.fit_importance_poly_device(torch.as_tensor(xi),
                                                      degree)
    assert p.dtype == q.dtype == torch.float64
    rp, rq = (np.asarray(a) for a in jax_fit_device(jnp.asarray(xi), degree))
    hp, hq = poly_importance.fit_importance_poly(xi, degree)
    for got, want in ((p.numpy(), rp), (q.numpy(), rq), (p.numpy(), hp),
                      (q.numpy(), hq)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(
            1.0, float(np.abs(want).max())))


def test_fit_tables_are_cached_per_device():
    a = poly_importance.fit_tables(64, 6, "cpu")
    assert a is poly_importance.fit_tables(64, 6, torch.device("cpu"))
    assert all(t.dtype == torch.float64 for t in a)


# ---------------------------------------------------------------------------
# the frozen phase against the host loop, bit for bit

G3 = genz.f4_gaussian(3, a=5.0)


def _vector(x):
    return torch.stack([G3(x), x.sum(-1)], dim=-1)


FROZEN = {
    # converging in the frozen phase
    "poly torch": (G3, dict(epsrel=2e-3, ncall=3e4, adjust_iters=4)),
    "poly hybrid": (G3, dict(epsrel=2e-3, ncall=3e4, adjust_iters=4,
                             sampler="hybrid")),
    "poly fused f32": (G3, dict(epsrel=2e-3, ncall=3e4, adjust_iters=4,
                                sampler="fused",
                                eval_dtype=torch.float32)),
    "grid": (G3, dict(epsrel=2e-3, ncall=3e4, adjust_iters=4,
                      importance="grid")),
    "grid f32": (G3, dict(epsrel=2e-3, ncall=3e4, adjust_iters=4,
                          importance="grid", dtype=torch.float32)),
    # running to total_iters
    "fixed length": (G3, dict(epsrel=1e-9, epsabs=1e-300, ncall=2e4,
                              total_iters=9, adjust_iters=4, skip_iters=2)),
    # a skip window longer than the adjustment phase
    "long skip": (G3, dict(epsrel=5e-3, ncall=2e4, total_iters=12,
                           adjust_iters=3, skip_iters=6)),
    "vector poly": (_vector, dict(ndim=3, epsrel=2e-3, ncall=3e4,
                                  adjust_iters=4)),
    "vector grid": (_vector, dict(ndim=3, epsrel=1e-9, epsabs=1e-300,
                                  ncall=2e4, total_iters=8, adjust_iters=3,
                                  importance="grid")),
}


def _same(a, b):
    for name in ("status", "iters", "neval", "lastPhase", "estimate",
                 "errorest", "chi_sq", "prob"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("estimates", "errorests", "probs"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("case", list(FROZEN))
def test_frozen_phase_gives_the_host_loops_bits(case, monkeypatch):
    f, kw = FROZEN[case]
    kw = dict(kw, seed=5, device="cpu")
    phases.reset_stats()
    fused = mcubes.integrate(f, **kw)
    assert phases.stats["phases"] == 1 and phases.stats["captures"] == 0
    assert phases.stats["eager"] == fused.iters - min(
        kw.get("adjust_iters", 15), fused.iters)
    # the debug logger takes the host loop, as the reference's does
    _same(fused, mcubes.integrate(f, debug_logger=VegasDebugLogger(), **kw))
    monkeypatch.setattr(phases, "FORM", "host")
    phases.reset_stats()
    _same(fused, mcubes.integrate(f, **kw))
    assert phases.stats["phases"] == 0


def test_frozen_phase_converges_early_and_resumes():
    """Early convergence: the phase stops at the host loop's iteration.
    A resumed state (it0, n_acc, accumulators) continues alike."""
    kw = dict(epsrel=1e-9, epsabs=1e-300, ncall=2e4, adjust_iters=2,
              skip_iters=1, total_iters=4, seed=8, device="cpu")
    states = {}
    for fused in (True, False):
        logger = {} if fused else {"debug_logger": VegasDebugLogger()}
        st = V.VegasState(xi=grid.uniform_grid(3, 64))
        a = mcubes.integrate(G3, state=st, nbins=64, **logger, **kw)
        b = mcubes.integrate(G3, state=st, nbins=64, **logger,
                             **dict(kw, epsrel=2e-2, total_iters=8))
        states[fused] = (a, b, st)
    (a1, b1, s1), (a0, b0, s0) = states[True], states[False]
    _same(a1, a0)
    _same(b1, b0)
    assert b1.status == 0 and b1.iters < 8
    assert (s1.it0, s1.n_acc, s1.si, s1.swgt, s1.schi) == (
        s0.it0, s0.n_acc, s0.si, s0.swgt, s0.schi)
    assert torch.equal(s1.xi, s0.xi)


def test_stream_counter_tensor_gives_the_host_words():
    cubes = torch.arange(5, 40, dtype=torch.int64)
    for it in (1, 7, 2 ** 32 + 3):
        want = stream.stream_bits(4, it, cubes, 2, 5)
        got = stream.stream_bits(4, torch.tensor(it), cubes, 2, 5)
        assert torch.equal(want, got)
    cpu = torch.device("cpu")
    c = stream.counter(2 ** 32 + 3, cpu)
    assert c.dim() == 0 and c.dtype == torch.int64 and int(c) == 3
    assert stream.counter(c, cpu) is c
    with pytest.raises(ValueError, match="0-d"):
        stream.counter(torch.zeros(2, dtype=torch.int64), cpu)
    with pytest.raises(ValueError, match="0-d"):
        stream.counter(torch.zeros((), dtype=torch.int32), cpu)


def test_phase_masks_iterations_past_its_end():
    """A step whose ``run`` is false changes no carried value."""
    calls = []

    def iterate(word, hist, xi, p, q):
        calls.append(int(word))
        return torch.tensor([1.0, 0.5], dtype=torch.float64), None

    ph = phases.Phase(iterate, adjust=False, capture=False, dv2g=2.0,
                      skip_iters=0, epsrel=0.0, epsabs=0.0)
    xi = torch.zeros(2, 3)
    c = ph._carry(xi.device, 1, 10, 0.0, 0.0, 0.0, xi, None, None)
    for _ in range(3):
        ph._step(c, 2, 10)
    assert calls == [11, 12, 13]
    packed = c["packed"].numpy()
    assert packed[0] == 3 and packed[1] == 0.0
    # two accumulated iterations, wgt = 1 / (0.5 * 2) = 1, ti = 1
    assert list(packed[2:]) == [2.0, 2.0, 2.0]


def _packed(it, si, swgt):
    si, swgt = np.atleast_1d(si), np.atleast_1d(swgt)
    return np.concatenate([[it, 0.0], si, swgt, np.zeros_like(si)])


EXPECTED = {
    # (packed after the first iteration, weights before it, left, epsrel,
    #  epsabs) -> iterations expected after it
    # sd = 1 at weight 1 a pass, epsrel 0.1 of 10: weight 1 suffices, but
    # none converges before iteration 5
    "floor at iteration 5": ((_packed(7, 10.0, 1.0), 0.0, 40, 0.1, 0.0), 1),
    "early": ((_packed(3, 10.0, 1.0), 0.0, 40, 0.1, 0.0), 3),
    # weight 100 needed at 1 an iteration: 99 more, capped at left
    "capped": ((_packed(7, 10.0, 1.0), 0.0, 40, 0.01, 0.0), 40),
    # tgral 2, sd target 0.2: weight 25 at 1 an iteration from 2
    "needs 23": ((_packed(7, 4.0, 2.0), 1.0, 60, 0.1, 0.0), 23),
    # epsabs met at once
    "epsabs": ((_packed(7, 10.0, 1.0), 0.0, 40, 1e-9, 2.0), 1),
    # the first iteration in the skip window: no reading, left
    "skip window": ((_packed(3, 0.0, 0.0), 0.0, 12, 0.1, 0.0), 12),
    # every component must pass: the second needs weight 100
    "vector": ((_packed(7, [10.0, 2.0], [1.0, 1.0]), np.zeros(2), 1000,
                0.05, 0.0), 99),
    "zero estimate": ((_packed(7, 0.0, 1.0), 0.0, 30, 0.1, 0.0), 30),
}


@pytest.mark.parametrize("case", list(EXPECTED))
def test_expected_iters_reads_the_carry(case):
    (packed, swgt0, left, epsrel, epsabs), want = EXPECTED[case]
    assert phases.expected_iters(packed, np.atleast_1d(swgt0), left,
                                 epsrel=epsrel, epsabs=epsabs) == want


def test_graph_pays_only_for_long_phases(monkeypatch):
    """A phase captures where allowed and GRAPH_MIN_ITERS iterations are
    expected, or as ``FORM`` pins it; never where a capture is refused."""
    def phase(capture):
        return phases.Phase(None, adjust=False, capture=capture, dv2g=1.0,
                            skip_iters=0, epsrel=0.01, epsabs=0.0)

    long_ = (_packed(7, 10.0, 1.0), np.zeros(1))    # 99 more expected
    short = (_packed(7, 1e3, 100.0), np.zeros(1))   # converged weight
    n = phases.GRAPH_MIN_ITERS
    assert phase(True).graph_pays(*long_, n)
    assert not phase(True).graph_pays(*long_, n - 1)
    assert not phase(True).graph_pays(*short, 50)
    assert not phase(False).graph_pays(*long_, 50)
    monkeypatch.setattr(phases, "FORM", "graph")
    assert phase(True).graph_pays(*short, 1)
    assert not phase(False).graph_pays(*short, 1)
    monkeypatch.setattr(phases, "FORM", "eager")
    assert not phase(True).graph_pays(*long_, 50)


def test_replays_count_the_launches_they_run(monkeypatch):
    """The launch counts a capture recorded, taken back and then added at
    each replay: what the bookkeeping of ``Phase._capture`` does."""
    from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
    cuda_vegas.reset_launches()
    cuda_lookup.reset_launches()
    before = phases._launch_counts()
    cuda_vegas.launches += 3
    cuda_vegas.route_launches["paired"] += 3
    cuda_lookup.hist_launches += 3
    after = phases._launch_counts()
    recorded = {k: after[k] - n for k, n in before.items() if after[k] != n}
    assert len(recorded) == 3
    phases._add_launches(recorded, -1)
    assert phases._launch_counts() == before
    phases._add_launches(recorded, 2)
    assert cuda_vegas.launches == cuda_lookup.hist_launches == 6
    assert cuda_vegas.route_launches == {"paired": 6, "wide": 0,
                                         "generic": 0}
    cuda_vegas.reset_launches()
    cuda_lookup.reset_launches()


# ---------------------------------------------------------------------------
# refine='device' (tests/test_vegas.py::TestDeviceRefine, on the port)

@pytest.mark.parametrize("importance", ["grid", "poly"])
def test_device_refine_converges_and_tracks_host(importance):
    kw = dict(epsrel=5e-3, ncall=5e4, total_iters=12, adjust_iters=8,
              seed=1, importance=importance, device="cpu")
    rh = mcubes.integrate(G3, refine="host", **kw)
    rd = mcubes.integrate(G3, refine="device", **kw)
    assert rd.status == 0
    assert abs(rd.estimate - G3.true_value) / G3.true_value < 2e-2
    assert abs(rd.estimate - G3.true_value) <= 5 * rd.errorest
    assert abs(rd.estimate - rh.estimate) < 5 * max(rd.errorest,
                                                    rh.errorest)


@pytest.mark.parametrize("importance", ["grid", "poly"])
def test_device_refine_is_deterministic(importance):
    g = genz.f4_gaussian(2, a=3.0)
    kw = dict(ncall=1e4, total_iters=6, adjust_iters=4, seed=42,
              refine="device", importance=importance, device="cpu")
    a, b = mcubes.integrate(g, **kw), mcubes.integrate(g, **kw)
    assert (a.estimate, a.errorest, a.chi_sq) == (b.estimate, b.errorest,
                                                  b.chi_sq)


def test_device_refine_early_convergence_counts_as_host():
    m = misc.addition(3)
    kw = dict(epsrel=5e-3, ncall=4e4, total_iters=10, adjust_iters=10,
              seed=11, device="cpu")
    rh = mcubes.integrate(m, refine="host", **kw)
    rd = mcubes.integrate(m, refine="device", **kw)
    assert rd.status == rh.status == 0
    assert (rd.iters, rd.neval) == (rh.iters, rh.neval)
    assert abs(rd.estimate - m.true_value) / m.true_value < 5e-3


def test_device_refine_vector_and_frozen_grid_handoff():
    """A vector adapts on component 0; the grid leaves the phase in f32
    cast to dtype, and a state resumed from it continues on the host."""
    kw = dict(ndim=3, epsrel=1e-9, epsabs=1e-300, ncall=2e4, total_iters=7,
              adjust_iters=4, seed=2, device="cpu")
    st = V.VegasState(xi=grid.uniform_grid(3, 64))
    r = mcubes.integrate(_vector, refine="device", nbins=64, state=st, **kw)
    assert r.estimates.shape == (2,) and r.iters == 7
    assert np.all(np.abs(r.estimates - [G3.true_value, 1.5])
                  <= 5 * r.errorests)
    assert st.xi.dtype == torch.float64
    assert torch.equal(st.xi, st.xi.to(torch.float32).to(torch.float64))
    assert (st.it0, st.n_acc) == (7, 7 - 5)


def test_device_refine_refusals():
    kw = dict(ncall=2e3, device="cpu", refine="device")
    with pytest.raises(ValueError, match="refine='host'"):
        mcubes.integrate(G3, debug_logger=VegasDebugLogger(), **kw)
    with pytest.raises(TypeError, match="fused"):
        mcubes.integrate(G3, fused=False, **kw)


def test_counter_checks_rehearse_on_the_cpu(monkeypatch):
    """mcubes/kernel_check's device-counter checks (run on the card by
    chip_smoke.py phase 5) on the plain versions: a counter tensor draws
    the words of its value, and a wrong word is caught."""
    from gpuintegration_torch.mcubes import kernel_check
    case = kernel_check.sampler_case(4, 1e4, 256, nbins=50, degree=8,
                                     position="end", device="cpu")
    for g in (None, genz.f4_gaussian(4)):
        for with_hist in (False, True):
            r = kernel_check.check_sampler_counter(case, g,
                                                   with_hist=with_hist)
            assert r == {"samples": 512, "equal": True}
    assert kernel_check.check_resolve_counter(4, 1e4, 256, 50,
                                              device="cpu")["equal"]
    # an instance reading the wrong word draws another iteration's stream
    words = stream.stream_bits

    def off_by_one(seed, it, *args):
        return words(seed, it + 1 if isinstance(it, torch.Tensor) else it,
                     *args)

    monkeypatch.setattr(stream, "stream_bits", off_by_one)
    with pytest.raises(AssertionError, match="device counter"):
        kernel_check.check_sampler_counter(case, None, with_hist=False)
