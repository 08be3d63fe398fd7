"""Suave (gpuintegration_torch/pagani/suave.py) on the CPU against the JAX
package's (gpuintegration_tpu/pagani/suave.py and its checks in
tests/test_workspace_features.py::TestSuave, test_vector_integrands.py and
test_cpu_oracle.py).

* One cycle given the same grids and uniforms (``jax.random.uniform``
  patched in the reference, run under ``jax.disable_jit()``): I, var, the
  fluctuations and the masses to roundoff.
* The host driver (convergence test, split choice, pool growth, grid and
  pool surgery, child seeding) given the same cycle outputs: the same
  lows, lengths and grids in every cycle, bit for bit.
* The reference's own checks run on the port, and port against reference
  statistically (the draws are the port's Philox stream, not Threefry).
* The draws' counter words: SUAVE, ASSISTED, FROZEN and the VEGAS
  sampler's ranges pairwise disjoint; ASSISTED's words unchanged.

The port runs with ``torch.set_flush_denormal(True)``, as XLA on the CPU
flushes subnormals."""
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.pagani import suave as JS
from gpuintegration_torch import diff
from gpuintegration_torch.mcubes import stream
from gpuintegration_torch.models import genz
from gpuintegration_torch.pagani import suave as TS
from gpuintegration_torch.pagani import vegas_assisted as TA
from gpuintegration_torch.utils.stats import chi2_prob

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _pool(ndim, cap, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(0.05, 0.5, (ndim, cap))
    lows = rng.random((ndim, cap)) * (1.0 - lengths)
    return lows, lengths


def _grids(cap, ndim, nbins, rng):
    g = np.sort(rng.random((cap, ndim, nbins + 1)), axis=-1).astype(
        np.float32)
    g[..., 0], g[..., -1] = 0.0, 1.0
    return g


def _cycle_both(ndim, cap, nnew, nbins, passes, seed, ncomp=1,
                lo=None, rng_=None):
    rng = np.random.default_rng(seed)
    lows, lengths = _pool(ndim, cap, seed)
    grids = _grids(cap, ndim, nbins, rng)
    uni = [rng.random((cap, nnew, ndim)).astype(np.float32)
           for _ in range(2 * passes)]
    glo = np.zeros(ndim) if lo is None else np.asarray(lo)
    grange = np.ones(ndim) if rng_ is None else np.asarray(rng_)
    g_j = jax_genz.f4_gaussian(ndim, a=5.0)
    g_t = genz.f4_gaussian(ndim, a=5.0)
    h_j = jax_genz.f1_oscillatory(ndim)
    h_t = genz.f1_oscillatory(ndim)
    if ncomp == 1:
        f_j, f_t = g_j, g_t
    else:
        def f_j(x):
            return jnp.stack([g_j(x), h_j(x)], axis=-1)

        def f_t(x):
            return torch.stack([g_t(x), h_t(x)], dim=-1)
    draws = iter([jnp.asarray(u) for u in uni])
    with jax.disable_jit(), mock.patch(
            "jax.random.uniform", side_effect=lambda *a, **k: next(draws)):
        ref = JS._suave_cycle(
            f_j, ndim, passes, nnew, nbins, "float64", 16.0,
            jax.random.PRNGKey(0), jnp.asarray(lows), jnp.asarray(lengths),
            jnp.asarray(grids), jnp.asarray(cap, jnp.int32),
            jnp.asarray(glo), jnp.asarray(grange), ncomp=ncomp)
    got = TS._suave_cycle(
        f_t, ndim, passes, nnew, nbins, torch.float64, 16.0,
        lambda i: (torch.as_tensor(uni[2 * i]),
                   torch.as_tensor(uni[2 * i + 1])),
        torch.as_tensor(lows), torch.as_tensor(lengths),
        torch.as_tensor(grids), torch.as_tensor(glo), torch.as_tensor(grange),
        ncomp=ncomp)
    return [np.asarray(a) for a in ref], [t.numpy() for t in got]


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("case", ["unit", "volume"])
def test_one_cycle_on_injected_uniforms(case, ncomp):
    """One pass: the same points, so I, var, flu and the masses agree to
    roundoff (read: <= 2e-15 relative)."""
    lo, rng_ = (None, None) if case == "unit" else ([0.1, -1.0, 0.5],
                                                     [0.8, 2.0, 1.5])
    ref, got = _cycle_both(3, 16, 128, 20, 1, 11, ncomp, lo, rng_)
    names = ["grids", "I", "var", "flu", "mass_lo", "mass", "mass_abs"]
    for name, r, g in zip(names, ref, got):
        assert g.shape == r.shape, name
        if name == "grids":
            # the f32 rebin on a histogram summed in another order: some
            # f32 ulps of an edge (as tests/test_torch_vegas_assisted.py)
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
        else:
            scale = np.abs(r).max()
            np.testing.assert_allclose(g, r, rtol=1e-12,
                                       atol=1e-13 * scale, err_msg=name)


def test_two_passes_chain_the_refined_grids():
    """Two passes: the second samples on the grids the first refined, which
    differ from the reference's by f32 ulps of an edge, so the second
    pass's points move by as much: the totals agree to 1e-4 relative of
    their scale, far inside a cycle's statistical error."""
    ref, got = _cycle_both(3, 16, 128, 20, 2, 12)
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_zero_region_floor():
    """A region where f is 0 everywhere: f64 reads flu 0 (the 1e-300
    floor); in f32 that floor is 0 in the reference, whose flu is NaN
    there (0/0), while the port floors at finfo(f32).tiny and reads 0.
    Both then split such a region along axis 0 (np.argmin of an all-NaN
    row is its first index)."""
    ndim, cap, nnew, nbins = 2, 4, 64, 8
    lows, lengths = _pool(ndim, cap, 3)
    rng = np.random.default_rng(3)
    grids = _grids(cap, ndim, nbins, rng)
    uni = [rng.random((cap, nnew, ndim)).astype(np.float32) for _ in "ab"]

    def zero_j(x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def zero_t(x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype)

    for dt_j, dt_t in (("float64", torch.float64),
                       ("float32", torch.float32)):
        draws = iter([jnp.asarray(u) for u in uni])
        with jax.disable_jit(), mock.patch(
                "jax.random.uniform", side_effect=lambda *a, **k: next(draws)):
            ref = JS._suave_cycle(
                zero_j, ndim, 1, nnew, nbins, dt_j, 16.0,
                jax.random.PRNGKey(0), jnp.asarray(lows, dt_j),
                jnp.asarray(lengths, dt_j), jnp.asarray(grids),
                jnp.asarray(cap, jnp.int32), jnp.zeros(ndim, dt_j),
                jnp.ones(ndim, dt_j))
        got = TS._suave_cycle(
            zero_t, ndim, 1, nnew, nbins, dt_t, 16.0,
            lambda i: (torch.as_tensor(uni[0]), torch.as_tensor(uni[1])),
            torch.as_tensor(lows, dtype=dt_t),
            torch.as_tensor(lengths, dtype=dt_t), torch.as_tensor(grids),
            torch.zeros(ndim, dtype=dt_t), torch.ones(ndim, dtype=dt_t))
        flu_ref, flu = np.asarray(ref[3]), got[3].numpy()
        assert np.all(flu == 0.0)
        if dt_t == torch.float64:
            assert np.all(flu_ref == 0.0)
        else:
            assert np.all(np.isnan(flu_ref))
        np.testing.assert_array_equal(np.argmin(flu, axis=1),
                                      np.argmin(flu_ref, axis=1))


def _fake_outputs(cycle, cap, ndim, nbins, ncomp):
    """Cycle outputs made from (cycle, cap) alone: grids refined by a
    fixed power, variances that keep most regions over budget."""
    rng = np.random.default_rng(100 + cycle)
    I = rng.normal(0.1, 0.05, (ncomp, cap))
    var = rng.uniform(1e-6, 1e-4, (ncomp, cap))
    var[:, ::5] = 1e-14
    flu = rng.random((cap, ndim))
    mass_lo = rng.normal(0.05, 0.05, (ncomp, cap, ndim))
    mass = rng.normal(0.1, 0.05, (ncomp, cap))
    mass[:, ::7] = 1e-6                        # cancellation: even split
    mass_abs = np.abs(mass) + rng.uniform(0.0, 0.2, (ncomp, cap))
    return I, var, flu, mass_lo, mass, mass_abs


@pytest.mark.parametrize("ncomp", [1, 2])
def test_driver_surgery_and_seeding_equal(ncomp):
    """The host driver given the same cycle outputs: every cycle's pool
    (lows, lengths) and grids EQUAL to the reference's, through pool
    growth (64 -> 128 -> 256) and the max_regions cap, and the result's
    estimate, errorest, neval and regions EQUAL."""
    ndim, nbins, cycles = 3, 16, 10
    seen = {"ref": [], "port": []}

    def refine(g):
        return (np.asarray(g, np.float32) ** np.float32(1.25)).astype(
            np.float32)

    def fake_j(f, ndim_, passes, nnew, nbins_, dtype_name, p, key, lows,
               lengths, grids, n, gl, gr, ncomp=1):
        # copies: on the CPU jnp.asarray may alias the driver's NumPy pool,
        # which the surgery then changes in place
        seen["ref"].append([np.array(lows), np.array(lengths),
                            np.array(grids)])
        cap = lows.shape[1]
        out = _fake_outputs(len(seen["ref"]), cap, ndim, nbins, ncomp)
        return (jnp.asarray(refine(grids)),) + tuple(jnp.asarray(a)
                                                     for a in out)

    def fake_t(f, ndim_, passes, nnew, nbins_, dtype, p, draw, lows, lengths,
               grids, gl, gr, ncomp=1):
        seen["port"].append([lows.numpy().copy(), lengths.numpy().copy(),
                             grids.numpy().copy()])
        cap = lows.shape[1]
        out = _fake_outputs(len(seen["port"]), cap, ndim, nbins, ncomp)
        return (torch.as_tensor(refine(grids.numpy())),) + tuple(
            torch.as_tensor(a) for a in out)

    def vec_j(x):
        return jnp.stack([x[..., 0]] * ncomp, -1) if ncomp > 1 else x[..., 0]

    def vec_t(x):
        return torch.stack([x[..., 0]] * ncomp, -1) if ncomp > 1 else x[..., 0]

    kw = dict(epsrel=1e-6, epsabs=1e-40, ndim=ndim, nnew=8, nbins=nbins,
              max_regions=200, max_cycles=cycles)
    with mock.patch.object(JS, "_suave_cycle", fake_j):
        ref = JS.suave(vec_j, **kw)
    with mock.patch.object(TS, "_suave_cycle", fake_t):
        got = TS.suave(vec_t, **kw, **CPU)
    assert len(seen["ref"]) == len(seen["port"]) == cycles
    caps = [s[0].shape[1] for s in seen["port"]]
    assert caps[0] == 64 and max(caps) == 200
    for c, (r, g) in enumerate(zip(seen["ref"], seen["port"])):
        for name, a, b in zip(("lows", "lengths", "grids"), r, g):
            assert a.shape == b.shape, (c, name)
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {c}")
    assert (got.estimate, got.errorest, got.neval, got.nregions, got.iters) \
        == (ref.estimate, ref.errorest, ref.neval, ref.nregions, ref.iters)
    assert (got.chi_sq, got.prob) == (ref.chi_sq, ref.prob)
    if ncomp > 1:
        np.testing.assert_array_equal(got.estimates, ref.estimates)
        np.testing.assert_array_equal(got.errorests, ref.errorests)


def test_initial_and_reset_grids_are_suaves_own():
    """f32 of NumPy's f64 linspace: the reference's initial grids
    (np.linspace(..., dtype=float32)) and its reset axis (f64 linspace
    stored into f32) alike; not uniform_grids' k f32(1/nbins)."""
    for nbins in (10, 64, 100):
        e = TS.uniform_edges(nbins).numpy()
        np.testing.assert_array_equal(
            e, np.linspace(0.0, 1.0, nbins + 1, dtype=np.float32))
        reset = np.zeros(nbins + 1, np.float32)
        reset[:] = np.linspace(0.0, 1.0, nbins + 1)
        np.testing.assert_array_equal(e, reset)
    assert not np.array_equal(TS.uniform_edges(10).numpy(),
                              TA.uniform_grids(1, 1, 10, "cpu")[0, 0].numpy())


# -- the reference's own checks, on the port --------------------------------

def test_converges_with_chi2_prob():
    g = genz.f4_gaussian(2, a=5.0)
    r = TS.suave(g, epsrel=5e-3, epsabs=1e-40, nnew=512, seed=2, **CPU)
    assert r.status == 0
    assert abs(r.estimate - g.true_value) < 5 * max(r.errorest, 1e-5)
    assert r.nregions > 1 and r.neval > 0 and r.iters > 0
    assert r.neval % (2 * 512 * 64) == 0     # nmin nnew, every slot
    assert 0.0 <= r.prob < 0.999
    if r.iters >= 2:
        assert r.prob == pytest.approx(
            chi2_prob(r.chi_sq * (r.iters - 0.9999), r.iters - 1), abs=1e-6)


def test_subdivision_beats_single_region():
    g = genz.f2_product_peak(3)
    r = TS.suave(g, epsrel=1e-3, epsabs=1e-40, nnew=1024, seed=3,
                 max_cycles=24, **CPU)
    rel = abs(r.estimate - g.true_value) / g.true_value
    assert rel < 1e-2
    assert abs(r.estimate - g.true_value) < 6 * r.errorest
    # one region, the same samples: far from the subdivided accuracy
    one = TS.suave(g, epsrel=1e-3, epsabs=1e-40, nnew=1024, seed=3,
                   max_cycles=r.iters, max_regions=1, **CPU)
    assert one.nregions == 1 and one.errorest > 3 * r.errorest


def test_split_targets_the_peaked_axis():
    def ridge(x0, x1):
        return 1.0 / (1e-3 + (x0 - 0.3) ** 2) + 0.0 * x1

    splits = []
    real = TS._split

    def spy(*args):
        out = real(*args)
        splits.extend(out[-1].tolist())
        return out

    with mock.patch.object(TS, "_split", spy):
        r = TS.suave(ridge, epsrel=1e-4, epsabs=1e-40, nnew=1024, seed=1,
                     max_cycles=12, **CPU)
    truth = (math.atan(0.7 / math.sqrt(1e-3))
             + math.atan(0.3 / math.sqrt(1e-3))) / 1e-3 ** 0.5
    assert abs(r.estimate - truth) / truth < 1e-2
    assert splits and np.mean(np.asarray(splits) == 0) > 0.75


def test_sign_changing_integrand():
    def f(x, y):
        return torch.sin(2 * math.pi * x) * (1.0 + 4.0 * (y - 0.5) ** 2)

    r = TS.suave(f, epsrel=1e30, epsabs=2e-4, nnew=1024, seed=4,
                 max_cycles=24, **CPU)
    assert abs(r.estimate) < 6 * max(r.errorest, 1e-5)


def test_vector_integrands():
    nd = 3
    g1, g2 = genz.f4_gaussian(nd, a=6.0), genz.f2_product_peak(nd)

    def fv(x):
        return torch.stack([g1(x), g2(x)], dim=-1)

    fv.ndim = nd
    r = TS.suave(fv, epsrel=5e-3, epsabs=1e-40, nnew=1024, nmin=2,
                 max_regions=512, seed=3, **CPU)
    assert r.estimates.shape == (2,) and r.errorests.shape == (2,)
    assert r.probs is not None
    truths = np.array([g1.true_value, g2.true_value])
    for k in range(2):
        band = 5 * max(r.errorests[k] / abs(truths[k]), 5e-3)
        assert abs(r.estimates[k] - truths[k]) / abs(truths[k]) < band
    rs = TS.suave(g1, epsrel=5e-3, epsabs=1e-40, nnew=1024, nmin=2,
                  max_regions=256, seed=3, **CPU)
    assert rs.estimates is None and np.isfinite(rs.estimate)


def test_same_seed_same_bits_and_card_required():
    g = genz.f4_gaussian(2, a=5.0)
    a = TS.suave(g, epsrel=1e-2, epsabs=1e-40, nnew=256, seed=7, **CPU)
    b = TS.suave(g, epsrel=1e-2, epsabs=1e-40, nnew=256, seed=7, **CPU)
    assert (a.estimate, a.errorest, a.neval) == (b.estimate, b.errorest,
                                                 b.neval)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.suave(g)


# -- port against reference, statistically -----------------------------------

A3 = 5.0


def _g3_jax(x, y, z):
    s = (x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2
    return jnp.exp(-A3 * A3 * s)


def _g3_torch(x, y, z):
    s = (x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2
    return torch.exp(-A3 * A3 * s)


STAT_CASES = {
    "F4 2D a=5": (lambda: jax_genz.f4_gaussian(2, a=5.0),
                  lambda: genz.f4_gaussian(2, a=5.0),
                  dict(epsrel=5e-3, nnew=512, seed=2)),
    "gauss 3D a=5": (lambda: _g3_jax, lambda: _g3_torch,
                     dict(epsrel=2e-3, nnew=512, seed=2)),
}


@pytest.mark.parametrize("case", list(STAT_CASES))
def test_port_against_reference_statistically(case):
    make_j, make_t, kw = STAT_CASES[case]
    ref = JS.suave(make_j(), epsabs=1e-40, **kw)
    got = TS.suave(make_t(), epsabs=1e-40, **kw, **CPU)
    assert ref.status == 0 and got.status == 0
    assert abs(got.estimate - ref.estimate) <= 3 * (got.errorest
                                                    + ref.errorest)
    if case.startswith("gauss"):
        truth = (math.sqrt(math.pi) / A3 * math.erf(A3 / 2)) ** 3
        assert abs(got.estimate - truth) <= 3 * got.errorest + 1e-12


# -- the draws' counter words -------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 32, 33, 64])
def test_stream_ranges_disjoint(ndim):
    """Fourth counter words: the VEGAS sampler's 4 slot + d / 4 (below 2^31
    for any npg below 2^29), ASSISTED's and SUAVE's [base, base + B
    max_passes) at this ndim, diff.FROZEN_STREAM's one word: pairwise
    disjoint; the module's copies of the bases are the streams' own."""
    assert TA.STREAM_BASES == (TA.ASSISTED_STREAM, TS.SUAVE_STREAM,
                               diff.FROZEN_STREAM)
    blocks = TA.pass_blocks(ndim)
    ranges = {
        "sampler": (0, 1 << 31),
        "assisted": (TA.ASSISTED_STREAM, TA.ASSISTED_STREAM + blocks
                     * TA.max_passes(ndim, TA.ASSISTED_STREAM)),
        "suave": (TS.SUAVE_STREAM, TS.SUAVE_STREAM + blocks
                  * TA.max_passes(ndim, TS.SUAVE_STREAM)),
        "frozen": (diff.FROZEN_STREAM, diff.FROZEN_STREAM + 1),
    }
    names = list(ranges)
    for i, a in enumerate(names):
        lo, hi = ranges[a]
        assert 0 <= lo < hi <= 1 << 32
        for b in names[i + 1:]:
            lo2, hi2 = ranges[b]
            assert hi <= lo2 or hi2 <= lo, (a, b)


def _philox_words(seed, ids, spp, it, word3):
    k0, k1 = stream.seed_key(seed)
    shape = (ids.numel(), spp)
    c0 = ids[:, None].expand(shape)
    c1 = torch.arange(spp, dtype=torch.int64)[None, :].expand(shape)
    c2 = torch.full(shape, it, dtype=torch.int64)
    c3 = torch.full(shape, word3, dtype=torch.int64)
    return stream.philox4x32(c0, c1, c2, c3, k0, k1)


@pytest.mark.parametrize("ndim", [1, 2, 3, 5])
def test_assisted_words_unchanged_and_suave_stream(ndim):
    """``region_draws`` keeps ASSISTED's words by default (the counter
    (id, slot, iteration, ASSISTED_STREAM + 16 pass + block), written out
    here word for word), and with ``stream_base=SUAVE_STREAM`` draws
    Suave's own, different words."""
    ids = torch.arange(5, dtype=torch.int64) * 3 + 1
    spp, it, p = 7, 4, 2
    u_bin, u_pos = TA.region_draws(9, it, p, ids, spp, ndim)
    words = []
    for b in range(-(-2 * ndim // 4)):
        words.extend(_philox_words(9, ids, spp, it,
                                   TA.ASSISTED_STREAM + 16 * p + b)[
            :min(4, 2 * ndim - 4 * b)])
    want = stream.bits_to_uniform(torch.stack(words, dim=-1))
    assert torch.equal(torch.cat([u_bin, u_pos], dim=-1), want)
    s_bin, s_pos = TA.region_draws(9, it, p, ids, spp, ndim,
                                   stream_base=TS.SUAVE_STREAM)
    w0 = _philox_words(9, ids, spp, it, TS.SUAVE_STREAM + 16 * p)[0]
    assert torch.equal(s_bin[..., 0], stream.bits_to_uniform(w0))
    assert not torch.equal(s_bin, u_bin)


@pytest.mark.parametrize("base", [TA.ASSISTED_STREAM, TS.SUAVE_STREAM])
@pytest.mark.parametrize("ndim", [33, 64])
def test_region_draws_refuses_overlapping_blocks(ndim, base):
    """Past 32 dimensions a pass's 2 ndim uniforms fill more than 16
    blocks, and a pass owns B = ceil(2 ndim / 4) of them: its draws are the
    words base + B p + b, written out here, pass p's last word below pass
    p + 1's first; the last pass whose words stay below the next stream's
    base draws, the next one raises."""
    blocks = TA.pass_blocks(ndim)
    used = -(-2 * ndim // 4)
    assert blocks == used > 16
    ids = torch.arange(3, dtype=torch.int64) * 5 + 2
    spp, it = 3, 6
    last = TA.max_passes(ndim, base) - 1
    for p in (0, 1, 7, last):
        first_word = base + blocks * p
        assert first_word + used - 1 < base + blocks * (p + 1)
        u_bin, u_pos = TA.region_draws(5, it, p, ids, spp, ndim,
                                       stream_base=base)
        words = []
        for b in range(used):
            words.extend(_philox_words(5, ids, spp, it, first_word + b)[
                :min(4, 2 * ndim - 4 * b)])
        want = stream.bits_to_uniform(torch.stack(words, dim=-1))
        assert torch.equal(torch.cat([u_bin, u_pos], dim=-1), want)
    assert base + blocks * (last + 1) <= TA.stream_limit(base)
    assert base + blocks * (last + 2) > TA.stream_limit(base)
    with pytest.raises(ValueError, match="overlap the next stream"):
        TA.region_draws(5, it, last + 1, ids, spp, ndim, stream_base=base)


@pytest.mark.parametrize("ndim", range(1, 33))
def test_region_draws_keep_the_words_up_to_32d(ndim):
    """Up to 32D a pass owns 16 blocks, as before the blocks grew with
    ndim: the draws are the words base + 16 pass + block, written out
    here, bit for bit, on both streams and at the 4096 passes the draws
    took before (the last one 4095)."""
    assert TA.pass_blocks(ndim) == 16
    ids = torch.arange(2, dtype=torch.int64) * 7 + 1
    spp, it = 2, 3
    for base in (TA.ASSISTED_STREAM, TS.SUAVE_STREAM):
        for p in (0, 5, 4095):
            got = torch.cat(TA.region_draws(9, it, p, ids, spp, ndim,
                                            stream_base=base), dim=-1)
            words = []
            for b in range(-(-2 * ndim // 4)):
                words.extend(_philox_words(9, ids, spp, it,
                                           base + 16 * p + b)[
                    :min(4, 2 * ndim - 4 * b)])
            assert torch.equal(got, stream.bits_to_uniform(
                torch.stack(words, dim=-1)))


def test_suave_past_32d_against_reference():
    """33D Genz F4 (a = 1) at 1e-2, nnew 256, 3 cycles: the reference runs
    there and so does the port now (its draws took at most 32D).  Their
    draws differ (Philox against Threefry), so the estimates are held to
    each other statistically: within 3 of their errorests together; both
    end where the reference does, at the cycle budget."""
    kw = dict(nnew=256, max_cycles=3)
    ref = JS.suave(jax_genz.f4_gaussian(33, a=1.0), 1e-2, **kw)
    got = TS.suave(genz.f4_gaussian(33, a=1.0), 1e-2, **kw, **CPU)
    assert ref.status == got.status == 1 and got.iters == ref.iters == 3
    assert np.isfinite(got.estimate) and got.errorest > 0
    assert abs(got.estimate - ref.estimate) <= 3 * (got.errorest
                                                    + ref.errorest)
