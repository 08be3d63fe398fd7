"""The VEGAS stream's counter layout (mcubes/stream.py, csrc/philox.cuh).

The counter of a draw is (cube low word, cube high word, iteration,
B * slot + d // 4), coordinate d of sample slot ``slot`` taking word d % 4,
with B = max(4, ceil(ndim / 4)) blocks a slot.  Up to 16D B is 4, the
layout the stream always had; from 17D a slot's blocks would otherwise run
into the next slot's and repeat its uniforms.

* no two (slot, coordinate) pairs of a cube share a counter and word, at
  every ndim up to 32;
* at 1..16D every word is the one of the layout 4 * slot + d // 4, written
  out here;
* B * npg >= 2^32 is refused by the stream and by the wrappers that draw
  from it;
* one grid-map iteration at 17D on f = x0 + x16: over 40 seeds the pulls
  (estimate - 1) / errorest have a variance near 1.  With the uniforms of
  coordinates 16.. repeating those of coordinates 0.. of the next sample,
  as they did, it was 3.19 (the error estimate 1.8 times too small);
* one 17D run of each package, Genz F4 (a = 5) on both maps at ncall
  2.7e5, 8 iterations: each estimate within 5 of its errorests of the
  closed form, the two errorests within a factor of 2 (the packages draw
  other streams, Threefry against Philox, so only the statistics meet);
* at 17D on the grid map, Genz F4 at a = 5 amplifies a 1-ulp change of
  1 % of its histograms' bins to 1e-6..1e-3 of the estimate, a = 3 not.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from gpuintegration_tpu.mcubes import vegas as JV
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas, stream
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.models import genz
from gpuintegration_torch.tools import pull_variance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the workers running side by side would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counters(monkeypatch, npg, ndim):
    """(npg * ndim,) the counter word times 4 plus the word index of each
    row slot * ndim + d of stream_bits, read by putting in place of the
    generator one that returns its counter."""
    def layout(c0, c1, c2, c3, k0, k1):
        return tuple(4 * c3 + j for j in range(4))
    monkeypatch.setattr(stream, "philox4x32", layout)
    rows = stream.stream_bits(1, 2, torch.arange(3), npg, ndim)
    assert (rows == rows[:, :1]).all()      # the same in every cube
    return rows[:, 0]


@pytest.mark.parametrize("ndim", [1, 3, 4, 9, 16, 17, 20, 24, 29, 32])
@pytest.mark.parametrize("npg", [1, 2, 7])
def test_each_slot_and_coordinate_has_its_own_counter(monkeypatch, ndim, npg):
    got = _counters(monkeypatch, npg, ndim)
    assert len(set(got.tolist())) == npg * ndim
    blocks = stream.slot_blocks(ndim)
    assert blocks == max(4, -(-ndim // 4))
    slot, d = np.divmod(np.arange(npg * ndim), ndim)
    np.testing.assert_array_equal(got.numpy(),
                                  4 * (blocks * slot + d // 4) + d % 4)


@pytest.mark.parametrize("ndim", [17, 20, 24, 32])
def test_no_two_rows_of_a_cube_repeat(ndim):
    """The words themselves: over 64 cubes no two rows (slot, coordinate)
    are equal, as they were from 17D when slot s's block 4 was slot
    s + 1's block 0."""
    bits = stream.stream_bits(7, 1, torch.arange(64), 3, ndim)
    assert len({tuple(r) for r in bits.tolist()}) == 3 * ndim


@pytest.mark.parametrize("ndim", range(1, 17))
def test_words_up_to_16d_are_the_first_layout(ndim):
    """At 1..16D every word is philox4x32 at counter word 4 slot + d // 4,
    word d % 4: the stream as it was before B grew past 4."""
    npg, seed, iteration = 3, 2 ** 40 + 9, 5
    cubes = 2 ** 32 - 2 + torch.arange(5)            # across 2^32
    got = stream.stream_bits(seed, iteration, cubes, npg, ndim)
    k0, k1 = stream.seed_key(seed)
    c0, c1 = cubes & stream.MASK32, cubes >> 32
    c2 = torch.full_like(cubes, iteration)
    for slot in range(npg):
        for d in range(ndim):
            block = stream.philox4x32(
                c0, c1, c2, torch.full_like(cubes, 4 * slot + d // 4), k0, k1)
            assert torch.equal(got[slot * ndim + d], block[d % 4])


@pytest.mark.parametrize("ndim,npg", [(16, 2 ** 30), (17, 858_993_460),
                                      (32, 2 ** 29)])
def test_counter_word_overflow_is_refused(ndim, npg):
    """B * npg >= 2^32 would wrap the counter word: the stream, the
    sampler and the bin resolve drawing xn refuse it (one cube, before a
    word is drawn); one slot fewer is taken."""
    blocks = stream.slot_blocks(ndim)
    assert blocks * npg >= 2 ** 32 > blocks * (npg - 1)
    assert stream.check_counter(npg - 1, ndim) == blocks
    with pytest.raises(ValueError, match="2\\^32"):
        stream.check_counter(npg, ndim)
    with pytest.raises(ValueError, match="2\\^32"):
        stream.stream_bits(0, 1, torch.arange(1), npg, ndim)
    pmap = cuda_vegas.fold_map(torch.zeros((ndim, 2)), torch.ones((ndim, 1)),
                               torch.zeros(ndim), torch.ones(ndim))
    with pytest.raises(ValueError, match="2\\^32"):
        cuda_vegas.sample_chunk(pmap, None, 1, npg, 1, 10, False, 1.0, 0, 1,
                                0, 1, emit_points=True)
    with pytest.raises(ValueError, match="2\\^32"):
        cuda_lookup.bin_resolve_stratified(torch.ones((ndim, 11)), 10, 1,
                                           npg, 1, 0, 1, 0, 1)


def test_17d_error_estimate_is_honest():
    """One grid-map iteration at 17D (ng 2, npg 2) of f = x0 + x16, truth
    1, over seeds 1..40: the pulls (estimate - 1) / errorest have a
    variance in [0.5, 1.7].  Coordinate 16 drawing coordinate 0's uniforms
    of the next sample made it 3.19 (tools/pull_variance.py)."""
    assert 0.5 <= pull_variance.pull_variance(17, 40) <= 1.7


@pytest.mark.parametrize("a,moved", [(3.0, (0.0, 1e-6)),
                                     (5.0, (1e-6, 1e-3))])
def test_17d_grid_map_amplifies_an_ulp_of_its_histogram(a, moved):
    """Genz F4 at 17D on the grid map (ncall 2.7e5, 6 iterations, 4
    adjusting, seed 5), once as it is and once with 1 % of the bins of
    every chunk's histogram one f32 ulp higher: at a = 3 the estimate
    moves by less than 1e-6 of itself; at a = 5, where the histograms'
    mass sits in a few bins, the refinement amplifies the ulp to 1e-6..1e-3
    of the estimate (within 0.1 of its errorest).  So two histogram
    routes that add in other orders part a = 5 runs by more than their
    rounding (tests/test_torch_cuda_vegas.py holds the card's so)."""
    g = genz.f4_gaussian(17, a=a)
    kw = dict(epsrel=1e-2, ncall=2.7e5, total_iters=6, adjust_iters=4,
              seed=5, importance="grid", device="cpu")
    base = V.integrate(g, **kw)
    accum, rng = cuda_lookup.hist_accum_plain, np.random.default_rng(0)

    def one_ulp_up(d, ia, f2, nbins, **kwargs):
        out = accum(d, ia, f2, nbins, **kwargs)
        up = torch.as_tensor(rng.random(tuple(out.shape)) < 0.01)
        return torch.where(up, torch.nextafter(out, torch.ones_like(out)),
                           out)
    with mock.patch.object(cuda_lookup, "hist_accum_plain", one_ulp_up):
        moved_run = V.integrate(g, **kw)
    rel = abs(moved_run.estimate / base.estimate - 1.0)
    assert moved[0] <= rel < moved[1]
    assert abs(moved_run.estimate - base.estimate) <= 0.1 * base.errorest


@pytest.mark.parametrize("importance", ["poly", "grid"])
def test_17d_runs_of_both_packages_agree(importance):
    """Genz F4 (a = 5) at 17D, ncall 2.7e5 (ng 2, npg 2), 8 iterations, 5
    adjusting, in each package on the CPU: each estimate within 5
    errorests of the closed form, the errorests within a factor of 2."""
    kw = dict(epsrel=1e-3, ncall=2.7e5, total_iters=8, adjust_iters=5,
              skip_iters=2, seed=3, importance=importance)
    ref = JV.vegas(jax_genz.f4_gaussian(17, a=5.0), ndim=17, **kw)
    g = genz.f4_gaussian(17, a=5.0)
    got = V.vegas(g, ndim=17, device="cpu", **kw)
    for r in (ref, got):
        assert abs(float(r.estimate) - g.true_value) <= 5 * float(r.errorest)
    ratio = got.errorest / float(ref.errorest)
    assert 0.5 <= ratio <= 2.0
