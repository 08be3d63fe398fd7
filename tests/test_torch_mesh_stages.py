"""The mesh's shard-local stages (``gpuintegration_torch.parallel``) against
the JAX package's ``parallel/sharded.py`` at the same D, and a mesh of one
rank against one device, on the CPU under gloo.

The JAX side runs as ``tests/test_sharded.py`` runs it (``make_mesh(D)`` on
the conftest's 8 virtual CPU devices); the port runs in D spawned gloo ranks
(``parallel.launch.run_on_ranks``, the rank side in
``tools/mesh_cases.py``), once a module, while the parent runs the
reference.  Pools, counts, active flags and split axes after the deal,
compaction and split are held EQUAL (``convert.shards_from_reference`` and
its inverse); rule sums and the all-reduced scalars to reassociation
roundoff: |got - ref| <= 1e-12 |ref| + 1e-13 of the region's volume times
max |f|, the reading of ``test_torch_rule_eval.py`` (a sum over the pool
at its total volume, 1).  D = 3 deals 256
regions unevenly (86, 85, 85).  Also: the refusals, and a rank that raises
or hangs failing ``run_on_ranks`` within its timeout."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.integrand import make_integrand as jax_make_integrand
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.pagani import region_pool as jax_region_pool
from gpuintegration_tpu.parallel import sharded as jax_sharded
from gpuintegration_tpu.parallel.mesh import (make_mesh, pool_sharding,
                                              region_sharding)
from gpuintegration_torch import Workspace, convert, mcubes
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.parallel import mesh as pmesh
from gpuintegration_torch.parallel.launch import run_on_ranks
from gpuintegration_torch.tools import mesh_cases

NDIM = 4
PARTS = 4              # 256 initial regions
CHUNK = 256
EPSREL = 1e-8          # the second sweep finishes some regions, not all
F3 = ("genz", "f3_corner_peak", NDIM, {})
G3 = ("genz", "f4_gaussian", 3, {"a": 5.0})
VEGAS_KW = dict(epsrel=1e-4, ncall=8192.0, total_iters=8, adjust_iters=4,
                seed=3, chunk_cubes=64)
# D = 1 against one device: the host loop, the fused phase, a vector, VEGAS
SINGLE = {
    "host": dict(what="pagani", integrand=G3, ndim=3,
                 ws=dict(chunk_size=CHUNK),
                 kw=dict(epsrel=1e-6, epsabs=1e-40, fused=False),
                 checkpoint=True),
    "fused": dict(what="pagani", integrand=("genz", "f3_corner_peak", 3, {}),
                  ndim=3, ws=dict(chunk_size=CHUNK),
                  kw=dict(epsrel=1e-8, epsabs=1e-40)),
    "vector": dict(what="pagani",
                   integrand=("vector", [G3, ("genz", "f1_oscillatory", 3,
                                              {})]),
                   ndim=3, ws=dict(chunk_size=CHUNK),
                   kw=dict(epsrel=1e-6, epsabs=1e-40)),
    "vegas": dict(what="vegas", integrand=G3, kw=dict(VEGAS_KW)),
    "vegas_device": dict(what="vegas", integrand=G3,
                         kw=dict(VEGAS_KW, refine="device")),
}
for _case in SINGLE.values():
    _case["single"] = True


def _dealt_pool(d):
    """The reference's initial mesh pool (``_integrate_mesh``'s deal):
    global (ndim, D cap_s) arrays, shard k's regions first in its block,
    the padding region 0; and the (D,) counts."""
    lows, lengths, n = jax_region_pool.uniform_split(NDIM, PARTS,
                                                     PARTS ** NDIM)
    lows, lengths = np.asarray(lows), np.asarray(lengths)
    counts = pmesh.deal(n, d)
    cap_s = max(region_pool.next_pow2(max(counts)), CHUNK)
    glo = np.repeat(lows[:, :1], d * cap_s, axis=1)
    gln = np.repeat(lengths[:, :1], d * cap_s, axis=1)
    start = 0
    for k, c in enumerate(counts):
        glo[:, k * cap_s:k * cap_s + c] = lows[:, start:start + c]
        gln[:, k * cap_s:k * cap_s + c] = lengths[:, start:start + c]
        start += c
    return glo, gln, np.asarray(counts, np.int64)


def _reference_stages(d, pool):
    """The JAX package's stages in ``mesh_cases.run_stages``' order."""
    mesh = make_mesh(d)
    psh, vsh = pool_sharding(mesh), region_sharding(mesh)
    f, _ = jax_make_integrand(jax_genz.f3_corner_peak(NDIM), NDIM)
    lows = jax.device_put(jnp.asarray(pool[0]), psh)
    lengths = jax.device_put(jnp.asarray(pool[1]), psh)
    ns = jax.device_put(jnp.asarray(pool[2], jnp.int32), vsh)
    cap_s = pool[0].shape[1] // d
    gl, gr = jnp.zeros(NDIM), jnp.ones(NDIM)
    eps = jnp.asarray(EPSREL)
    yes, no = jnp.asarray(True), jnp.asarray(False)

    def child_cap(ns_act):
        return max(region_pool.next_pow2(2 * int(np.max(ns_act))), CHUNK)

    def host(*a):
        return tuple(np.asarray(x) for x in a)

    out = {}
    est, err, sd = jax_sharded.sharded_eval_stage(
        f, NDIM, "float64", mesh, lows, lengths, gl, gr, ns=ns)
    out["eval1"] = host(est, err, sd)
    e1, r1, a1, m1, na1, s1 = jax_sharded.sharded_post_stage(
        True, False, mesh, est, err, ns, jnp.zeros(d * cap_s), no, eps)
    out["post1"] = host(e1, r1, a1, m1, na1, s1)
    out["reductions"] = np.asarray(
        jax_sharded.sharded_reductions(mesh, e1, r1, a1))
    ns2, lo2, ln2, par, perr = jax_sharded.sharded_compact_split(
        mesh, child_cap(np.asarray(na1)), a1, lows, lengths, sd, e1, r1)
    out["split1"] = host(ns2, lo2, ln2, par, perr)
    est2, err2, sd2, fr2 = jax_sharded.sharded_eval_stage(
        f, NDIM, "float64", mesh, lo2, ln2, gl, gr, ns=ns2, blocked=True,
        with_split_frac=True)
    out["eval2"] = host(est2, err2, sd2, fr2)
    e2, r2, a2, m2, na2, s2 = jax_sharded.sharded_post_stage(
        True, True, mesh, est2, err2, ns2, par, yes, eps)
    out["post2"] = host(e2, r2, a2, m2, na2, s2)
    out["split2"] = host(*jax_sharded.sharded_compact_split(
        mesh, child_cap(np.asarray(na2)), a2, lo2, ln2, sd2, e2, r2,
        extra=fr2))
    out["split_only"] = host(*jax_sharded.sharded_split(
        mesh, 2 * cap_s, lows, lengths, sd, ns))
    ev = jax.device_put(jnp.stack([est2, 2 * est2]), psh)
    rv = jax.device_put(jnp.stack([err2, 3 * err2]), psh)
    pv = jax.device_put(jnp.stack([par, 2 * par]), psh)
    out["post_vector"] = host(*jax_sharded.sharded_post_stage_vector(
        True, True, mesh, 2, ev, rv, ns2, pv, yes, eps))
    return out


@pytest.fixture(scope="module")
def stages():
    """{D: (the reference's stages, the ranks' stage outputs)} for D = 2,
    3; the ranks run while the parent runs the reference."""
    out = {}
    with ThreadPoolExecutor(2) as ex:
        futures = {}
        for d in (2, 3):
            pool = _dealt_pool(d)
            case = dict(what="stages", integrand=F3, ndim=NDIM,
                        epsrel=EPSREL, chunk=CHUNK, pool=pool)
            futures[d] = (pool, ex.submit(run_on_ranks, mesh_cases.run_cases,
                                          d, args=({"s": case},),
                                          timeout=300))
        for d, (pool, fut) in futures.items():
            ref = _reference_stages(d, pool)
            out[d] = (ref, [r["s"]["stages"] for r in fut.result()], pool)
    return out


@pytest.fixture(scope="module")
def single():
    """One rank's mesh runs and the same calls without a mesh."""
    return run_on_ranks(mesh_cases.run_cases, 1, args=(SINGLE,),
                        timeout=300)[0]


def _cat(ranks, key, i):
    """Output ``i`` of stage ``key`` over the ranks, on the reference's
    global layout (the region axis last)."""
    return np.concatenate([r[key][i] for r in ranks], axis=-1)


def _real(ns, cap_s):
    """The real slots of a blocked (post-split) global pool of per-shard
    capacity ``cap_s``: the first n_k / 2 of each static half of shard k
    (the padding slots' contents are the compaction's own: the reference's
    shift passes leave other regions there than the port's slot 0)."""
    return np.concatenate([region_pool.block_mask(cap_s, int(n), True)
                           .numpy() for n in ns])


def _mag(lows_global, lengths_global):
    # F3's largest value, at the origin, (1 + sum c)^-(n + 1) <= 1 there:
    # the region's volume bounds the scale of its rule sums
    return np.prod(lengths_global, axis=0)


def _close(got, ref, mag, where):
    bound = 1e-12 * np.abs(ref) + 1e-13 * mag
    bad = where & ~(np.abs(got - ref) <= bound)
    assert not bad.any(), (got[bad][:5], ref[bad][:5])


def _scalars_close(got, ref):
    """Sums of rule outputs: the same reading, at the pool's total volume
    (at most the unit cube's, 1); the count exact."""
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=1e-12, atol=1e-13)
    assert got[-1] == ref[-1]


@pytest.mark.parametrize("d", [2, 3])
def test_first_sweep_matches_reference(stages, d):
    ref, ranks, pool = stages[d]
    real = _cat(ranks, "post1", 3).astype(bool)
    np.testing.assert_array_equal(real, ref["post1"][3])
    mag = _mag(*pool[:2])
    for i in (0, 1):
        _close(_cat(ranks, "eval1", i), ref["eval1"][i], mag, real)
    np.testing.assert_array_equal(_cat(ranks, "eval1", 2)[real],
                                  ref["eval1"][2][real])
    for i in (0, 1):
        _close(_cat(ranks, "post1", i), ref["post1"][i], mag, real)
    np.testing.assert_array_equal(_cat(ranks, "post1", 2), ref["post1"][2])
    assert [r["post1"][4] for r in ranks] == list(ref["post1"][4])
    for r in ranks:    # every rank holds the same global scalars
        _scalars_close(r["post1"][5], ref["post1"][5])
        _scalars_close(r["reductions"], ref["reductions"])
        np.testing.assert_array_equal(r["post1"][5], ranks[0]["post1"][5])


@pytest.mark.parametrize("d", [2, 3])
def test_compaction_and_split_equal_reference(stages, d):
    """The pools after each compaction and split, and the counts, EQUAL
    the reference's: the port's shards read through
    ``convert.shards_to_reference``."""
    ref, ranks, _ = stages[d]
    for key in ("split1", "split2", "split_only"):
        shards = [(torch.as_tensor(r[key][1]), torch.as_tensor(r[key][2]),
                   r[key][0]) for r in ranks]
        lows, lengths, ns = convert.shards_to_reference(shards)
        np.testing.assert_array_equal(ns, ref[key][0])
        real = _real(ns, lows.shape[1] // d)
        assert real.sum() == ns.sum() > 0
        np.testing.assert_array_equal(lows[:, real], ref[key][1][:, real])
        np.testing.assert_array_equal(lengths[:, real],
                                      ref[key][2][:, real])
        # and back: the reference's global pool as the ranks' shards
        back = convert.shards_from_reference(ref[key][1], ref[key][2],
                                             ref[key][0], d)
        for (lo, ln, n), r, m in zip(back, ranks, np.split(real, d)):
            assert n == r[key][0]
            np.testing.assert_array_equal(lo.numpy()[:, m], r[key][1][:, m])
            np.testing.assert_array_equal(ln.numpy()[:, m], r[key][2][:, m])


@pytest.mark.parametrize("d", [2, 3])
def test_second_sweep_matches_reference(stages, d):
    """The blocked sweep with parents: rule sums, split axes and cut
    fractions, the post stage's flags and counts, the vector post stage."""
    ref, ranks, _ = stages[d]
    lows = np.concatenate([r["split1"][1] for r in ranks], axis=-1)
    lengths = np.concatenate([r["split1"][2] for r in ranks], axis=-1)
    real = _cat(ranks, "post2", 3).astype(bool)
    np.testing.assert_array_equal(real, ref["post2"][3])
    mag = _mag(lows, lengths)
    for i in (0, 1):
        _close(_cat(ranks, "eval2", i), ref["eval2"][i], mag, real)
    for i in (2, 3):
        np.testing.assert_array_equal(_cat(ranks, "eval2", i)[real],
                                      ref["eval2"][i][real])
    for i in (0, 1):
        _close(_cat(ranks, "post2", i), ref["post2"][i], mag, real)
    np.testing.assert_array_equal(_cat(ranks, "post2", 2), ref["post2"][2])
    assert [r["post2"][4] for r in ranks] == list(ref["post2"][4])
    # the survivors' estimates and errors, compacted into the first n / 2
    # slots of each shard's parents
    half = ref["split2"][3].shape[-1] // d
    kept = np.concatenate([np.arange(half) < n // 2
                           for n in ref["split2"][0]])
    for i in (3, 4):
        _close(_cat(ranks, "split2", i), ref["split2"][i], np.max(mag), kept)
    vec = ref["post_vector"]
    real_v = _cat(ranks, "post_vector", 3).astype(bool)
    for i in (0, 1):
        for c, scale in ((0, 1.0), (1, 3.0)):
            _close(_cat(ranks, "post_vector", i)[c], vec[i][c],
                   scale * mag, real_v)
    np.testing.assert_array_equal(_cat(ranks, "post_vector", 2), vec[2])
    assert [r["post_vector"][4] for r in ranks] == list(vec[4])
    for r in ranks:
        _scalars_close(r["post2"][5], ref["post2"][5])
        _scalars_close(r["post_vector"][5], vec[5])


@pytest.mark.parametrize("name", list(SINGLE))
def test_one_rank_mesh_is_one_device(single, name):
    """A mesh of one rank gives the single-device run's bits: PAGANI's host
    loop (and its checkpoint), the fused phase, a vector, VEGAS."""
    got, one = single[name], single[name + "/single"]
    for k, v in one["result"].items():
        np.testing.assert_array_equal(np.asarray(got["result"][k]),
                                      np.asarray(v), err_msg=k)
    if "checkpoint" in one:
        for k, v in one["checkpoint"].items():
            np.testing.assert_array_equal(np.asarray(got["checkpoint"][k]),
                                          np.asarray(v), err_msg=k)
    assert got["result"]["status"] in (0, 1)
    if name == "fused":
        assert got["fused_stats"]["bursts"] > 0


def test_refusals():
    """``mesh=`` takes a DeviceMesh only; on a mesh ``vegas_assisted`` and
    ``predict_split`` raise the reference's ValueError, and a ``device``
    other than the rank's raises."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Workspace(3, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcubes.integrate(jax_genz, device="cpu", mesh="r")
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(device_type="cpu")
    out = run_on_ranks(mesh_cases.refusals, 2, timeout=120)
    for r in out:
        for option in ("vegas_assisted", "predict_split"):
            assert r[option] == (
                "ValueError", "mesh mode does not support vegas_assisted/"
                "predict_split; run them single-chip")
        assert r["device"][0] == "ValueError"
    assert pmesh.deal(256, 3) == [86, 85, 85]


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_failing_rank_fails_the_launch(mode):
    """A rank that raises fails ``run_on_ranks`` with its traceback while
    the other rank waits in a collective; one that hangs fails it at the
    timeout.  Neither hangs the caller."""
    err = RuntimeError if mode == "raise" else TimeoutError
    match = "fails on purpose" if mode == "raise" else "not done within"
    with pytest.raises(err, match=match):
        run_on_ranks(mesh_cases.fail_on_rank, 2, args=(1, mode), timeout=10)
