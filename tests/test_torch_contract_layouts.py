"""The host side of the split route's contraction on the CPU
(``ops/cuda_rule.py``: ``contract_route``, ``cluster_plan``,
``cluster_partition``; the kernels are csrc/rule_split.cu and run on the
card only, tests/test_torch_cuda_split.py).

* Which route the values' layout takes, at every dimension's Workspace
  chunk, for rows, planes, odd counts and other strides.
* The cluster route's partition (rank, stage, warp -> points) covers each
  point of each orbit exactly once, and the kernel's 16-byte copies cover
  each segment whatever its address.
* A torch emulation of the cluster route's summation order (running sums
  per warp and orbit, then warps in order, then ranks in order) against
  ``rule_eval.rule_outputs`` within ``kernel_check``'s limits, split_dim
  EQUAL; and, at one case, against the JAX package's ``rule_eval`` on the
  same numpy-made values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import misc
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval

DTYPES = [torch.float64, torch.float32]


def _chunk(ndim, dtype):
    return Workspace(ndim, dtype=dtype, device="cpu").chunk_size


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", range(2, 17))
def test_contract_route_by_layout(ndim, dtype):
    """At the Workspace's chunk, and at odd counts: values as rows (a
    reduction over the axes) take the cluster route at every ndim; as
    planes (a per-axis callable) where a region has CLUSTER_PLANES_FEVAL
    points or more; at other strides the generic route.  The address does
    not enter; the plan fills the launch to CLUSTER_CTAS CTAs in clusters
    of at most 8, each rank with a stage."""
    feval = rule_eval.rule_tables(ndim).feval
    for count in (_chunk(ndim, dtype), _chunk(ndim, dtype) - 1, 33, 2):
        route = cuda_rule.contract_route
        assert route(dtype, ndim, count, feval, (feval, 1)) == "cluster"
        assert route(dtype, ndim, count, feval, (feval + 3, 1)) == "cluster"
        planes = "cluster" if feval >= cuda_rule.CLUSTER_PLANES_FEVAL \
            else "generic"
        assert route(dtype, ndim, count, feval, (1, count)) == planes
        for strides in ((2 * feval, 2), (2, 2 * count), (feval, 3)):
            assert route(dtype, ndim, count, feval, strides) == "generic"
            assert not cuda_rule.cluster_takes(dtype, ndim, count, feval,
                                               strides)
        assert cuda_rule.cluster_takes(dtype, ndim, count, feval, (1, count))
        k, points, stages, ring = cuda_rule.cluster_plan(dtype, ndim, count,
                                                         feval)
        groups = -(-count // cuda_rule.CLUSTER_GROUP)
        assert 1 <= k <= min(cuda_rule.MAX_CLUSTER, stages)
        assert k == min(cuda_rule.MAX_CLUSTER, stages,
                        -(-cuda_rule.CLUSTER_CTAS // groups))
        item = torch.finfo(dtype).bits // 8
        assert points * cuda_rule.CLUSTER_GROUP * item == \
            cuda_rule.CLUSTER_STAGE_BYTES and points % (16 // item) == 0
        assert stages == -(-(feval - 4 * ndim - 1) // points) and ring >= 2
    assert cuda_rule.contract_route(dtype, ndim, 1, feval, (feval, 1)) == \
        "cluster"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", range(2, 17))
def test_cluster_partition_covers_each_point_once(ndim, dtype):
    """Each point of each orbit is summed by exactly one (rank, stage,
    warp); the head (points 0..4n, orbits 0-2) by the leader; each rank's
    stages are contiguous and in order; a warp's points ascend."""
    tables = rule_eval.rule_tables(ndim)
    count = _chunk(ndim, dtype)
    k, points, stages, _ = cuda_rule.cluster_plan(dtype, ndim, count,
                                                  tables.feval)
    parts = cuda_rule.cluster_partition(dtype, ndim, count, tables.feval)
    seen = np.zeros(tables.feval, dtype=np.int64)
    for rank, stage, warp, pts in parts:
        seen[pts] += 1
        assert 0 <= warp < cuda_rule.CLUSTER_WARPS and 0 <= rank < k
        assert np.all(np.diff(pts) == cuda_rule.CLUSTER_WARPS)
        if stage < 0:
            assert rank == 0 and np.all(pts < 4 * ndim + 1)
        else:
            lo = 4 * ndim + 1 + stage * points
            assert np.all((pts >= lo) & (pts < lo + points))
            assert rank * stages // k <= stage < (rank + 1) * stages // k
    np.testing.assert_array_equal(seen, np.ones(tables.feval, np.int64))
    assert tables.orbit_bounds[3] == 4 * ndim + 1
    # every rank has a stage; the ranks' stages, in rank order, are 0..T-1
    order = [s for _, s, w, _ in parts if s >= 0 and w == 0]
    assert order == list(range(stages))
    assert {r for r, s, _, _ in parts if s >= 0} == set(range(k))


@pytest.mark.parametrize("item", [8, 4])
def test_segment_copies_cover_any_address(item):
    """The kernel copies a segment of ``len`` values from element g of
    values at an address a in whole 16-byte units: from a + g - off (off =
    (a / item + g) mod 16 / item) for round_up((off + len) item, 16)
    bytes.  The copy starts and ends on 16-byte boundaries, holds the
    segment at ``off``, and reaches less than 16 bytes past either end (so
    never into another page)."""
    slack = 16 // item
    rng = np.random.default_rng(item)
    for _ in range(2000):
        addr = 256 * int(rng.integers(1, 1 << 20)) + item * int(
            rng.integers(0, slack))
        g, n = int(rng.integers(0, 1 << 24)), int(rng.integers(1, 300))
        off = (addr // item + g) % slack
        start = addr + (g - off) * item
        nbytes = -(-(off + n) * item // 16) * 16
        assert start % 16 == 0 and nbytes % 16 == 0
        assert start + off * item == addr + g * item
        assert start + nbytes >= addr + (g + n) * item
        assert start + nbytes - (addr + (g + n) * item) < 16 and off < slack


def cluster_order_sums(vals: torch.Tensor, tables, count: int):
    """The orbit sums (C, 9) of ``vals`` (C, feval) in the cluster route's
    order for a launch over ``count`` regions: each warp's points of an
    orbit in ascending order from 0 (``cluster_partition``), the warps'
    sums added in warp order, the ranks' in rank order.  Sequential sums in
    the values' own type, as numpy's ``add.accumulate`` takes them."""
    dtype = vals.dtype
    v = vals.numpy()
    ob = np.asarray(tables.orbit_bounds)
    parts = cuda_rule.cluster_partition(dtype, tables.ndim, count,
                                        tables.feval)
    k = 1 + max(r for r, _, _, _ in parts)
    runs = {}
    for rank, _, warp, pts in parts:
        runs.setdefault((rank, warp), []).append(pts)
    zero = np.zeros(v.shape[0], dtype=v.dtype)
    out = np.zeros((v.shape[0], 9), dtype=v.dtype)
    for s in range(9):
        rank_sum = None
        for rank in range(k):
            warp_sum = None
            for warp in range(cuda_rule.CLUSTER_WARPS):
                pts = np.concatenate(runs.get((rank, warp), [np.zeros(0, int)]))
                pts = pts[(pts >= ob[s]) & (pts < ob[s + 1])]
                run = np.concatenate([zero[:, None], v[:, pts]], axis=1)
                acc = np.add.accumulate(run, axis=1)[:, -1]
                warp_sum = acc if warp_sum is None else warp_sum + acc
            rank_sum = warp_sum if rank_sum is None else rank_sum + warp_sum
        out[:, s] = rank_sum
    return torch.as_tensor(out)


def _pool(ndim, c, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype) for a in (
        rng.uniform(0.0, 0.5, (ndim, c)), rng.uniform(0.01, 0.5, (ndim, c)),
        np.zeros(ndim), rng.uniform(0.5, 1.5, ndim))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", [8, 12, 16])
def test_cluster_order_matches_rule_outputs(ndim, dtype):
    """sin(sum x) on a few regions: est/err from the cluster route's
    summation order (at the partition of the Workspace's chunk) against
    rule_eval.rule_outputs within kernel_check's limits, split_dim EQUAL."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths, gl, gr = _pool(ndim, 3, dtype, ndim)
    g = misc.sin_sum(ndim)
    vals, u = kernel_check.value_scales(g, tables, lows, lengths, gl, gr)
    plain = rule_eval.rule_outputs(vals, tables, lengths, gr)
    by_orbit = cluster_order_sums(vals, tables, _chunk(ndim, dtype))
    ordered = rule_eval.rule_outputs(vals, tables, lengths, gr, by_orbit)
    r = kernel_check.judge(kernel_check.region_readings(
        ordered, plain, vals, u, tables, lengths, gr), name="sin_sum",
        dtype=dtype)
    assert r["regions"] == 3 and r["mismatches"] == 0
    assert torch.equal(ordered[2], plain[2])


def test_cluster_order_matches_jax_rule_eval(flush_denormal):
    """8D f64, values on the grid k/8 made with numpy (every orbit sum
    exact in any order) handed to the JAX package's rule_eval.apply_rule
    as the integrand's values: the cluster route's order gives its
    estimates and errors within kernel_check's limits (scales from
    |values|), its split axes EQUAL."""
    ndim, c = 8, 5
    tables = rule_eval.rule_tables(ndim)
    lows, lengths, gl, gr = _pool(ndim, c, torch.float64, 1)
    rng = np.random.default_rng(2)
    v = rng.integers(4, 12, (c, tables.feval)) / 8.0
    ref = jax_rule_eval.apply_rule(
        lambda x: jnp.asarray(v), jax_rule_eval.rule_tables(ndim, "float64"),
        *(jnp.asarray(t.numpy()) for t in (lows, lengths, gl, gr)))
    ref = [torch.as_tensor(np.array(o)) for o in ref]
    vals = torch.as_tensor(v)
    ordered = rule_eval.rule_outputs(
        vals, tables, lengths, gr,
        cluster_order_sums(vals, tables, _chunk(ndim, torch.float64)))
    kernel_check.judge(kernel_check.region_readings(
        ordered, ref, vals, vals.abs(), tables, lengths, gr), name="grid",
        dtype=torch.float64)
    np.testing.assert_array_equal(ordered[2].numpy(), ref[2].numpy())


@pytest.fixture
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
