"""The host side of the components cluster contraction on the CPU
(``ops/cuda_rule.py``: ``contract_route`` for a vector's values,
``comp_cluster_plan``, ``comp_cluster_partition``, ``comp_cluster_smem``;
the kernel, csrc/rule_split.cu ``rule_contract_comp_cluster_kernel``, runs
on the card only, tests/test_torch_cuda_vector.py).

* Which route a vector's values take, at every dimension's Workspace chunk,
  f64 and f32, 2, 3, 4 and 8 components, component-minor,
  component-major and other strides, odd counts.
* The partition covers each point of each orbit once for each component,
  and gives each (rank, warp) the scalar cluster route's points in its
  order; the 16-byte copies cover a component-minor segment at any address.
* A torch emulation of the route's summation order against
  ``rule_eval.rule_outputs_vector`` within ``kernel_check``'s limits,
  split_dim EQUAL, each component bit for bit the scalar cluster route's
  order on its plane (``cluster_order_sums``); one case against the JAX
  package's ``rule_eval.apply_rule`` on numpy-made grid values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_torch import Workspace
from gpuintegration_torch.models import misc
from gpuintegration_torch.ops import cuda_rule, kernel_check, rule_eval
from test_torch_contract_layouts import cluster_order_sums

DTYPES = [torch.float64, torch.float32]
NCOMPS = [2, 3, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    and the test workers running side by side would otherwise
    oversubscribe the cores (each worker's pool defaults to every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(ndim, dtype):
    return Workspace(ndim, dtype=dtype, device="cpu").chunk_size


def _layouts(count, feval, ncomp):
    """Strides of a vector's values: component-minor (torch.stack(...,
    -1)), component-major (a (ncomp, ...) tensor with its axis moved),
    every other component of a wider tensor, and a component-minor slice
    of wider rows."""
    return {"minor": (feval * ncomp, ncomp, 1),
            "major": (feval, 1, count * feval),
            "strided": (2 * feval * ncomp, 2 * ncomp, 2),
            "wide rows": (feval * ncomp + 5, ncomp, 1)}


@pytest.mark.parametrize("ncomp", NCOMPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", range(2, 17))
def test_vector_route_by_layout(ndim, dtype, ncomp):
    """At the Workspace's chunk and at odd counts, component-minor values
    (any region stride) take 'components_cluster', every other layout
    'components'; the plan takes the scalar cluster route's K and rows,
    stages of a multiple of 8 points, and fits a CTA's shared memory."""
    feval = rule_eval.rule_tables(ndim).feval
    for count in (_chunk(ndim, dtype), _chunk(ndim, dtype) - 1, 33, 1):
        for name, strides in _layouts(count, feval, ncomp).items():
            want = (cuda_rule.COMPONENTS_CLUSTER
                    if name in ("minor", "wide rows")
                    else cuda_rule.COMPONENTS)
            assert cuda_rule.contract_route(dtype, ndim, count, feval,
                                            strides, ncomp) == want
        k, rows, points, ring = cuda_rule.comp_cluster_plan(
            dtype, ndim, count, feval, ncomp)
        assert (k, rows) == cuda_rule.cluster_plan(dtype, ndim, count,
                                                   feval)[:2]
        item = torch.finfo(dtype).bits // 8
        assert points % cuda_rule.CLUSTER_WARPS == 0 and rows % 8 == 0
        assert points * ncomp * item * cuda_rule.CLUSTER_GROUP <= \
            cuda_rule.COMP_STAGE_BYTES or points == cuda_rule.CLUSTER_WARPS
        assert ring == cuda_rule.COMP_RING >= 2
        assert cuda_rule.comp_cluster_smem(dtype, ndim, ncomp, points,
                                           ring) <= cuda_rule.MAX_SMEM
    # more components than a warp keeps sums for, or a missing ncomp
    minor9 = (feval * 9, 9, 1)
    assert cuda_rule.contract_route(dtype, ndim, 64, feval, minor9, 9) == \
        cuda_rule.COMPONENTS
    with pytest.raises(ValueError, match="ncomp"):
        cuda_rule.contract_route(dtype, ndim, 64, feval, minor9)


def test_vector_route_at_the_timed_shapes():
    """The 8D and 12D f64 chunks of four components: clusters of 2 and 7
    (256 and 224 CTAs), stages of 32 points (1 KB a region's segment).
    These and the 16D chunk of four, the 8D of eight components take at
    most PAIR_SMEM of shared memory, so that two CTAs share an SM; the
    head tile lies beside the first stage at 8D and 12D, over the ring's
    slots at 16D."""
    for ndim, count, k in ((8, 4096, 2), (12, 1024, 7)):
        feval = rule_eval.rule_tables(ndim).feval
        plan = cuda_rule.comp_cluster_plan(torch.float64, ndim, count, feval,
                                           4)
        assert plan == (k, 128, 32, 2)
    smem = {(ndim, ncomp): cuda_rule.comp_cluster_smem(
        torch.float64, ndim, ncomp, *cuda_rule.comp_cluster_plan(
            torch.float64, ndim, 1024, rule_eval.rule_tables(ndim).feval,
            ncomp)[2:]) for ndim, ncomp in ((8, 4), (12, 4), (16, 4), (8, 8))}
    assert max(smem.values()) <= cuda_rule.PAIR_SMEM <= cuda_rule.MAX_SMEM // 2
    # 8D: the ring holds the head and a stage; 16D: the head alone
    assert smem[(8, 4)] == 8 * (32 * (134 + 130) + (9 + 8) * 4 * 32 + 16 * 32)
    assert smem[(16, 4)] == 8 * (32 * 262 + (9 + 8) * 4 * 32 + 16 * 32)


@pytest.mark.parametrize("ncomp", [3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", range(2, 17))
def test_comp_partition_covers_each_point_once(ndim, dtype, ncomp):
    """Each point of each orbit is summed by exactly one (rank, stage,
    warp), for every component (the kernel reads a point's components
    together); the head (points 0..4n) by the leader; a warp's points
    ascend; and the points of each (rank, warp), in order, are the scalar
    cluster route's, so that each component's sums are that route's."""
    tables = rule_eval.rule_tables(ndim)
    feval = tables.feval
    count = _chunk(ndim, dtype)
    k, rows, points, _ = cuda_rule.comp_cluster_plan(dtype, ndim, count,
                                                     feval, ncomp)
    parts = cuda_rule.comp_cluster_partition(dtype, ndim, count, feval, ncomp)
    seen = np.zeros(feval, dtype=np.int64)
    runs, scalar_runs = {}, {}
    for rank, stage, warp, pts in parts:
        seen[pts] += 1
        assert 0 <= warp < cuda_rule.CLUSTER_WARPS and 0 <= rank < k
        assert np.all(np.diff(pts) == cuda_rule.CLUSTER_WARPS)
        if stage < 0:
            assert rank == 0 and np.all(pts < 4 * ndim + 1)
        else:
            assert len(pts) <= -(-points // cuda_rule.CLUSTER_WARPS)
        runs.setdefault((rank, warp), []).append(pts)
    np.testing.assert_array_equal(seen, np.ones(feval, np.int64))
    for rank, _, warp, pts in cuda_rule.cluster_partition(dtype, ndim, count,
                                                          feval):
        scalar_runs.setdefault((rank, warp), []).append(pts)
    assert runs.keys() == scalar_runs.keys()
    for key in runs:
        np.testing.assert_array_equal(np.concatenate(runs[key]),
                                      np.concatenate(scalar_runs[key]))


@pytest.mark.parametrize("item", [8, 4])
def test_component_minor_copies_cover_any_address(item):
    """A stage's segment of a region is ``points`` x ncomp values from
    element c sc + p0 ncomp; the kernel copies it in whole 16-byte units
    from an address a (rule_split.cu Segments, seg_pitch): from a + g -
    off for round_up((off + len) item, 16) bytes, off = (a / item + g) mod
    16 / item.  The copy starts and ends on 16-byte boundaries, holds the
    segment at ``off``, reaches less than 16 bytes past it, fits the
    tile's pitch, and a stage's bytes stay under an mbarrier's 2^20."""
    slack = 16 // item
    dtype = torch.float64 if item == 8 else torch.float32
    rng = np.random.default_rng(item)
    for _ in range(2000):
        ncomp = int(rng.integers(2, 9))
        ndim = int(rng.integers(2, 17))
        feval = rule_eval.rule_tables(ndim).feval
        points = cuda_rule.comp_cluster_plan(dtype, ndim, 1024, feval,
                                             ncomp)[2]
        sc = feval * ncomp + int(rng.integers(0, 4))
        addr = 256 * int(rng.integers(1, 1 << 20)) + item * int(
            rng.integers(0, slack))
        c = int(rng.integers(0, 4096))
        p0 = int(rng.integers(0, feval))
        n = min(points, feval - p0) if rng.random() < 0.5 else \
            4 * ndim + 1
        g, length = c * sc + p0 * ncomp, n * ncomp
        off = (addr // item + g) % slack
        start = addr + (g - off) * item
        nbytes = -(-(off + length) * item // 16) * 16
        assert start % 16 == 0 and nbytes % 16 == 0
        assert start + off * item == addr + g * item
        assert start + nbytes >= addr + (g + length) * item
        assert start + nbytes - (addr + (g + length) * item) < 16
        assert nbytes <= cuda_rule._seg_pitch(item, length) * item
        assert 32 * cuda_rule._seg_pitch(item, length) * item < 1 << 20


def comp_order_sums(vals: torch.Tensor, tables, count: int):
    """The orbit sums (ncomp, C, 9) of ``vals`` (C, feval, ncomp) in the
    components cluster route's order for a launch over ``count`` regions:
    for each component, each warp's points of an orbit in the order
    ``comp_cluster_partition`` lists them, a running sum from 0; the warps'
    sums added in warp order, the ranks' in rank order.  Sequential sums
    in the values' own type."""
    v = vals.movedim(-1, 0).numpy()
    ob = np.asarray(tables.orbit_bounds)
    parts = cuda_rule.comp_cluster_partition(vals.dtype, tables.ndim, count,
                                             tables.feval, v.shape[0])
    k = 1 + max(r for r, _, _, _ in parts)
    runs = {}
    for rank, _, warp, pts in parts:
        runs.setdefault((rank, warp), []).append(pts)
    out = np.zeros(v.shape[:2] + (9,), dtype=v.dtype)
    zero = np.zeros(v.shape[:2] + (1,), dtype=v.dtype)
    for s in range(9):
        rank_sum = None
        for rank in range(k):
            warp_sum = None
            for warp in range(cuda_rule.CLUSTER_WARPS):
                pts = np.concatenate(runs.get((rank, warp),
                                              [np.zeros(0, int)]))
                pts = pts[(pts >= ob[s]) & (pts < ob[s + 1])]
                acc = np.add.accumulate(
                    np.concatenate([zero, v[:, :, pts]], axis=2),
                    axis=2)[:, :, -1]
                warp_sum = acc if warp_sum is None else warp_sum + acc
            rank_sum = warp_sum if rank_sum is None else rank_sum + warp_sum
        out[:, :, s] = rank_sum
    return torch.as_tensor(out)


def comp_split_axis(vals: torch.Tensor, tables, lengths):
    """The kernel's split axis: each axis' fourth difference the largest
    over the components (a NaN propagating), the first largest where it is
    positive and none is NaN, else the widest axis."""
    fd = torch.stack([rule_eval.fourth_differences(
        vals[..., c], tables.ndim, tables.ratio)
        for c in range(vals.shape[-1])])
    top = fd[0]
    for c in range(1, fd.shape[0]):
        top = torch.where(torch.isnan(fd[c]) | (fd[c] > top), fd[c], top)
    out = []
    for r in range(vals.shape[0]):
        row = top[r].tolist()
        if any(np.isnan(row)) or max(row) <= 0:
            out.append(int(torch.argmax(lengths[:, r])))
        else:
            out.append(int(np.argmax(row)))
    return torch.as_tensor(out, dtype=torch.int32)


def emulate(vals, tables, lengths, gr, count):
    """(est (ncomp, C), err (ncomp, C), split_dim (C,)) as the kernel forms
    them: each component's orbit sums in the route's order through
    rule_outputs' epilogue; the split axis by ``comp_split_axis``."""
    sums = comp_order_sums(vals, tables, count)
    est, err = zip(*(rule_eval.rule_outputs(
        vals[..., c].contiguous(), tables, lengths, gr, sums[c])[:2]
        for c in range(vals.shape[-1])))
    return (torch.stack(est), torch.stack(err),
            comp_split_axis(vals, tables, lengths))


def _pool(ndim, c, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype) for a in (
        rng.uniform(0.0, 0.5, (ndim, c)), rng.uniform(0.01, 0.5, (ndim, c)),
        np.zeros(ndim), rng.uniform(0.5, 1.5, ndim))]


@pytest.mark.parametrize("ncomp", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", [3, 8, 12])
def test_comp_order_matches_rule_outputs_vector(ndim, dtype, ncomp):
    """sin(sum x) and exp(-sum x) alternating over the components on a few
    regions: est/err from the route's summation order (at the partition of
    the Workspace's chunk) against rule_outputs_vector within
    kernel_check's limits, split_dim EQUAL; each component's orbit sums
    bit for bit the scalar cluster route's order on its plane."""
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    lows, lengths, gl, gr = _pool(ndim, 3, dtype, ndim)
    g = misc.sin_sum(ndim)
    members = [g if c % 2 == 0 else (lambda x: torch.exp(-x.sum(-1)))
               for c in range(ncomp)]
    vals, u = zip(*(kernel_check.value_scales(m, tables, lows, lengths, gl,
                                              gr) for m in members))
    vals, u = torch.stack(vals, -1), torch.stack(u, -1)
    count = _chunk(ndim, dtype)
    sums = comp_order_sums(vals, tables, count)
    for c in range(ncomp):
        assert kernel_check.same_bits(
            sums[c], cluster_order_sums(vals[..., c].contiguous(), tables,
                                        count))
    got = emulate(vals, tables, lengths, gr, count)
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    r = kernel_check.check_components(got, plain, vals, u, tables, lengths,
                                      gr, name="sin/exp")
    assert r["regions"] == 3 and r["split_dim_equal"] == 3


def test_comp_split_axis_takes_the_widest_for_a_nan():
    """A NaN in one component of a region makes the widest axis its split
    axis, as torch.amax's NaN does in rule_outputs_vector."""
    ndim, ncomp = 4, 3
    tables = rule_eval.rule_tables(ndim)
    lows, lengths, gl, gr = _pool(ndim, 5, torch.float64, 3)
    rng = np.random.default_rng(4)
    vals = torch.as_tensor(rng.uniform(0.5, 1.5, (5, tables.feval, ncomp)))
    vals[2, 2 + 2 * ndim, 1] = float("nan")
    got = comp_split_axis(vals, tables, lengths)
    plain = rule_eval.rule_outputs_vector(vals, tables, lengths, gr)
    assert torch.equal(got, plain[2])
    assert int(got[2]) == int(torch.argmax(lengths[:, 2]))


def test_comp_order_matches_jax_rule_eval(flush_denormal):
    """8D f64, four components on the grid k/8 made with numpy (every orbit
    sum exact in any order) handed to the JAX package's
    rule_eval.apply_rule(..., ncomp=4) as the integrand's values: the
    route's order gives its estimates and errors within kernel_check's
    limits (scales from |values|), its split axes EQUAL."""
    ndim, c, ncomp = 8, 5, 4
    tables = rule_eval.rule_tables(ndim)
    lows, lengths, gl, gr = _pool(ndim, c, torch.float64, 1)
    rng = np.random.default_rng(2)
    v = rng.integers(4, 12, (c, tables.feval, ncomp)) / 8.0
    ref = jax_rule_eval.apply_rule(
        lambda x: jnp.asarray(v), jax_rule_eval.rule_tables(ndim, "float64"),
        *(jnp.asarray(t.numpy()) for t in (lows, lengths, gl, gr)),
        ncomp=ncomp)
    ref = [torch.as_tensor(np.array(o)) for o in ref]
    vals = torch.as_tensor(v)
    got = emulate(vals, tables, lengths, gr, _chunk(ndim, torch.float64))
    kernel_check.check_components(got, ref, vals, vals.abs(), tables,
                                  lengths, gr, name="grid")
    np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())


@pytest.fixture
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
