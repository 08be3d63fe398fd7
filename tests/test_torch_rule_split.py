"""The rule's split route (any torch callable on the card: a points kernel,
the callable, a contraction kernel; ``ops/cuda_rule.py``,
``csrc/rule_split.cu``) on the CPU: which integrands take it, that a pool
on the card reaches it with its chunk and layout, the chunk and slot walk
against ``region_pool.block_mask``, the layout of the points against
``rule_eval.rule_points``', the wrapper's walk with its two kernels
replaced by their plain versions, and ``kernel_check``'s split check.  The
kernels themselves run on the card only (tests/test_torch_cuda_split.py)."""
import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz, misc
from gpuintegration_torch.ops import cuda_build, cuda_rule, kernel_check
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani.region_pool import block_mask


@pytest.mark.parametrize("ndim", [2, 3, 8, 9, 16])
def test_route_follows_the_integrand(ndim):
    """A Genz family takes the fused routes by its shape; anything else the
    split route: a lambda, a zoo integrand, a Genz integrand without its
    family id or without its parameters."""
    fused = "tile" if ndim in cuda_rule.TILE_NDIMS else "generic"
    g = genz.f4_gaussian(ndim)
    assert cuda_rule.rule_route(ndim) == cuda_rule.rule_route(ndim, g) == fused
    for f in (lambda x: torch.exp(-torch.sum(x * x, dim=-1)),
              misc.sin_sum(ndim),
              genz.GenzIntegrand("plain", ndim, g.f, g.true_value),
              genz.GenzIntegrand("no params", ndim, g.f, g.true_value, 4)):
        assert not cuda_rule.is_genz_family(f)
        assert cuda_rule.rule_route(ndim, f) == "split"
    for g in genz.genz_suite(ndim):
        assert cuda_rule.is_genz_family(g)


def _meta_pool(ndim=3, cap=8):
    lows = torch.empty((ndim, cap), dtype=torch.float64, device="meta")
    gl = torch.empty((ndim,), dtype=torch.float64, device="meta")
    return lows, lows, gl, gl


def test_device_pool_goes_to_the_split_route(monkeypatch):
    """A callable on a pool that is not on the CPU (a meta tensor stands in
    for the card) is handed to the split wrapper with the chunk, the count
    of real regions and the layout; a Genz family to the fused one."""
    calls = []

    def fake_split(f, tables, lows, lengths, gl, gr, *, chunk_size, n,
                   blocked):
        calls.append(("split", lows.device.type, chunk_size, n, blocked))
        return "split"

    def fake_fused(f, tables, lows, lengths, gl, gr, *, n, blocked):
        calls.append(("fused", n, blocked))
        return "fused"

    monkeypatch.setattr(cuda_rule, "cuda_apply_rule_split", fake_split)
    monkeypatch.setattr(cuda_rule, "cuda_apply_rule", fake_fused)
    tables = rule_eval.rule_tables(3)
    assert rule_eval.apply_rule(lambda x, y, z: x * y * z, tables,
                                *_meta_pool(), chunk_size=4, n=6,
                                blocked=True) == "split"
    assert rule_eval.apply_rule(misc.xyz(), tables, *_meta_pool(),
                                chunk_size=2, n=8) == "split"
    assert rule_eval.apply_rule(genz.f3_corner_peak(3), tables,
                                *_meta_pool(), chunk_size=2, n=8) == "fused"
    assert calls == [("split", "meta", 4, 6, True),
                     ("split", "meta", 2, 8, False), ("fused", 8, False)]


@pytest.mark.parametrize("cap,n,blocked,chunk", [
    (64, 64, False, None), (64, 50, False, 16), (64, 50, False, 7),
    (64, 40, True, 16), (64, 40, True, 3), (64, 2, True, 1),
    (1024, 1000, True, 128), (16, 0, False, 4)])
def test_chunks_walk_the_real_slots(cap, n, blocked, chunk):
    """The chunks cover real regions 0..n-1 once each, in order, at most
    ``chunk`` at a time; their slots are block_mask's real slots in
    ascending order (apply_rule_plain's order), padding never touched."""
    chunks = cuda_rule.split_chunks(n, chunk)
    assert sum(c for _, c in chunks) == n
    assert [f for f, _ in chunks] == list(np.cumsum([0] + [c for _, c in
                                                           chunks])[:-1])
    assert all(1 <= c <= (chunk or n) for _, c in chunks)
    slots = np.concatenate([cuda_rule.split_slots(cap, n, blocked, f, c)
                            for f, c in chunks] + [np.zeros(0, np.int64)])
    want = np.nonzero(block_mask(cap, n, blocked, "cpu").numpy())[0]
    np.testing.assert_array_equal(slots, want)


@pytest.mark.parametrize("ndim", [2, 5, 8, 9])
@pytest.mark.parametrize("count", [1, 2, 3, 100])
def test_points_layout_is_rule_points(ndim, count):
    """The points kernel writes at the strides PyTorch gives rule_points'
    broadcast (coordinate planes, region fastest; one region
    points-major), so a callable sees the same tensor on both."""
    t = rule_eval.rule_tables(ndim)
    rng = np.random.default_rng(count)
    lows = torch.as_tensor(rng.uniform(0, 0.5, (ndim, count)))
    x, _, _ = rule_eval.rule_points(t, lows, lows + 0.25,
                                    torch.zeros(ndim, dtype=torch.float64),
                                    torch.ones(ndim, dtype=torch.float64))
    assert cuda_rule.points_strides(count, t.feval, ndim) == x.stride()
    if count > 1:
        assert x.stride() == (1, count, count * t.feval)


def _plain_stand_ins(monkeypatch, *, shift=0.0, padding=False):
    """The split wrapper's pool check and two launches replaced by their
    plain versions on CPU tensors: points by rule_points of the chunk's
    slots (written into a tensor of the kernel's strides, ``shift`` added
    to one coordinate), the contraction by rule_outputs scattered into the
    slots (and, with ``padding``, a value into a padding slot)."""
    monkeypatch.setattr(cuda_build, "load", lambda *a: None)

    def check(what, tables, lows, lengths, gl, gr, n, blocked):
        cap = lows.shape[1]
        return cap, cap if n is None else int(n)

    def points(lib, tables, lows, lengths, gl, gr, cap, n, blocked, first,
               count):
        slots = cuda_rule.split_slots(cap, n, blocked, first, count)
        x, _, _ = rule_eval.rule_points(tables, lows[:, slots],
                                        lengths[:, slots], gl, gr)
        out = torch.empty_strided(x.shape, cuda_rule.points_strides(
            count, tables.feval, tables.ndim), dtype=x.dtype)
        out.copy_(x)
        out[0, 1, 0] += shift
        cuda_rule.split_launches["points"] += 1
        return out

    def contract(lib, tables, vals, lengths, gr, cap, n, blocked, first,
                 count, est, err, sdim, route=None):
        slots = torch.as_tensor(cuda_rule.split_slots(cap, n, blocked, first,
                                                      count))
        for o, v in zip((est, err, sdim), rule_eval.rule_outputs(
                vals, tables, lengths[:, slots], gr)):
            o[slots] = v
        if padding and n < cap:
            est[-1] = 1.0
        cuda_rule.split_launches["contract"] += 1

    monkeypatch.setattr(cuda_rule, "_check_pool", check)
    monkeypatch.setattr(cuda_rule, "_points_launch", points)
    monkeypatch.setattr(cuda_rule, "_contract_launch", contract)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def _pool(ndim, cap, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(0.0, 0.5, (ndim, cap))),
            torch.as_tensor(rng.uniform(0.05, 0.5, (ndim, cap))),
            torch.zeros(ndim, dtype=torch.float64),
            torch.ones(ndim, dtype=torch.float64))


@pytest.mark.parametrize("n,blocked,chunk", [(64, False, None),
                                             (50, False, 16), (40, True, 7)])
def test_split_walk_equals_the_plain_rule(monkeypatch, n, blocked, chunk):
    """With its kernels replaced by their plain versions, the split
    wrapper gives apply_rule_plain's outputs bit for bit, zeros in the
    padding slots, one launch of each kernel a chunk; the per-axis and the
    batched form of a callable alike."""
    _plain_stand_ins(monkeypatch)
    ndim, cap = 4, 64
    pool = _pool(ndim, cap)
    tables = rule_eval.rule_tables(ndim)
    for f in (misc.sin_sum(ndim),
              lambda a, b, c, d: torch.sin(a + b + c + d)):
        cuda_rule.reset_launches()
        got = cuda_rule.cuda_apply_rule_split(f, tables, *pool,
                                              chunk_size=chunk, n=n,
                                              blocked=blocked)
        want = rule_eval.apply_rule_plain(f, tables, *pool, chunk_size=chunk,
                                          n=n, blocked=blocked)
        for a, b in zip(got, want):
            assert kernel_check.same_bits(a, b)
        chunks = len(cuda_rule.split_chunks(n, chunk))
        assert cuda_rule.split_launches == {"points": chunks,
                                            "contract": chunks}
        assert cuda_rule.launches == 0
    cuda_rule.reset_launches()
    assert cuda_rule.split_launches == {"points": 0, "contract": 0}


def test_split_wrapper_refuses_values_of_another_shape(monkeypatch):
    _plain_stand_ins(monkeypatch)
    tables = rule_eval.rule_tables(3)
    bad = genz.GenzIntegrand("bad", 3, lambda x: torch.sum(x, dim=(-1, -2)),
                             0.0)
    with pytest.raises(ValueError, match="integrand values"):
        cuda_rule.cuda_apply_rule_split(bad, tables, *_pool(3, 16))


def test_split_check_logic_on_cpu(monkeypatch):
    """kernel_check.check_split_against_plain with the plain version
    standing in for the kernels passes, counting every split_dim EQUAL; a
    point one ulp off, or a value in a padding slot, fails it."""
    ndim, cap, n = 3, 64, 40
    pool = _pool(ndim, cap, 1)
    tables = rule_eval.rule_tables(ndim)
    g = misc.sin_sum(ndim)

    def split_points(tables, lows, lengths, gl, gr, first, count, *, n,
                     blocked):
        return cuda_rule._points_launch(None, tables, lows, lengths, gl, gr,
                                        lows.shape[1], n, blocked, first,
                                        count)

    for kw, message in (({}, None), ({"shift": 1e-16}, "points differ"),
                        ({"padding": True}, "padding slots")):
        with monkeypatch.context() as m:
            _plain_stand_ins(m, **kw)
            m.setattr(cuda_rule, "split_points", split_points)
            if message is None:
                r = kernel_check.check_split_against_plain(
                    g, tables, *pool, n=n, blocked=True, chunk_size=16)
                assert r["split_dim_equal"] == r["regions"] == n
                assert r["est_ulps"] == r["err_ulps"] == 0
            else:
                with pytest.raises(AssertionError, match=message):
                    kernel_check.check_split_against_plain(
                        g, tables, *pool, n=n, blocked=True, chunk_size=16)


def test_split_route_refuses_non_cuda_and_fails_a_build(monkeypatch,
                                                        tmp_path):
    """Nothing falls back to the plain version: a pool off the card is
    refused, and a failed build raises."""
    tables = rule_eval.rule_tables(3)
    plain = []
    monkeypatch.setattr(rule_eval, "apply_rule_plain",
                        lambda *a, **k: plain.append(1))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rule_eval.apply_rule(misc.xyz(), tables, *_meta_pool())
    z = torch.zeros((3, 8), dtype=torch.float64)
    for call in (lambda: cuda_rule.split_points(tables, z, z + 1.0, z[:, 0],
                                                z[:, 0] + 1.0, 0, 4),
                 lambda: cuda_rule.split_contract(
                     torch.zeros((4, tables.feval), dtype=torch.float64),
                     tables, z, z + 1.0, z[:, 0], z[:, 0] + 1.0, 0)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call()
    assert not plain
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: rule_split.cu broken' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="rule_split.cu broken"):
        cuda_build.build("rule_split.cu")
    assert not list((tmp_path / "build").glob("*.so"))
