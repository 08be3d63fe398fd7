"""The port's vector rule evaluation (``rule_eval.rule_outputs_vector``,
``apply_rule_plain(..., ncomp)``, the components contraction's wrapper and
check) against the JAX package's ``rule_eval.apply_rule(..., ncomp)``
(XLA's ``_eval_chunk_vector``), on the CPU.

* f64: est/err to 1e-14 relative plus 1e-13 of the region's magnitude
  (volume x jacobian x its largest |f|: the null-rule errors cancel, and
  reassociated sums move them by ulps of that magnitude, never of their
  own size), split_dim EQUAL.
* f32: each component held by ``kernel_check``'s gate-aware reading (ulps
  of its own rounding scale), never a plain relative tolerance.

XLA on the CPU flushes subnormal results; the port runs with
``torch.set_flush_denormal(True)``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import cuda_build, cuda_rule, kernel_check
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import region_pool

MEMBERS = [("f1_oscillatory", jax_genz.f1_oscillatory),
           ("f2_product_peak", jax_genz.f2_product_peak),
           ("f4_gaussian", jax_genz.f4_gaussian),
           ("f5_c0", jax_genz.f5_c0_continuous)]


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


def _members(ndim):
    """The same vector integrand in both packages, and the port's
    components."""
    jm = [make(ndim) for _, make in MEMBERS]
    tm = [genz.FAMILIES[name](ndim) for name, _ in MEMBERS]

    def fj(x):
        return jnp.stack([m(x) for m in jm], axis=-1)

    def ft(x):
        return torch.stack([m(x) for m in tm], dim=-1)

    return fj, ft, tm


def _pool(ndim, cap, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [a.astype(dtype) for a in (
        rng.uniform(0.0, 0.5, (ndim, cap)), rng.uniform(0.01, 0.5, (ndim, cap)),
        rng.uniform(-1.0, 0.0, ndim), rng.uniform(0.5, 2.0, ndim))]


def _reference(fj, ndim, dtype_name, pool, ncomp, **kw):
    out = jax_rule_eval.apply_rule(
        fj, jax_rule_eval.rule_tables(ndim, dtype_name),
        *[jnp.asarray(a) for a in pool], ncomp=ncomp, **kw)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("ndim", [3, 5])
def test_plain_vector_matches_jax_f64(ndim):
    pool = _pool(ndim, 256, ndim)
    fj, ft, _ = _members(ndim)
    ref = _reference(fj, ndim, "float64", pool, len(MEMBERS))
    t = [torch.as_tensor(a) for a in pool]
    tables = rule_eval.rule_tables(ndim)
    got = [o.numpy() for o in rule_eval.apply_rule(
        ft, tables, *t, chunk_size=96, ncomp=len(MEMBERS))]
    assert got[0].shape == got[1].shape == (len(MEMBERS), 256)
    vals = rule_eval.rule_values(ft, tables, *t)
    mag = (np.prod(pool[1], axis=0) * np.prod(pool[3])
           * vals.abs().amax(dim=1).numpy().T)          # (ncomp, C)
    for g, r in zip(got[:2], ref[:2]):
        assert np.all(np.abs(g - r) <= 1e-14 * np.abs(r) + 1e-13 * mag)
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], ref[2])
    # the same from rule_outputs_vector on the values
    est, err, sd = rule_eval.rule_outputs_vector(vals, tables, t[1], t[3])
    np.testing.assert_array_equal(sd.numpy(), got[2])
    np.testing.assert_array_equal(est.numpy(), got[0])


@pytest.mark.parametrize("ndim", [3, 5])
def test_plain_vector_matches_jax_f32(ndim):
    """f32 against the reference's XLA vector rule: each component's est
    and err within kernel_check's limits of the port's, read on the
    port's rounding scales; split_dim agreeing but for near-ties."""
    pool = _pool(ndim, 256, 10 + ndim, np.float32)
    fj, ft, tm = _members(ndim)
    ref = _reference(fj, ndim, "float32", pool, len(MEMBERS))
    t = [torch.as_tensor(a) for a in pool]
    tables = rule_eval.rule_tables(ndim, "float32")
    got = rule_eval.apply_rule_plain(ft, tables, *t, ncomp=len(MEMBERS))
    for k, m in enumerate(tm):
        vals, u = kernel_check.value_scales(m, tables, *t)
        r = kernel_check.judge(kernel_check.region_readings(
            [torch.as_tensor(np.array(r)) for r in (ref[0][k], ref[1][k],
                                                    ref[2])],
            [got[0][k], got[1][k], got[2]], vals, u, tables, t[1], t[3]),
            name=m.name, dtype=torch.float32, min_agree=0.99)
        assert r["regions"] == 256


def test_nan_component_takes_the_widest_axis():
    """A NaN in one component's fourth differences makes the widest axis
    the split axis (torch.amax propagates it), as in the reference."""
    ndim = 3
    pool = _pool(ndim, 64, 5)[:2] + [np.zeros(ndim), np.ones(ndim)]
    t = [torch.as_tensor(a) for a in pool]
    tables = rule_eval.rule_tables(ndim)

    def ft(x):
        bad = torch.where(x[..., 0] > 0.9, torch.nan, 1.0)
        return torch.stack([torch.exp(-x.sum(-1)), bad], dim=-1)

    def fj(x):
        bad = jnp.where(x[..., 0] > 0.9, jnp.nan, 1.0)
        return jnp.stack([jnp.exp(-x.sum(-1)), bad], axis=-1)

    est, err, sd = rule_eval.apply_rule_plain(ft, tables, *t, ncomp=2)
    ref = _reference(fj, ndim, "float64", pool, 2)
    nan = torch.isnan(est[1])
    assert nan.any() and not nan.all()
    widest = torch.argmax(t[1], dim=0).to(torch.int32)
    assert torch.equal(sd[nan], widest[nan])
    np.testing.assert_array_equal(sd.numpy(), ref[2])
    assert not torch.isnan(est[0]).any()


def test_two_equal_components_are_the_scalar_rule():
    """[f, f] gives f's rule_outputs bit for bit in both components."""
    ndim = 4
    t = [torch.as_tensor(a) for a in _pool(ndim, 128, 7)]
    tables = rule_eval.rule_tables(ndim)
    g = genz.f2_product_peak(ndim)
    vals = rule_eval.rule_values(g, tables, *t)
    s = rule_eval.rule_outputs(vals, tables, t[1], t[3])
    v = rule_eval.rule_outputs_vector(torch.stack([vals, vals], dim=-1),
                                      tables, t[1], t[3])
    for k in range(2):
        assert kernel_check.same_bits(v[0][k], s[0])
        assert kernel_check.same_bits(v[1][k], s[1])
    assert kernel_check.same_bits(v[2], s[2])


@pytest.mark.parametrize("layout", ["minor", "major", "strided"])
def test_route_choice_is_components_for_vectors(layout):
    """Values (count, feval, ncomp) take a vector's contraction: the
    components cluster route component-minor, the components route at any
    other strides; a component's plane a scalar route; a vector of Genz
    members takes the split route."""
    ndim, count, ncomp = 8, 64, 3
    feval = rule_eval.rule_tables(ndim).feval
    v = torch.zeros((count, feval, ncomp))
    if layout == "major":
        v = torch.zeros((ncomp, count, feval)).movedim(0, -1)
    elif layout == "strided":
        v = torch.zeros((count, feval, 2 * ncomp))[..., ::2]
    want = "components_cluster" if layout == "minor" else "components"
    assert cuda_rule.contract_route(torch.float64, ndim, count, feval,
                                    v.stride(), ncomp) == want
    assert cuda_rule.contract_route(torch.float64, ndim, count, feval,
                                    v[..., 0].stride()) in ("cluster",
                                                            "generic")
    g = genz.f4_gaussian(ndim)
    assert cuda_rule.rule_route(ndim, g) == "tile"
    assert cuda_rule.rule_route(ndim, g, ncomp) == "split"
    assert {"components", "components_cluster"} <= set(
        cuda_rule.contract_route_launches)


def _plain_components(monkeypatch):
    """The split wrapper's pool check and launches replaced by their plain
    versions on CPU tensors (tests/test_torch_rule_split.py's pattern),
    the components contraction by rule_outputs_vector."""
    monkeypatch.setattr(cuda_build, "load", lambda *a: None)

    def check(what, tables, lows, lengths, gl, gr, n, blocked):
        cap = lows.shape[1]
        return cap, cap if n is None else int(n)

    def points(lib, tables, lows, lengths, gl, gr, cap, n, blocked, first,
               count):
        slots = cuda_rule.split_slots(cap, n, blocked, first, count)
        cuda_rule.split_launches["points"] += 1
        return rule_eval.rule_points(tables, lows[:, slots],
                                     lengths[:, slots], gl, gr)[0]

    def contract(lib, tables, vals, lengths, gr, cap, n, blocked, first,
                 count, est, err, sdim, route=None):
        slots = torch.as_tensor(cuda_rule.split_slots(cap, n, blocked, first,
                                                      count))
        e, r, s = rule_eval.rule_outputs_vector(vals, tables,
                                                lengths[:, slots], gr)
        est[:, slots], err[:, slots], sdim[slots] = e, r, s
        cuda_rule.split_launches["contract"] += 1
        cuda_rule.contract_route_launches[route or cuda_rule.contract_route(
            vals.dtype, tables.ndim, count, tables.feval, vals.stride(),
            vals.shape[2])] += 1

    monkeypatch.setattr(cuda_rule, "_check_pool", check)
    monkeypatch.setattr(cuda_rule, "_points_launch", points)
    monkeypatch.setattr(cuda_rule, "_contract_comp_launch", contract)


@pytest.mark.parametrize("n,blocked,chunk", [(64, False, None),
                                             (50, False, 16), (40, True, 7)])
def test_split_walk_of_a_vector(monkeypatch, n, blocked, chunk):
    """With its kernels replaced by their plain versions, the split wrapper
    walks a vector integrand's chunks into (ncomp, cap) outputs equal to
    apply_rule_plain's, zeros in the padding slots, one launch a chunk on
    the route contract_route names (the members stacked component-minor:
    the components cluster route); the scalar routes refuse a vector's
    values."""
    _plain_components(monkeypatch)
    ndim, cap = 3, 64
    t = [torch.as_tensor(a) for a in _pool(ndim, cap, 2)]
    tables = rule_eval.rule_tables(ndim)
    _, ft, _ = _members(ndim)
    cuda_rule.reset_launches()
    got = cuda_rule.cuda_apply_rule_split(ft, tables, *t, chunk_size=chunk,
                                          n=n, blocked=blocked, ncomp=4)
    want = rule_eval.apply_rule_plain(ft, tables, *t, chunk_size=chunk, n=n,
                                      blocked=blocked, ncomp=4)
    for a, b in zip(got, want):
        assert kernel_check.same_bits(a, b)
    chunks = len(cuda_rule.split_chunks(n, chunk))
    assert cuda_rule.contract_route_launches == {
        "cluster": 0, "generic": 0, "components_cluster": chunks,
        "components": 0}
    assert cuda_rule.split_launches == {"points": chunks, "contract": chunks}
    mask = region_pool.block_mask(cap, n, blocked)
    assert not got[0][:, ~mask].any() and not got[2][~mask].any()
    with pytest.raises(ValueError, match="'components' contraction"):
        cuda_rule.cuda_apply_rule_split(ft, tables, *t, ncomp=4,
                                        route="cluster")
    with pytest.raises(ValueError, match="integrand values"):
        cuda_rule.cuda_apply_rule_split(ft, tables, *t, ncomp=3)


def test_components_check_logic_on_cpu():
    """kernel_check.check_components passes the plain version against
    itself, and fails an est a few hundred ulps of its scale off, or one
    split_dim changed."""
    ndim, count = 3, 64
    t = [torch.as_tensor(a) for a in _pool(ndim, count, 4)]
    tables = rule_eval.rule_tables(ndim)
    _, ft, tm = _members(ndim)
    vals, u = zip(*(kernel_check.value_scales(m, tables, *t) for m in tm))
    vals, u = torch.stack(vals, -1), torch.stack(u, -1)
    plain = rule_eval.rule_outputs_vector(vals, tables, t[1], t[3])
    r = kernel_check.check_components(plain, plain, vals, u, tables, t[1],
                                      t[3])
    assert r["ncomp"] == 4 and r["split_dim_equal"] == count
    assert r["est_ulps"] == r["err_ulps"] == 0.0
    est = plain[0].clone()
    s_est, _ = kernel_check.roundoff_scales(u[..., 0], tables, t[1], t[3])
    est[0, 5] += 300 * torch.finfo(torch.float64).eps * s_est[5] \
        + 1e-12 * est[0, 5].abs()
    with pytest.raises(AssertionError, match="component 0 .* est"):
        kernel_check.check_components((est,) + plain[1:], plain, vals, u,
                                      tables, t[1], t[3])
    sd = plain[2].clone()
    sd[3] = (sd[3] + 1) % ndim
    with pytest.raises(AssertionError, match="split_dim differs"):
        kernel_check.check_components(plain[:2] + (sd,), plain, vals, u,
                                      tables, t[1], t[3])
