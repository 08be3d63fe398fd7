"""VEGAS on a mesh (``mcubes.vegas(..., mesh=m)``) on the CPU under gloo.

Rank i samples the global chunks [i num_chunks, (i + 1) num_chunks), the
draws keyed on the global cube id, and ti, tsi and the f32 histogram are
all-reduced, so with the chunks matched (``ncall=8192, chunk_cubes=64``:
4096 cubes, 64 chunks) a mesh run draws the single-device run's samples and
must agree with the port's single-device run at rtol 1e-5 for the estimate
and 1e-3 for the errorest, the iterations equal (the reference's
``test_vegas_mesh_matches_single_chip``), on both maps, a vector integrand
too; D = 3 cuts 4096 cubes into 1366 a rank, its last chunks past the
lattice masked.  The same seed gives the same bits twice, on every rank.
``refine='device'`` (the adjustment phase, its histogram all-reduced before
the rebin) and the frozen phase converge; a per-axis callable traced into
the fused sampler (``sampler='fused'``) matches its single-device run.  Against the JAX package's mesh
at the same D the draws differ (Philox against Threefry), so the estimates
agree statistically: within 5 sqrt(e1^2 + e2^2)."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from gpuintegration_tpu.mcubes.vegas import vegas as jax_vegas
from gpuintegration_tpu.parallel.mesh import make_mesh
from gpuintegration_torch.parallel.launch import run_on_ranks
from gpuintegration_torch.tools import mesh_cases
from test_torch_mesh_pagani import jax_integrand

G = ("genz", "f4_gaussian", 3, {"a": 5.0})
VEC = ("vector", [G, ("genz", "f1_oscillatory", 3, {})])
MATCHED = dict(epsrel=1e-4, ncall=8192.0, total_iters=8, adjust_iters=4,
               seed=3, chunk_cubes=64)
CONVERGE = dict(epsrel=1e-3, ncall=8192.0, total_iters=12, adjust_iters=6,
                seed=3, chunk_cubes=64)


def _vegas(integrand, single=False, **kw):
    return dict(what="vegas", integrand=integrand, kw=kw, single=single)


CASES = {
    "poly": _vegas(G, True, **MATCHED),
    "poly_again": _vegas(G, **MATCHED),
    "grid": _vegas(G, True, importance="grid", **MATCHED),
    "vector": _vegas(VEC, True, **MATCHED),
    "device": _vegas(G, refine="device", **dict(CONVERGE, adjust_iters=8)),
    "frozen": _vegas(G, **dict(CONVERGE, adjust_iters=3)),
    # a per-axis callable traced into the fused sampler (the reference's
    # sampler='pallas' on a mesh, tests/test_pallas_vegas.py:169-175)
    "fused_axes": _vegas(("axes", 3, 5.0), True, sampler="fused",
                         **MATCHED),
}
# the reference's mesh on the same configurations
REFERENCE = ("poly", "grid", "device")


def _reference(d):
    mesh = make_mesh(d)
    out = {}
    for name in REFERENCE:
        case = CASES[name]
        r = jax_vegas(jax_integrand(case["integrand"]), mesh=mesh,
                      **case["kw"])
        out[name] = mesh_cases.outcome(r)
    return out


@pytest.fixture(scope="module")
def runs():
    """{D: (the reference's outcomes, the ranks' outcomes)}."""
    with ThreadPoolExecutor(2) as ex:
        futures = {d: ex.submit(run_on_ranks, mesh_cases.run_cases, d,
                                args=(CASES,), timeout=600)
                   for d in (2, 3)}
        refs = {d: _reference(d) for d in futures}
        return {d: (refs[d], fut.result()) for d, fut in futures.items()}


def _values(r, name):
    v = r[name + "s"] if r.get(name + "s") is not None else r[name]
    return np.atleast_1d(np.asarray(v, np.float64))


def _truth(spec):
    from gpuintegration_torch.tools.mesh_cases import integrand
    if spec[0] == "vector":
        return np.array([integrand(m).true_value for m in spec[1]])
    return np.array([integrand(spec).true_value])


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", ["poly", "grid", "vector", "fused_axes"])
def test_matched_chunks_match_one_device(runs, d, name):
    _, ranks = runs[d]
    got, one = ranks[0][name]["result"], ranks[0][name + "/single"]["result"]
    assert got["iters"] == one["iters"] and got["neval"] == one["neval"]
    np.testing.assert_allclose(_values(got, "estimate"),
                               _values(one, "estimate"), rtol=1e-5)
    np.testing.assert_allclose(_values(got, "errorest"),
                               _values(one, "errorest"), rtol=1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_same_seed_same_bits_on_every_rank(runs, d):
    _, ranks = runs[d]
    first = ranks[0]["poly"]["result"]
    for r in ranks:
        for name in CASES:
            for k, v in ranks[0][name]["result"].items():
                np.testing.assert_array_equal(
                    np.asarray(r[name]["result"][k]), np.asarray(v),
                    err_msg=f"{name} {k}")
        for k, v in first.items():
            np.testing.assert_array_equal(
                np.asarray(r["poly_again"]["result"][k]), np.asarray(v),
                err_msg=k)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", ["device", "frozen", "vector"])
def test_phases_converge(runs, d, name):
    """The device-resident phases on the mesh: each run ends status 0 (the
    vector: its components within 5 errorests of the truths), having run
    its phase (on the CPU eagerly)."""
    _, ranks = runs[d]
    out = ranks[0][name]
    got = out["result"]
    truth = _truth(CASES[name]["integrand"])
    est, err = _values(got, "estimate"), _values(got, "errorest")
    assert np.all(np.abs(est - truth) <= 5 * err), (est, err, truth)
    if name != "vector":
        assert got["status"] == 0
    assert out["vegas_stats"]["phases"] >= 1
    assert out["vegas_stats"]["uncaptured"] == 0


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", REFERENCE)
def test_agrees_with_reference_mesh(runs, d, name):
    refs, ranks = runs[d]
    got, ref = ranks[0][name]["result"], refs[name]
    assert abs(got["estimate"] - ref["estimate"]) <= 5 * np.hypot(
        got["errorest"], ref["errorest"])
