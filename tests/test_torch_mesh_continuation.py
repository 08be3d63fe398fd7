"""The classifier, checkpoints, the continuation and vector integrands on a
mesh (``Workspace(ndim, mesh=m)``) against the JAX package's mesh at the
same D, on the CPU under gloo (``test_torch_mesh_pagani.py`` runs both
sides the same way and holds runs the same way).

The cases: F3 3D with ``max_pool_regions=2048`` at 1e-10 (the classifier
on the global pool: its ladder's floor, ceiling and rungs all-reduced;
F3's per-axis coefficients leave no tied split axes, which a centred
Gaussian's checkpoints would part on in either package), its checkpoint
and one after an iteration budget (``make_checkpoint`` gathering the
shards in rank order: the regions EQUAL the reference's row for row, the
per-region sweep to roundoff); ``_rebalance_checkpoint_for_mesh``'s order
EQUAL the reference's on the reference's checkpoint; the continuation with
a resume round (rebalanced) and with partitioned slices, the same stages
as the reference's; vectors through the host loop and the fused phase,
their checkpoint and continuation."""
import numpy as np
import pytest

from gpuintegration_torch.pagani.workspace import rebalance_checkpoint
from test_torch_mesh_pagani import assert_same_run, mesh_runs

F3 = ("genz", "f3_corner_peak", 3, {})
G5 = ("genz", "f4_gaussian", 3, {"a": 5.0})
VEC = ("vector", [G5, ("genz", "f1_oscillatory", 3, {})])
VEC_CK = ("vector", [G5, ("genz", "f2_product_peak", 3, {})])
WS = dict(chunk_size=256)


def _case(what, integrand, ws=WS, **kw):
    return dict(what=what, integrand=integrand, ndim=3, ws=ws,
                kw=dict(epsabs=1e-40, **kw))


CLASSIFIER = _case("pagani", F3, dict(WS, max_pool_regions=2048),
                   epsrel=1e-10, checkpoint=True)
CASES = {
    2: {
        "classifier": CLASSIFIER,
        "vector_host": _case("pagani", VEC, epsrel=1e-6, fused=False),
        "vector_fused": _case("pagani", VEC, epsrel=1e-6),
        "resume": _case("convergence", F3, epsrel=1e-9, max_iterations=4),
    },
    3: {
        "classifier": CLASSIFIER,
        "budget": _case("pagani", F3, epsrel=1e-10, max_iterations=7,
                        fused=False, checkpoint=True),
        "slices": _case("convergence", ("genz", "f4_gaussian", 3,
                                        {"a": 5.0, "b": 0.3}),
                        dict(WS, max_pool_regions=1024), epsrel=1e-9),
        "vector_budget": _case("pagani", VEC_CK, epsrel=1e-8,
                               max_iterations=4, fused=False,
                               checkpoint=True),
        "vector_convergence": _case("convergence", VEC_CK, epsrel=1e-7,
                                    max_iterations=6,
                                    finish_epsrel_scale=0.4),
    },
}
# the checkpoint flag is the runner's, not integrate's
for _cases in CASES.values():
    for _c in _cases.values():
        if _c["kw"].pop("checkpoint", False):
            _c["checkpoint"] = True


@pytest.fixture(scope="module")
def runs():
    return mesh_runs(CASES)


@pytest.mark.parametrize("d,name", [(d, n) for d, c in CASES.items()
                                    for n in c])
def test_mesh_run_matches_reference_mesh(runs, d, name):
    ref, ranks = runs[d][name]
    assert_same_run(ref, ranks)
    if "stages" in ref:
        assert ranks[0]["stages"] == ref["stages"]
        assert ranks[0]["result"]["status"] == 0
    if name == "resume":
        assert ref["stages"] == ["resume_round2", "round1"]
    if name == "slices":
        assert "slices" in ref["stages"]


@pytest.mark.parametrize("d,name", [(d, n) for d, c in CASES.items()
                                    for n, case in c.items()
                                    if case.get("checkpoint")])
def test_checkpoint_equals_reference(runs, d, name):
    """The gathered checkpoint: regions EQUAL the reference's row for row
    (rank order, each shard's blocked halves in turn), the ledger EQUAL,
    the per-region sweep to reassociation roundoff; every rank holds the
    same."""
    ref, ranks = runs[d][name]
    want = ref["checkpoint"]
    got = ranks[0]["checkpoint"]
    assert got["lows"].shape[0] > 0
    for k in ("lows", "lengths"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)))
    for k in ("nregions", "iters", "neval"):
        assert got[k] == getattr(want, k)
    np.testing.assert_allclose(got["estimate"], want.estimate, rtol=1e-15)
    np.testing.assert_allclose(got["errorest"], want.errorest, rtol=1e-6)
    # a region's rule sums' scale: its estimate, or its volume where f is
    # at most 1 and cancels
    scale = np.abs(np.asarray(want.region_estimates))
    vol = np.prod(got["lengths"], axis=1)
    scale = np.maximum(scale, vol if scale.ndim == 1 else vol[:, None])
    for k in ("region_estimates", "region_errorests"):
        a = np.asarray(getattr(want, k))
        assert np.all(np.abs(got[k] - a) <= 1e-12 * scale), k
    for r in ranks[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(r["checkpoint"][k]),
                                          np.asarray(v), err_msg=k)


@pytest.mark.parametrize("d,name", [(d, n) for d, c in CASES.items()
                                    for n, case in c.items()
                                    if case.get("checkpoint")])
def test_rebalance_order_equals_reference(runs, d, name):
    """``rebalance_checkpoint`` (the port's ``_rebalance_checkpoint_for_mesh``)
    on the reference's checkpoint gives the reference's order exactly: a
    round-robin deal of the survivors sorted hottest first, whose blocks
    are the contiguous deal's."""
    ref, _ = runs[d][name]
    ck, want = ref["checkpoint"], ref["rebalanced"]
    got = rebalance_checkpoint(ck, d)
    for k in ("lows", "lengths", "region_estimates", "region_errorests"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)))
