"""Whole PAGANI runs on a mesh (``Workspace(ndim, mesh=m)``) against the JAX
package's mesh at the same D, on the CPU under gloo: the JAX package's own
``tests/test_sharded.py`` cases.

The JAX side runs ``Workspace(..., mesh=make_mesh(D))`` on the conftest's 8
virtual CPU devices in this process while the port's D gloo ranks
(``parallel.launch.run_on_ranks``, ``tools/mesh_cases.py``) run the same
cases, every case of a D in one spawn.  Each case must give the same status,
iterations, regions, finished regions and neval, with estimates within 4
ulps and errorests within 1e-6 of their value plus 64 ulps of the estimate
(they are sums of cancelling null-rule differences, whose roundoff scales
with the estimate, ``test_torch_fused.py``'s reading; the reference's own
mesh-against-one-device test holds them at 1e-9,
``test_mesh_fused_growth_parity``), and every rank the same result bits.  The cases: F1 4D at 1e-7; F4 3D at 1e-7 (fused bursts
and bucket growth: three overflow exits; the reference's 4D case at 1e-4,
a million regions, is phase 24's 8D run's work on the card); F5 3D crease at 1e-7 (the cut fractions through the
fused carry and the shard-local split); NaN (status 1); D = 3 deals
unevenly.  The crease run sums 21 iterations' partials, and at D = 2 the
reference's own mesh estimate sits 3 ulps from its one-device run (the
shards' sums reassociate the pool's): there the estimates are held within
4 ulps plus that gap, which the case measures (``one_device``; ROADMAP
C).  The classifier, checkpoints, the continuation and vectors are in
``test_torch_mesh_continuation.py``."""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.parallel.mesh import make_mesh
from gpuintegration_tpu.utils.profiling import StageTimer as JaxStageTimer
from gpuintegration_tpu.utils.recorder import (
    IterationRecorder as JaxIterationRecorder)
from gpuintegration_torch.parallel.launch import run_on_ranks
from gpuintegration_torch.tools import mesh_cases

ULPS = 4
ERR_RTOL = 1e-6
CASES = {
    2: {
        "f4_growth": dict(what="pagani",
                          integrand=("genz", "f4_gaussian", 3, {"a": 5.0}),
                          ndim=3, ws=dict(chunk_size=256),
                          kw=dict(epsrel=1e-7, epsabs=1e-40)),
        "crease": dict(what="pagani",
                       integrand=("genz", "f5_c0_continuous", 3,
                                  {"a": 10.0, "b": 0.37}),
                       ndim=3, ws=dict(chunk_size=256),
                       kw=dict(epsrel=1e-7, epsabs=1e-40, crease_split=True,
                               max_iterations=60),
                       one_device=True),
        # the mesh loop's recorder rows (the reference's workspace.py:
        # 1714-1723), from the all-reduced scalars on every rank
        "recorder": dict(what="pagani",
                         integrand=("genz", "f3_corner_peak", 3, {}),
                         ndim=3, ws=dict(chunk_size=256),
                         kw=dict(epsrel=1e-6, epsabs=1e-40), record=True),
    },
    3: {
        "f1": dict(what="pagani", integrand=("genz", "f1_oscillatory", 4, {}),
                   ndim=4, ws=dict(chunk_size=1024),
                   kw=dict(epsrel=1e-7, epsabs=1e-40)),
        "nan": dict(what="pagani", integrand=("nan", 3), ndim=3,
                    ws=dict(chunk_size=256),
                    kw=dict(epsrel=1e-9, epsabs=1e-40, max_iterations=5)),
    },
}


def jax_integrand(spec):
    """The JAX package's callable of a ``mesh_cases`` spec."""
    if spec[0] == "genz":
        return getattr(jax_genz, spec[1])(spec[2], **spec[3])
    if spec[0] == "nan":
        def nanf(x):
            return jnp.where(x[..., 0] > 0.5, jnp.nan, 1.0)

        nanf.ndim = spec[1]
        return nanf
    members = [jax_integrand(m) for m in spec[1]]

    def fv(x):
        return jnp.stack([g(x) for g in members], axis=-1)

    fv.ndim = members[0].ndim
    return fv


def jax_case(case, mesh):
    """One case on the reference's mesh: the result, and the checkpoint
    (and its rebalance) or the continuation's stage names where asked."""
    ws = JaxWorkspace(case["ndim"], mesh=mesh, **case.get("ws", {}))
    f = jax_integrand(case["integrand"])
    out = {}
    kw = dict(case["kw"])
    if case.get("record"):
        kw["recorder"] = JaxIterationRecorder()
    if case["what"] == "convergence":
        timer = JaxStageTimer()
        res = ws.integrate_to_convergence(f, stage_timer=timer, **case["kw"])
        out["stages"] = sorted(timer.report())
    else:
        res = ws.integrate(f, **kw)
        if case.get("record"):
            out["rows"] = kw["recorder"].rows
        if case.get("one_device"):
            out["one_device"] = mesh_cases.outcome(JaxWorkspace(
                case["ndim"], **case.get("ws", {})).integrate(
                    f, **case["kw"]))
    out["result"] = mesh_cases.outcome(res)
    if case.get("checkpoint"):
        ck = ws.make_checkpoint()
        out["checkpoint"] = ck
        out["rebalanced"] = ws._rebalance_checkpoint_for_mesh(ck)
    return out


def mesh_runs(cases_by_d):
    """{D: {name: (the reference's outcome, the ranks' outcomes)}}: the
    port's ranks of every D run while this process runs the reference."""
    out = {}
    with ThreadPoolExecutor(len(cases_by_d)) as ex:
        futures = {d: ex.submit(run_on_ranks, mesh_cases.run_cases, d,
                                args=(cases,), timeout=600)
                   for d, cases in cases_by_d.items()}
        refs = {d: {name: jax_case(case, make_mesh(d))
                    for name, case in cases.items()}
                for d, cases in cases_by_d.items()}
        for d, fut in futures.items():
            ranks = fut.result()
            out[d] = {name: (refs[d][name], [r[name] for r in ranks])
                      for name in cases_by_d[d]}
    return out


def _values(r, name):
    v = r[name + "s"] if r.get(name + "s") is not None else r[name]
    return np.atleast_1d(np.asarray(v, np.float64))


def assert_same_run(ref, ranks):
    """The discrete outcomes equal, estimates within ULPS (plus the
    reference's own mesh-against-one-device gap where the case measured
    it), errorests within ERR_RTOL, and every rank's result the same
    bits."""
    got = ranks[0]["result"]
    want = ref["result"]
    key = ("status", "iters", "nregions", "nFinishedRegions", "neval")
    assert tuple(got[k] for k in key) == tuple(want[k] for k in key)
    est, est_ref = _values(got, "estimate"), _values(want, "estimate")
    finite = np.isfinite(est_ref)
    np.testing.assert_array_equal(np.isfinite(est), finite)
    spacing = np.spacing(np.abs(est_ref[finite]))
    ulps = np.abs(est - est_ref)[finite] / spacing
    limit = ULPS
    if "one_device" in ref:
        limit = ULPS + np.abs(
            _values(ref["one_device"], "estimate")[finite]
            - est_ref[finite]) / spacing
    assert np.all(ulps <= limit), (ulps, limit)
    err, err_ref = _values(got, "errorest"), _values(want, "errorest")
    assert np.all(np.abs(err - err_ref)[finite]
                  <= ERR_RTOL * np.abs(err_ref[finite]) + 64 * spacing)
    for r in ranks[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(r["result"][k]),
                                          np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def runs():
    return mesh_runs(CASES)


@pytest.mark.parametrize("d,name", [(d, n) for d, c in CASES.items()
                                    for n in c])
def test_mesh_run_matches_reference_mesh(runs, d, name):
    ref, ranks = runs[d][name]
    assert_same_run(ref, ranks)
    got = ranks[0]
    if name == "nan":
        assert got["result"]["status"] == 1
    else:
        assert got["result"]["status"] == 0
    if name in ("f4_growth", "crease"):
        # the fused phase ran, and left on a bucket overflow at least once
        assert got["fused_stats"]["bursts"] > 0 and 1 in got["fused_exits"]
        # on the CPU every iteration is eager; nothing is counted as a
        # backend's refusal to capture there
        assert got["fused_stats"]["uncaptured"] == 0


def test_mesh_recorder_rows(runs):
    """On the mesh every rank records the same rows, the reference's mesh
    rows: the same iterations, regions and finished regions, estimates
    within ULPS."""
    ref, ranks = runs[2]["recorder"]
    rows = ranks[0]["rows"]
    assert rows and len(rows) == len(ref["rows"]) == ranks[0]["result"][
        "iters"]
    def untimed(rs):
        return [{k: v for k, v in row.items() if k != "time_ms"}
                for row in rs]

    for r in ranks[1:]:
        assert untimed(r["rows"]) == untimed(rows)
    for a, b in zip(rows, ref["rows"]):
        for k in ("it", "nregions", "fnregions"):
            assert a[k] == b[k], k
        for k in ("estimate", "errorest", "festimate", "ferrorest"):
            assert abs(a[k] - b[k]) <= ULPS * np.spacing(
                abs(b["estimate"])), k
    # a recorder turns the fused phase off
    assert ranks[0]["fused_stats"]["bursts"] == 0
