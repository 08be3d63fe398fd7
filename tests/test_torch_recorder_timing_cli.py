"""The port's utilities against the JAX package's, on the CPU: the iteration
recorder (``utils/recorder.py``, ``Workspace.integrate(recorder=)``), the
region dump, the CLI (``python -m gpuintegration_torch.cli``, which drives
``utils/timing.py``) and the continuation log
(``GPUINT_TPU_CONTINUATION_LOG``).

Recorder rows of one F3 3D host-loop run: the same ``it``, ``nregions`` and
``fnregions`` as the reference's rows, estimates within 64 ulps (the
host loops' own agreement, ``test_torch_workspace.py``).  The CLI: each
subcommand's CSV header and exit code equal the reference's at tiny
sizes (the ``backend`` column names the port's route, the reference's
'xla').  The continuation log: as many lines as the reference prints, the
same fields, and the same discrete values (slice, n_in, depth, status,
requeued, queued).  The mesh loop's rows are held in
``test_torch_mesh_pagani.py`` (its D = 2 ranks already run)."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from gpuintegration_tpu import Workspace as JaxWorkspace
from gpuintegration_tpu import cli as jax_cli
from gpuintegration_tpu.models import genz as jax_genz
from gpuintegration_tpu.utils import recorder as jax_recorder
from gpuintegration_torch import Workspace, cli
from gpuintegration_torch.models import genz
from gpuintegration_torch.utils import recorder, timing

ULPS = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_columns_and_csv_text():
    assert recorder.IterationRecorder.COLUMNS == \
        jax_recorder.IterationRecorder.COLUMNS
    rows = [dict(it=0, estimate=1.5, errorest=0.25, festimate=0.0,
                 ferrorest=0.0, nregions=16, fnregions=0, time_ms=1.0),
            dict(it=1, estimate=1.25, nregions=32)]
    texts = []
    for mod in (recorder, jax_recorder):
        buf = io.StringIO()
        with mod.IterationRecorder(buf) as rec:
            for r in rows:
                rec.record(**r)
        texts.append(buf.getvalue())
        assert rec.rows == rows
    assert texts[0] == texts[1]


def test_recorder_rows_match_the_reference_host_loop():
    jrec = jax_recorder.IterationRecorder()
    ref = JaxWorkspace(3, chunk_size=1024).integrate(
        jax_genz.f3_corner_peak(3), epsrel=1e-6, epsabs=1e-40, fused=False,
        recorder=jrec)
    rec = recorder.IterationRecorder()
    ws = Workspace(3, chunk_size=1024, device="cpu")
    got = ws.integrate(genz.f3_corner_peak(3), epsrel=1e-6, epsabs=1e-40,
                       recorder=rec)
    assert (got.status, got.iters, got.nregions) == \
        (ref.status, ref.iters, ref.nregions)
    assert len(rec.rows) == len(jrec.rows) == got.iters
    for a, b in zip(rec.rows, jrec.rows):
        assert set(a) == set(b) == set(recorder.IterationRecorder.COLUMNS)
        for k in ("it", "nregions", "fnregions"):
            assert a[k] == b[k], k
        for k in ("estimate", "errorest", "festimate", "ferrorest"):
            assert abs(a[k] - b[k]) <= ULPS * np.spacing(abs(b["estimate"]))
    # a recorder turns the fused phase off: the fused default took it here
    from gpuintegration_torch.pagani import fused_loop
    fused_loop.reset_stats()
    ws.integrate(genz.f3_corner_peak(3), epsrel=1e-6, epsabs=1e-40,
                 recorder=recorder.IterationRecorder())
    assert fused_loop.stats["bursts"] == 0
    ws.integrate(genz.f3_corner_peak(3), epsrel=1e-6, epsabs=1e-40)
    assert fused_loop.stats["bursts"] > 0


def test_vector_loop_records_component_0():
    def fv(x):
        return torch.stack([genz.f4_gaussian(3, a=5.0)(x),
                            genz.f3_corner_peak(3)(x)], dim=-1)

    fv.ndim = 3
    rec = recorder.IterationRecorder()
    res = Workspace(3, chunk_size=256, device="cpu").integrate(
        fv, epsrel=1e-4, epsabs=1e-40, recorder=rec)
    assert [r["it"] for r in rec.rows] == list(range(res.iters))
    assert rec.rows[-1]["estimate"] == pytest.approx(res.estimates[0],
                                                     rel=1e-12)


def test_dump_regions_csv_same_text():
    ws = Workspace(3, chunk_size=256, device="cpu")
    ws.integrate(genz.f4_gaussian(3, a=5.0), epsrel=1e-3, epsabs=1e-40,
                 fused=False)
    lows, lengths, n, blocked = ws.final_pool
    got, want = io.StringIO(), io.StringIO()
    recorder.dump_regions_csv(lows, lengths, n, got, blocked=blocked)
    jax_recorder.dump_regions_csv(lows.numpy(), lengths.numpy(), n, want,
                                  blocked=blocked)
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) == n + 1


CLI_CASES = {
    "pagani": ["pagani", "--integrand", "f4_gaussian", "--ndim", "3"],
    "mcubes": ["mcubes", "--integrand", "f4_gaussian", "--ndim", "3",
               "--ncall", "1e4", "--iters", "8", "--adjust-iters", "4"],
    "suave": ["suave", "--integrand", "f4_gaussian", "--ndim", "3",
              "--nnew", "256", "--epsrel", "1e-2"],
    "ladder": ["ladder", "--integrand", "f4_gaussian", "--ndim", "3",
               "--floor", "1e-4"],
    "scan": ["scan", "--ndim", "3", "--values", "1:3:3", "--partitions",
             "2", "--grad"],
    "profile": ["profile", "--integrand", "f4_gaussian", "--ndim", "3",
                "--splits", "2:4", "--repeats", "2"],
}


def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_headers_and_exit_codes(name):
    argv = CLI_CASES[name]
    rc_ref, ref = _main(jax_cli.main, argv)
    rc, got = _main(cli.main, argv + ["--device", "cpu"])
    assert rc == rc_ref
    assert got[0] == ref[0]
    assert len(got) == len(ref)
    fields = len(ref[0].split(","))
    for line in got[1:]:
        if not line.startswith("#"):
            assert len(line.split(",")) == fields
    if "backend" in got[0]:
        col = got[0].split(",").index("backend")
        assert {line.split(",")[col] for line in got[1:]
                if not line.startswith("#")} == {"torch"}


def test_cli_unknown_integrand_and_header_constants():
    with pytest.raises(SystemExit, match="unknown integrand"):
        cli.main(["pagani", "--integrand", "nope", "--device", "cpu"])
    from gpuintegration_tpu.utils import timing as jax_timing
    assert timing.PAGANI_CSV_HEADER == jax_timing.PAGANI_CSV_HEADER
    assert timing.MCUBES_CSV_HEADER == jax_timing.MCUBES_CSV_HEADER


def test_call_cubature_rules_backends():
    """The three backends give the same rows' fields; 'fused' takes a
    per-axis callable only."""
    def g(x, y, z):
        return torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2 + z))

    rows = {b: timing.call_cubature_rules(g, 3, splits_per_dim=[2, 3],
                                          repeats=1, backend=b,
                                          device="cpu")
            for b in timing.BACKENDS}
    for b, r in rows.items():
        assert [(x["splits_per_dim"], x["regions"], x["padded_capacity"],
                 x["feval"]) for x in r] == [(2, 8, 128, 77),
                                            (3, 27, 128, 77)], b
        assert all(x["evals_per_sec"] > 0 for x in r)
    with pytest.raises(ValueError, match="scalar-per-axis"):
        timing.call_cubature_rules(genz.f4_gaussian(3), 3,
                                   splits_per_dim=[2], backend="fused",
                                   device="cpu")
    with pytest.raises(ValueError, match="backend"):
        timing.call_cubature_rules(g, 3, backend="pallas", device="cpu")


_LINE = re.compile(r"\[continuation\] slice (\d+)/(\d+): (.*)")
CONT = dict(ndim=3, a=15.0, b=0.3, epsrel=1e-9,
            ws=dict(max_pool_regions=1024, chunk_size=128))


def _log_lines(capfd, run):
    run()
    err = capfd.readouterr().err
    return [m for m in map(_LINE.match, err.splitlines()) if m]


def test_continuation_log_matches_the_reference(capfd, monkeypatch):
    monkeypatch.setenv("GPUINT_TPU_CONTINUATION_LOG", "1")
    nd, kw = CONT["ndim"], dict(epsrel=CONT["epsrel"], epsabs=1e-40,
                                fused=False)
    ref = _log_lines(capfd, lambda: JaxWorkspace(
        nd, **CONT["ws"]).integrate_to_convergence(
            jax_genz.f4_gaussian(nd, a=CONT["a"], b=CONT["b"]), **kw))
    got = _log_lines(capfd, lambda: Workspace(
        nd, device="cpu", **CONT["ws"]).integrate_to_convergence(
            genz.f4_gaussian(nd, a=CONT["a"], b=CONT["b"]), **kw))
    assert len(ref) >= 3 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.group(1, 2) == r.group(1, 2)
        gf = dict(kv.split("=") for kv in g.group(3).split())
        rf = dict(kv.split("=") for kv in r.group(3).split())
        assert list(gf) == list(rf)
        for k in ("n_in", "depth", "status", "requeued", "queued"):
            assert gf[k] == rf[k], k
    # without the variable nothing is printed
    monkeypatch.delenv("GPUINT_TPU_CONTINUATION_LOG")
    assert not _log_lines(capfd, lambda: Workspace(
        nd, device="cpu", **CONT["ws"]).integrate_to_convergence(
            genz.f4_gaussian(nd, a=CONT["a"], b=CONT["b"]), **kw))
