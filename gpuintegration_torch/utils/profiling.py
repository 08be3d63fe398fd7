"""Profiling hooks (PyTorch port of ``gpuintegration_tpu/utils/profiling.py``).

The reference's tracing apparatus (std::chrono per-stage timers
Workspace.cuh:159-352, cudaEvent pairs cudaTimerUtil.h, NVTX ranges in
demos) on PyTorch: ``torch.profiler`` traces, named spans, and wall-clock
stage timers that wait for the card.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is a
    card, the device; on exit it is written to ``log_dir`` as a Chrome
    trace (view with Perfetto).  Yields the profiler, whose
    ``key_averages()`` sum the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class StageTimer:
    """Wall-clock stage timer (the cudaEvent-pair analogue).

    A ``stage()`` that ran work on the card waits for it at exit
    (``torch.cuda.synchronize``), so the time covers the device's work,
    not its asynchronous launch.  Times of stages of the same name add
    up."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, outfile=None):
        """The stages, longest first, as {name: seconds}; with ``outfile``
        also printed there as ``name,milliseconds`` lines."""
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        if outfile is not None:
            for name, t in rows:
                print(f"{name},{t * 1e3:.3f}", file=outfile)
        return dict(rows)


def annotate(name: str):
    """A named span in the trace (the NVTX range analogue)."""
    return torch.profiler.record_function(name)
