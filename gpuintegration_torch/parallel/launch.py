"""Spawn D ranks, each with the default process group initialised, and
collect what each returns: the PyTorch stand-in for what ``make_mesh(D)``
gives the JAX package inside one process.

    from gpuintegration_torch.parallel.launch import run_on_ranks
    results = run_on_ranks(fn, 2, backend="gloo", device_type="cpu",
                           args=(spec,))

``fn(rank, *args)`` runs on every rank (it builds its mesh with
``parallel.mesh.make_mesh(device_type=...)``); the results come back in
rank order.  ``fn`` must be importable by name from a module that a fresh
process can import (a spawned rank re-imports it), and its arguments and
result must pickle.  The group is initialised from a ``file://`` store in a
temporary directory, so no port is opened.  A rank that raises fails the
call with that rank's traceback; a rank that is not done within ``timeout``
seconds fails it too, and every rank still running is killed, so a
collective that one rank never joins ends in an error, not a hang.

On cards, ``torchrun --nproc-per-node=D script.py`` with
``torch.distributed.init_process_group("nccl")`` and ``make_mesh()`` in the
script is the usual launch; this function is for tests and for several
ranks on one card (gloo).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, backend, store, fn, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=600))
        try:
            out = fn(rank, *args)
            if dist.get_backend() == "nccl":
                torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))


def _failures(results, failed: dict, world_size: int) -> str:
    """The tracebacks of the ranks that fail within a second of the first:
    a rank that raises makes its peers' collectives fail too, and their
    reports may come first."""
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            rank, ok, payload = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if not ok:
            failed[rank] = payload
    return "\n".join(f"run_on_ranks: rank {r} of {world_size} raised:\n{tb}"
                     for r, tb in sorted(failed.items()))


def run_on_ranks(fn, world_size: int, *, backend: str = "gloo",
                 device_type: str = "cpu", args: tuple = (),
                 timeout: float = 600.0) -> list:
    """``fn(rank, *args)`` on ``world_size`` spawned ranks of a group of
    ``backend`` ('gloo' or 'nccl'); returns their results in rank order.
    ``device_type`` is only checked here ('nccl' needs 'cuda'); ``fn``
    passes it to ``make_mesh``.  Raises RuntimeError with the traceback of
    every rank that failed (those failing within a second of the first),
    or TimeoutError after ``timeout`` seconds."""
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend needs device_type='cuda'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, backend, store, fn, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_on_ranks: ranks {sorted(set(range(world_size)) - set(out))} "
                        f"of {world_size} not done within {timeout:g} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"run_on_ranks: rank {dead[0]} died with exit "
                            f"code {procs[dead[0]].exitcode} and no report")
                    continue
                if not ok:
                    raise RuntimeError(_failures(
                        results, {rank: payload}, world_size))
                out[rank] = payload
        finally:
            for p in procs:
                if p.is_alive() and len(out) < world_size:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
