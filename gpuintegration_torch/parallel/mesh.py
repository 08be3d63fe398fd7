"""The 1-D device mesh and its collectives (PyTorch port of
``gpuintegration_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with one axis,
named ``REGION_AXIS``, over the whole default process group: rank k owns
shard k of the PAGANI region pool and the k-th range of VEGAS chunks.  The
algorithms need all-reduces of a few scalars, of VEGAS's (ndim, nbins)
histogram and, at a checkpoint, of the pool's rows; nothing else crosses
ranks.

Every collective here is ``dist.all_reduce`` (SUM or MAX; a minimum rides
in a MAX as its negation, as the classifier's floor does): NCCL
refuses two ranks on one card, and gloo takes CUDA tensors in
``all_reduce`` and ``broadcast`` only, so an all-reduce runs under NCCL on
one card a rank and under gloo on the CPU or with several ranks on one card
(gloo copies a CUDA tensor through the host itself).  An all-gather of one
count a rank is the SUM of a one-hot vector (``gather_counts``).  All ranks
receive the same bits.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

REGION_AXIS = "r"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` (two ranks
    on one card both get ``cuda:0``), or the CPU.  The local rank is
    ``LOCAL_RANK`` where a launcher (``torchrun``) sets it, else the global
    rank."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA card and none is "
                           "available; pass device_type='cpu'")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named (``REGION_AXIS``,) over the initialised default
    group, every rank in it (``n_devices``, if given, must be the world
    size).  On ``cuda`` the rank's card (``rank_device``) becomes the
    current device first."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: start "
            "the ranks with torchrun (and call "
            "torch.distributed.init_process_group) or with "
            "gpuintegration_torch.parallel.launch.run_on_ranks")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a group of "
                         f"{world} ranks: the mesh spans the whole group")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return DeviceMesh(device_type, list(range(world)),
                      mesh_dim_names=(REGION_AXIS,))


def check_mesh(mesh) -> DeviceMesh | None:
    """``mesh`` as an entry point takes it: None, or a 1-D ``DeviceMesh``
    over the whole default group (``make_mesh``)."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(
            "mesh= takes a 1-D torch.distributed.device_mesh.DeviceMesh "
            "over the default process group (parallel.mesh.make_mesh()), "
            f"not {type(mesh).__name__}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; it must span all")
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shard: its card on a CUDA mesh."""
    return rank_device(mesh.device_type)


def backend(mesh: DeviceMesh) -> str:
    """The group's backend, 'nccl' or 'gloo': only an NCCL all-reduce can be
    captured into a CUDA graph."""
    return str(dist.get_backend(mesh.get_group()))


def deal(n: int, d: int) -> list[int]:
    """The contiguous deal of ``n`` regions over ``d`` shards: shard k takes
    n // d + (k < n % d) of them, in order (reference
    ``pagani/workspace.py:1457``)."""
    return [n // d + (1 if k < n % d else 0) for k in range(d)]


def _all_reduce(mesh: DeviceMesh, t: torch.Tensor, op) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group())
    return out


def all_reduce_sum(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """The SUM over the ranks of ``t``, a new tensor on every rank."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def all_reduce_max(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def gather_counts(mesh: DeviceMesh, count: int,
                  device: torch.device | None = None) -> np.ndarray:
    """Every rank's ``count`` as a (D,) int64 array on every rank: the SUM
    of a one-hot f64 vector (exact below 2^53; the reference's all-gather
    of per-shard counts)."""
    device = device or mesh_device(mesh)
    onehot = torch.zeros(mesh.size(), dtype=torch.float64, device=device)
    onehot[mesh.get_local_rank()] = float(count)
    return all_reduce_sum(mesh, onehot).cpu().numpy().astype(np.int64)
