"""Multi-device PAGANI and VEGAS over a ``torch.distributed`` mesh (PyTorch
port of ``gpuintegration_tpu/parallel``).

The JAX package drives a 1-D ``jax.sharding.Mesh`` from one process through
``shard_map``.  Here every device is a process (a rank): each rank builds
the same ``Workspace(ndim, mesh=m)`` or makes the same ``vegas(...,
mesh=m)`` call, holds its shard of the region pool or its range of VEGAS
chunks, runs the single-device kernels on it, and returns the same
replicated result.  Every collective is an all-reduce of a small tensor
(``mesh.all_reduce_sum``, ``all_reduce_max``, ``gather_counts``), so the same
code runs under gloo on the CPU, under gloo with several ranks on one card,
and under NCCL on one card per rank.

``mesh.make_mesh`` makes the mesh over an initialised default group;
``launch.run_on_ranks`` spawns the ranks and initialises the group for
tests and scripts; ``sharded`` holds the shard-local pipeline stages.
"""
