"""gpuintegration_torch: the PyTorch/CUDA port of gpuintegration_tpu.

PAGANI adaptive cubature on one NVIDIA GPU: the host loops of
``Workspace.integrate`` (scalar and vector-valued integrands, f: (...,
ndim) -> (...,) or (..., ncomp)) in plain PyTorch, with the Genz-Malik
rule evaluation in hand-written CUDA kernels (ops/cuda_rule.py): a Genz
family fused into one kernel (csrc/rule_eval.cu), any other torch callable
between a points kernel and a contraction kernel (csrc/rule_split.cu; a
vector's values through the components contraction).
``Workspace.integrate_to_convergence`` carries deep tolerances past one
run's pool wall (checkpoint-resume rounds, then a partitioned continuation
whose state ``utils.checkpoint.ContinuationState`` saves; stage times by
``utils.profiling.StageTimer``).  The reference's integrand zoo is
``models.misc``, the Genz families ``models.genz``.  m-CUBES/VEGAS Monte Carlo: ``mcubes.integrate``
(also ``mcubes.vegas``, ``mcubes.simple_integrate``, ``mcubes.VegasState``)
with its sampler, histogram, bin-resolve and edge-lookup kernels in CUDA
(mcubes/cuda_vegas.py, mcubes/cuda_lookup.py, csrc/vegas_*.cu).
Differentiable estimates (``torch.func.grad`` / ``vmap`` over integrand
parameters) on a fixed PAGANI mesh or a frozen VEGAS grid: ``diff``
(``fixed_mesh_integral``, ``frozen_grid_estimate``, ``mesh_from_checkpoint``,
``train_grid``); the frozen grid's bin edges come from the edge-lookup
kernel.  The JAX
package ``gpuintegration_tpu`` is the reference; this package imports torch
and numpy only, never JAX.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from gpuintegration_torch.types import IntegrationResult, Volume, unit_volume
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.pagani.workspace import Workspace
from gpuintegration_torch import mcubes
from gpuintegration_torch.diff import (
    fixed_mesh_integral, frozen_grid_estimate, mesh_from_checkpoint,
    train_grid)

__all__ = [
    "IntegrationResult",
    "Volume",
    "unit_volume",
    "make_integrand",
    "Workspace",
    "mcubes",
    "fixed_mesh_integral",
    "frozen_grid_estimate",
    "mesh_from_checkpoint",
    "train_grid",
]

__version__ = "0.1.0"
