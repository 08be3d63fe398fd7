"""m-CUBES / VEGAS Monte Carlo integration on one NVIDIA GPU (PyTorch port
of ``gpuintegration_tpu/mcubes``; public surface).

Mirrors the reference's cuda_mcubes namespace entry points
(reference: cuda/mcubes/vegasT.cuh:1023-1135 integrate/simple_integrate).
``vegas`` stays the submodule (full-control entry point lives at
``vegas.vegas``).
"""
from gpuintegration_torch.mcubes import vegas  # noqa: F401  (submodule)
from gpuintegration_torch.mcubes.vegas import (  # noqa: F401
    VegasState,
    integrate,
    simple_integrate,
)

__all__ = ["VegasState", "integrate", "simple_integrate", "vegas"]
