"""gpuintegration_torch: the PyTorch/CUDA port of gpuintegration_tpu.

PAGANI adaptive cubature on one NVIDIA GPU: the scalar host loop of
``Workspace.integrate`` in plain PyTorch, with the Genz-Malik rule
evaluation as a hand-written CUDA kernel (ops/cuda_rule.py,
csrc/rule_eval.cu).  The JAX package ``gpuintegration_tpu`` is the
reference; this package imports torch and numpy only, never JAX.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from gpuintegration_torch.types import IntegrationResult, Volume, unit_volume
from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.pagani.workspace import Workspace

__all__ = [
    "IntegrationResult",
    "Volume",
    "unit_volume",
    "make_integrand",
    "Workspace",
]

__version__ = "0.1.0"
