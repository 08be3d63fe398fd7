"""The CUDA rule kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_rule.py
"""
import numpy as np
import pytest
import torch

from gpuintegration_torch.models import genz
from gpuintegration_torch.ops import kernel_check, rule_eval


def _pool(ndim, cap, seed):
    """Random sub-boxes of a non-unit volume [gl, gl + gr] inside the
    positive orthant (F3's pole 1 + sum a_i x_i = 0 stays outside)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 0.5, (ndim, cap)),
            rng.uniform(0.01, 0.5, (ndim, cap)),
            rng.uniform(0.0, 0.5, ndim), rng.uniform(0.5, 1.5, ndim))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """Runs on a CUDA card only: the kernel against the plain version on a
    blocked 5D pool, every family, with the tolerances and the near-tie
    rule of kernel_check.check_against_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ndim, cap, n = 5, 2048, 1500
    lows, lengths, gl, gr = _pool(ndim, cap, 1)
    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in (lows, lengths, gl, gr)]
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    for g in genz.genz_suite(ndim):
        kernel_check.check_against_plain(g, tables, *t, n=n, blocked=True,
                                         min_agree=0.0)
