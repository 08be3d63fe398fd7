"""The port's host rule tables are bitwise equal to the JAX package's."""
import numpy as np
import pytest

from gpuintegration_tpu.ops import rule_eval as jax_rule_eval
from gpuintegration_torch.ops import rule_eval as torch_rule_eval


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("ndim", range(2, 11))
def test_rule_tables_bitwise(ndim, dtype_name):
    ref = jax_rule_eval.rule_tables(ndim, dtype_name)
    got = torch_rule_eval.rule_tables(ndim, dtype_name)
    assert (got.ndim, got.feval, got.feval_padded) == (
        ref.ndim, ref.feval, ref.feval_padded)
    for name in ("gen", "wts", "orbit_wts", "scale", "norm"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype == np.dtype(dtype_name), name
        assert a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.orbit_bounds == ref.orbit_bounds
    assert got.ratio == ref.ratio
