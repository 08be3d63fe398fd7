"""Integrand protocol and adapters (PyTorch port of
``gpuintegration_tpu/integrand.py``).

Canonical form: a *batched* callable ``f(x)`` mapping a tensor of shape
(..., ndim) to (...).  Forms accepted by ``make_integrand``:

* scalar-per-axis functions ``f(x0, ..., x{n-1})`` (cubacpp style,
  arity.hh:36-75); the arity gives ndim;
* single-argument batched functions; ndim must be supplied or carried as
  an ``ndim`` attribute (``models.genz.GenzIntegrand``).

A callable may also return (..., ncomp): a vector-valued integrand
(cubacpp's ``array<double,N>``), whose components share one point set;
``deduce_ncomp`` reads ncomp from one probe call.
"""
from __future__ import annotations

import inspect
from typing import Callable

import torch


def _positional_arity(f: Callable) -> int | None:
    """Count REQUIRED positional parameters; None when not
    introspectable/variadic.  Parameters with defaults are configuration
    (``lambda x, sigma=0.1: ...``), not integration axes."""
    try:
        target = f if inspect.isfunction(f) or inspect.ismethod(f) else f.__call__
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return None
    count = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is inspect.Parameter.empty:
                count += 1
        elif p.kind == p.VAR_POSITIONAL:
            return None
    return count


def _broadcast_scalar(out, x: torch.Tensor) -> torch.Tensor:
    """A Python-number result (``lambda x, y: 0.0``) is a constant
    integrand: broadcast it to the batch shape.  A rank-0 *tensor* is
    almost always an accidental whole-batch reduction (``torch.sum(x**2)``
    missing ``dim=-1``), which would integrate a garbage per-chunk
    constant, so it is refused."""
    if isinstance(out, (int, float)):
        return torch.full(x.shape[:-1], float(out), dtype=x.dtype,
                          device=x.device)
    if out.dim() == 0:
        raise ValueError(
            "integrand returned a rank-0 tensor -- this reduces over the "
            "batch axis too (did you mean dim=-1 in a sum/prod?). Expected "
            "one value per point, shape (...,) for the (..., ndim) batch.")
    return out


def make_integrand(f: Callable, ndim: int | None = None) -> tuple[Callable, int]:
    """Normalise ``f`` to batched form; return (batched_f, ndim)."""
    if ndim is None and hasattr(f, "ndim"):
        ndim = int(f.ndim)
    arity = _positional_arity(f)
    if arity is not None and arity > 1:
        if ndim is not None and ndim != arity:
            raise ValueError(
                f"integrand takes {arity} positional args but ndim={ndim}")

        def batched(x):
            return _broadcast_scalar(f(*[x[..., d] for d in range(arity)]), x)

        return batched, arity
    if ndim is None:
        raise ValueError(
            "cannot deduce ndim from a single-argument integrand; "
            "pass ndim explicitly")

    def batched1(x):
        return _broadcast_scalar(f(x), x)

    return batched1, ndim


def deduce_ncomp(batched_f: Callable, ndim: int, dtype: torch.dtype,
                 device) -> int:
    """Number of components the batched integrand returns per point, from
    one probe call on three points: 1 for (...,) scalars, N for (..., N)
    vectors (the runtime analogue of cubacpp's return-type deduction,
    cubacpp/integrand_traits.hh:81-93)."""
    probe = torch.full((3, ndim), 0.5, dtype=dtype, device=device)
    shape = tuple(batched_f(probe).shape)
    if shape == (3,):
        return 1
    if len(shape) == 2 and shape[0] == 3:
        return int(shape[1])
    raise ValueError(
        f"integrand maps (3, {ndim}) -> {shape}; expected (3,) for a "
        f"scalar integrand or (3, ncomp) for a vector-valued one")
