"""A scalar-per-axis callable traced into a straight-line program, and that
program emitted as CUDA C++ for the fused kernels.

The counterpart of what Pallas does in the reference when it traces the
user's ``f_axes(*xs)`` into its kernel bodies
(``gpuintegration_tpu/ops/pallas_rule.py:86-129``,
``gpuintegration_tpu/mcubes/pallas_vegas.py:163``): the fused rule kernels
(csrc/rule_eval.cuh) and the fused sampler (csrc/vegas_sample.cuh) take a
family of their own, ``kGenerated``, whose value at a point is
``gen_integrand<T>(x)``, a device function generated here from the
callable.  The kernel bodies stay the repository's sources; only the
integrand's expression is generated, at first use (ops/cuda_build.py
``build_generated``).

* ``trace_axes(f, ndim)`` traces ``f(x0, ..., x{ndim-1})`` with
  ``torch.fx.symbolic_trace``: Python loops unroll, and what is left is a
  ``Program``, a list of steps over the axes, earlier steps and constants.
  The steps it takes are the elementwise operations listed in ``OPS``
  (``+ - * /``, unary minus, ``**`` with a number exponent, ``abs``,
  ``torch.exp log sin cos tan tanh sqrt expm1 log1p``, ``torch.minimum``,
  ``torch.maximum``, ``torch.where`` over ``< <= > >=``, ``torch.clamp``
  with number bounds, and the Tensor-method forms of the same); the
  constants Python or numpy numbers and 0-d tensors.  Anything else
  raises ValueError naming the step: ``sampler='hybrid'`` or the default
  rule route then evaluate the callable in PyTorch.
* ``evaluate(program, xs)`` is ``gen_integrand``'s plain version: the same
  steps, each the very PyTorch call the callable made with the same
  arguments, so on any tensors it gives the callable's bits.
* ``emit_cuda(program)`` writes the header: one statement a step.  A
  constant is an exact hexadecimal literal of the value PyTorch computes
  with in each type (a Python number meeting a float32 tensor is rounded to
  float32 first).  Products, sums and differences take the
  round-to-nearest intrinsics (csrc/gen_integrand.cuh), so nvcc forms no
  multiply-add that PyTorch's separate kernels do not.  A division by a
  constant multiplies by the constant's reciprocal, as PyTorch's CUDA
  kernel does with a host scalar; ``c / x`` is ``reciprocal(x) * c``, as
  ``Tensor.__rtruediv__`` computes it; ``x ** 2`` is a product.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.integrand import _positional_arity

MAX_NDIM = 16          # cuda_rule.MAX_NDIM, cuda_vegas.MAX_NDIM
KIND = 7               # kGenerated of csrc/gen_integrand.cuh

UNARY = ("exp", "log", "sin", "cos", "tan", "tanh", "sqrt", "abs", "expm1",
         "log1p", "neg")
BINARY = ("add", "sub", "mul", "div", "minimum", "maximum")
COMPARE = ("lt", "le", "gt", "ge")
OPS = UNARY + BINARY + COMPARE + ("pow", "where", "clamp")

_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.neg: "neg", operator.abs: "abs",
    operator.pow: "pow", operator.lt: "lt", operator.le: "le",
    operator.gt: "gt", operator.ge: "ge",
    torch.add: "add", torch.sub: "sub", torch.mul: "mul", torch.div: "div",
    torch.true_divide: "div", torch.neg: "neg", torch.pow: "pow",
    torch.minimum: "minimum", torch.maximum: "maximum",
    torch.where: "where", torch.clamp: "clamp",
    torch.lt: "lt", torch.le: "le", torch.gt: "gt", torch.ge: "ge",
}
_FUNCTIONS.update({getattr(torch, name): name for name in UNARY})
_METHODS = {name: name for name in UNARY + BINARY + COMPARE + ("pow",
                                                               "clamp")}
_METHODS.update({"true_divide": "div", "__add__": "add", "__sub__": "sub",
                 "__mul__": "mul", "__truediv__": "div", "__neg__": "neg",
                 "__abs__": "abs", "__pow__": "pow"})
_REFUSED = ("sampler='hybrid' (VEGAS) or rule_backend='cuda' (PAGANI) "
            "evaluate any callable in PyTorch")


@dataclasses.dataclass(frozen=True)
class Ref:
    """An operand: axis ``i`` ('x'), step ``i``'s value ('v'), or constant
    ``i`` ('c')."""
    kind: str
    index: int


@dataclasses.dataclass(frozen=True, eq=False)
class Step:
    """One elementwise operation: ``op`` (one of OPS), the operands, and
    the call that made it, repeated by ``evaluate``: ('function', f) or
    ('method', name); ``kwargs`` clamp's bounds as operands."""
    op: str
    args: tuple
    kwargs: tuple
    call: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """A traced callable: ``steps`` in order, the constants (each the
    object the callable used, a number or a 0-d tensor), the result."""
    ndim: int
    steps: tuple
    consts: tuple
    out: Ref
    name: str = "integrand"


def _refuse(what: str) -> ValueError:
    return ValueError(f"the fused kernels cannot take this callable: {what}; "
                      f"{_REFUSED}")


def _per_axis_wrapper(f: Callable, ndim: int) -> Callable:
    """A plain function of ``ndim`` named arguments calling ``f``: fx
    traces functions (not arbitrary callable objects) by their signature."""
    names = ", ".join(f"x{d}" for d in range(ndim))
    return eval(f"lambda {names}: f({names})", {"f": f})


def trace_axes(f: Callable, ndim: int, name: str | None = None) -> Program:
    """The program of the scalar-per-axis callable ``f(x0, ..., x{n-1})``
    (its required positional arity must be ``ndim``, 2 <= ndim <= 16).
    ValueError, naming what was refused, for a callable that does not
    trace into the steps of OPS over the axes and number constants."""
    if not 2 <= ndim <= MAX_NDIM:
        raise ValueError(f"ndim {ndim}: the fused kernels take 2..{MAX_NDIM} "
                         "axes")
    if _positional_arity(f) != ndim:
        raise ValueError(
            "the fused kernels need a scalar-per-axis integrand "
            f"f(x0, ..., x{ndim - 1}) of {ndim} positional arguments "
            f"(got arity {_positional_arity(f)}); {_REFUSED}")
    try:
        gm = torch.fx.symbolic_trace(_per_axis_wrapper(f, ndim))
    except Exception as e:   # noqa: BLE001 -- the user's code, any failure
        raise _refuse(f"tracing it raised {type(e).__name__}: {e} (control "
                      "flow on a value, or an argument fx cannot hold)") \
            from e
    gm.graph.eliminate_dead_code()
    refs: dict = {}
    steps: list[Step] = []
    consts: list = []
    out = None
    nplace = 0

    def const(value) -> Ref:
        if isinstance(value, bool) or not isinstance(
                value, (int, float, np.floating, np.integer, torch.Tensor)):
            raise _refuse(f"the operand {value!r} is neither a value of the "
                          "axes nor a number")
        consts.append(value)
        return Ref("c", len(consts) - 1)

    def operand(a) -> Ref:
        if isinstance(a, torch.fx.Node):
            return refs[a]
        return const(a)

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            refs[node] = Ref("x", nplace)
            nplace += 1
        elif node.op == "get_attr":
            t = gm
            for part in node.target.split("."):
                t = getattr(t, part)
            if not isinstance(t, torch.Tensor) or t.dim() != 0:
                raise _refuse(f"the constant {node.target} of shape "
                              f"{tuple(getattr(t, 'shape', ()))} (only 0-d "
                              "tensors and numbers)")
            refs[node] = const(t.detach())
        elif node.op in ("call_function", "call_method"):
            table = _FUNCTIONS if node.op == "call_function" else _METHODS
            op = table.get(node.target)
            if op is None:
                raise _refuse(f"the step {node.format_node()} (not one of "
                              f"{', '.join(OPS)})")
            kwargs = dict(node.kwargs)
            if op == "clamp":
                if len(node.args) > 1:
                    kwargs.update(zip(("min", "max"), node.args[1:]))
                args = node.args[:1]
                bad = [k for k in kwargs if k not in ("min", "max")] + [
                    k for k, v in kwargs.items()
                    if isinstance(v, torch.fx.Node)]
            else:
                args = node.args
                bad = list(kwargs)
            if op == "clamp" and not any(v is not None
                                         for v in kwargs.values()):
                bad.append("no bound")
            if bad:
                raise _refuse(f"the step {node.format_node()} (arguments "
                              f"{bad})")
            refs[node] = Ref("v", len(steps))
            steps.append(Step(
                op, tuple(operand(a) for a in args),
                tuple((k, operand(v)) for k, v in kwargs.items()
                      if v is not None),
                ("function", node.target) if node.op == "call_function"
                else ("method", node.target)))
        elif node.op == "output":
            if not isinstance(node.args[0], torch.fx.Node):
                raise _refuse(f"it returns {node.args[0]!r} (a Python number "
                              "or a structure, not one value a point)")
            out = refs[node.args[0]]
        else:
            raise _refuse(f"the node {node.format_node()}")
    program = Program(ndim, tuple(steps), tuple(consts), out,
                      name or getattr(f, "__name__", "integrand"))
    _check_types(program)
    return program


def _check_types(program: Program):
    """Each step's operands: numbers where numbers are taken, a comparison
    only as the condition of a ``where``, at least one operand a value of
    the axes (a step on constants alone would run in the constants' own
    type); the result a number."""
    is_bool = []
    for i, s in enumerate(program.steps):
        refs = list(s.args) + [r for _, r in s.kwargs]
        if not any(r.kind in ("x", "v") for r in refs):
            raise _refuse(f"step {i} ({s.op}) on constants alone")
        want = (1 if s.op in UNARY else 3 if s.op == "where" else
                1 if s.op == "clamp" else 2)
        if len(s.args) != want:
            raise _refuse(f"step {i} ({s.op}) with {len(s.args)} operands")
        for j, r in enumerate(s.args):
            boolean = r.kind == "v" and is_bool[r.index]
            if boolean != (s.op == "where" and j == 0):
                raise _refuse(f"step {i} ({s.op}): operand {j} is "
                              + ("a comparison" if boolean else
                                 "not a comparison"))
        if s.op == "pow" and s.args[1].kind != "c":
            raise _refuse(f"step {i}: pow with a tensor exponent")
        is_bool.append(s.op in COMPARE)
    out = program.out
    if out.kind == "c" or (out.kind == "v" and is_bool[out.index]):
        raise _refuse("its result is not a value computed from the axes")


def _call(step: Step, args, kwargs):
    kind, target = step.call
    if kind == "function":
        return target(*args, **kwargs)
    return getattr(args[0], target)(*args[1:], **kwargs)


def evaluate(program: Program, xs) -> torch.Tensor:
    """``gen_integrand``'s plain version: the program on the axes ``xs``
    (a sequence of ``ndim`` tensors of one shape), each step the callable's
    own PyTorch call on the same operands, so the callable's bits."""
    if len(xs) != program.ndim:
        raise ValueError(f"{len(xs)} axes for a program of {program.ndim}")
    vals: list = []

    def get(r: Ref):
        return xs[r.index] if r.kind == "x" else (
            vals[r.index] if r.kind == "v" else program.consts[r.index])

    for s in program.steps:
        vals.append(_call(s, [get(r) for r in s.args],
                          {k: get(r) for k, r in s.kwargs}))
    return get(program.out)


@dataclasses.dataclass(frozen=True, eq=False)
class TracedIntegrand:
    """A traced per-axis callable as the port's entry points take it: a
    batched integrand over (..., ndim) (``evaluate`` on the last axis'
    planes), with the ``program`` from which the fused kernels' library is
    generated and ``kind`` the generated family's id."""
    program: Program
    name: str
    kind: int = KIND

    @property
    def ndim(self) -> int:
        return self.program.ndim

    def __call__(self, x):
        return evaluate(self.program, x.unbind(-1))


def traced(f: Callable, ndim: int, name: str | None = None
           ) -> TracedIntegrand:
    """``trace_axes(f, ndim)`` as a ``TracedIntegrand`` named ``name`` (the
    callable's ``__name__`` by default)."""
    name = name or getattr(f, "__name__", "integrand")
    return TracedIntegrand(trace_axes(f, ndim, name), name)


# ---------------------------------------------------------------------------
# The CUDA header

def _const_value(c) -> float:
    """A constant as the float64 value PyTorch holds: a number's own, a 0-d
    tensor's in its dtype."""
    if isinstance(c, torch.Tensor):
        return float(c.item())
    return float(c)


def _hex(value: float, dtype) -> str:
    """An exact hexadecimal literal of ``value`` rounded to ``dtype``
    (np.float64 or np.float32), infinities and NaN spelled out."""
    v = dtype(value)
    suffix = "f" if dtype is np.float32 else ""
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)" if suffix else \
            "__longlong_as_double(0x7ff8000000000000LL)"
    if math.isinf(v):
        big = "__int_as_float(0x7f800000)" if suffix else \
            "__longlong_as_double(0x7ff0000000000000LL)"
        return big if v > 0 else f"(-{big})"
    return float(v).hex() + suffix


def const_literal(value: float) -> str:
    """``gen_const<T>(double literal, float literal)`` of a constant: the
    value PyTorch computes with in float64 and in float32."""
    return (f"gen_const<T>({_hex(value, np.float64)}, "
            f"{_hex(value, np.float32)})")


def _recip_literal(value: float) -> str:
    """The reciprocal of a host scalar as PyTorch's CUDA division takes it:
    1 / c computed in the working type."""
    with np.errstate(divide="ignore"):
        r64 = np.float64(1.0) / np.float64(value)
        r32 = np.float32(1.0) / np.float32(value)
    return f"gen_const<T>({_hex(r64, np.float64)}, {_hex(r32, np.float32)})"


_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">="}


def emit_cuda(program: Program) -> str:
    """The header of ``program``: ``kGenNdim`` and ``template <typename T>
    __device__ __forceinline__ T gen_integrand(const T* x)``, one statement
    a step.  csrc/gen_integrand.cuh holds the helpers it calls."""
    consts = [_const_value(c) for c in program.consts]

    def arg(r: Ref) -> str:
        if r.kind == "x":
            return f"x[{r.index}]"
        if r.kind == "v":
            return f"v{r.index}"
        return const_literal(consts[r.index])

    lines = []
    for i, s in enumerate(program.steps):
        a = [arg(r) for r in s.args]
        kw = {k: arg(r) for k, r in s.kwargs}
        kind = "bool" if s.op in COMPARE else "T"
        if s.op in _CMP:
            expr = f"({a[0]} {_CMP[s.op]} {a[1]})"
        elif s.op == "div" and s.args[0].kind == "c":
            expr = f"gen_mul(gen_recip({a[1]}), {a[0]})"
        elif s.op == "div" and s.args[1].kind == "c":
            expr = f"gen_mul({a[0]}, {_recip_literal(consts[s.args[1].index])})"
        elif s.op in BINARY:
            expr = f"gen_{s.op}({a[0]}, {a[1]})"
        elif s.op in UNARY:
            expr = f"gen_{s.op}({a[0]})"
        elif s.op == "pow":
            expr = _pow(a[0], _const_value(program.consts[s.args[1].index]))
        elif s.op == "where":
            expr = f"({a[0]} ? {a[1]} : {a[2]})"
        elif set(kw) == {"min", "max"}:
            expr = f"gen_clamp({a[0]}, {kw['min']}, {kw['max']})"
        else:   # clamp with one bound
            (bound, b), = kw.items()
            expr = f"gen_clamp_{bound}({a[0]}, {b})"
        lines.append(f"  const {kind} v{i} = {expr};")
    body = "\n".join(lines)
    return (
        f"// Generated by gpuintegration_torch/ops/integrand_gen.py from the\n"
        f"// traced callable {program.name!r} over {program.ndim} axes:\n"
        f"// {len(program.steps)} steps, {len(program.consts)} constants.\n"
        "#pragma once\n"
        "#include \"gen_integrand.cuh\"\n\n"
        f"constexpr int kGenNdim = {program.ndim};\n\n"
        "template <typename T>\n"
        "__device__ __forceinline__ T gen_integrand(const T* x) {\n"
        f"{body}\n"
        f"  return {arg(program.out)};\n"
        "}\n")


def _pow(a: str, e: float) -> str:
    """x ** e as PyTorch's CUDA kernel computes it for a number exponent."""
    if e == 2.0:
        return f"gen_mul({a}, {a})"
    if e == 3.0:
        return f"gen_mul(gen_mul({a}, {a}), {a})"
    if e == 0.5:
        return f"gen_sqrt({a})"
    if e == -1.0:
        return f"gen_recip({a})"
    if e == -2.0:
        return f"gen_recip(gen_mul({a}, {a}))"
    return f"gen_pow({a}, {const_literal(e)})"


@functools.lru_cache(maxsize=64)
def header(program: Program) -> str:
    """``emit_cuda(program)``, once per program (the last 64 programs): the
    key of its library (ops/cuda_build.py ``load_generated``)."""
    return emit_cuda(program)


def program_ops(program: Program) -> int:
    """Arithmetic operations of one value: one a step (exp, sin, cos and
    the other transcendentals as ONE, as the kernels' bounds count them),
    a power by its products, clamp as two; comparisons and selections
    count one.  A lower bound of what the kernel executes."""
    n = 0
    for s in program.steps:
        if s.op == "pow":
            e = _const_value(program.consts[s.args[1].index])
            n += 2 if e in (3.0, -2.0) else 1
        elif s.op == "clamp":
            n += max(len(s.kwargs), 1)
        else:
            n += 1
    return n
