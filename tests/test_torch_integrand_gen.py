"""The tracer and emitter of the generated integrand family
(``gpuintegration_torch/ops/integrand_gen.py``) on the CPU.

Each callable of the table is built twice from the same constants, once in
jnp (the JAX package's convention, what its Pallas kernels trace) and once
in torch.  ``evaluate(trace_axes(f))`` must be the torch callable bit for
bit, in f64 and f32, on seeded numpy inputs; the two builds agree to
roundoff (f64 1e-12, f32 64 ulps of the value or of the largest value: the
packages' exp/cos kernels differ in the last bits, and XLA may contract a
sum of products, whose rounding an exponent of some hundreds amplifies).
The header's constants must parse back to the bits PyTorch computes with;
each refused form raises ValueError naming ``sampler='hybrid'``."""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.ops import integrand_gen as G

C_NP = np.float64(0.7)               # a numpy-scalar closure
C_TORCH = torch.tensor(0.3, dtype=torch.float64)   # a 0-d tensor closure
C_JNP = jnp.asarray(0.3, dtype=jnp.float64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the port's other test files set it: the
    test workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f4_axes(exp):
    def f4(x0, x1, x2, x3, x4, x5, x6, x7):
        s = 0.0
        for u in (x0, x1, x2, x3, x4, x5, x6, x7):
            s = s + 625.0 * (u - 0.5) ** 2
        return exp(-s)
    return f4


def g3(exp):
    def g(x, y, z):
        return exp(-25.0 * ((x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2))
    return g


def g6(exp):
    def g(x0, x1, x2, x3, x4, x5):
        s = 0.0
        for x in (x0, x1, x2, x3, x4, x5):
            s = s + (x - 0.5) ** 2
        return exp(-25.0 * s)
    return g


def cos_sum(cos):
    def c(x0, x1, x2, x3, x4):
        return cos(x0 + x1 + x2 + x3 + x4)
    return c


def where_clamp_torch(x, y, z):
    body = torch.where(x < 0.5, torch.clamp(y, 0.1, 0.9), torch.maximum(y, z))
    return body / 3.0 + 1.0 / (z + 1.0) + torch.sqrt(x) ** 3 - abs(y - z)


def where_clamp_jnp(x, y, z):
    body = jnp.where(x < 0.5, jnp.clip(y, 0.1, 0.9), jnp.maximum(y, z))
    return body / 3.0 + 1.0 / (z + 1.0) + jnp.sqrt(x) ** 3 - abs(y - z)


def np_closure(exp):
    def n(x, y):
        return exp(x * C_NP - y) * C_NP + x ** 1.5
    return n


def tensor_closure_torch(x, y):
    return torch.log1p(x * C_TORCH) + y / C_TORCH - y.clamp(min=0.2)


def tensor_closure_jnp(x, y):
    return jnp.log1p(x * C_JNP) + y / C_JNP - jnp.maximum(y, 0.2)


CASES = {
    "f4_axes": (8, f4_axes(torch.exp), f4_axes(jnp.exp)),
    "g3": (3, g3(torch.exp), g3(jnp.exp)),
    "g6": (6, g6(torch.exp), g6(jnp.exp)),
    "cos_sum": (5, cos_sum(torch.cos), cos_sum(jnp.cos)),
    "where_clamp": (3, where_clamp_torch, where_clamp_jnp),
    "numpy_scalar": (2, np_closure(torch.exp), np_closure(jnp.exp)),
    "tensor_0d": (2, tensor_closure_torch, tensor_closure_jnp),
}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _inputs(ndim, dtype, seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (ndim, n)).astype(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_is_the_callable_bit_for_bit(name, dtype):
    ndim, f, f_jnp = CASES[name]
    xs_np = _inputs(ndim, dtype)
    xs = [torch.from_numpy(a) for a in xs_np]
    program = G.trace_axes(f, ndim)
    want = f(*xs)
    got = G.evaluate(program, xs)
    assert got.dtype == want.dtype == DTYPES[dtype]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the batched form the entry points take, over (..., ndim), against
    # the callable's own batched form (make_integrand) on the same strided
    # planes: PyTorch's CPU kernels may round a strided plane otherwise
    # than a contiguous one
    t = G.traced(f, ndim)
    assert t.ndim == ndim and t.kind == G.KIND
    stacked = torch.stack(xs, dim=-1)
    np.testing.assert_array_equal(_bits(t(stacked)),
                                  _bits(make_integrand(f, ndim)[0](stacked)))
    # the jnp build of the same callable, to roundoff
    ref = np.asarray(f_jnp(*[jnp.asarray(a) for a in xs_np]))
    if dtype == "float64":
        np.testing.assert_allclose(want.numpy(), ref, rtol=1e-12,
                                   atol=1e-300)
    else:
        eps = np.finfo(np.float32).eps
        np.testing.assert_allclose(want.numpy(), ref, rtol=64 * eps,
                                   atol=64 * eps * np.abs(ref).max())


_LITERAL = re.compile(r"gen_const<T>\(([^,()]+), ([^,()]+)\)")


def _pairs(header: str) -> set:
    """The (f64 bits, f32 bits) of every constant literal of a header."""
    out = set()
    for d, f in _LITERAL.findall(header):
        assert f.endswith("f")
        v64, v32 = float.fromhex(d), float.fromhex(f[:-1])
        assert np.float32(v32) == v32           # an exact f32 literal
        out.add((np.float64(v64).view(np.uint64).item(),
                 np.float32(v32).view(np.uint32).item()))
    return out


def _bits_of(v64: float, v32) -> tuple:
    return (np.float64(v64).view(np.uint64).item(),
            np.float32(v32).view(np.uint32).item())


@pytest.mark.parametrize("name", list(CASES))
def test_header_constants_parse_back(name):
    """Every constant of the program appears as the literal pair of its
    value in f64 and rounded to f32; a divisor also as its reciprocal in
    each type (1/c computed in that type), as PyTorch's CUDA division by a
    host scalar takes it."""
    ndim, f, _ = CASES[name]
    program = G.trace_axes(f, ndim)
    header = G.emit_cuda(program)
    assert f"constexpr int kGenNdim = {ndim};" in header
    assert header.count("const T v") + header.count("const bool v") == \
        len(program.steps)
    pairs = _pairs(header)
    pow_exponents = {s.args[1].index for s in program.steps if s.op == "pow"}
    divisors = {s.args[1].index for s in program.steps
                if s.op == "div" and s.args[1].kind == "c"}
    numerators = {s.args[0].index for s in program.steps
                  if s.op == "div" and s.args[0].kind == "c"}
    for i, c in enumerate(program.consts):
        v = float(c.item()) if isinstance(c, torch.Tensor) else float(c)
        if i in divisors:
            assert _bits_of(1.0 / v, np.float32(1.0) / np.float32(v)) \
                in pairs
        elif i in pow_exponents and v in (2.0, 3.0, 0.5, -1.0, -2.0):
            continue                       # products, sqrt or reciprocals
        else:
            assert _bits_of(v, np.float32(v)) in pairs, (i, v)
        assert i not in numerators or _bits_of(v, np.float32(v)) in pairs


def test_header_forms():
    """x ** 2 is a product, c / x a reciprocal times c, x / c a product by
    1/c, and sums and products the round-to-nearest helpers."""
    program = G.trace_axes(lambda x, y: 2.0 / x + y / 4.0 + (x - y) ** 2, 2)
    header = G.emit_cuda(program)
    assert "gen_mul(gen_recip(x[0]), gen_const<T>(0x1.0000000000000p+1, " \
        "0x1.0000000000000p+1f))" in header
    assert "gen_mul(x[1], gen_const<T>(0x1.0000000000000p-2, " \
        "0x1.0000000000000p-2f))" in header
    assert re.search(r"gen_mul\((v\d+), \1\)", header)
    assert "gen_sub(x[0], x[1])" in header and "gen_add(" in header
    assert "pow" not in header
    assert G.program_ops(program) == len(program.steps)
    # an axis itself is a result
    program = G.trace_axes(lambda x, y: y, 2)
    assert "return x[1];" in G.emit_cuda(program)
    y = torch.rand(8, dtype=torch.float64)
    assert G.evaluate(program, [torch.rand(8, dtype=torch.float64), y]) is y
    # a general exponent goes to pow with its constant
    header = G.emit_cuda(G.trace_axes(lambda x, y: x ** 1.5 + y, 2))
    assert "gen_pow(x[0], gen_const<T>(0x1.8000000000000p+0, " \
        "0x1.8000000000000p+0f))" in header


def test_method_forms_trace():
    """The Tensor-method forms of the same operations trace and evaluate
    as the callable."""
    def f(x, y, z):
        return (x.exp().mul(y).add(z.sin()).sub(x.neg().abs())
                .div(y.cos().add(2.0)).clamp(min=-1.0, max=3.0)
                .minimum(z.sqrt()).maximum(y.tanh()) + x.log1p().expm1()
                + z.log().tan() * 1e-3 + x.pow(2))
    xs = [torch.from_numpy(a) for a in _inputs(3, "float64", seed=2)]
    program = G.trace_axes(f, 3)
    np.testing.assert_array_equal(_bits(G.evaluate(program, xs)),
                                  _bits(f(*xs)))
    assert {s.op for s in program.steps} >= {
        "exp", "mul", "add", "sin", "sub", "neg", "abs", "div", "cos",
        "clamp", "minimum", "sqrt", "maximum", "tanh", "log1p", "expm1",
        "log", "tan", "pow"}


def _control_flow(x, y):
    if x > 0.5:
        return x
    return y


REFUSED = {
    "reduction": (lambda x, y: torch.sum(x) + y, "torch.sum"),
    "indexing": (lambda x, y: x[0] + y, "getitem"),
    "control_flow": (_control_flow, "TraceError"),
    "vector_constant": (lambda x, y: x * torch.tensor([1.0, 2.0]) + y,
                        "of shape"),
    "unknown_op": (lambda x, y: torch.sigmoid(x) + y, "sigmoid"),
    "number_result": (lambda x, y: 0.0, "Python number"),
    "comparison_as_number": (lambda x, y: (x < y) * 1.0 + y,
                             "comparison"),
    "tensor_exponent": (lambda x, y: x ** y, "tensor exponent"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusals_name_hybrid(name):
    f, what = REFUSED[name]
    with pytest.raises(ValueError, match="sampler='hybrid'") as e:
        G.trace_axes(f, 2)
    assert what in str(e.value)


def test_arity_and_ndim_refusals():
    with pytest.raises(ValueError, match="scalar-per-axis"):
        G.trace_axes(lambda x: x[..., 0], 3)
    with pytest.raises(ValueError, match="scalar-per-axis"):
        G.trace_axes(lambda x, y: x + y, 3)
    with pytest.raises(ValueError, match="2..16"):
        G.trace_axes(lambda x: x, 1)
    names = ", ".join(f"x{d}" for d in range(17))
    with pytest.raises(ValueError, match="2..16"):
        G.trace_axes(eval(f"lambda {names}: x0"), 17)


def test_special_constants_spelt_out():
    """Infinities and NaN have no hexadecimal literal: they are spelt as
    bit patterns."""
    header = G.emit_cuda(G.trace_axes(
        lambda x, y: torch.clamp(x, max=math.inf) + torch.where(
            y < 0.5, y, math.nan), 2))
    assert "__int_as_float(0x7f800000)" in header
    assert "__longlong_as_double(0x7ff8000000000000LL)" in header


def test_generated_library_target():
    """A generated library is named by the digest of the flags, the
    sources, csrc's headers and its generated header: one library a
    header, whose header file lies under build/gen, never in csrc."""
    from gpuintegration_torch.ops import cuda_build
    h1 = G.emit_cuda(G.trace_axes(CASES["g3"][1], 3))
    h2 = G.emit_cuda(G.trace_axes(CASES["where_clamp"][1], 3))
    t1 = cuda_build._target(cuda_build.GEN_SOURCE, h1)
    assert t1 == cuda_build._target(cuda_build.GEN_SOURCE, h1)
    assert t1 != cuda_build._target(cuda_build.GEN_SOURCE, h2)
    assert t1 != cuda_build._target(cuda_build.GEN_SOURCE)
    assert t1.parent == cuda_build.BUILD_DIR
    assert t1.name.startswith("libgen_integrand_")
    assert cuda_build.GEN_DIR.parent == cuda_build.BUILD_DIR
    assert not list(cuda_build.CSRC.glob("*" + t1.stem[-16:] + "*"))
    # the header is emitted once a program
    t = G.traced(CASES["g3"][1], 3)
    assert G.header(t.program) is G.header(t.program)

