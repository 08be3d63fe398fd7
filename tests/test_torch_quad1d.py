"""1-D quadrature (gpuintegration_torch/ops/quad1d.py) against the JAX
package's (gpuintegration_tpu/ops/quad1d.py and its tests
test_quad1d_gsl.py, test_quad1d_heuristics.py), on the CPU.

* The tables EQUAL: ``gk_pair`` for keys 1-6, ``cc_rule``, the GK15 pin;
  their degree of exactness.
* ``qng``, ``qag`` for each key, ``cquad``, ``qawo``, ``qawf`` on the
  reference's own cases: status, neval and nregions EQUAL, the estimate
  and errorest to roundoff (the rule sums add the points in another order:
  1e-12 relative plus 1e-15 of max(|estimate|, 1), the cases' |f| being
  O(1) on O(1) intervals); the closed forms as the reference's tests hold them.
* ``_wynn_epsilon`` EQUAL on fixed sequences."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuintegration_tpu.ops import quad1d as JQ
from gpuintegration_torch.ops import quad1d as TQ

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("key", sorted(TQ.KEY_TO_GAUSS_N))
def test_gk_tables_equal_and_exact(key):
    n = TQ.KEY_TO_GAUSS_N[key]
    assert TQ.KEY_TO_GAUSS_N == JQ.KEY_TO_GAUSS_N
    for got, ref in zip(TQ.gk_pair(n), JQ.gk_pair(n)):
        np.testing.assert_array_equal(got, ref)
    xk, wk, wg = TQ.gk_pair(n)
    for deg in range(0, 2 * n):
        truth = 2.0 / (deg + 1) if deg % 2 == 0 else 0.0
        assert np.sum(wg * xk ** deg) == pytest.approx(truth, abs=1e-12)
    for deg in range(0, 3 * n + 2):
        truth = 2.0 / (deg + 1) if deg % 2 == 0 else 0.0
        assert np.sum(wk * xk ** deg) == pytest.approx(truth, abs=1e-11)


def test_gk15_pin():
    np.testing.assert_array_equal(TQ._XGK15, JQ._XGK15)
    np.testing.assert_array_equal(TQ._WGK15, JQ._WGK15)
    xk, wk, _ = TQ.gk_pair(7)
    np.testing.assert_allclose(xk[xk >= -1e-15][::-1], TQ._XGK15, atol=1e-12)
    np.testing.assert_allclose(wk[xk >= -1e-15][::-1], TQ._WGK15, atol=1e-12)


@pytest.mark.parametrize("m", [4, 8, 16, 32, 64])
def test_cc_rule_equal_exact_nested(m):
    x, w = TQ.cc_rule(m)
    rx, rw = JQ.cc_rule(m)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(w, rw)
    for deg in range(0, m + 1):
        truth = 2.0 / (deg + 1) if deg % 2 == 0 else 0.0
        assert np.sum(w * x ** deg) == pytest.approx(truth, abs=1e-12)
    if m >= 8:
        np.testing.assert_allclose(x[::2], TQ.cc_rule(m // 2)[0], atol=1e-14)


def _pair(expr):
    """The same integrand in both packages: ``expr(x, lib)``."""
    return (lambda x: expr(x, torch)), (lambda x: expr(x, jnp))


A = 200.0
KINK = (2 - math.exp(-A * 0.37) - math.exp(-A * 0.63)) / A

# name: (method, integrand, positional args, keyword args, closed form)
CASES = {
    "qng exp": ("qng", lambda x, m: m.exp(x), (0.0, 1.0),
                dict(epsrel=1e-10), math.e - 1.0),
    "qng x^-1/2 flagged": ("qng", lambda x, m: 1.0 / m.sqrt(m.abs(x) + 1e-300),
                           (0.0, 1.0), dict(epsrel=1e-10), None),
    "qag polynomial": ("qag", lambda x, m: x ** 7 - 3 * x ** 2 + 1,
                       (0.0, 2.0), dict(epsrel=1e-12),
                       2 ** 8 / 8 - 2 ** 3 + 2),
    "qag kink": ("qag", lambda x, m: m.exp(-A * m.abs(x - 0.37)), (0.0, 1.0),
                 dict(epsrel=1e-10, max_intervals=4096), KINK),
    "qag kink 1e-7": ("qag", lambda x, m: m.exp(-A * m.abs(x - 0.37)),
                      (0.0, 1.0), dict(epsrel=1e-7), KINK),
    "qag odd": ("qag", lambda x, m: x, (-1.0, 1.0),
                dict(epsrel=1e-10, epsabs=1e-14), 0.0),
    "qag x^-1/2 capped": ("qag",
                          lambda x, m: 1.0 / m.sqrt(m.abs(x) + 1e-300),
                          (0.0, 1.0), dict(epsrel=1e-14, max_intervals=64),
                          None),
    "cquad exp": ("cquad", lambda x, m: m.exp(x), (0.0, 1.0),
                  dict(epsrel=1e-10), math.e - 1.0),
    "cquad sqrt": ("cquad", lambda x, m: m.sqrt(m.abs(x)), (0.0, 1.0),
                   dict(epsrel=1e-8), 2.0 / 3.0),
    "cquad stiff": ("cquad", lambda x, m: 1.0 / (1e-2 + x ** 2), (-1.0, 1.0),
                    dict(epsrel=1e-9), 2.0 * math.atan(10.0) / 0.1),
    "cquad cos 8x": ("cquad", lambda x, m: m.cos(8.0 * x), (0.0, 1.0),
                     dict(epsrel=1e-10), math.sin(8.0) / 8.0),
    "qawo x sin": ("qawo", lambda x, m: x, (0.0, 1.0, 10.0 * math.pi),
                   dict(sin_or_cos="sin", epsrel=1e-10),
                   -math.cos(10.0 * math.pi) / (10.0 * math.pi)),
    "qawo cos": ("qawo", lambda x, m: m.exp(-x), (0.0, 3.0, 7.0),
                 dict(sin_or_cos="cos", epsrel=1e-10),
                 (1 - math.exp(-3.0) * (math.cos(21.0) - 7 * math.sin(21.0)))
                 / 50.0),
    "qawf damped sin": ("qawf", lambda x, m: m.exp(-x), (0.0, 2.0),
                        dict(sin_or_cos="sin", epsabs=1e-10), 2.0 / 5.0),
    "qawf algebraic": ("qawf", lambda x, m: 1.0 / (1.0 + x * x), (0.0, 1.0),
                       dict(sin_or_cos="cos", epsabs=1e-8),
                       math.pi / (2.0 * math.e)),
    "qawf peaked cycle": ("qawf", lambda x, m: 1.0 / (
        1.0 + (50.0 * (x - 4.0)) ** 2) * m.exp(-0.05 * x), (0.0, 1.0),
        dict(sin_or_cos="sin", epsabs=1e-8), -0.03810737676239791),
}
for _k in range(1, 7):
    CASES[f"qag key {_k} cos 50x"] = (
        "qag", lambda x, m: m.cos(50 * x), (0.0, 1.0),
        dict(epsrel=1e-10, key=_k), math.sin(50.0) / 50.0)


def _same(got, ref, scale):
    assert (got.status, got.neval, got.nregions) == (
        ref.status, ref.neval, ref.nregions)
    for a, b in ((got.estimate, ref.estimate), (got.errorest, ref.errorest)):
        assert abs(a - b) <= 1e-12 * abs(b) + 1e-15 * scale, (a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_against_reference(case):
    method, expr, args, kw, truth = CASES[case]
    f_t, f_j = _pair(expr)
    ref = getattr(JQ, method)(f_j, *args, **kw)
    got = getattr(TQ, method)(f_t, *args, **kw, **CPU)
    # the absolute scale: every case's |f| is O(1) on an O(1) interval,
    # the odd one's integral 0
    scale = max(abs(ref.estimate), 1.0)
    _same(got, ref, scale)
    # the odd integrand's integral is 0: epsrel cannot certify it, and
    # epsabs lies below the 50 eps resabs floor (status 1 in both)
    assert got.status == (1 if truth is None or case == "qag odd" else 0)
    if truth is not None:
        tol = kw.get("epsrel", 0.0) * 10 * abs(truth) + 10 * got.errorest
        assert abs(got.estimate - truth) <= max(tol, 1e-13)


def test_qag_is_integrate1d_and_keys():
    assert TQ.qag is TQ.integrate1d
    with pytest.raises(ValueError):
        TQ.integrate1d(lambda x: x, 0.0, 1.0, key=7, **CPU)
    r1 = TQ.qag(lambda x: torch.cos(50 * x), 0.0, 1.0, epsrel=1e-10, key=1,
                **CPU)
    r6 = TQ.qag(lambda x: torch.cos(50 * x), 0.0, 1.0, epsrel=1e-10, key=6,
                **CPU)
    assert r6.nregions < r1.nregions


def test_cquad_escalation_reuses_nested_nodes():
    calls = {"n": 0, "batches": 0}

    def f(x):
        calls["n"] += x.numel()
        calls["batches"] += 1
        return torch.cos(8.0 * x)

    r = TQ.cquad(f, 0.0, 1.0, epsrel=1e-10, **CPU)
    assert r.status == 0 and r.nregions == 1
    assert calls["n"] == r.neval == 33
    # one integrand call a round
    assert calls["batches"] == 3


def test_qawf_and_qawo_arguments():
    with pytest.raises(ValueError):
        TQ.qawf(lambda x: x, 0.0, omega=0.0, **CPU)
    with pytest.raises(ValueError):
        TQ.qawo(lambda x: x, 0.0, 1.0, 1.0, sin_or_cos="tan", **CPU)


def test_eval_gk_roundoff_floor_and_padding():
    lo = torch.tensor([0.0, 0.0], dtype=torch.float64)
    ln = torch.tensor([2.0 * np.pi, 0.0], dtype=torch.float64)
    e, r = TQ._eval_gk(lambda x: 1e16 * torch.cos(x), lo, ln, 30)
    re, rr = JQ._eval_gk(lambda x: 1e16 * jnp.cos(x), jnp.asarray(lo.numpy()),
                         jnp.asarray(ln.numpy()), 30)
    assert float(r[0]) >= 50 * np.finfo(np.float64).eps * 1e16
    # a zero-length padding interval: 0 estimate and error in both
    assert float(e[1]) == float(r[1]) == float(re[1]) == float(rr[1]) == 0.0
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=1e-12)


@pytest.mark.parametrize("seq", ["log2", "leibniz", "short", "constant"])
def test_wynn_epsilon_equal(seq):
    s = {"log2": np.cumsum([(-1.0) ** k / (k + 1) for k in range(12)]),
         "leibniz": np.cumsum([4 * (-1.0) ** k / (2 * k + 1)
                               for k in range(9)]),
         "short": np.array([1.0]),
         "constant": np.ones(7)}[seq]
    assert TQ._wynn_epsilon(list(s)) == JQ._wynn_epsilon(list(s))
    if seq == "log2":
        assert TQ._wynn_epsilon(list(s))[0] == pytest.approx(math.log(2.0),
                                                             abs=1e-8)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: TQ.qng(torch.exp, 0.0, 1.0),
                 lambda: TQ.qag(torch.exp, 0.0, 1.0),
                 lambda: TQ.cquad(torch.exp, 0.0, 1.0),
                 lambda: TQ.qawo(torch.exp, 0.0, 1.0, 3.0),
                 lambda: TQ.qawf(torch.exp, 0.0, 3.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
