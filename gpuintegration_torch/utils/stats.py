"""Small host-side statistics helpers.

Currently: the chi-squared probability attached to Monte-Carlo results,
matching the surface of cubacpp's ``integration_result::prob``
(reference: cubacpp/cubacpp/integration_result.hh:85-99, which forwards
CUBA's ``prob`` — "the chi-square probability that ``error`` is NOT a
reliable estimate of the true integration error"; CUBA manual
convention: values close to 1 flag inconsistent per-iteration results).

Pure NumPy on host scalars — these run once per integration result, so
there is nothing to fuse or jit.
"""

from __future__ import annotations

import math
import warnings

__all__ = ["chi2_prob", "gammainc_lower"]


def gammainc_lower(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x).

    Series expansion for x < a + 1, Lentz continued fraction for the
    upper function otherwise (the classic numerically-stable split).
    Accurate to ~1e-14 for the half-integer ``a`` the chi-squared CDF
    needs; validated against scipy.special.gammainc in
    tests/test_aux_subsystems.py.
    """
    if x < 0.0 or a <= 0.0:
        raise ValueError("gammainc_lower requires a > 0 and x >= 0")
    if x == 0.0:
        return 0.0
    lg = math.lgamma(a)
    if x < a + 1.0:
        # power series: P(a,x) = x^a e^-x / Gamma(a) * sum x^n / (a)_{n+1}
        term = 1.0 / a
        total = term
        n = a
        for _ in range(500):
            n += 1.0
            term *= x / n
            total += term
            if abs(term) < abs(total) * 1e-16:
                break
        else:
            # NR's gser raises here; a silent partial sum would be an
            # unflagged wrong answer for huge ``a``
            warnings.warn(
                f"gammainc_lower series did not converge in 500 "
                f"iterations (a={a!r}, x={x!r}); result is a partial sum",
                RuntimeWarning, stacklevel=2)
        return total * math.exp(-x + a * math.log(x) - lg)
    # continued fraction for Q(a,x) (modified Lentz)
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-16:
            break
    else:
        warnings.warn(
            f"gammainc_lower continued fraction did not converge in 500 "
            f"iterations (a={a!r}, x={x!r}); result is approximate",
            RuntimeWarning, stacklevel=2)
    q = math.exp(-x + a * math.log(x) - lg) * h
    return 1.0 - q


def chi2_prob(chi2_total: float, dof: float) -> float:
    """Chi-squared CDF at ``chi2_total`` with ``dof`` degrees of freedom.

    This is the ``prob`` CUBA attaches to VEGAS/Suave/Cuhre results
    (cubacpp/integration_result.hh:88 "the chisquared probability; see
    CUBA docs"): the probability that a chi-squared variable would be
    SMALLER than the observed inter-iteration scatter, so values near 1
    mean the iterations disagree far more than their error bars allow
    and ``errorest`` is untrustworthy.  Returns 0.0 when there are no
    degrees of freedom (fewer than two accumulated iterations).
    """
    if dof <= 0.0 or not math.isfinite(chi2_total) or chi2_total <= 0.0:
        return 0.0
    return gammainc_lower(0.5 * dof, 0.5 * chi2_total)
