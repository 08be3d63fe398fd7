"""The CUDA rule kernel held against its plain PyTorch version.

The two compute the same rule sums in another order, and the kernel forms
each coordinate with one fused multiply-add where the plain version rounds
twice, so they differ by roundoff.  Each output is held to that roundoff's
own scale in its region, counted in ulps (``finfo.eps``) of the working
type:

* each value f_p = f(x_p) is uncertain by a few ulps of
  ``u_p = |f_p| + sum_d |df/dx_d| (|c_d| + |g_pd l_d|)`` (the coordinate
  x_pd = c_d - g_pd l_d is rounded, and f can amplify that: F4's
  exponent is 2 a^2 |x - u| |x| ~ 600 times more sensitive than f); the
  derivative comes from autograd in the working type, and from an f64
  pass where that backward over- or underflows (F2 in f32 from 9D on),
  u_p and the scales below then in f64;
* estimate: ``s_est = vol * jacobian * sum_p |w0_p| u_p``, the rounding
  bound of the degree-7 sum;
* errorest: ``s_err = 5 max_r s_r`` with ``s_r = vol * jacobian * max_s
  norm[s,r] (sum_p |w_{r+1},p| u_p + |scale[s,r]| sum_p |w_r,p| u_p)``,
  the rounding bound of the null-rule term e_r of the error model.

A region passes when ``|kernel - plain| <= rtol |plain| + ULPS * eps * s +
finfo.tiny``.  ULPS is set a small factor above the largest excess read on
the card (PERF.md).  The error model's gate (``rule_eval.gate_errors``) is
a step: where one of its two comparisons lies within the roundoff of the
terms it compares, the kernel may take the other branch, and its err is
then held to that branch of the plain version's terms.  Everywhere else a
kernel that gates, scales or normalises differently fails.

A split_dim mismatch must be a near-tie: the two fourth differences within
TIE ulps of the largest of the 4n+1 values they are made of.

The split route (``cuda_rule.cuda_apply_rule_split``, any integrand) is
held tighter where it can be: its points kernel must write the plain
version's points bit for bit and in their layout, so the callable's values
are EQUAL too; est and err are held to the limits above (only the orbit
sums are taken in another order); split_dim is read against the same
near-tie rule, and its exact agreement is counted
(``check_split_against_plain``).

The components contraction (a vector integrand's values, ``cuda_rule.
split_contract_components``) is read the same way component by component
against ``rule_eval.rule_outputs_vector``: each component's est and err in
ulps of its own rounding scales, the gate's ties resolved as above; its
split_dim, one axis from all components' fourth differences, must be
EQUAL in every region (``check_components``).

The split fraction (csrc/split_frac.cuh) rounds every operation as the
plain version does: its fraction and split_dim must be EQUAL to
``rule_eval.split_fraction`` on the same values.  The standalone kernel
(``cuda_rule.split_frac``) is held so on the card and on a CPU copy
(``check_split_frac``, on ``crease_stencils``' values).  The folded forms,
which a crease run takes, are held so on the values their kernel read
(``check_folded_frac``): the fused kernels' on the collinear values they
write out when asked (``kept``), from the split axes of the same launch
without the fraction, whose est and err must have the same bits
(``check_fused_frac``); the contractions' on the values they were given,
and to the standalone kernel's bits too (``check_contract_frac``).  The
kept values themselves are held to the callable's at rule points 0 .. 4n
(``check_kept_values``): each within rtol |f_p| + ULPS["value"] ulps of
its u_p, or, where a point lies within its coordinates' rounding of a
discontinuity, of the callable at the point moved by that rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.ops import cuda_rule, rule_eval
from gpuintegration_torch.pagani.region_pool import block_mask

READINGS = ("abs_est", "est", "err", "err_direct", "gate_tie", "err_resolved",
            "tie_gap")

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
ULPS = {"est": 1.0, "err": 1.0, "value": 4.0}
TIE = 256.0


def value_scales(integrand, tables: rule_eval.RuleTables, lows, lengths,
                 global_lo, global_range):
    """(f_p (C, feval), u_p (C, feval)) of the module docstring for C
    regions, the derivative by autograd."""
    _, _, vals, u = _points_values_scales(integrand, tables, lows, lengths,
                                          global_lo, global_range)
    return vals, u


def _points_values_scales(integrand, tables: rule_eval.RuleTables, lows,
                          lengths, global_lo, global_range,
                          head: int | None = None):
    """At rule points 0 .. head - 1 (every point where None) of C regions:
    (x (C, P, ndim), the coordinates' rounding scales |c_d| + |g_pd l_d|
    (C, P, ndim), f_p (C, P), u_p (C, P))."""
    batched, _ = make_integrand(integrand, tables.ndim)
    x, center_g, len_g = rule_eval.rule_points(tables, lows, lengths,
                                               global_lo, global_range)
    gen, _, _, _ = rule_eval.device_tables(tables.ndim, lows.dtype,
                                           lows.device)
    x, gen = x[:, :head].detach().requires_grad_(True), gen[:head]
    with torch.enable_grad():
        vals = batched(x).to(lows.dtype)
        (grad,) = torch.autograd.grad(vals.sum(), x)
    size = (center_g.T.abs()[:, None, :]
            + (gen[None, :, :] * len_g.T[:, None, :]).abs())
    vals = vals.detach()
    bad = ~torch.isfinite(grad)
    if lows.dtype != torch.float64 and bool(bad.any()):
        # the working type's backward can over- or underflow in an
        # intermediate where the derivative is finite (F2's 1 / prod
        # squares a prod of ~1e-25 from 9D on in f32), and the derivative
        # itself can pass the type's largest value: those entries from an
        # f64 pass at the same points, and u_p in f64, so that it stays
        # finite wherever the value is
        x64 = x.detach().double().requires_grad_(True)
        with torch.enable_grad():
            (g64,) = torch.autograd.grad(batched(x64).double().sum(), x64)
        grad = torch.where(bad, g64, grad.double())
        size = size.double()
    return (x.detach(), size.to(lows.dtype), vals,
            vals.abs() + (grad.abs() * size).sum(dim=-1))


def roundoff_scales(u, tables: rule_eval.RuleTables, lengths,
                    global_range):
    """(s_est (C,), s_r (C, 3)) of the module docstring from u_p."""
    _, orbit_wts, scale, norm = rule_eval.device_tables(
        tables.ndim, u.dtype, u.device)
    ob = tables.orbit_bounds
    orbit_abs = torch.stack([u[:, ob[s]:ob[s + 1]].sum(dim=1)
                             for s in range(len(ob) - 1)], dim=1)
    w = torch.sum(orbit_abs[:, :, None] * orbit_wts.abs()[None], dim=1)
    w = w * (torch.prod(global_range) * torch.prod(lengths, dim=0))[:, None]
    s_r = torch.amax(norm[None, :, 1:4] * (
        w[:, None, 2:5] + scale[None, :, 1:4].abs() * w[:, None, 1:4]), dim=1)
    return w[:, 0], s_r


def _excess(k, p, scale, rtol, fi):
    """Ulps of ``scale`` by which |k - p| exceeds rtol |p| + tiny: 0 where
    k and p are equal (NaN and NaN included), inf where the scale is 0 or
    only one of them is NaN."""
    over = (k - p).abs() - rtol * p.abs() - fi.tiny
    x = torch.where(over > 0, over / scale / fi.eps, torch.zeros_like(k))
    x = torch.where(torch.isnan(x) | torch.isnan(over),
                    torch.full_like(x, float("inf")), x)
    same = (k == p) | (torch.isnan(k) & torch.isnan(p))
    return torch.where(same, torch.zeros_like(x), x)


def region_readings(kernel, plain, vals, u, tables: rule_eval.RuleTables,
                    lengths, global_range):
    """Per-region readings of ``kernel`` (est, err, split_dim) against
    ``plain`` on C regions whose rule values are ``vals`` (C, feval), with
    the rounding scales ``u`` of ``value_scales``: the
    excess of est and err in ulps of their scales, the gate ties, the
    plain err in ulps of its scale, and the gap of each split_dim
    mismatch in ulps of its values."""
    fi = torch.finfo(vals.dtype)
    rtol = RTOL[vals.dtype]
    s_est, s_r = roundoff_scales(u, tables, lengths, global_range)
    s_err = 5.0 * s_r.amax(dim=1)
    e = rule_eval.null_errors(rule_eval.rule_sums(vals, tables, global_range),
                              tables) * torch.prod(lengths, dim=0)[:, None]
    noise = ULPS["err"] * fi.eps * s_r
    tie = (((5.0 * e[:, 0] - e[:, 1]).abs() < 5.0 * noise[:, 0] + noise[:, 1])
           | ((5.0 * e[:, 1] - e[:, 2]).abs()
              < 5.0 * noise[:, 1] + noise[:, 2]))
    err_x = err_direct = _excess(kernel[1], plain[1], s_err, rtol, fi)
    for branch in (e[:, 0], 5.0 * e.amax(dim=1)):
        alt = _excess(kernel[1], branch, s_err, rtol, fi)
        err_x = torch.where(tie, torch.minimum(err_x, alt), err_x)

    mism = torch.nonzero(kernel[2] != plain[2])[:, 0]
    v = vals[mism]
    fd = rule_eval.fourth_differences(v, tables.ndim, tables.ratio)
    rows = torch.arange(mism.numel(), device=fd.device)
    gap = (fd[rows, kernel[2][mism].long()]
           - fd[rows, plain[2][mism].long()]).abs()
    top = v[:, :4 * tables.ndim + 1].abs().amax(dim=1)
    return {
        "abs_est": (kernel[0] - plain[0]).abs(),
        "est": _excess(kernel[0], plain[0], s_est, rtol, fi),
        "err": err_x,
        "err_direct": err_direct,
        "gate_tie": tie,
        "err_resolved": plain[1][s_err > 0] / s_err[s_err > 0] / fi.eps,
        "tie_gap": gap / (fi.eps * top + fi.tiny),
    }


def judge(r, *, name: str, dtype, min_agree: float = 0.999):
    """Readings of ``region_readings`` (one chunk, or chunks concatenated)
    as one summary; raises AssertionError where the kernel disagrees."""
    def top(t):
        return float(t.amax()) if t.numel() else 0.0

    n = r["est"].numel()
    out = {"regions": n, "max_abs_est": top(r["abs_est"])}
    for what in ("est", "err"):
        out[f"{what}_ulps"] = worst = top(r[what])
        if not worst <= ULPS[what]:
            raise AssertionError(
                f"{name} {dtype} {what}: {int((r[what] > ULPS[what]).sum())} "
                f"of {n} regions beyond rtol {RTOL[dtype]} + {ULPS[what]} "
                f"ulps of their roundoff scale, worst {worst:.3g}")
    out["err_ulps_without_gate_ties"] = top(r["err_direct"])
    out["gate_ties"] = int(r["gate_tie"].sum())
    res = r["err_resolved"]
    out["err_resolved_ulps_median"] = float(res.median()) if res.numel() \
        else 0.0
    gaps = r["tie_gap"]
    out["mismatches"] = gaps.numel()
    out["agree"] = 1.0 - gaps.numel() / max(n, 1)
    if out["agree"] < min_agree:
        raise AssertionError(f"{name} {dtype}: split_dim agrees on "
                             f"{out['agree']:.5f} < {min_agree}")
    if gaps.numel():
        out["tie_ulps_max"] = top(gaps)
        out["tie_ulps_median"] = float(gaps.median())
        out["exact_ties"] = int((gaps == 0).sum())
        if not out["tie_ulps_max"] <= TIE:
            raise AssertionError(
                f"{name} {dtype}: a split_dim mismatch is not a near-tie "
                f"({out['tie_ulps_max']:.3g} > {TIE} ulps of the values)")
    return out


def compare_outputs(kernel, plain, integrand, tables: rule_eval.RuleTables,
                    lows, lengths, global_lo, global_range, *,
                    min_agree: float = 0.999):
    """``judge`` of ``region_readings`` on C regions (every slot real)."""
    vals, u = value_scales(integrand, tables, lows, lengths, global_lo,
                           global_range)
    return judge(region_readings(kernel, plain, vals, u, tables, lengths,
                                 global_range),
                 name=getattr(integrand, "name", "integrand"),
                 dtype=lows.dtype, min_agree=min_agree)


def check_against_plain(integrand, tables: rule_eval.RuleTables, lows,
                        lengths, global_lo, global_range, *,
                        n: int | None = None, blocked: bool = False,
                        min_agree: float = 0.999, chunk: int = 4096,
                        route: str | None = None):
    """One kernel launch (by ``route``; None: the route the shape takes)
    over a CUDA pool against
    ``rule_eval.apply_rule_plain`` on the same pool: the padding slots
    must hold est = err = 0, and the real slots pass ``judge``, read in
    chunks of ``chunk`` regions (a chunk's rule values are held in
    memory).  Raises AssertionError on a disagreement; returns the
    summary."""
    k = cuda_rule.cuda_apply_rule(integrand, tables, lows, lengths,
                                  global_lo, global_range, n=n,
                                  blocked=blocked,
                                  **({} if route is None else {"route": route}))
    torch.cuda.synchronize()
    return check_outputs_against_plain(
        {"kernel": k}, integrand, tables, lows, lengths, global_lo,
        global_range, n=n, blocked=blocked, min_agree=min_agree,
        chunk=chunk)["kernel"]


def check_outputs_against_plain(outputs: dict, integrand,
                                tables: rule_eval.RuleTables, lows, lengths,
                                global_lo, global_range, *,
                                n: int | None = None, blocked: bool = False,
                                min_agree: float = 0.999, chunk: int = 4096):
    """Rule outputs (estimate, errorest, split_dim) over a CUDA pool, each
    entry of ``outputs`` another route's (or another entry point's), against
    one run of ``rule_eval.apply_rule_plain`` on the same pool: the padding
    slots must hold est = err = 0, and the real slots pass ``judge``, read in
    chunks of ``chunk`` regions (a chunk's rule values are held in memory).
    Raises AssertionError on a disagreement; returns the summaries by key."""
    p = rule_eval.apply_rule_plain(integrand, tables, lows, lengths,
                                   global_lo, global_range, chunk_size=4096,
                                   n=n, blocked=blocked)
    torch.cuda.synchronize()
    cap = lows.shape[1]
    mask = block_mask(cap, cap if n is None else int(n), blocked, lows.device)
    name = getattr(integrand, "name", "integrand")
    for key, k in outputs.items():
        if bool((k[0][~mask] != 0).any() | (k[1][~mask] != 0).any()):
            raise AssertionError(f"{name} ({key}): est/err written into "
                                 "padding slots")
    real = torch.nonzero(mask)[:, 0]
    parts = {key: [] for key in outputs}
    for s in range(0, real.numel(), chunk):
        idx = real[s:s + chunk]
        ln = lengths[:, idx]
        vals, u = value_scales(integrand, tables, lows[:, idx], ln,
                               global_lo, global_range)
        for key, k in outputs.items():
            parts[key].append(region_readings(
                [o[idx] for o in k], [o[idx] for o in p], vals, u, tables,
                ln, global_range))
    return {key: judge(_joined(parts[key], lows.device), name=name,
                       dtype=lows.dtype, min_agree=min_agree)
            for key in outputs}


def _joined(parts, device):
    return {key: torch.cat([q[key] for q in parts]) if parts
            else torch.zeros(0, device=device) for key in READINGS}


def check_components(kernel, plain, vals, u, tables: rule_eval.RuleTables,
                     lengths, global_range, *, name: str = "integrand"):
    """The components contraction's (est (ncomp, C), err (ncomp, C),
    split_dim (C,)) against ``plain``, ``rule_eval.rule_outputs_vector``'s,
    on C regions whose values are ``vals`` (C, feval, ncomp), with rounding
    scales ``u`` of the same shape (``value_scales`` of each component, or
    |vals| for values that no coordinate's rounding reaches): split_dim
    EQUAL in every region, and each component's est and err by ``judge``.
    Raises AssertionError on a disagreement; returns the worst readings
    over the components."""
    differ = int((kernel[2] != plain[2]).sum())
    if differ:
        raise AssertionError(f"{name}: split_dim differs from the plain "
                             f"version's in {differ} of {plain[2].numel()} "
                             "regions")
    worst = {"regions": plain[2].numel(), "ncomp": vals.shape[-1],
             "max_abs_est": 0.0, "est_ulps": 0.0, "err_ulps": 0.0,
             "err_ulps_without_gate_ties": 0.0, "gate_ties": 0,
             "split_dim_equal": plain[2].numel()}
    for k in range(vals.shape[-1]):
        r = judge(region_readings(
            (kernel[0][k], kernel[1][k], plain[2]),
            (plain[0][k], plain[1][k], plain[2]), vals[..., k], u[..., k],
            tables, lengths, global_range),
            name=f"{name} component {k}", dtype=vals.dtype)
        for key in ("max_abs_est", "est_ulps", "err_ulps",
                    "err_ulps_without_gate_ties"):
            worst[key] = max(worst[key], r[key])
        worst["gate_ties"] += r["gate_ties"]
    return worst


def same_bits(a, b) -> bool:
    """Equal shapes, strides and bits (NaN and the sign of 0 included)."""
    return (a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype and torch.equal(
                a.contiguous().view(torch.uint8),
                b.contiguous().view(torch.uint8)))


def check_split_against_plain(integrand, tables: rule_eval.RuleTables, lows,
                              lengths, global_lo, global_range, *,
                              n: int | None = None, blocked: bool = False,
                              chunk_size: int = 4096,
                              min_agree: float = 0.999,
                              route: str | None = None):
    """The split route over a CUDA pool, ``chunk_size`` regions at a time,
    its contraction by ``route`` (None: the one ``contract_route`` names),
    against the plain version: the padding slots must hold zeros; for each
    chunk the points kernel's points must be EQUAL to ``rule_points``' (bits
    and strides), the integrand's values on them EQUAL to its values on the
    plain points, and est/err/split_dim of the whole route's launch must
    pass ``judge`` against ``rule_outputs`` of those values.  Raises
    AssertionError on a disagreement; returns the summary, with
    ``split_dim_equal``, the regions whose split_dim is EQUAL."""
    name = getattr(integrand, "name", "integrand")
    k = cuda_rule.cuda_apply_rule_split(integrand, tables, lows, lengths,
                                        global_lo, global_range,
                                        chunk_size=chunk_size, n=n,
                                        blocked=blocked, route=route)
    torch.cuda.synchronize()
    cap = lows.shape[1]
    n = cap if n is None else int(n)
    mask = block_mask(cap, n, blocked, lows.device)
    if bool((k[0][~mask] != 0).any() | (k[1][~mask] != 0).any()
            | (k[2][~mask] != 0).any()):
        raise AssertionError(f"{name}: the split route wrote into padding "
                             "slots")
    batched, _ = make_integrand(integrand, tables.ndim)
    parts, equal = [], 0
    for first, count in cuda_rule.split_chunks(n, chunk_size):
        slots = torch.as_tensor(
            cuda_rule.split_slots(cap, n, blocked, first, count),
            device=lows.device)
        lo, ln = lows[:, slots], lengths[:, slots]
        xk = cuda_rule.split_points(tables, lows, lengths, global_lo,
                                    global_range, first, count, n=n,
                                    blocked=blocked)
        xp, _, _ = rule_eval.rule_points(tables, lo, ln, global_lo,
                                         global_range)
        if not same_bits(xk, xp):
            raise AssertionError(
                f"{name}: the points kernel's points differ from the plain "
                f"version's in regions {first}..{first + count - 1} (strides "
                f"{xk.stride()} and {xp.stride()})")
        vk = batched(xk).to(lows.dtype)
        del xk, xp
        vals, u = value_scales(integrand, tables, lo, ln, global_lo,
                               global_range)
        if not same_bits(vk, vals):
            raise AssertionError(f"{name}: the integrand's values on the "
                                 "kernel's points differ from its values on "
                                 "the plain points")
        plain = rule_eval.rule_outputs(vals, tables, ln, global_range)
        kern = [o[slots] for o in k]
        equal += int((kern[2] == plain[2]).sum())
        parts.append(region_readings(kern, plain, vals, u, tables, ln,
                                     global_range))
    out = judge(_joined(parts, lows.device), name=name, dtype=lows.dtype,
                min_agree=min_agree)
    out.update(points_equal=True, values_equal=True, split_dim_equal=equal)
    return out


def check_routes(integrand, tables: rule_eval.RuleTables, lows, lengths,
                 global_lo, global_range, *, n: int | None = None,
                 blocked: bool = False):
    """The two routes of the kernel on one CUDA pool against each other.
    Every rule value has the same bits on both, so split_dim must be EQUAL
    in every slot; est and err are sums taken in another order and are
    held to the plain version by ``check_against_plain``, so here they are
    only read: the largest |difference| relative to the pool's largest
    |value|.  Each route launched twice must repeat its bits.  Raises
    AssertionError on a disagreement; returns the readings."""
    name = getattr(integrand, "name", "integrand")
    outs = {}
    for route in cuda_rule.ROUTES:
        a, b = (cuda_rule.cuda_apply_rule(
            integrand, tables, lows, lengths, global_lo, global_range, n=n,
            blocked=blocked, route=route) for _ in range(2))
        torch.cuda.synchronize()
        for what, x, y in zip(("est", "err", "split_dim"), a, b):
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                raise AssertionError(f"{name}: two launches of the {route} "
                                     f"route differ in {what}")
        outs[route] = a
    t, g = outs["tile"], outs["generic"]
    differ = int((t[2] != g[2]).sum())
    if differ:
        raise AssertionError(f"{name}: split_dim differs between the routes "
                             f"in {differ} of {t[2].numel()} slots")

    def rel(x, y):
        top = float(y.abs().nan_to_num(0.0).amax()) if y.numel() else 0.0
        d = (x - y).abs().nan_to_num(0.0)
        return float(d.amax()) / top if top > 0 else 0.0

    return {"slots": t[2].numel(), "split_dim_equal": True,
            "est_rel": rel(t[0], g[0]), "err_rel": rel(t[1], g[1])}


def crease_stencils(ndim: int, count: int, dtype: str, seed: int):
    """Rule values (count, feval) of type ``dtype`` with planted kinks and
    jumps, and split axes (count,) int32, as numpy arrays: smooth noise
    around 1, then on a third of the regions a |x - t| kink, on another
    third a step plus a slope, at a random position of the collinear
    stencil, along the region's split axis or a random one; so that both
    detectors of ``rule_eval.split_fraction`` fire on many regions."""
    rng = np.random.default_rng(seed)
    tables = rule_eval.rule_tables(ndim, dtype)
    slots, _ = rule_eval.split_stencil(ndim, dtype)
    vals = rng.normal(size=(count, tables.feval)) * 0.05 + 1.0
    sd = rng.integers(0, ndim, count).astype(np.int32)
    axis = np.where(rng.uniform(size=count) < 0.5, sd,
                    rng.integers(0, ndim, count))
    t = rng.uniform(-0.45, 0.45, count)
    kind = rng.integers(0, 3, count)
    for r in range(count):
        d = axis[r]
        xs = np.concatenate([[0.0], -tables.gen[slots[d], d].astype(
            np.float64)])
        idx = np.concatenate([[0], slots[d]])
        if kind[r] == 1:
            vals[r, idx] += -3.0 * np.abs(xs - t[r])
        elif kind[r] == 2:
            vals[r, idx] += np.where(xs <= t[r], 2.0, 0.0) + 0.3 * xs
    return vals.astype(dtype), sd


def check_split_frac(vals, split_dim, ndim: int) -> dict:
    """``cuda_rule.split_frac`` on CUDA values (C, feval), at their strides,
    against ``rule_eval.split_fraction`` on the same values on the card and
    on a CPU copy: fraction and split_dim EQUAL, or AssertionError.
    Returns {regions, cut (fractions other than 0.5), overrides (split
    axes a jump moved), max_abs_err (0.0)}."""
    got = cuda_rule.split_frac(vals, split_dim, ndim)
    on_card = rule_eval.split_fraction(vals, split_dim, ndim)
    on_cpu = rule_eval.split_fraction(vals.cpu(), split_dim.cpu(), ndim)
    for name, g, c, h in zip(("frac", "split_dim"), got, on_card, on_cpu):
        for ref, where in ((c, "on the card"), (h.to(g.device), "on the CPU")):
            if not same_bits(g.contiguous(), ref.contiguous()):
                bad = int((g != ref).sum())
                raise AssertionError(
                    f"split fraction kernel: {name} differs from the plain "
                    f"version {where} in {bad} of {g.shape[0]} regions")
    frac, sd = got
    return {"regions": int(frac.shape[0]),
            "cut": int((frac != 0.5).sum()),
            "overrides": int((sd != split_dim.to(torch.int32)).sum()),
            "max_abs_err": 0.0}


def check_folded_frac(frac, split_dim, kept, split_dim_before, ndim: int, *,
                      name: str = "folded split fraction") -> dict:
    """A kernel's cut fraction and split axis of C regions (``frac``,
    ``split_dim`` (C,)) against ``rule_eval.split_fraction`` on the values
    it read, ``kept`` (C, 4 ndim + 1 or more), from the split axes it
    started from, ``split_dim_before`` (C,): both EQUAL, or
    AssertionError.  Returns {regions, cut (fractions other than 0.5),
    overrides (split axes a jump moved), max_abs_err (0.0)}."""
    want = rule_eval.split_fraction(kept, split_dim_before, ndim)
    for what, got, ref in zip(("frac", "split_dim"),
                              (frac, split_dim.to(torch.int32)), want):
        if not same_bits(got.contiguous(), ref.contiguous()):
            bad = int((got != ref).sum())
            raise AssertionError(
                f"{name}: {what} differs from rule_eval.split_fraction on "
                f"the kernel's own values in {bad} of {ref.shape[0]} "
                "regions")
    return {"regions": int(frac.shape[0]),
            "cut": int((frac != 0.5).sum()),
            "overrides": int((split_dim.to(torch.int32)
                              != split_dim_before.to(torch.int32)).sum()),
            "max_abs_err": 0.0}


def kept_value_readings(kept, integrand, tables: rule_eval.RuleTables,
                        lows, lengths, global_lo, global_range):
    """A fused kernel's collinear values ``kept`` (C, 4 ndim + 1) of C
    regions against the callable's at the same rule points (the prefix
    0 .. 4 ndim): (the excess of each value in ulps of its u_p (C,
    4 ndim + 1); the same excess against the callable at the point moved
    by twice its coordinates' rounding, every axis up or every axis down,
    whichever is smaller, where the first exceeds ULPS["value"], else inf;
    the callable's values).  A point within roundoff of a discontinuity
    (F6's bounds) may fall on the other side in the kernel, which forms
    its coordinates with one fused multiply-add; the moved point crosses
    with it."""
    batched, _ = make_integrand(integrand, tables.ndim)
    x, size, vals, u = _points_values_scales(
        integrand, tables, lows, lengths, global_lo, global_range,
        head=kept.shape[1])
    fi = torch.finfo(lows.dtype)
    rtol = RTOL[lows.dtype]
    excess = _excess(kept, vals, u, rtol, fi)
    moved = torch.full_like(excess, float("inf"))
    far = excess > ULPS["value"]
    if bool(far.any()):
        xf, step = x[far], 2.0 * fi.eps * size[far]
        best = torch.full_like(excess[far], float("inf"))
        for sign in (1.0, -1.0):
            alt = batched(xf + sign * step).to(lows.dtype)
            best = torch.minimum(best, _excess(kept[far], alt, u[far], rtol,
                                               fi))
        moved[far] = best
    return excess, moved, vals


def check_kept_values(kept, integrand, tables: rule_eval.RuleTables, lows,
                      lengths, global_lo, global_range, *,
                      name: str = "kept values") -> dict:
    """``kept_value_readings`` judged: every value within ULPS["value"]
    ulps of its u_p beyond rtol of the callable's at its rule point, or of
    the callable's at the moved point (a discontinuity within roundoff).
    A slot-order or sign error in the kernel's collinear prefix fails.
    Raises AssertionError; returns {values, value_ulps (the worst excess
    of the values held at their own point), value_rel (their largest
    |kept - f| / |f|), discontinuities (the values held at the moved
    point)}."""
    excess, moved, vals = kept_value_readings(kept, integrand, tables, lows,
                                              lengths, global_lo,
                                              global_range)
    limit = ULPS["value"]
    far = excess > limit
    bad = far & ~(moved <= limit)
    if bool(bad.any()):
        i = torch.nonzero(bad)[0]
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {kept.numel()} kept values beyond "
            f"rtol + {limit} ulps of their roundoff scale, the first at "
            f"region {int(i[0])} point {int(i[1])}: "
            f"{float(excess[i[0], i[1]]):.3g} ulps")
    near = excess[~far]
    rel = ((kept - vals).abs() / vals.abs())[~far & (vals != 0)
                                             & torch.isfinite(vals)]
    return {"values": kept.numel(),
            "value_ulps": float(near.amax()) if near.numel() else 0.0,
            "value_rel": float(rel.amax()) if rel.numel() else 0.0,
            "discontinuities": int(far.sum())}


def check_fused_frac(integrand, tables: rule_eval.RuleTables, lows, lengths,
                     global_lo, global_range, *, n: int | None = None,
                     blocked: bool = False, route: str | None = None) -> dict:
    """A fused kernel's crease form (``route``; None: the route the shape
    takes) on a CUDA pool: one launch without the fraction, one with it and
    the collinear values written out (``kept``).  The values' bits do not
    depend on the fraction, so est and err must have the same bits in
    both; the padding slots must hold fraction 0.5 and split_dim 0; on the
    real slots fraction and split_dim must be EQUAL to
    ``rule_eval.split_fraction`` on the kept values from the first
    launch's split axes (``check_folded_frac``), and the kept values
    themselves must be the callable's at rule points 0 .. 4n
    (``check_kept_values``).  Raises AssertionError; returns
    check_folded_frac's summary and check_kept_values'."""
    name = (f"{getattr(integrand, 'name', 'integrand')} "
            f"{route or cuda_rule.rule_route(tables.ndim)} route fraction")
    kw = dict(n=n, blocked=blocked,
              **({} if route is None else {"route": route}))
    base = cuda_rule.cuda_apply_rule(integrand, tables, lows, lengths,
                                     global_lo, global_range, **kw)
    cap = lows.shape[1]
    kept = torch.full((cap, 4 * tables.ndim + 1), float("nan"),
                      dtype=lows.dtype, device=lows.device)
    got = cuda_rule.cuda_apply_rule(integrand, tables, lows, lengths,
                                    global_lo, global_range, **kw,
                                    with_split_frac=True, kept=kept)
    torch.cuda.synchronize()
    for what, a, b in zip(("est", "err"), got, base):
        if not same_bits(a, b):
            raise AssertionError(f"{name}: {what} differs from the launch "
                                 "without the fraction")
    mask = block_mask(cap, cap if n is None else int(n), blocked,
                      lows.device)
    if bool((got[3][~mask] != 0.5).any() | (got[2][~mask] != 0).any()):
        raise AssertionError(f"{name}: padding slots without fraction 0.5 "
                             "and split_dim 0")
    real = torch.nonzero(mask)[:, 0]
    values = check_kept_values(kept[real], integrand, tables,
                               lows[:, real], lengths[:, real], global_lo,
                               global_range, name=name)
    return {**check_folded_frac(got[3][real], got[2][real], kept[real],
                                base[2][real], tables.ndim, name=name),
            **values}


def check_contract_frac(vals, tables: rule_eval.RuleTables, lows, lengths,
                        global_lo, global_range, *,
                        route: str | None = None) -> dict:
    """A scalar contraction's crease form (``route``; None:
    ``contract_route``'s) on the values ``vals`` (C, feval) of a CUDA pool
    of C regions, all real: launched without and with the fraction, est
    and err the same bits; fraction and split_dim EQUAL to the standalone
    kernel's (``cuda_rule.split_frac``) on the same values from the first
    launch's split axes, and to ``rule_eval.split_fraction``
    (``check_folded_frac``).  Raises AssertionError; returns the
    summary."""
    name = f"{route or 'named'} contraction fraction"
    args = (vals, tables, lows, lengths, global_lo, global_range, 0)
    base = cuda_rule.split_contract(*args, route=route)
    got = cuda_rule.split_contract(*args, route=route, with_split_frac=True)
    alone = cuda_rule.split_frac(vals, base[2], tables.ndim)
    torch.cuda.synchronize()
    for what, a, b in zip(("est", "err"), got, base):
        if not same_bits(a, b):
            raise AssertionError(f"{name}: {what} differs from the launch "
                                 "without the fraction")
    for what, a, b in zip(("frac", "split_dim"), (got[3], got[2]), alone):
        if not same_bits(a, b):
            raise AssertionError(f"{name}: {what} differs from the "
                                 "standalone kernel's")
    return check_folded_frac(got[3], got[2], vals, base[2], tables.ndim,
                             name=name)
