"""The CUDA rule kernel held against its plain PyTorch version.

The two compute the same rule sums in another order, and the kernel forms
each coordinate with one fused multiply-add where the plain version rounds
twice, so they differ by roundoff.  Each output is held to that roundoff's
own scale in its region, counted in ulps (``finfo.eps``) of the working
type:

* each value f_p = f(x_p) is uncertain by a few ulps of
  ``u_p = |f_p| + sum_d |df/dx_d| (|c_d| + |g_pd l_d|)`` (the coordinate
  x_pd = c_d - g_pd l_d is rounded, and f can amplify that: F4's
  exponent is 2 a^2 |x - u| |x| ~ 600 times more sensitive than f);
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
"""
from __future__ import annotations

import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.ops import cuda_rule, rule_eval
from gpuintegration_torch.pagani.region_pool import block_mask

READINGS = ("abs_est", "est", "err", "err_direct", "gate_tie", "err_resolved",
            "tie_gap")

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
ULPS = {"est": 1.0, "err": 1.0}
TIE = 256.0


def value_scales(integrand, tables: rule_eval.RuleTables, lows, lengths,
                 global_lo, global_range):
    """(f_p (C, feval), u_p (C, feval)) of the module docstring for C
    regions, the derivative by autograd."""
    batched, _ = make_integrand(integrand, tables.ndim)
    x, center_g, len_g = rule_eval.rule_points(tables, lows, lengths,
                                               global_lo, global_range)
    gen, _, _, _ = rule_eval.device_tables(tables.ndim, lows.dtype,
                                           lows.device)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        vals = batched(x).to(lows.dtype)
        (grad,) = torch.autograd.grad(vals.sum(), x)
    size = (center_g.T.abs()[:, None, :]
            + (gen[None, :, :] * len_g.T[:, None, :]).abs())
    vals = vals.detach()
    return vals, vals.abs() + (grad.abs() * size).sum(dim=-1)


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
    p = rule_eval.apply_rule_plain(integrand, tables, lows, lengths,
                                   global_lo, global_range, chunk_size=4096,
                                   n=n, blocked=blocked)
    torch.cuda.synchronize()
    cap = lows.shape[1]
    mask = block_mask(cap, cap if n is None else int(n), blocked, lows.device)
    name = getattr(integrand, "name", "integrand")
    if bool((k[0][~mask] != 0).any() | (k[1][~mask] != 0).any()):
        raise AssertionError(f"{name}: the kernel wrote est/err into "
                             "padding slots")
    real = torch.nonzero(mask)[:, 0]
    parts = []
    for s in range(0, real.numel(), chunk):
        idx = real[s:s + chunk]
        ln = lengths[:, idx]
        vals, u = value_scales(integrand, tables, lows[:, idx], ln,
                               global_lo, global_range)
        parts.append(region_readings([o[idx] for o in k],
                                     [o[idx] for o in p], vals, u, tables,
                                     ln, global_range))
    return judge(_joined(parts, lows.device), name=name, dtype=lows.dtype,
                 min_agree=min_agree)


def _joined(parts, device):
    return {key: torch.cat([q[key] for q in parts]) if parts
            else torch.zeros(0, device=device) for key in READINGS}


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
