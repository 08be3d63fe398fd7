"""Suave: subregion-adaptive importance-sampling Monte Carlo (PyTorch port
of ``gpuintegration_tpu/pagani/suave.py``).

Re-expression of the algorithm behind cubacpp's Suave binding
(reference: cubacpp/cubacpp/suave.hh -> CUBA's Suave; parameter surface
nnew/nmin/flatness):

  1. VEGAS-style importance sampling with a grid PER SUBREGION that
     children inherit from their parent,
  2. sample REUSE: information from earlier samples keeps contributing
     to a region's estimate after subdivision,
  3. the split dimension minimizes the FLUCTUATION of the samples in the
     two prospective halves (flatness = the p-norm exponent emphasizing
     spiky components).

The pool is batched: every cycle samples all regions at once (nmin passes
of nnew samples a region, through ``vegas_assisted._sample_regions_pass``,
the per-region grids refined on the device in f32), and every
over-budget region splits in the same cycle.  Sample reuse is carried as
sufficient statistics: per region the inverse-variance weighted (estimate,
weight) sums; a split seeds each child with the parent's information
(estimates apportioned by the SIGNED measured per-half mass, with an even
split under heavy cancellation; weight halved).  The fluctuation of a
prospective half is the normalized p-norm of |w f| over its samples, p =
min(flatness, 16), in ratios-to-max form.

The draws come from the Philox stream of mcubes/stream.py with a counter
of their own, (slot id, sample slot, cycle, SUAVE_STREAM + B pass +
block), B = ``vegas_assisted.pass_blocks(ndim)``:
``vegas_assisted.region_draws`` with ``stream_base=SUAVE_STREAM``.
They repeat bitwise on the CPU and the card.

Pool surgery (split and bookkeeping) runs on the host in NumPy, as in the
reference (pools <= ``max_regions``): each cycle's small outputs come back
in one transfer.  The grids stay on the device; a cycle's grid surgery is
a few indexed copies.

Entry point ``suave`` runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.integrand import deduce_ncomp, make_integrand
from gpuintegration_torch.pagani import vegas_assisted
from gpuintegration_torch.pagani.vegas_assisted import _sample_regions_pass
from gpuintegration_torch.pagani.workspace import _resolve_device
from gpuintegration_torch.types import IntegrationResult, Volume
from gpuintegration_torch.utils.stats import chi2_prob

# The fourth counter word's base of Suave's draws (above it: B pass +
# block, below diff.FROZEN_STREAM: vegas_assisted.max_passes).  Apart from
# the VEGAS sampler's 4 slot + d / 4 (below 2^31) and
# vegas_assisted.ASSISTED_STREAM's words (below this base).
SUAVE_STREAM = 0xB5A40000


def uniform_edges(nbins: int, device=None) -> torch.Tensor:
    """(nbins+1,) f32 equal-width edges: the f32 rounding of NumPy's f64
    ``linspace(0, 1, nbins + 1)``, Suave's initial grid and the grid a
    split axis is reset to (not ``vegas_assisted.uniform_grids``' k times
    f32(1/nbins))."""
    return torch.as_tensor(
        np.linspace(0.0, 1.0, nbins + 1).astype(np.float32), device=device)


def _suave_cycle(
    f,
    ndim: int,
    passes: int,          # nmin sampling passes of this cycle
    nnew: int,            # samples per region per pass
    nbins: int,
    dtype,
    p: float,             # fluctuation norm exponent (capped flatness)
    draw,                 # draw(i) -> (u_bin, u_pos) of pass i
    lows, lengths,        # (ndim, cap) dims-major unit-space regions
    grids,                # (cap, ndim, nbins+1) f32 per-region grids
    global_lo, global_range,
    ncomp: int = 1,
):
    """One Suave cycle over the whole (padded) pool.

    Returns (grids', I (ncomp, cap), var (ncomp, cap), flu (cap, ndim),
    mass_lo (ncomp, cap, ndim), mass (ncomp, cap), mass_abs (ncomp,
    cap)): the cycle's per-region importance-sampled estimate and
    variance of the mean per component, the per-dimension fluctuation of
    the two prospective halves (split criterion: argmin; a vector
    measures it on the worst per-sample |wf| over components), and the
    SIGNED lower-half and total sampled integrand mass plus its absolute
    total per component (child seeding).  Padding slots give finite junk
    that the host driver masks.  All components share one point set and
    one per-region grid (adapted on component 0)."""
    cap = lows.shape[1]
    dev = lows.device
    vol = torch.prod(lengths, dim=0).to(dtype)                  # (cap,)
    # the reference's 1e-300 floor is 0 in f32 (NaN for a region where f
    # is 0 everywhere): f32's smallest normal there
    floor = 1e-300 if dtype == torch.float64 else torch.finfo(dtype).tiny
    s_wf = torch.zeros((ncomp, cap), dtype=dtype, device=dev)
    s_wf2 = torch.zeros_like(s_wf)
    s_mass_abs = torch.zeros_like(s_wf)
    s_flu_lo = torch.zeros((cap, ndim), dtype=dtype, device=dev)
    s_flu_hi = torch.zeros_like(s_flu_lo)
    s_mass_lo = torch.zeros((ncomp, cap, ndim), dtype=dtype, device=dev)
    for i in range(passes):
        u, wf, grids = _sample_regions_pass(
            f, draw(i), grids, lows, lengths, global_lo, global_range, nbins,
            dtype, ncomp=ncomp)
        if ncomp == 1:
            wf = wf[None]                                       # (1, cap, nnew)
        awf_c = torch.abs(wf)                                   # (ncomp, cap, nnew)
        awf = torch.amax(awf_c, dim=0)                          # worst component
        s_wf = s_wf + torch.sum(wf, dim=2)
        s_wf2 = s_wf2 + torch.sum(wf * wf, dim=2)

        # fluctuation per (region, dim, half): the normalized p-norm of |wf|
        # over each prospective half, every dimension in one broadcast; and
        # the SIGNED lower-half mass for child seeding
        fmax = torch.clamp(torch.amax(awf, dim=1, keepdim=True), min=floor)
        ratio_p = ((awf / fmax) ** p)[..., None]                # (cap, nnew, 1)
        in_lo = (u < 0.5).to(dtype)                             # (cap, nnew, ndim)
        s_flu_lo = s_flu_lo + fmax * torch.sum(
            ratio_p * in_lo, dim=1) ** (1.0 / p)
        s_flu_hi = s_flu_hi + fmax * torch.sum(
            ratio_p * (1.0 - in_lo), dim=1) ** (1.0 / p)
        s_mass_lo = s_mass_lo + torch.sum(wf[..., None] * in_lo[None], dim=2)
        s_mass_abs = s_mass_abs + torch.sum(awf_c, dim=2)

    cnt = torch.full((), float(passes * nnew), dtype=dtype, device=dev)
    mean = s_wf / cnt
    var_mean = torch.clamp(s_wf2 / cnt - mean * mean, min=0.0) / torch.clamp(
        cnt - 1.0, min=1.0)
    I = vol[None] * mean
    var = (vol * vol)[None] * var_mean
    flu = s_flu_lo + s_flu_hi                                   # (cap, ndim)
    return grids, I, var, flu, s_mass_lo, s_wf, s_mass_abs


def _host_outputs(I, var, flu, mass_lo, mass, mass_abs, n: int):
    """The cycle's outputs for the first n slots as f64 NumPy arrays, in one
    device-to-host transfer."""
    ncomp = I.shape[0]
    ndim = flu.shape[1]
    parts = [I[:, :n], var[:, :n], flu[:n], mass_lo[:, :n], mass[:, :n],
             mass_abs[:, :n]]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts])
    host = flat.cpu().numpy()
    shapes = [(ncomp, n), (ncomp, n), (n, ndim), (ncomp, n, ndim), (ncomp, n),
              (ncomp, n)]
    out, at = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        out.append(host[at:at + size].reshape(shape))
        at += size
    return out


def suave(
    integrand,
    epsrel: float = 1e-3,
    epsabs: float = 1e-12,
    vol: Volume | None = None,
    *,
    ndim: int | None = None,
    nnew: int = 2048,
    nmin: int = 2,
    flatness: float = 50.0,
    nbins: int = 64,
    max_regions: int = 1024,
    max_cycles: int = 64,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
) -> IntegrationResult:
    """Suave driver (cubacpp/suave.hh parameter surface).

    ``nnew``: fresh samples per region per pass; ``nmin``: passes per
    cycle (every region keeps at least nmin*nnew samples' worth of
    information between subdivisions); ``flatness``: fluctuation-norm
    exponent (capped at 16 in ratios-to-max form).

    Each cycle: batch-sample every region, fold the cycle's estimates into
    the per-region inverse-variance accumulators (sample reuse), then split
    every region whose variance exceeds its fair share of the error budget,
    seeding children from the parent's accumulated information.  Stops on
    accuracy, ``max_regions`` exhaustion, or ``max_cycles``.

    Vector-valued integrands (f -> (..., ncomp)) run end to end: every
    component shares one point set, one region tree and one per-region grid
    (adapted on component 0); accumulators, splits (any component over its
    fair share) and the all-components convergence test are per component;
    the result carries ``estimates``/``errorests``/``probs``."""
    dev = _resolve_device(device, "suave")
    f, ndim = make_integrand(integrand, ndim)
    if vol is None:
        vol = Volume(ndim=ndim)
    most = vegas_assisted.max_passes(ndim, SUAVE_STREAM)
    if nmin > most:
        raise ValueError(
            f"nmin {nmin} at {ndim}D: passes past {most} would overlap the "
            f"next stream's words (vegas_assisted.max_passes)")
    ncomp = deduce_ncomp(f, ndim, dtype, dev)
    p = float(min(flatness, 16.0))
    gl = torch.as_tensor(np.asarray(vol.lows), dtype=dtype, device=dev)
    gr = torch.as_tensor(np.asarray(vol.highs) - np.asarray(vol.lows),
                         dtype=dtype, device=dev)

    # the host-side pool.  Padding slots are FINITE unit boxes, not
    # zero-length ones: a zero-length box evaluates f exactly at the
    # domain's lower corner every pass, which explodes on boundary-singular
    # integrands
    cap = 64
    lows = np.zeros((ndim, cap))
    lengths = np.ones((ndim, cap))           # slot 0 = root region
    n = 1
    edges = uniform_edges(nbins, dev)
    grids = edges.expand(cap, ndim, nbins + 1).contiguous()
    wi = np.zeros((ncomp, cap))              # sum of wgt * estimate
    w = np.zeros((ncomp, cap))               # sum of wgt (inverse variance)

    res = IntegrationResult(status=1)
    # the inter-cycle consistency ledger: each cycle's fresh-sample total
    # is an independent unbiased estimate of the whole integral, so the
    # weighted chi-squared VEGAS keeps across iterations applies across
    # cycles (result.chi_sq / result.prob); per component for a vector
    c_si = np.zeros(ncomp)
    c_swgt = np.zeros(ncomp)
    c_schi = np.zeros(ncomp)

    for cycle in range(max_cycles):
        ids = torch.arange(cap, dtype=torch.int64, device=dev)

        def draw(i, cycle=cycle, ids=ids):
            return vegas_assisted.region_draws(
                seed, cycle, i, ids, nnew, ndim, stream_base=SUAVE_STREAM)

        (grids, I_d, var_d, flu_d, mass_lo_d, mass_d,
         mass_abs_d) = _suave_cycle(
            f, ndim, nmin, nnew, nbins, dtype, p, draw,
            torch.as_tensor(lows, dtype=dtype, device=dev),
            torch.as_tensor(lengths, dtype=dtype, device=dev),
            grids, gl, gr, ncomp=ncomp)
        I, var, flu, mass_lo, mass, mass_abs = _host_outputs(
            I_d, var_d, flu_d, mass_lo_d, mass_d, mass_abs_d, n)
        var = np.maximum(var, 1e-300)
        res.neval += nmin * nnew * cap           # every slot is evaluated
        res.iters += 1

        # fold the cycle into the per-region accumulators (sample reuse)
        wgt = 1.0 / var
        wi[:, :n] += wgt * I
        w[:, :n] += wgt
        t_c = np.sum(I, axis=1)              # this cycle's fresh estimate
        w_c = 1.0 / np.maximum(np.sum(var, axis=1), 1e-300)
        c_si += w_c * t_c
        c_swgt += w_c
        c_schi += w_c * t_c * t_c

        est_r = wi[:, :n] / w[:, :n]
        var_r = 1.0 / w[:, :n]
        total = np.sum(est_r, axis=1)        # (ncomp,)
        err = np.sqrt(np.sum(var_r, axis=1))
        tol = np.maximum(epsrel * np.abs(total), epsabs)
        if np.all(err <= tol):
            res.status = 0
            break

        # split every region where ANY component's variance exceeds that
        # component's fair share of its budget (batch adaptivity);
        # capacity-limited, worst share first
        share = var_r / (tol * tol)[:, None] * max(n, 1)  # (ncomp, n)
        worst = share.max(axis=0)
        over = np.flatnonzero(worst > 1.0)
        if over.size == 0:
            over = np.argsort(worst)[-max(n // 4, 1):]
        room = max_regions - n
        if room <= 0:
            break                            # pool exhausted
        if over.size > room:
            over = over[np.argsort(worst[over])[-room:]]

        if n + over.size > cap:              # grow the padded pool
            new_cap = 1 << int(n + over.size - 1).bit_length()
            new_cap = min(max(new_cap, cap), max_regions)
            pad = new_cap - cap
            if pad > 0:
                lows = np.pad(lows, ((0, 0), (0, pad)))
                lengths = np.pad(lengths, ((0, 0), (0, pad)))
                lengths[:, cap:] = 1.0       # finite padding boxes
                grids = torch.cat(           # NumPy's mode="edge"
                    [grids, grids[-1:].expand(pad, ndim, nbins + 1)])
                wi = np.pad(wi, ((0, 0), (0, pad)))
                w = np.pad(w, ((0, 0), (0, pad)))
                cap = new_cap

        parents, children, dims = _split(lows, lengths, wi, w, over, flu,
                                         mass_lo, mass, mass_abs, n)
        grids = _split_grids(grids, parents, children, dims, edges)
        n += over.size

    est_r = wi[:, :n] / np.maximum(w[:, :n], 1e-300)
    est_c = np.sum(est_r, axis=1)
    err_c = np.sqrt(np.sum(1.0 / np.maximum(w[:, :n], 1e-300), axis=1))
    res.estimate = float(est_c[0])
    res.errorest = float(err_c[0])
    res.nregions = n
    if res.iters >= 2 and np.all(c_swgt > 0.0):
        chi2_total = np.maximum(c_schi - c_si * c_si / c_swgt, 0.0)
        chi2a = chi2_total / (res.iters - 0.9999)
        probs = np.array([chi2_prob(float(c), res.iters - 1)
                          for c in chi2_total])
        res.chi_sq = float(chi2a[0]) if ncomp == 1 else float(chi2a.max())
        res.prob = float(probs[0]) if ncomp == 1 else float(probs.max())
        if ncomp > 1:
            res.probs = probs
    if ncomp > 1:
        res.estimates = est_c
        res.errorests = err_c
    return res


def _split(lows, lengths, wi, w, over, flu, mass_lo, mass, mass_abs, n: int):
    """Bisect regions ``over`` of the host pool (in that order, the upper
    child of the k-th into slot n + k) along their fluctuation-minimizing
    axis, seeding both children from the parent's accumulators per
    component: estimates apportioned by the SIGNED measured half mass
    (|.|-mass would seed the wrong sign where the integrand changes sign
    inside the region), weight halved; under heavy cancellation (|mass|
    <= 0.1 mass_abs) an even split.  Updates the arrays in place; returns
    (parents, children, axes) for the grids."""
    ncomp = wi.shape[0]
    over = np.asarray(over, dtype=np.int64)
    children = n + np.arange(over.size, dtype=np.int64)
    dims = np.argmin(flu[over], axis=1)
    half = lengths[dims, over] * 0.5
    lows[:, children] = lows[:, over]
    lengths[:, children] = lengths[:, over]
    lows[dims, children] = lows[dims, over] + half
    lengths[dims, children] = half
    lengths[dims, over] = half
    for k in range(ncomp):
        e_par = wi[k, over] / w[k, over]
        w_par = w[k, over]
        m = mass[k, over]
        with np.errstate(divide="ignore", invalid="ignore"):
            fl = np.clip(mass_lo[k, over, dims] / m, -1.0, 2.0)
        fl = np.where(np.abs(m) > 0.1 * mass_abs[k, over], fl, 0.5)
        w[k, over] = w[k, children] = w_par * 0.5
        wi[k, over] = w[k, over] * e_par * fl
        wi[k, children] = w[k, children] * e_par * (1.0 - fl)
    return over, children, dims


def _split_grids(grids, parents, children, dims, edges):
    """The children inherit their parent's grid, the split axis of both
    reset to the uniform ``edges``."""
    if parents.size == 0:
        return grids
    dev = grids.device
    par = torch.as_tensor(parents, device=dev)
    chi = torch.as_tensor(children, device=dev)
    d = torch.as_tensor(dims, device=dev)
    grids[chi] = grids[par]
    grids[par, d] = edges
    grids[chi, d] = edges
    return grids
