"""VEGAS-assisted region sampling, the PAGANI+VEGAS hybrid (PyTorch port of
``gpuintegration_tpu/pagani/vegas_assisted.py``; reference:
cuda/pagani/quad/GPUquad/Sample.cuh:292-729 Vegas_assisted_SampleRegionBlock).

After the cubature rule picks each region's bisection dimension, the
region's estimate and error are overwritten by an in-region mini-VEGAS
Monte Carlo result: a per-region importance grid of ``nbins`` bins a
dimension ((R, ndim, nbins+1) f32), adapted over a few passes.

``_refine_grids`` is also the f32 rebin of VEGAS's ``refine='device'``
(mcubes/vegas.py), on a (1, ndim, 500) grid.  On the GPU a searchsorted
and gathers are legal, so the reference's compare-count and one-hot
contractions become ``torch.cumsum``, ``torch.searchsorted`` and
``torch.gather``.  Divisions whose bits the reference takes from XLA's
true division divide by 0-d tensors here: PyTorch on the card divides by a
host scalar as a product with its rounded reciprocal.

The draws come from the Philox stream of mcubes/stream.py with a counter
of their own, (global region id, sample slot, iteration, ASSISTED_STREAM +
B pass + block), block b holding uniforms 4b..4b+3 of the sample's 2 ndim
(bin draws, then in-bin positions), B = ``pass_blocks(ndim)`` blocks a
pass (16 up to 32D): they do not depend on how the regions are chunked,
and repeat bitwise on the CPU and on the card.  The
per-(region, dimension) f^2 histogram is a stable sort by bin and a
segmented sum (``torch.segment_reduce``), with no float atomics, so a run
repeats bitwise too.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.mcubes import stream

# The fourth counter word's base: the VEGAS sampler's fourth word is
# 4 slot + d / 4 and the frozen estimate's diff.FROZEN_STREAM, so the
# streams of one seed stay apart.  Above it: B pass + block.
ASSISTED_STREAM = 0xA55A0000
# The bases of the streams keyed this way, in counter order: ASSISTED_STREAM,
# suave.SUAVE_STREAM, diff.FROZEN_STREAM (copies: those modules import this
# one; tests hold them equal).  A stream's words stay below the next base,
# the last one's below 2^32.
STREAM_BASES = (ASSISTED_STREAM, 0xB5A40000, 0xD1FF0000)
# Blocks of 4 uniforms a pass takes at least: 2 ndim <= 64 up to 32D
PASS_BLOCKS = 16
# bins a dimension of a region's grid (the reference's 100, Sample.cuh)
NBINS = 100


def _scalar(value: float, like):
    """A 0-d tensor of ``value`` in ``like``'s dtype and device (made on the
    device, no host-to-device copy, so a CUDA graph can capture it)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _refine_grids(grids, hist):
    """Batched grid refinement: 3-bin smoothing, NR's TINY floor,
    log-damped weights, rebin (the device-side rebin of
    Sample.cuh:299-326, 483-523), over (..., ndim, nb) in f32.

    grids (..., ndim, nb+1) f32 edges, hist (..., ndim, nb) f32 weights.
    Each new edge j lies at the target j * total / nb of the cumulative
    weight: k = searchsorted(cum, target, 'left') clipped to [0, nb-1], the
    edge interpolated inside old bin k (guarded where r_k = 0).  A
    dimension whose smoothed histogram sums to 0 keeps its edges."""
    nb = hist.shape[-1]
    left = torch.cat([hist[..., :1], hist[..., :-1]], dim=-1)
    right = torch.cat([hist[..., 1:], hist[..., -1:]], dim=-1)
    sm = (left + hist + right) / _scalar(3.0, hist)
    sm[..., 0] = (hist[..., 0] + hist[..., 1]) / _scalar(2.0, hist)
    sm[..., -1] = (hist[..., -2] + hist[..., -1]) / _scalar(2.0, hist)
    dt = torch.sum(sm, dim=-1, keepdim=True)   # raw: gates keep-edges
    # the TINY floor (mcubes.grid.smooth_and_refine's): zero-mass bins keep
    # a small weight, or a narrow early peak collapses every edge into it
    sm = torch.clamp(sm, min=1e-30)
    dts = torch.sum(sm, dim=-1, keepdim=True)
    frac = sm / dts
    safe = torch.clamp(frac, 1e-30, 1.0)
    r = ((1.0 - frac) / (-torch.log(safe))) ** 1.5

    cum = torch.cumsum(r, dim=-1)                        # (..., nb)
    total = cum[..., -1:]
    targets = (torch.arange(1, nb, dtype=grids.dtype, device=grids.device)
               * (total / _scalar(float(nb), total)))    # (..., nb-1)
    k = torch.searchsorted(cum.contiguous(), targets.contiguous(),
                           side="left")
    k = torch.clamp(k, 0, nb - 1)
    cum_k = torch.gather(cum, -1, k)
    r_k = torch.gather(r, -1, k)
    xo = torch.gather(grids[..., :nb], -1, k)
    xn = torch.gather(grids[..., 1:nb + 1], -1, k)
    dr = cum_k - targets
    rk = torch.where(r_k > 0, r_k, torch.ones_like(r_k))
    inner = xn - (xn - xo) * dr / rk                     # (..., nb-1)
    edge0 = torch.zeros_like(inner[..., :1])
    refined = torch.cat([edge0, inner, torch.ones_like(edge0)], dim=-1)
    return torch.where(dt > 0, refined, grids)


def pass_blocks(ndim: int) -> int:
    """B, the blocks of 4 uniforms that a pass of ``ndim`` dimensions owns:
    PASS_BLOCKS up to 32D (the counter words of every earlier run), else
    the ceil(2 ndim / 4) its 2 ndim uniforms fill, so that a pass's last
    block never is the next pass's first."""
    return max(PASS_BLOCKS, -(-2 * ndim // 4))


def stream_limit(stream_base: int) -> int:
    """The first fourth word above ``stream_base`` that another stream
    owns: the next of STREAM_BASES, or 2^32."""
    return min([b for b in STREAM_BASES if b > stream_base] + [1 << 32])


def max_passes(ndim: int, stream_base: int = ASSISTED_STREAM) -> int:
    """The passes of ``ndim`` dimensions whose words stay below
    ``stream_limit(stream_base)``: pass p takes the words stream_base +
    B p .. stream_base + B (p + 1) - 1."""
    return (stream_limit(stream_base) - stream_base) // pass_blocks(ndim)


def region_draws(seed: int, iteration: int, pass_: int, region_ids,
                 spp: int, ndim: int, stream_base: int = ASSISTED_STREAM):
    """(u_bin, u_pos): the uniforms of pass ``pass_`` for regions
    ``region_ids`` ((R,) int64 global ids below 2^32), each (R, spp, ndim)
    f32 in [0, 1): 24-bit uniforms of the Philox stream keyed on ``seed``,
    counter (region id, slot, iteration, stream_base + B pass_ + block),
    B = ``pass_blocks(ndim)``.  ``stream_base``: ASSISTED_STREAM here,
    suave.SUAVE_STREAM for Suave's draws.  ValueError for a pass whose
    words would overlap the next stream's (``max_passes``)."""
    blocks = pass_blocks(ndim)
    limit = stream_limit(stream_base)
    if not 0 <= pass_ < max_passes(ndim, stream_base):
        raise ValueError(
            f"pass {pass_} at {ndim}D: its {blocks} blocks would overlap "
            f"the next stream's words (base {limit:#x}); passes 0 .. "
            f"{max_passes(ndim, stream_base) - 1}")
    k0, k1 = stream.seed_key(seed)
    ids = region_ids.to(torch.int64) & stream.MASK32
    dev = ids.device
    shape = (ids.numel(), spp)
    c0 = ids[:, None].expand(shape)
    c1 = torch.arange(spp, dtype=torch.int64, device=dev)[None, :].expand(
        shape)
    c2 = torch.full(shape, int(iteration) & stream.MASK32,
                    dtype=torch.int64, device=dev)
    nvals = 2 * ndim
    words = []
    for b in range(-(-nvals // 4)):
        c3 = torch.full(shape, stream_base + blocks * pass_ + b,
                        dtype=torch.int64, device=dev)
        words.extend(stream.philox4x32(c0, c1, c2, c3, k0, k1)[
            :min(4, nvals - 4 * b)])
    u = stream.bits_to_uniform(torch.stack(words, dim=-1))   # (R, spp, 2n)
    return u[..., :ndim], u[..., ndim:]


def _region_hist(bins, f2, nbins: int):
    """(R, ndim, nbins) f32: per region and dimension, the sum of f2 (R, spp)
    over the samples whose bin ``bins`` (R, spp, ndim) is b.  A stable sort
    by bin and a segmented sum, each bin's values added in an order its
    indices fix: the same bits from run to run."""
    R, spp, ndim = bins.shape
    b = bins.permute(0, 2, 1).to(torch.int64)                # (R, ndim, spp)
    sb, order = torch.sort(b, dim=-1, stable=True)
    vals = f2[:, None, :].expand(R, ndim, spp).gather(-1, order)
    edges = torch.arange(nbins + 1, dtype=torch.int64, device=bins.device)
    pos = torch.searchsorted(
        sb.contiguous(), edges.expand(R, ndim, nbins + 1).contiguous(),
        side="left")
    lengths = (pos[..., 1:] - pos[..., :-1]).reshape(-1)
    hist = torch.segment_reduce(vals.reshape(-1), "sum", lengths=lengths,
                                initial=0.0)
    return hist.view(R, ndim, nbins)


def _sample_regions_pass(f, draws, grids, lows, lengths, global_lo,
                         global_range, nbins: int, dtype, ncomp: int = 1):
    """One importance-sampled pass over regions: each (bin, in-bin
    position) pair of ``draws`` (u_bin, u_pos; (R, spp, ndim) f32) gives a
    point inside its region's grid cell, the integrand is evaluated there,
    and each region's grid is refined on this pass's f^2 histogram.

    ``f``: the batched integrand, (..., ndim) -> (...) or (..., ncomp);
    grids (R, ndim, nbins+1) f32; lows, lengths (ndim, R) unit-space
    regions; global_lo, global_range (ndim,) the volume.  Returns (u (R,
    spp, ndim) f32 unit-region coordinates, wf (R, spp) importance-weighted
    values in ``dtype``, or (ncomp, R, spp) component-major, grids
    refined); the grids adapt on component 0."""
    u_bin, u_pos = draws
    jac = torch.prod(global_range).to(dtype)
    bins = torch.clamp((u_bin * nbins).to(torch.int32), 0, nbins - 1)
    idx = bins.permute(0, 2, 1).to(torch.int64)              # (R, ndim, spp)
    lo = torch.gather(grids[..., :nbins], -1, idx)
    wid = torch.gather(grids[..., 1:], -1, idx) - lo
    u = (lo + u_pos.permute(0, 2, 1) * wid).permute(0, 2, 1)  # (R, spp, ndim)
    w = (wid * nbins).to(dtype)
    wprod = w[:, 0]
    for d in range(1, w.shape[1]):
        wprod = wprod * w[:, d]                              # (R, spp)

    x = (global_lo + (lows.T[:, None, :] + u.to(dtype)
                      * lengths.T[:, None, :]) * global_range)
    fx = f(x).to(dtype) * jac                                # (R, spp[, nc])
    if ncomp == 1:
        wf = wprod * fx
        hist_wf = wf
    else:
        wf = torch.movedim(fx, -1, 0) * wprod[None]          # (ncomp, R, spp)
        hist_wf = wf[0]
    # the per-region f^2 histogram of |wf| over its per-region max (the
    # 1e22-magnitude fix: raw f^2 of a huge integrand is inf in f32, and
    # the rebin is scale-invariant, so normalising first is exact)
    absf = torch.abs(hist_wf)
    scale = torch.amax(absf, dim=1, keepdim=True)
    floor = 1e-300 if dtype == torch.float64 else 1e-30
    f2n = absf / torch.clamp(scale, min=floor)
    f2 = (f2n * f2n).to(torch.float32)                       # in [0, 1]
    return u, wf, _refine_grids(grids, _region_hist(bins, f2, nbins))


def uniform_grids(count: int, ndim: int, nbins: int, device):
    """(count, ndim, nbins+1) f32 equal-width grids: edge k is k times the
    f32 reciprocal of nbins, the last edge 1 (the bits of the reference's
    ``jnp.linspace(0, 1, nbins + 1)`` on the CPU)."""
    f32 = torch.float32
    edges = torch.arange(nbins + 1, dtype=f32, device=device) * float(
        np.float32(1.0) / np.float32(nbins))
    edges[-1] = 1.0
    return edges.expand(count, ndim, nbins + 1).contiguous()


def vegas_assisted_estimates(f, ndim: int, passes: int, spp: int, nbins: int,
                             dtype, seed: int, iteration: int, lows, lengths,
                             global_lo, global_range, *, chunk: int,
                             ranges=None):
    """Per-region adaptive importance-sampling estimates: (estimate (R,),
    errorest (R,)) in ``dtype`` to overwrite the rule's (the reference
    overwrites r->avg/err, Sample.cuh:726-727), R = lows.shape[1].

    The importance-weighted mean of ``passes`` x ``spp`` samples a region,
    each pass on the grid the previous one refined, and its standard error,
    both times the region's unit-space volume.  Regions are taken ``chunk``
    at a time (device memory is bounded by one chunk's (chunk, spp, ndim)
    points); ``ranges``: the (start, stop) slot ranges to estimate, the
    rest left 0 (a pool's padding slots, which the caller masks); None:
    every slot.  The draws of pass p of region i depend on (seed,
    iteration, p, i) alone (``region_draws``)."""
    R = lows.shape[1]
    if R > stream.MASK32:
        raise ValueError(f"{R} regions: the draws' region ids take 32 bits")
    dev = lows.device
    est = torch.zeros(R, dtype=dtype, device=dev)
    err = torch.zeros(R, dtype=dtype, device=dev)
    n = torch.full((), float(passes * spp), dtype=dtype, device=dev)
    for start, stop in ([(0, R)] if ranges is None else ranges):
        for c0 in range(start, stop, chunk):
            c1 = min(c0 + chunk, stop)
            lo, ln = lows[:, c0:c1], lengths[:, c0:c1]
            ids = torch.arange(c0, c1, dtype=torch.int64, device=dev)
            grids = uniform_grids(c1 - c0, ndim, nbins, dev)
            sum_wf = torch.zeros(c1 - c0, dtype=dtype, device=dev)
            sum_wf2 = torch.zeros_like(sum_wf)
            for p in range(passes):
                draws = region_draws(seed, iteration, p, ids, spp, ndim)
                _, wf, grids = _sample_regions_pass(
                    f, draws, grids, lo, ln, global_lo, global_range, nbins,
                    dtype)
                sum_wf = sum_wf + torch.sum(wf, dim=1)
                sum_wf2 = sum_wf2 + torch.sum(wf * wf, dim=1)
            mean = sum_wf / n
            var_mean = torch.clamp(sum_wf2 / n - mean * mean, min=0.0) / (
                torch.clamp(n - 1.0, min=1.0))
            vol = torch.prod(ln, dim=0).to(dtype)
            est[c0:c1] = vol * mean
            err[c0:c1] = vol * torch.sqrt(var_mean)
    return est, err
