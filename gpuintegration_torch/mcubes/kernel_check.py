"""The four VEGAS kernels held against their plain PyTorch versions on the
same inputs.  The smoke run and the card-only tests call these checks on
CUDA tensors; on CPU tensors the wrappers take the plain versions, which
rehearses the checks themselves.  Each check returns its readings and
raises AssertionError on a disagreement.

What may differ, and by how much.  The sampler's plain version rounds every
product and every sum; the kernel contracts multiply-adds into one rounding
and sums in another order.  Whatever has no multiply-then-add must be
EQUAL: the uniforms, the stratified position s, the bin ids, the table
entries and their difference.  The Chebyshev recurrences are all
multiply-add, so each difference is read in f32 ulps (``finfo.eps``) of its
own rounding scale:

* coordinate x_d: ``S_d = sum_i |c_di|`` of the volume-folded P series;
* weight w = prod q_d^2: ``prod_d (sum_i |q_di|)^2``;
* a fused sample value fx = f(x) w xjac: ``u = |fx| + sum_d |dfx/dx_d| S_d``
  (f amplifies the rounding of x: F4's exponent is ~600 times more
  sensitive than f; the derivative comes from autograd), f^2: ``2 |fx| u``;
* the chunk's sums: ``sum fb``: ``sum_n u_n``; ``sum f2b``:
  ``sum_n 2 |npg fx_n - fb_c| u_n + sum_c npg sum f^2``.

ULPS holds the limits, a small factor above the largest readings taken on
an H100 (PERF.md).  The histogram is held to the plain version within
HIST_RTOL per bin, and to itself bitwise across two launches.  The bin
resolve's ``rc`` is held to RC_ULP ulps of its value.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.mcubes.poly_importance import fit_importance_poly

ULPS = {"x": 16.0, "w": 8.0, "f2": 16.0, "fb": 1.0, "f2b": 1.0}
HIST_RTOL = 1e-6
RC_ULP = 2
EPS32 = float(torch.finfo(torch.float32).eps)


def random_grid(ndim: int, nbins: int, seed: int) -> np.ndarray:
    """A VEGAS-like grid: (ndim, nbins+1) f64, monotone from 0 to 1."""
    rng = np.random.default_rng(seed)
    w = rng.random((ndim, nbins)) + 0.05
    xi = np.concatenate([np.zeros((ndim, 1)), np.cumsum(w, axis=1)], axis=1)
    return xi / xi[:, -1:]


def _top(t) -> float:
    return float(t.amax()) if t.numel() else 0.0


def _chunk_start(ng: int, ndim: int, ncubes: int, chunk_cubes: int,
                 position: str) -> int:
    """First cube of the checked chunk: 'end' is the LAST chunk of the
    lattice shifted so that its last cubes lie beyond ``ncubes``; 'middle'
    is centred on the cube at the middle of every axis, where a centred
    peak lives."""
    if position == "end":
        return ncubes - chunk_cubes + max(chunk_cubes // 64, 1)
    centre = sum((ng // 2) * ng ** k for k in range(ndim))
    return max(min(centre - chunk_cubes // 2, ncubes - chunk_cubes), 0)


def sampler_case(ndim: int, ncall: float, chunk_cubes: int, *,
                 nbins: int = 500, degree: int = 14, seed: int = 0,
                 lows=None, highs=None, position: str = "end",
                 device="cuda"):
    """Arguments of one sampler chunk at the stratification of ``ncall``
    calls: a map fitted to a random grid, and the chunk that
    ``_chunk_start`` places."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk_cubes = min(chunk_cubes, ncubes)
    lows = np.zeros(ndim) if lows is None else np.asarray(lows, float)
    highs = np.ones(ndim) if highs is None else np.asarray(highs, float)
    p, q = fit_importance_poly(random_grid(ndim, nbins, seed), degree)
    f32 = torch.float32
    pmap = cuda_vegas.fold_map(
        torch.as_tensor(p, dtype=f32, device=device),
        torch.as_tensor(q, dtype=f32, device=device),
        torch.as_tensor(lows, device=device),
        torch.as_tensor(highs - lows, device=device))
    return {"pmap": pmap, "ng": ng, "npg": npg, "chunk_cubes": chunk_cubes,
            "nbins": nbins, "xjac": float(np.prod(highs - lows))
            / (float(npg) * ncubes),
            "cube0": _chunk_start(ng, ndim, ncubes, chunk_cubes, position),
            "ncubes": ncubes}


def _case_bits(case, seed: int):
    """Words of a numpy generator, as the int32 tensor ``bits=`` takes."""
    rng = np.random.default_rng(seed)
    rows = case["npg"] * case["pmap"].ndim
    words = rng.integers(0, 2 ** 32, (rows, case["chunk_cubes"]),
                         dtype=np.uint64).astype(np.uint32)
    return torch.as_tensor(words.view(np.int32),
                           device=case["pmap"].table.device)


def check_sampler(case, integrand=None, *, with_hist: bool, rng: str,
                  seed: int = 0, iteration: int = 1):
    """One sampler launch against ``sample_chunk_plain``: emit mode when
    ``integrand`` is None, else fused with that Genz family.  ``rng``:
    'device' (the Philox stream of (seed, iteration)) or 'input' (the same
    words given to both as a tensor)."""
    pmap = case["pmap"]
    args = (pmap, integrand, case["ng"], case["npg"], case["chunk_cubes"],
            case["nbins"], with_hist, case["xjac"], case["cube0"],
            case["ncubes"], seed, iteration)
    kw = {"bits": _case_bits(case, seed) if rng == "input" else None,
          "emit_points": integrand is None}
    k = cuda_vegas.sample_chunk(*args, **kw)
    if pmap.table.is_cuda:
        torch.cuda.synchronize()
    p = cuda_vegas.sample_chunk_plain(*args, **kw)
    ndim, npg = pmap.ndim, case["npg"]
    pf, q, _, _ = pmap.parts()
    s_x = pf.abs().sum(dim=1)                                    # (ndim,)
    out = {"samples": case["chunk_cubes"] * npg}
    label = (f"sampler {'emit' if integrand is None else integrand.name} "
             f"hist={with_hist} rng={rng}")
    ia = 2 if integrand is None else 1
    if with_hist and not torch.equal(k[ia], p[ia]):
        raise AssertionError(
            f"{label}: {int((k[ia] != p[ia]).sum())} bin ids differ")
    out["ia_equal"] = bool(with_hist)
    if integrand is None:
        out["max_abs_x"] = _top((k[0] - p[0]).abs())
        out["x_ulps"] = _top((k[0] - p[0]).abs() / (EPS32 * s_x[:, None]))
        s_w = float(torch.prod(q.abs().sum(dim=1) ** 2))
        out["w_ulps"] = _top((k[1] - p[1]).abs() / (EPS32 * s_w))
    else:
        # rounding scale of each sample value, from the plain emit mode
        xs, wt, _ = cuda_vegas.sample_chunk_plain(
            *args[:6], False, *args[7:], bits=kw["bits"], emit_points=True)
        f, _ = make_integrand(integrand, ndim)
        x = xs.T.detach().requires_grad_(True)
        with torch.enable_grad():
            fx = f(x) * (wt * case["xjac"])
            (grad,) = torch.autograd.grad(fx.sum(), x)
        fx = fx.detach()
        u = fx.abs() + (grad.abs() * s_x[None, :]).sum(dim=1)
        fx_c, u_c = fx.view(-1, npg), u.view(-1, npg)
        fb = fx_c.sum(dim=1, keepdim=True)
        s_fb = float(u.double().sum())
        s_f2b = float((2.0 * (npg * fx_c - fb).abs() * u_c).double().sum()
                      + npg * (fx * fx).double().sum())
        tiny = float(torch.finfo(torch.float32).tiny)
        out["fb_ulps"] = abs(float(k[0][0] - p[0][0])) / (EPS32 * s_fb + tiny)
        out["f2b_ulps"] = abs(float(k[0][1] - p[0][1])) / (EPS32 * s_f2b
                                                            + tiny)
        out["sum_fb"], out["sum_f2b"] = float(k[0][0]), float(k[0][1])
        if with_hist:
            out["f2_ulps"] = _top((k[2] - p[2]).abs()
                                  / (EPS32 * 2.0 * fx.abs() * u + tiny))
    for key, limit in (("x_ulps", ULPS["x"]), ("w_ulps", ULPS["w"]),
                       ("f2_ulps", ULPS["f2"]), ("fb_ulps", ULPS["fb"]),
                       ("f2b_ulps", ULPS["f2b"])):
        if key in out and not out[key] <= limit:
            raise AssertionError(f"{label}: {key} {out[key]:.3g} beyond the "
                                 f"limit {limit:g}")
    return out


def check_stream(case, *, seed: int = 0, iteration: int = 1):
    """The kernel's generator against the plain one, word for word: under
    the identity map (P(s) = s, q = 1, unit volume) no multiply-add rounds
    differently, so the emitted coordinate is the stratified position
    (kg + (1 - u)) / ng itself and must be EQUAL to the plain version's in
    every sample -- which it is only if every 24-bit uniform is."""
    pmap = case["pmap"]
    dev, ndim = pmap.table.device, pmap.ndim
    f32 = torch.float32
    ident = cuda_vegas.fold_map(
        torch.tensor([[0.5, 0.5]] * ndim, dtype=f32, device=dev),
        torch.ones((ndim, 1), dtype=f32, device=dev),
        torch.zeros(ndim, dtype=f32, device=dev),
        torch.ones(ndim, dtype=f32, device=dev))
    args = (ident, None, case["ng"], case["npg"], case["chunk_cubes"],
            case["nbins"], True, case["xjac"], case["cube0"], case["ncubes"],
            seed, iteration)
    k = cuda_vegas.sample_chunk(*args, emit_points=True)
    p = cuda_vegas.sample_chunk_plain(*args, emit_points=True)
    for name, a, b in zip(("xs", "wt", "ia"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(
                f"stream: {int((a != b).sum())} of {a.numel()} {name} differ "
                "under the identity map: the generators disagree")
    return {"samples": k[1].numel(), "uniforms": k[0].numel()}


def check_hist(ndim: int, n: int, nbins: int, *, seed: int = 0,
               device="cuda"):
    """The histogram kernel against ``hist_plain`` within HIST_RTOL per
    bin, two launches bitwise equal, and an inf and a value above the cap
    in f2 leaving every bin finite."""
    rng = np.random.default_rng(seed)
    ia = torch.as_tensor(rng.integers(0, nbins, (ndim, n), dtype=np.int32),
                         device=device)
    f2_np = rng.random(n, dtype=np.float32) ** 8      # a wide dynamic range
    f2_np[:2] = [np.inf, 1e38]
    f2 = torch.as_tensor(f2_np, device=device)
    k1 = cuda_lookup.hist(ia, f2, nbins)
    k2 = cuda_lookup.hist(ia, f2, nbins)
    p = cuda_lookup.hist_plain(ia, f2, nbins)
    if not torch.equal(k1, k2):
        raise AssertionError("histogram: two launches on one input differ")
    if not bool(torch.isfinite(k1).all()):
        raise AssertionError("histogram: a non-finite bin")
    rel = _top((k1 - p).abs() / p.abs().clamp_min(1e-30))
    if not rel <= HIST_RTOL:
        raise AssertionError(f"histogram: a bin {rel:.3g} from the plain "
                             f"version's, beyond {HIST_RTOL:g}")
    return {"samples": n, "max_rel": rel, "repeat_bitwise": True,
            "max_abs": _top((k1 - p).abs())}


def _ulp_gap(a, b) -> int:
    """Largest distance between two f32 tensors of one sign, in ulps."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max()) if a.numel() else 0


def check_bin_resolve(ndim: int, n: int, nbins: int, *, seed: int = 0,
                      device="cuda"):
    """The bin-resolve kernel on given xn against ``bin_resolve_plain``:
    ia and xo EQUAL, rc within RC_ULP ulps."""
    rng = np.random.default_rng(seed)
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    xn_np = (1.0 + rng.random((ndim, n)) * nbins).astype(np.float32)
    xn_np[:, 0] = 1.0                      # the lowest coordinate
    xn = torch.as_tensor(np.minimum(xn_np, np.nextafter(
        np.float32(nbins + 1), np.float32(0))), device=device)
    k = cuda_lookup.bin_resolve(xi32, xn, nbins, with_ia=True)
    p = cuda_lookup.bin_resolve_plain(xi32, xn, nbins, with_ia=True)
    return _judge_resolve("bin_resolve", k, p, n)


def check_bin_resolve_stratified(ndim: int, ncall: float, chunk_cubes: int,
                                 nbins: int, *, seed: int = 0,
                                 iteration: int = 1, device="cuda"):
    """The kernel drawing xn itself against the plain draw and resolve,
    on the last chunk of the lattice shifted beyond its end."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk_cubes = min(chunk_cubes, ncubes)
    cube0 = _chunk_start(ng, ndim, ncubes, chunk_cubes, "end")
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    args = (xi32, nbins, ng, npg, chunk_cubes, cube0, ncubes, seed, iteration)
    k = cuda_lookup.bin_resolve_stratified(*args, with_ia=True)
    p = cuda_lookup.bin_resolve_stratified_plain(*args, with_ia=True)
    return _judge_resolve("bin_resolve (stream)", k, p, chunk_cubes * npg)


def _judge_resolve(label, k, p, n):
    for name, a, b in (("xo", k[1], p[1]), ("ia", k[2], p[2])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: {int((a != b).sum())} of {a.numel()} {name} differ")
    gap = _ulp_gap(k[0], p[0])
    if gap > RC_ULP:
        raise AssertionError(f"{label}: rc {gap} ulps from the plain "
                             f"version's, beyond {RC_ULP}")
    return {"samples": n, "rc_ulps": gap,
            "max_abs": _top((k[0] - p[0]).abs())}


def check_edge_lookup(ndim: int, cubes: int, npg: int, nbins: int, *,
                      seed: int = 0, device="cuda"):
    """The edge-lookup kernel against ``edge_lookup_plain``: EQUAL."""
    rng = np.random.default_rng(seed)
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    ia = torch.as_tensor(
        rng.integers(1, nbins + 1, (cubes, npg, ndim), dtype=np.int32),
        device=device)
    k = cuda_lookup.edge_lookup(xi32, ia, nbins)
    p = cuda_lookup.edge_lookup_plain(xi32, ia, nbins)
    for name, a, b in zip(("lo", "hi"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(f"edge_lookup: {int((a != b).sum())} of "
                                 f"{a.numel()} {name} edges differ")
    return {"samples": cubes * npg, "max_abs": 0.0}
