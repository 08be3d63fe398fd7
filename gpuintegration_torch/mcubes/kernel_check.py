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
  sensitive than f; the derivative comes from autograd);
* one sample's f^2 = fx^2: fx also carries the weight's rounding, whose
  scale lies well above the weight itself where the q series cancel (some 30
  times at the default degree), so ``v = u + |f(x) xjac| prod_d (sum_i
  |q_di|)^2``, and an error of r ulps of v in fx moves f^2 by
  ``2 |fx| r v + (r v)^2``: the reading is the r that solves this for the
  difference found (the square matters where fx crosses zero);
* the chunk's sums: ``sum fb``: ``sum_n u_n``; ``sum f2b``:
  ``sum_n 2 |npg fx_n - fb_c| u_n + sum_c npg sum f^2``.  The weights'
  roundings average out over a chunk, so the sums are held to u, not v.
  f2b is floored: a cube whose ``npg sum f^2 - fb^2`` lies within its own
  rounding of zero (or whose f^2 fall below the f32 normal range) may take
  the floor TINY in one computation and not in the other.  With t such
  cubes in the chunk, the nearest whole number of TINY, at most t, is taken
  off the difference before it is read (``f2b_floor_steps`` of
  ``f2b_floor_ties``; ``f2b_ulps_before_floor_ties`` is the reading with
  nothing taken off).

ULPS holds the limits, a small factor above the largest readings taken on
an H100 (PERF.md).  The histogram is held to the plain version within
HIST_RTOL per bin, and to itself bitwise across two launches; its routes
add in different orders, so they agree within HIST_RTOL, not bitwise.  The
bin resolve's ``rc`` is held to RC_ULP ulps of its value; its routes
compute alike and must be EQUAL.
"""
from __future__ import annotations

import numpy as np
import torch

from gpuintegration_torch.integrand import make_integrand
from gpuintegration_torch.mcubes import cuda_lookup, cuda_vegas
from gpuintegration_torch.mcubes import stream
from gpuintegration_torch.mcubes import vegas as V
from gpuintegration_torch.mcubes.grid import TINY
from gpuintegration_torch.mcubes.poly_importance import fit_importance_poly

ULPS = {"x": 16.0, "w": 8.0, "f2": 16.0, "fb": 1.0, "f2b": 1.0}
HIST_RTOL = 1e-6
RC_ULP = 2
EPS32 = float(torch.finfo(torch.float32).eps)
TINY32 = float(torch.finfo(torch.float32).tiny)
DENORM32 = 2.0 ** -149     # the spacing of f32 below its normal range


def random_grid(ndim: int, nbins: int, seed: int) -> np.ndarray:
    """A VEGAS-like grid: (ndim, nbins+1) f64, monotone from 0 to 1."""
    rng = np.random.default_rng(seed)
    w = rng.random((ndim, nbins)) + 0.05
    xi = np.concatenate([np.zeros((ndim, 1)), np.cumsum(w, axis=1)], axis=1)
    return xi / xi[:, -1:]


def _top(t) -> float:
    return float(t.amax()) if t.numel() else 0.0


def _same(a, b) -> bool:
    """Two scalar tensors equal, or both NaN."""
    return bool(a == b) or bool(torch.isnan(a) & torch.isnan(b))


def _bits_equal(x, y) -> bool:
    """Two tensors the same bits (NaNs included)."""
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


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
                  seed: int = 0, iteration: int = 1,
                  route: str | None = None, weight_witness: bool = False):
    """One sampler launch (by ``route``; None: the route the shape takes)
    against ``sample_chunk_plain``: emit mode when ``integrand`` is None,
    else fused with that Genz family.  ``rng``: 'device' (the Philox
    stream of (seed, iteration)) or 'input' (the same words given to both
    as a tensor).  ``weight_witness`` (emit mode): the weights are held
    to the f64 evaluation instead (``_weight_witness``: within ULPS['w']
    of it, and no farther than the plain version lies plus one ulp), for
    maps whose weight is one or two factors, where the plain version's own
    roundings reach the limit; ``w_ulps`` is still read against it."""
    pmap = case["pmap"]
    args = (pmap, integrand, case["ng"], case["npg"], case["chunk_cubes"],
            case["nbins"], with_hist, case["xjac"], case["cube0"],
            case["ncubes"], seed, iteration)
    kw = {"bits": _case_bits(case, seed) if rng == "input" else None,
          "emit_points": integrand is None}
    named = {} if route is None else {"route": route}
    k = cuda_vegas.sample_chunk(*args, **kw, **named)
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
        if weight_witness:
            wk, wp = _weight_witness(case, k[1], p[1], kw["bits"], seed,
                                     iteration, s_w)
            out["kernel_w_f64_ulps"], out["plain_w_f64_ulps"] = wk, wp
            if not (wk <= ULPS["w"] and wk <= wp + 1.0):
                raise AssertionError(
                    f"{label}: weights {wk:.3g} ulps from the f64 "
                    f"evaluation (the plain version {wp:.3g}; limit "
                    f"{ULPS['w']:g})")
    else:
        # rounding scale of each sample value, from the plain emit mode
        xs, wt, _ = cuda_vegas.sample_chunk_plain(
            *args[:6], False, *args[7:], bits=kw["bits"], emit_points=True)
        s_w = float(torch.prod(q.abs().sum(dim=1) ** 2))
        fx, u, v = _value_scales(integrand, xs, wt, case["xjac"], s_x, s_w)
        fx_c, u_c = fx.view(-1, npg), u.view(-1, npg)
        fb = fx_c.sum(dim=1, keepdim=True)
        s_fb = float(u.double().sum())
        s_f2b_c = ((2.0 * (npg * fx_c - fb).abs() * u_c).double().sum(dim=1)
                   + npg * (fx_c * fx_c).double().sum(dim=1))
        unit = EPS32 * float(s_f2b_c.sum()) + TINY32
        # equal sums read 0 whatever their scale, infinite or NaN ones too
        # (values past the f32 range: F2's peak and F6's exponent from 9D)
        dfb, diff = (0.0 if _same(k[0][j], p[0][j])
                     else float(k[0][j] - p[0][j]) for j in (0, 1))
        out["fb_ulps"] = (abs(dfb) / (EPS32 * s_fb + TINY32) if dfb
                          else 0.0)
        # cubes that may take the floor on one side only
        f2b_c = (npg * (fx_c.double() ** 2).sum(dim=1)
                 - fx_c.double().sum(dim=1) ** 2)
        cube = case["cube0"] + torch.arange(fx_c.shape[0], device=fx.device)
        ties = int(((f2b_c <= EPS32 * s_f2b_c + npg * npg * DENORM32)
                    & (cube < case["ncubes"])).sum())
        steps = max(-ties, min(ties, round(diff / TINY))) if diff else 0
        out["f2b_ulps"] = abs(diff - steps * TINY) / unit if diff else 0.0
        out["f2b_ulps_before_floor_ties"] = abs(diff) / unit if diff else 0.0
        out["f2b_floor_ties"], out["f2b_floor_steps"] = ties, steps
        out["sum_fb"], out["sum_f2b"] = float(k[0][0]), float(k[0][1])
        if with_hist:
            out["f2_ulps"] = _top(_square_ulps(k[2], p[2], fx, v))
    for key, limit in (("x_ulps", ULPS["x"]), ("w_ulps", ULPS["w"]),
                       ("f2_ulps", ULPS["f2"]), ("fb_ulps", ULPS["fb"]),
                       ("f2b_ulps", ULPS["f2b"])):
        if key in out and not out[key] <= limit and not (
                key == "w_ulps" and weight_witness):
            raise AssertionError(f"{label}: {key} {out[key]:.3g} beyond the "
                                 f"limit {limit:g}")
    return out


def _weight_witness(case, wk, wp, bits, seed, iteration, s_w):
    """How far the kernel's weights ``wk`` and the plain version's ``wp``
    lie from the weights evaluated in f64 from the same f32 positions
    (which both share bit for bit) and the map's f32 coefficients, in f32
    ulps of the weight's rounding scale ``s_w``, over the cubes inside the
    lattice."""
    pmap, npg, chunk = case["pmap"], case["npg"], case["chunk_cubes"]
    ndim, dev = pmap.ndim, pmap.table.device
    cube = case["cube0"] + torch.arange(chunk, dtype=torch.int64, device=dev)
    kg = (stream.decode_cube(cube, case["ng"], ndim) - 1).T.to(torch.float32)
    words = bits if bits is not None else stream.stream_bits(
        seed, iteration, cube, npg, ndim)
    uni = stream.bits_to_uniform(words).reshape(npg, ndim, chunk)
    s32 = (kg[None] + (1.0 - uni)) * (1.0 / case["ng"])
    pf, q, _, _ = (t.double() for t in pmap.parts())
    w64 = 1.0
    for d in range(ndim):
        _, acc_q = cuda_vegas._cheb_joint(pf[d], q[d],
                                          (2.0 * s32[:, d] - 1.0).double())
        w64 = w64 * (acc_q * acc_q)
    w64 = w64.T.reshape(-1)
    inside = torch.repeat_interleave(cube < case["ncubes"], npg)

    def ulps(w):
        return _top((w.double() - w64).abs()[inside]) / (EPS32 * s_w)
    return ulps(wk), ulps(wp)


def _value_scales(integrand, xs, wt, xjac, s_x, s_w):
    """(fx, u, v) of the plain emit mode's samples: the value
    fx = f(x) w xjac in f32, its rounding scale u (its own size and the
    coordinates' roundings through df/dx, by autograd) and v = u + the
    weight's rounding scale |f(x) xjac| s_w."""
    f, _ = make_integrand(integrand, xs.shape[0])
    x = xs.T.detach().requires_grad_(True)
    with torch.enable_grad():
        fval = f(x)
        fx = fval * (wt * xjac)
        (grad,) = torch.autograd.grad(fx.sum(), x)
    fx = fx.detach()
    u = fx.abs() + (grad.abs() * s_x[None, :]).sum(dim=1)
    return fx, u, u + (fval.detach() * xjac).abs() * s_w


def _square_ulps(a, b, fx, v):
    """The difference of two f32 values of fx^2 as an error of fx, in ulps
    of fx's rounding scale ``v``: the r >= 0 with
    |a - b| = 2 |fx| (r eps v) + (r eps v)^2, the first term carrying the
    f32 normal range's floor.  Where |fx| is well above its error this is
    |a - b| / (eps 2 |fx| v)."""
    d = (a - b).abs().double()
    lin = EPS32 * 2.0 * fx.abs().double() * v.double() + TINY32
    quad = (EPS32 * v.double()) ** 2
    # equal values read 0 whatever the scale (a peak's f32 scale overflows)
    r = 2.0 * d / (lin + torch.sqrt(lin * lin + 4.0 * quad * d))
    return torch.where(d > 0.0, r, torch.zeros_like(r))


def sampler_f64_witness(case, integrand, *, rng: str, seed: int = 0,
                        iteration: int = 1, route: str | None = None):
    """A second witness for the fused mode: the sampler's function evaluated
    in f64 from the f32 stratified positions (which kernel and plain
    version share bit for bit), with the map's f32 coefficients.  Returns
    how far the kernel's and the plain version's f^2 lie from it, in ulps
    of the rounding scale v, and how far their sums of f2b lie from the
    f64 sum, in units of the floor TINY: the f64 values take the floor only
    at an exact zero, so each figure is the number of cubes that computation
    floored, up to the roundings."""
    pmap, ndim, npg = case["pmap"], case["pmap"].ndim, case["npg"]
    dev, chunk = pmap.table.device, case["chunk_cubes"]
    args = (pmap, integrand, case["ng"], npg, chunk, case["nbins"], True,
            case["xjac"], case["cube0"], case["ncubes"], seed, iteration)
    bits = _case_bits(case, seed) if rng == "input" else None
    k = cuda_vegas.sample_chunk(*args, bits=bits,
                                **({} if route is None else {"route": route}))
    p = cuda_vegas.sample_chunk_plain(*args, bits=bits)
    xs, wt, _ = cuda_vegas.sample_chunk_plain(
        *args[:6], False, *args[7:], bits=bits, emit_points=True)

    # the f32 positions as the plain version forms them, then f64
    cube = case["cube0"] + torch.arange(chunk, dtype=torch.int64, device=dev)
    valid = cube < case["ncubes"]
    kg = (stream.decode_cube(cube, case["ng"], ndim) - 1).T.to(torch.float32)
    words = bits if bits is not None else stream.stream_bits(
        seed, iteration, cube, npg, ndim)
    uni = stream.bits_to_uniform(words).reshape(npg, ndim, chunk)
    s32 = (kg[None] + (1.0 - uni)) * (1.0 / case["ng"])
    pf, q, lo, hi = (t.double() for t in pmap.parts())
    x64, w64 = [], 1.0
    for d in range(ndim):
        acc_p, acc_q = cuda_vegas._cheb_joint(
            pf[d], q[d], (2.0 * s32[:, d] - 1.0).double())
        x64.append(torch.minimum(torch.maximum(acc_p, lo[d]), hi[d]))
        w64 = w64 * (acc_q * acc_q)
    f, _ = make_integrand(integrand, ndim)
    fx64 = f(torch.stack(x64, dim=-1)) * (
        w64 * float(np.float32(case["xjac"])))                  # (npg, C)
    fx64 = torch.where(valid[None], fx64, torch.zeros_like(fx64))
    f2b64 = npg * (fx64 * fx64).sum(dim=0) - fx64.sum(dim=0) ** 2
    f2b64 = torch.where(f2b64 <= 0.0, torch.full_like(f2b64, TINY), f2b64)
    sum64 = float(torch.where(valid, f2b64, torch.zeros_like(f2b64)).sum())

    s_x = pmap.parts()[0].abs().sum(dim=1)
    s_w = float(torch.prod(pmap.parts()[1].abs().sum(dim=1) ** 2))
    fx, _, v = _value_scales(integrand, xs, wt, case["xjac"], s_x, s_w)
    f2_64 = (fx64 * fx64).T.reshape(-1)
    return {"samples": chunk * npg,
            "kernel_f2_ulps": _top(_square_ulps(k[2], f2_64, fx, v)),
            "plain_f2_ulps": _top(_square_ulps(p[2], f2_64, fx, v)),
            "kernel_f2b_floors": (float(k[0][1]) - sum64) / TINY,
            "plain_f2b_floors": (float(p[0][1]) - sum64) / TINY,
            "sum_f2b_f64": sum64}


_OUTPUT_NAMES = {"xs": "coordinates", "wt": "weights", "ia": "bin ids",
                 "f2": "values of f^2"}


def check_sampler_routes(case, integrand=None, *, with_hist: bool, rng: str,
                         seed: int = 0, iteration: int = 1):
    """The route the shape takes (``sampler_route``: 'paired' or 'wide')
    and the generic route on one chunk, each launched twice.  A route must
    repeat its bits.  Within a chain every route keeps the generic kernel's
    order of operations, so between the routes the coordinates, weights,
    bin ids and f^2 must be EQUAL; the f64 sums over the chunk's cubes,
    which the routes group otherwise, are read in f64 ulps of the larger
    value and reported.  Meaningful on CUDA tensors only."""
    pmap = case["pmap"]
    args = (pmap, integrand, case["ng"], case["npg"], case["chunk_cubes"],
            case["nbins"], with_hist, case["xjac"], case["cube0"],
            case["ncubes"], seed, iteration)
    kw = {"bits": _case_bits(case, seed) if rng == "input" else None,
          "emit_points": integrand is None}
    label = (f"sampler {'emit' if integrand is None else integrand.name} "
             f"hist={with_hist} rng={rng}")
    routes = list(dict.fromkeys(
        [cuda_vegas.sampler_route(pmap.ndim, pmap.kp, pmap.kq), "generic"]))
    outs = {}
    for route in routes:
        a, b = (cuda_vegas.sample_chunk(*args, **kw, route=route)
                for _ in range(2))
        if pmap.table.is_cuda:
            torch.cuda.synchronize()
        for x, y in zip(a, b):
            if x is not None and not _bits_equal(x, y):
                raise AssertionError(f"{label}: two launches of the {route} "
                                     "route differ")
        outs[route] = a
    names = ("xs", "wt", "ia") if integrand is None else ("sums", "ia", "f2")
    out = {"samples": case["chunk_cubes"] * case["npg"], "routes": routes}
    for name, x, y in zip(names, outs[routes[0]], outs["generic"]):
        if x is None:
            continue
        if name != "sums":
            if not _bits_equal(x, y):
                raise AssertionError(
                    f"{label}: {int((x != y).sum())} of {x.numel()} "
                    f"{_OUTPUT_NAMES[name]} differ between the {routes[0]} "
                    "and the generic route")
            out[f"{name}_equal"] = True
            continue
        eps = float(torch.finfo(x.dtype).eps)
        size = torch.maximum(x.abs(), y.abs()).clamp_min(
            float(torch.finfo(x.dtype).tiny))
        out[f"{name}_ulps"] = _top((x - y).abs() / (eps * size))
    return out


def check_stream(case, *, seed: int = 0, iteration: int = 1,
                 route: str | None = None):
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
    k = cuda_vegas.sample_chunk(*args, emit_points=True,
                                **({} if route is None else {"route": route}))
    p = cuda_vegas.sample_chunk_plain(*args, emit_points=True)
    for name, a, b in zip(("xs", "wt", "ia"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(
                f"stream: {int((a != b).sum())} of {a.numel()} {name} differ "
                "under the identity map: the generators disagree")
    return {"samples": k[1].numel(), "uniforms": k[0].numel()}


def _hist_case(ndim: int, n: int, nbins: int, seed: int, device):
    """Bin ids (ndim, n) int32 and f2 (n,) f32 of a wide dynamic range, an
    inf and a value above the cap among them."""
    rng = np.random.default_rng(seed)
    ia = torch.as_tensor(rng.integers(0, nbins, (ndim, n), dtype=np.int32),
                         device=device)
    f2_np = rng.random(n, dtype=np.float32) ** 8
    f2_np[:2] = [np.inf, 1e38]
    return ia, torch.as_tensor(f2_np, device=device)


def check_hist(ndim: int, n: int, nbins: int, *, seed: int = 0,
               device="cuda"):
    """The histogram kernel against ``hist_plain`` within HIST_RTOL per
    bin, two launches bitwise equal, and an inf and a value above the cap
    in f2 leaving every bin finite."""
    ia, f2 = _hist_case(ndim, n, nbins, seed, device)
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


def _hist_rel(k, p) -> float:
    return _top((k - p).abs() / p.abs().clamp_min(1e-30))


def check_hist_routes(ndim: int, n: int, nbins: int, *, seed: int = 0,
                      device="cuda"):
    """Each histogram route that takes the shape (``hist_route`` names the
    shape's own) against ``hist_plain`` within HIST_RTOL per bin, two
    launches bitwise equal, every bin finite; f2 in f64 giving the bits of
    f2 in f32.  The accumulating form, from an accumulator whose bins lie
    near HIST_CAP, 0 and in between, with ids 1-based (base 1): within
    HIST_RTOL of ``hist_accum_plain``, twice the same bits, and EQUAL to
    min(d + the route's own histogram, HIST_CAP).  Returns the readings
    per route."""
    ia, f2 = _hist_case(ndim, n, nbins, seed, device)
    p = cuda_lookup.hist_plain(ia, f2, nbins)
    rng = np.random.default_rng(seed + 1)
    d0 = rng.random((ndim, nbins)) * cuda_lookup.HIST_CAP
    d0[:, ::3] = 0.0
    d0[:, 1::3] *= 1e-30
    d0 = torch.as_tensor(d0, dtype=torch.float32, device=device)
    acc_p = cuda_lookup.hist_accum_plain(d0, ia + 1, f2, nbins, base=1)
    routes = [r for r in cuda_lookup.HIST_ROUTES
              if r == "generic" or cuda_lookup.hist_route(ndim, nbins) == r]
    out = {"samples": n, "routes": routes}
    for route in routes:
        label = f"histogram ({route} route)"
        k1, k2 = (cuda_lookup.hist(ia, f2, nbins, route=route)
                  for _ in range(2))
        a1, a2 = (cuda_lookup.hist_accum(d0.clone(), ia + 1, f2, nbins,
                                         base=1, route=route)
                  for _ in range(2))
        if not (torch.equal(k1, k2) and torch.equal(a1, a2)):
            raise AssertionError(f"{label}: two launches on one input differ")
        if route == "grouped" and not torch.equal(
                cuda_lookup.hist(ia, f2.double(), nbins, route=route), k1):
            raise AssertionError(f"{label}: f2 in f64 gives other bits than "
                                 "f2 in f32")
        if not (bool(torch.isfinite(k1).all())
                and bool(torch.isfinite(a1).all())):
            raise AssertionError(f"{label}: a non-finite bin")
        if not torch.equal(a1, torch.clamp(d0 + k1,
                                           max=cuda_lookup.HIST_CAP)):
            raise AssertionError(f"{label}: the accumulating form is not "
                                 "min(d + the histogram, HIST_CAP)")
        rel, rel_acc = _hist_rel(k1, p), _hist_rel(a1, acc_p)
        if not max(rel, rel_acc) <= HIST_RTOL:
            raise AssertionError(f"{label}: a bin {max(rel, rel_acc):.3g} "
                                 "from the plain version's, beyond "
                                 f"{HIST_RTOL:g}")
        out[route] = {"max_rel": rel, "accum_max_rel": rel_acc,
                      "max_abs": _top((k1 - p).abs()), "hist": k1}
    if len(routes) == 2:
        out["between_routes_max_rel"] = _hist_rel(out["grouped"]["hist"],
                                                  out["generic"]["hist"])
    for route in routes:
        del out[route]["hist"]
    return out


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


def check_resolve_routes(ndim: int, ncall: float, chunk_cubes: int,
                         nbins: int, *, seed: int = 0, iteration: int = 1,
                         device="cuda"):
    """The bin-resolve routes against each other: rc, xo and ia EQUAL,
    drawing xn at the chunk around the volume's centre and at the last
    chunk shifted beyond the lattice's end, and given xn over n samples and
    n - 3 (a ragged row); each also against the plain version (ia, xo
    EQUAL, rc within RC_ULP)."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk_cubes = min(chunk_cubes, ncubes)
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    routes = [r for r in cuda_lookup.RESOLVE_ROUTES if r == "generic"
              or cuda_lookup.resolve_route(ndim, nbins, chunk_cubes * npg) == r]
    out = {"samples": chunk_cubes * npg, "routes": routes, "rc_ulps": 0,
           "max_abs": 0.0}
    cases = []
    for position in ("middle", "end"):
        args = (xi32, nbins, ng, npg, chunk_cubes,
                _chunk_start(ng, ndim, ncubes, chunk_cubes, position), ncubes,
                seed, iteration)
        cases.append((f"drawing xn, chunk at the {position}",
                      lambda route, args=args: cuda_lookup
                      .bin_resolve_stratified(*args, with_ia=True,
                                              route=route),
                      cuda_lookup.bin_resolve_stratified_plain(
                          *args, with_ia=True)))
    rng = np.random.default_rng(seed)
    for n in (chunk_cubes * npg, chunk_cubes * npg - 3):
        xn = torch.as_tensor((1.0 + rng.random((ndim, n)) * nbins).astype(
            np.float32), device=device).clamp_(max=float(np.nextafter(
                np.float32(nbins + 1), np.float32(0))))
        cases.append((f"given xn, {n} samples",
                      lambda route, xn=xn: cuda_lookup.bin_resolve(
                          xi32, xn, nbins, with_ia=True, route=route),
                      cuda_lookup.bin_resolve_plain(xi32, xn, nbins,
                                                    with_ia=True)))
    for label, run, plain in cases:
        got = {}
        for route in routes:
            got[route] = run(route)
            r = _judge_resolve(f"bin_resolve ({route} route, {label})",
                               got[route], plain, out["samples"])
            out["rc_ulps"] = max(out["rc_ulps"], r["rc_ulps"])
            out["max_abs"] = max(out["max_abs"], r["max_abs"])
        for name, a, b in zip(("rc", "xo", "ia"), got[routes[0]],
                              got[routes[-1]]):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"bin_resolve ({label}): {int((a != b).sum())} of "
                    f"{a.numel()} {name} differ between the routes")
    return out


def edge_ids(cubes: int, npg: int, ndim: int, nbins: int, *, seed: int = 0,
             offset: int = 0, device="cuda"):
    """Uniformly random bin ids in [1, nbins], (cubes, npg, ndim) int32, as
    a view ``offset`` elements into its storage (an offset of 1-3 leaves
    the data off a 16-byte boundary)."""
    rng = np.random.default_rng(seed)
    flat = torch.as_tensor(rng.integers(1, nbins + 1, offset + cubes * npg
                                        * ndim, dtype=np.int32), device=device)
    return flat[offset:].view(cubes, npg, ndim)


def check_edge_lookup(ndim: int, cubes: int, npg: int, nbins: int, *,
                      route: str | None = None, offset: int = 0,
                      seed: int = 0, ia=None, device="cuda"):
    """The edge-lookup kernel (the route ``edge_route`` gives the shape, or
    ``route``) against ``edge_lookup_plain``: EQUAL.  The ids are ``ia``,
    or ``edge_ids(cubes, npg, ndim, nbins, seed=, offset=)``.  Returns the
    kernel's (lo, hi) beside the counts."""
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    if ia is None:
        ia = edge_ids(cubes, npg, ndim, nbins, seed=seed, offset=offset,
                      device=device)
    k = cuda_lookup.edge_lookup(xi32, ia, nbins, route=route)
    p = cuda_lookup.edge_lookup_plain(xi32, ia, nbins)
    for name, a, b in zip(("lo", "hi"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(f"edge_lookup ({route or 'default'} route): "
                                 f"{int((a != b).sum())} of {a.numel()} "
                                 f"{name} edges differ")
    return {"samples": ia.numel() // ndim, "max_abs": 0.0, "edges": k}


def check_edge_routes(ndim: int, cubes: int, npg: int, nbins: int, *,
                      offset: int = 0, seed: int = 0, ia=None, device="cuda"):
    """Every edge-lookup route that takes the shape, each against
    ``edge_lookup_plain`` and the routes against each other: EQUAL."""
    routes = [r for r in cuda_lookup.EDGE_ROUTES if r == "generic"
              or cuda_lookup.edge_route(ndim, nbins) == r]
    got = {r: check_edge_lookup(ndim, cubes, npg, nbins, route=r,
                                offset=offset, seed=seed, ia=ia,
                                device=device)["edges"] for r in routes}
    for name, a, b in zip(("lo", "hi"), got[routes[0]], got[routes[-1]]):
        if not torch.equal(a, b):
            raise AssertionError(
                f"edge_lookup: {int((a != b).sum())} of {a.numel()} {name} "
                "edges differ between the routes")
    return {"samples": got[routes[0]][0].numel() // ndim, "routes": routes,
            "max_abs": 0.0}


def _equal_outputs(label, got, want, names):
    for name, a, b in zip(names, got, want):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            diff = "one is missing" if a is None or b is None else (
                f"{int((a != b).sum())} of {a.numel()} differ")
            raise AssertionError(f"{label}: {name}: {diff}")


def _replayed(launch, counter, iterations):
    """The outputs of ``launch(counter)`` with the 0-d counter filled with
    each of ``iterations``: on the card ONE launch captured in a CUDA graph
    and replayed after each fill (its outputs cloned), as the device-resident
    phases replay it; on the CPU a call a fill."""
    out = []
    if counter.device.type != "cuda":
        for it in iterations:
            counter.fill_(it)
            out.append(launch(counter))
        return out
    launch(counter)     # builds and configures outside the capture
    side = torch.cuda.Stream(device=counter.device)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        static = launch(counter)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for it in iterations:
        counter.fill_(it)
        graph.replay()
        out.append(tuple(None if t is None else t.clone() for t in static))
    return out


def check_sampler_counter(case, integrand=None, *, with_hist: bool,
                          seed: int = 0, iteration: int = 1,
                          route: str | None = None):
    """The sampler reading the iteration word from a device counter as a
    replayed graph does: one launch on a counter, captured and replayed
    after the counter is set to ``iteration`` and then ``iteration + 1``,
    EQUAL (``torch.equal``) in every output to a launch given each
    iteration as a host integer, on one chunk.  Emit mode when
    ``integrand`` is None, else fused with that Genz family."""
    pmap = case["pmap"]
    named = {} if route is None else {"route": route}

    def launch(it):
        return cuda_vegas.sample_chunk(
            pmap, integrand, case["ng"], case["npg"], case["chunk_cubes"],
            case["nbins"], with_hist, case["xjac"], case["cube0"],
            case["ncubes"], seed, it, emit_points=integrand is None, **named)

    names = ("xs", "wt", "ia") if integrand is None else ("sums", "ia", "f2")
    counter = torch.zeros((), dtype=torch.int64, device=pmap.table.device)
    label = (f"sampler {'emit' if integrand is None else integrand.name} "
             f"hist={with_hist} device counter")
    its = (iteration, iteration + 1)
    for it, got in zip(its, _replayed(launch, counter, its)):
        _equal_outputs(f"{label} at iteration {it}", got, launch(it), names)
    return {"samples": case["chunk_cubes"] * case["npg"], "equal": True}


def check_resolve_counter(ndim: int, ncall: float, chunk_cubes: int,
                          nbins: int, *, seed: int = 0, iteration: int = 1,
                          position: str = "end", route: str | None = None,
                          device="cuda"):
    """The bin resolve drawing xn from a device counter as a replayed graph
    does (``check_sampler_counter``'s check): rc, xo and ia EQUAL to
    launches given the iterations as host integers; on the chunk at
    ``position`` ('end': the last chunk shifted beyond the lattice's
    end)."""
    ng, ncubes = V.compute_ncubes(ncall, ndim)
    npg = V.samples_per_cube(ncall, ncubes)
    chunk_cubes = min(chunk_cubes, ncubes)
    cube0 = _chunk_start(ng, ndim, ncubes, chunk_cubes, position)
    xi32 = torch.as_tensor(random_grid(ndim, nbins, seed), dtype=torch.float32,
                           device=device)
    counter = torch.zeros((), dtype=torch.int64, device=xi32.device)

    def launch(it):
        return cuda_lookup.bin_resolve_stratified(
            xi32, nbins, ng, npg, chunk_cubes, cube0, ncubes, seed, it,
            with_ia=True, route=route)

    its = (iteration, iteration + 1)
    for it, got in zip(its, _replayed(launch, counter, its)):
        _equal_outputs(f"bin_resolve drawing xn, device counter, iteration "
                       f"{it}", got, launch(it), ("rc", "xo", "ia"))
    return {"samples": chunk_cubes * npg, "equal": True}
