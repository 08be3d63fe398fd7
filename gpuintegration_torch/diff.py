"""Differentiable integration: ``torch.func.grad`` / ``torch.func.vmap`` over
integrand parameters (PyTorch port of ``gpuintegration_tpu/diff.py``).

The estimator is a PyTorch function of the parameters, so a parameter
derivative costs one backward pass and a parameter scan is one ``vmap``.
Both entry points differentiate at a FROZEN discretization -- PAGANI's
region mesh or VEGAS's importance grid is data, not a function of the
parameters (discretize, then differentiate):

* ``fixed_mesh_integral``: the Genz-Malik rule estimate over a fixed region
  pool (a uniform mesh, or the adapted pool of ``Workspace.make_checkpoint``
  through ``mesh_from_checkpoint``).  Its gradient is the EXACT derivative
  of the cubature estimator on that mesh.
* ``frozen_grid_estimate``: an unbiased importance-sampled Monte Carlo
  estimate on a frozen VEGAS grid (``train_grid``).  Sample positions depend
  on (grid, seed) only, so E[d/dtheta f] = d/dtheta I, with the variance
  reduction of the trained grid.

Adaptivity (which regions were refined, how the grid was trained) is
outside the differentiation path: region selection is piecewise constant in
theta, so its derivative is zero almost everywhere.

Entry points build on the card unless given ``device="cpu"``.  On the card
the frozen estimate fetches its bin edges with the edge-lookup kernel
(``mcubes.cuda_lookup.edge_lookup``); the draws, the lookup and the grid do
not depend on theta, so under ``torch.func.grad`` and ``torch.func.vmap``
they are made as plain tensors (``frozen_points``), and only
``integrand(x, theta)`` carries the derivative or the batch.  Neither
estimator differentiates in the grid or the mesh.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gpuintegration_torch.mcubes import cuda_lookup, stream
from gpuintegration_torch.mcubes import grid as vgrid
from gpuintegration_torch.mcubes.vegas import VegasState, vegas
from gpuintegration_torch.ops import rule_eval
from gpuintegration_torch.pagani import region_pool
from gpuintegration_torch.types import Volume

# The fourth counter word of the frozen estimate's draws: the VEGAS
# sampler's fourth word is 4 slot + d / 4, so the two streams of one seed
# stay apart.
FROZEN_STREAM = 0xD1FF0000


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diff runs on the CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def mesh_from_checkpoint(ck) -> tuple[np.ndarray, np.ndarray]:
    """(lows, lengths) region-major (n, ndim), unit space, from a
    ``Workspace.make_checkpoint()`` snapshot: the adapted mesh as data.

    The checkpoint holds the ACTIVE pool: regions the run already retired
    are not in it.  For a complete partition of the volume, adapt with
    tolerances out of reach (``epsrel=1e-12, epsabs=1e-200``) for a few
    ``max_iterations`` so that no region retires."""
    return np.asarray(ck.lows), np.asarray(ck.lengths)


def fixed_mesh_integral(
    integrand: Callable,
    ndim: int,
    regions: tuple | None = None,
    *,
    partitions_per_axis: int | None = None,
    vol: Volume | None = None,
    dtype=torch.float64,
    device=None,
):
    """Build ``est_fn(theta) -> (estimate, errorest)`` over a fixed mesh.

    ``integrand``: ``f(x, theta)`` with ``x`` batched ``(..., ndim)`` and
    ``theta`` a tensor or any pytree (dict, tuple) of tensors.  ``est_fn``
    composes with ``torch.func``: ``vmap(est_fn)(theta_batch)`` is a
    parameter scan, ``grad(lambda t: est_fn(t)[0])`` the sensitivity.

    ``regions``: region-major ``(n, ndim)`` (lows, lengths) in UNIT space
    (e.g. ``mesh_from_checkpoint``); or ``partitions_per_axis`` for a
    uniform mesh.  The mesh is kept dims-major on ``device``.

    The rule runs through ``rule_eval.apply_rule_plain`` on every device,
    as the JAX package runs its XLA rule (``rule_eval.apply_rule``) and
    not its Pallas kernel here: the CUDA rule kernel evaluates the Genz
    families only and has no backward, and here the integrand is any
    PyTorch callable of (x, theta) that the derivative flows through."""
    dev = _resolve_device(device)
    if vol is None:
        vol = Volume(ndim=ndim)
    if (regions is None) == (partitions_per_axis is None):
        raise ValueError("pass exactly one of regions / partitions_per_axis")
    if regions is not None:
        lo_rm = torch.as_tensor(np.asarray(regions[0]), dtype=dtype)
        ln_rm = torch.as_tensor(np.asarray(regions[1]), dtype=dtype)
        for a in (lo_rm, ln_rm):
            if a.dim() != 2 or a.shape[1] != ndim:
                raise ValueError(f"regions must be region-major (n, {ndim}); "
                                 f"got {tuple(a.shape)}")
        lows = lo_rm.T.contiguous().to(dev)
        lengths = ln_rm.T.contiguous().to(dev)
    else:
        parts = int(partitions_per_axis)
        lows, lengths, _ = region_pool.uniform_split(
            ndim, parts, parts ** ndim, dtype, dev)
    tables = rule_eval.rule_tables(ndim, rule_eval.dtype_name(dtype))
    global_lo = torch.as_tensor(vol.lows, dtype=dtype, device=dev)
    global_range = torch.as_tensor(vol.highs - vol.lows, dtype=dtype,
                                   device=dev)

    def est_fn(theta):
        est, err, _ = rule_eval.apply_rule_plain(
            lambda x: integrand(x, theta), tables, lows, lengths, global_lo,
            global_range)
        return torch.sum(est), torch.sum(err)

    return est_fn


def train_grid(
    integrand: Callable,
    ndim: int,
    *,
    theta=None,
    ncall: float = 1e6,
    adjust_iters: int = 10,
    vol: Volume | None = None,
    seed: int = 0,
    nbins: int | None = None,
    dtype=torch.float64,
    device=None,
):
    """Run VEGAS grid adjustment at a pilot ``theta`` and return the
    trained edges ``xi`` (ndim, nbins + 1) for ``frozen_grid_estimate``.
    Any monotone grid gives an unbiased frozen estimator; training at one
    theta only affects the variance at nearby thetas.  On the card a
    callable runs the 'hybrid' sampler (the sampler kernel emitting points,
    the histogram kernel)."""
    dev = _resolve_device(device)
    nbins = nbins or vgrid.NDMX
    st = VegasState(xi=vgrid.uniform_grid(ndim, nbins, dtype, dev))
    f = integrand if theta is None else (lambda x: integrand(x, theta))
    vegas(f, epsrel=0.0, epsabs=0.0, ncall=ncall, vol=vol, ndim=ndim,
          total_iters=adjust_iters, adjust_iters=adjust_iters,
          skip_iters=adjust_iters, seed=seed, dtype=dtype, nbins=nbins,
          state=st, device=dev)
    return st.xi


def frozen_draws(seed: int, n: int, ndim: int, nbins: int, device):
    """The frozen estimate's random numbers: bin ids ``ia`` (n, ndim) int32,
    uniform in [1, nbins], and uniforms ``u`` (n, ndim) f32 in [0, 1).

    Counter-based and pure integer arithmetic (``mcubes.stream``'s
    Philox4x32-10 keyed on the seed, one block per sample and pair of
    dimensions with the counter (sample low word, sample high word, pair,
    FROZEN_STREAM)), so the same seed gives the same bits on the CPU and on
    the card, inside ``torch.func.vmap`` as well as outside.  Dimension
    2p + k takes words 2k and 2k + 1 of pair p's block, an id word and a u
    word.  The id is the 40-bit fraction (id word, low 8 bits of the u
    word) times nbins, so every bin is drawn with probability 1/nbins to
    within nbins/2^40; u is the u word's high 24 bits."""
    k0, k1 = stream.seed_key(seed)
    pairs = -(-ndim // 2)
    sample = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    pair = torch.arange(pairs, dtype=torch.int64, device=device)[None, :]
    w0, w1, w2, w3 = stream.philox4x32(
        (sample & stream.MASK32).expand(n, pairs), sample >> 32, pair,
        torch.full((1, 1), FROZEN_STREAM, dtype=torch.int64, device=device),
        k0, k1)
    w_id = torch.stack((w0, w2), dim=-1).reshape(n, 2 * pairs)[:, :ndim]
    w_u = torch.stack((w1, w3), dim=-1).reshape(n, 2 * pairs)[:, :ndim]
    ia = ((w_id * nbins + (((w_u & 0xFF) * nbins) >> 8)) >> 32) + 1
    return ia.to(torch.int32), stream.bits_to_uniform(w_u)


def frozen_points(xi32, ia, u, *, regn_lo, dx, jac: float,
                  dtype=torch.float64):
    """(x (n, ndim), w (n,)) of the frozen-grid estimator from the draws
    (ia, u), each (n, ndim): the edges of bin ia, the point lo + u (hi - lo)
    in unit space (f32, as the grid) mapped into the volume,
    ``regn_lo + x * dx``, and its weight prod(nbins (hi - lo)) times the
    volume's jacobian.  The edges come from ``cuda_lookup.edge_lookup``:
    the kernel for tensors on the card, the plain version on the CPU.

    Nothing here depends on theta.  It runs with ``torch.func``'s transforms
    off (``torch._C._DisableFuncTorch``), so that under ``grad`` or ``vmap``
    the draws, edges and points stay plain tensors: the kernel is bound
    through ctypes and needs their data pointers, which a tensor wrapped by
    ``grad`` does not have, and a constant needs no wrapping.  Since that
    would drop a transform's wrapping without a word, an input that a
    transform has wrapped (one that depends on what is differentiated or
    batched) raises instead."""
    wrapped = [name for name, t in (("xi32", xi32), ("ia", ia), ("u", u),
                                    ("regn_lo", regn_lo), ("dx", dx))
               if torch.is_tensor(t)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)]
    if wrapped:
        raise ValueError(f"{', '.join(wrapped)} depend on a torch.func "
                         "transform's input; the frozen estimate "
                         "differentiates and batches only through the "
                         "integrand's theta")
    nbins = xi32.shape[1] - 1
    with torch._C._DisableFuncTorch():
        lo, hi = cuda_lookup.edge_lookup(xi32, ia, nbins)
        width = hi - lo
        x_unit = (lo + u * width).to(dtype)
        x = regn_lo + x_unit * dx
        w = torch.prod(width.to(dtype) * nbins, dim=-1) * jac
    return x, w


def estimate_from_draws(integrand: Callable, theta, xi32, ia, u, *,
                        regn_lo, dx, jac: float, dtype=torch.float64):
    """(estimate, errorest) of the frozen-grid estimator at ``theta`` from
    the draws (ia, u) (``frozen_points``): the mean of
    ``integrand(x, theta) * w`` and its standard error."""
    x, w = frozen_points(xi32, ia, u, regn_lo=regn_lo, dx=dx, jac=jac,
                         dtype=dtype)
    fx = integrand(x, theta) * w
    n = fx.shape[-1]
    est = torch.mean(fx)
    var = torch.sum((fx - est) ** 2) / (n * (n - 1.0))
    return est, torch.sqrt(var)


def frozen_grid_estimate(
    integrand: Callable,
    xi,
    ndim: int,
    *,
    ncall: float = 1e6,
    vol: Volume | None = None,
    dtype=torch.float64,
    device=None,
):
    """Build ``est_fn(theta, seed) -> (estimate, errorest)``: an unbiased
    importance-sampled estimate on the FROZEN grid ``xi``, differentiable
    in ``theta``.

    Per sample and dimension a bin is drawn uniformly and a point placed
    uniformly inside it; the importance weight is ``nbins * bin_width``
    per dimension (the VEGAS map with uniform bin selection -- unbiased
    for any monotone grid).  Coordinates are f32-granular, as the grid.
    ``seed`` is an integer: the same seed gives the same samples
    (``frozen_draws``), so finite differences of ``est_fn`` in ``theta``
    use common random numbers and converge to the gradient.
    ``torch.func.grad(lambda t: est_fn(t, seed)[0])`` differentiates,
    ``torch.func.vmap(lambda t: est_fn(t, seed))`` scans."""
    dev = _resolve_device(device)
    if vol is None:
        vol = Volume(ndim=ndim)
    xi32 = torch.as_tensor(xi).to(device=dev, dtype=torch.float32).contiguous()
    if xi32.dim() != 2 or xi32.shape[0] != ndim:
        raise ValueError(f"xi must be (ndim={ndim}, nbins + 1); got "
                         f"{tuple(xi32.shape)}")
    nbins = int(xi32.shape[1]) - 1
    n = int(ncall)
    regn_lo = torch.as_tensor(vol.lows, dtype=dtype, device=dev)
    dx = torch.as_tensor(np.asarray(vol.highs) - np.asarray(vol.lows),
                         dtype=dtype, device=dev)

    def est_fn(theta, seed: int):
        with torch._C._DisableFuncTorch():    # see frozen_points
            ia, u = frozen_draws(seed, n, ndim, nbins, dev)
        return estimate_from_draws(integrand, theta, xi32, ia, u,
                                   regn_lo=regn_lo, dx=dx, jac=vol.jacobian,
                                   dtype=dtype)

    return est_fn
