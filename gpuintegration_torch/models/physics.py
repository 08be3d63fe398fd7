"""Physics-likelihood workload: a cluster-cosmology-flavored integrand
(PyTorch port of ``gpuintegration_tpu/models/physics.py``).

The reference validates against a real cosmology model -- a LambdaCDM
comoving-volume element times an interpolated halo-mass-function table
(reference: test/cuda/pagani/model.cu EZ/DV_DO_DZ + Interp2D over
data/HMF_t.dump, consumed by test_cpu_vs_gpu.cu:12-23).  This module
builds the same synthetic 6D likelihood integrand as the JAX package: an
``Interp2D`` table inside the integrand, smooth cosmology-like factors,
and Gaussian observational scatter kernels.  On the card it is a plain
callable, so PAGANI evaluates it through the rule's split route.

Dimensions: (z, logM_unit, obs1, obs2, bias, amp) mapped from [0,1]^6.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpuintegration_torch.ops.interp import Interp2D
from gpuintegration_torch.types import Volume


def _ez(z, omega_m=0.3, omega_l=0.7, omega_k=0.0):
    """Simplified LambdaCDM expansion rate E(z)."""
    zp1 = 1.0 + z
    return torch.sqrt(omega_m * zp1 ** 3 + omega_k * zp1 ** 2 + omega_l)


def make_hmf_table(n_mass: int = 64, n_z: int = 32, *,
                   device=None) -> Interp2D:
    """Synthetic halo-mass-function-like table n(logM, z): log-normal mass
    peak with redshift decay, sampled on a rectilinear grid (NumPy, the
    JAX package's table bit for bit)."""
    log_m = np.linspace(12.0, 15.0, n_mass)
    zs = np.linspace(0.0, 2.0, n_z)
    table = (np.exp(-0.5 * ((log_m[None, :] - 13.2) / 0.6) ** 2)
             * (1.0 + zs[:, None]) ** -2.0)
    return Interp2D(log_m, zs, table, device=device)


class ClusterLikelihood:
    """6D toy cluster-count likelihood.

    f(u) = dV-like(z) * HMF(logM, z) * N(obs1 | logM) * N(obs2 | z)
           * N(bias | 1) * amp-weight
    over the unit cube (all variables pre-scaled).  Carries its Interp2D
    table on ``device`` -- the stateful-integrand pattern (reference:
    StatefulIntegrand.cu, cuda_copy_to_managed).
    """

    ndim = 6

    def __init__(self, omega_m: float = 0.3, hmf: Interp2D | None = None,
                 *, interp_precision: str | None = None, device=None):
        """``hmf``: optionally supply the table, e.g. one read from a
        reference-format hexfloat dump (``Interp2D.from_text``) -- the
        reference's own pipeline loads data/HMF_t.dump this way
        (test/cuda/pagani/test_cpu_vs_gpu.cu).  It must lie on ``device``
        (by default the card).

        ``interp_precision``: the table's value precision
        (``ops.interp``'s "f64" or "f32"); every rule sum stays f64."""
        self.omega_m = omega_m
        self.hmf = make_hmf_table(device=device) if hmf is None else hmf
        if (hmf is not None and device is not None
                and hmf.device.type != torch.device(device).type):
            raise ValueError(f"the table lies on {hmf.device}, not {device}")
        if interp_precision is not None:
            self.hmf = self.hmf.with_precision(interp_precision)

    @property
    def device(self) -> torch.device:
        return self.hmf.device

    def __call__(self, x):
        z = 2.0 * x[..., 0]                    # z in [0, 2]
        log_m = 12.0 + 3.0 * x[..., 1]         # logM in [12, 15]
        obs1 = x[..., 2]
        obs2 = x[..., 3]
        bias = 0.5 + x[..., 4]                 # in [0.5, 1.5]
        amp = x[..., 5]

        ez = _ez(z, self.omega_m, 1.0 - self.omega_m)
        dv = (1.0 + z) ** 2 / ez               # volume-element flavor
        hmf = self.hmf(log_m, z).to(x.dtype)
        like1 = torch.exp(-0.5 * ((obs1 - (log_m - 12.0) / 3.0) / 0.15) ** 2)
        like2 = torch.exp(-0.5 * ((obs2 - z / 2.0) / 0.2) ** 2)
        like3 = torch.exp(-0.5 * ((bias - 1.0) / 0.25) ** 2)
        return dv * hmf * like1 * like2 * like3 * (0.5 + amp)

    # numpy twin for the CPU oracle (point-wise)
    def numpy_pointwise(self):
        hmf_xs = self.hmf.xs.cpu().numpy()
        hmf_ys = self.hmf.ys.cpu().numpy()
        hmf_zs = self.hmf.zs.cpu().numpy()
        omega_m = self.omega_m

        def f(x):
            z = 2.0 * x[0]
            log_m = 12.0 + 3.0 * x[1]
            obs1, obs2 = x[2], x[3]
            bias = 0.5 + x[4]
            amp = x[5]
            zp1 = 1.0 + z
            ez = math.sqrt(omega_m * zp1 ** 3 + (1 - omega_m))
            dv = zp1 ** 2 / ez
            # bilinear interpolation (the lerp form of ops.interp.Interp2D)
            i = np.clip(np.searchsorted(hmf_xs, log_m, side="right") - 1,
                        0, len(hmf_xs) - 2)
            j = np.clip(np.searchsorted(hmf_ys, z, side="right") - 1,
                        0, len(hmf_ys) - 2)
            tx = (log_m - hmf_xs[i]) / (hmf_xs[i + 1] - hmf_xs[i])
            ty = (z - hmf_ys[j]) / (hmf_ys[j + 1] - hmf_ys[j])
            top = hmf_zs[j, i] + tx * (hmf_zs[j, i + 1] - hmf_zs[j, i])
            bot = hmf_zs[j + 1, i] + tx * (hmf_zs[j + 1, i + 1]
                                           - hmf_zs[j + 1, i])
            hmf = top + ty * (bot - top)
            like1 = math.exp(-0.5 * ((obs1 - (log_m - 12.0) / 3.0) / 0.15) ** 2)
            like2 = math.exp(-0.5 * ((obs2 - z / 2.0) / 0.2) ** 2)
            like3 = math.exp(-0.5 * ((bias - 1.0) / 0.25) ** 2)
            return dv * hmf * like1 * like2 * like3 * (0.5 + amp)

        return f

    @property
    def volume(self) -> Volume:
        return Volume(ndim=self.ndim)
