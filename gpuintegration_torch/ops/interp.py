"""Device-callable interpolators for stateful integrands (PyTorch port of
``gpuintegration_tpu/ops/interp.py``).

Re-expression of the reference's managed-memory interpolators
(reference: common/cuda/Interp1D.cuh:17-251, Interp2D.cuh:16-60+,
Interp3D.cuh), used by the physics integrands in its tests (cosmology HMF
model, test/cuda/pagani/model.cu + data/HMF_t.dump).  Each interpolator
holds its tables as tensors on one device, and a closure over it is a
valid integrand anywhere in the package:

* clamped evaluation at the domain edges (Interp1D.cuh do_clamp/clamp),
* binary-search cell location on any monotone knot grid
  (``torch.searchsorted``), the corners fetched by gathers,
* (bi/tri)linear interpolation on the cell, the corners combined with
  the hat weights w0 = (x1 - x)/(x1 - x0), w1 = (x - x0)/(x1 - x0), as the
  reference's default dense path does: at a knot one weight is exactly 1
  and the other 0, so every knot's value, the top one's too, comes back
  exactly.  The axes combine x first, then y, then z.

``precision="f32"``: the knots, the cell and the weights stay f64; the
values are fetched and combined in f32 and widened back to f64 (the
reference's mixed-precision path, ~1e-7 relative).

``__call__`` reads nothing back to the host and copies nothing to the
device (the clamp bounds are kept as 0-d tensors), so a callable that
closes over an interpolator can be captured in a CUDA graph (PAGANI's
fused phase).  A query on another device than the table raises; ``x`` is
never moved.

Serialisation: ``to_text``/``from_text`` read and write the reference's
hexfloat dump format (str_to_doubles.hh:9-20: whitespace-separated C99
hexfloats, one line per array) so existing data files interchange.
"""
from __future__ import annotations

import numpy as np
import torch

_PRECISIONS = ("f64", "f32")


def _check_precision(precision: str):
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {_PRECISIONS}, got {precision!r}")


def _parse_doubles(text: str) -> np.ndarray:
    """Parse whitespace-separated (hex)float doubles
    (reference: common/cuda/str_to_doubles.hh:9-20)."""
    return np.array([float.fromhex(t) if ("x" in t or "X" in t)
                     else float(t) for t in text.split()], dtype=np.float64)


def _format_doubles(vals) -> str:
    return " ".join(float(v).hex() for v in np.asarray(vals).ravel())


def _parse_lines(text: str, n_lines: int, what: str) -> list:
    """Split a reference-format dump into exactly ``n_lines`` non-empty
    lines of hexfloat doubles (the reference reads one std::getline per
    array: Interp1D.cuh:226-233, Interp2D.cuh:172-182)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if len(lines) != n_lines:
        raise ValueError(
            f"{what} dump needs {n_lines} non-empty lines "
            f"(got {len(lines)})")
    return [_parse_doubles(ln) for ln in lines]


def _ascending(knots: np.ndarray, payload: np.ndarray, axis: int):
    """Normalise a knot axis to ascending order at construction
    (searchsorted assumes ascending; a descending grid would extrapolate
    through the wrong cell).  Descending grids are flipped with their
    payload along ``axis``; non-monotone grids rejected."""
    d = np.diff(knots)
    if (d > 0).all():
        return knots, payload
    if (d < 0).all():
        return knots[::-1].copy(), np.flip(payload, axis=axis).copy()
    raise ValueError("knot grid must be strictly monotone")


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the interpolators keep their tables on the CUDA card by default "
            "and none is available; pass device='cpu'")
    return device


class _Axis:
    """One knot axis on the device: the knots (K,) f64 and their clamp
    bounds as 0-d tensors."""

    def __init__(self, knots: np.ndarray, device):
        self.knots = torch.as_tensor(knots, dtype=torch.float64, device=device)
        self.lo = self.knots[0].clone()
        self.hi = self.knots[-1].clone()

    def cell(self, x):
        """(i, w0, w1): the cell knots[i] <= x < knots[i+1] (clamped to a
        valid one; x already clamped) and the hat weights of its two
        knots."""
        k = self.knots
        i = torch.clamp(torch.searchsorted(k, x, right=True) - 1, 0,
                        k.shape[0] - 2)
        x0 = k[i]
        x1 = k[i + 1]
        den = x1 - x0
        return i, (x1 - x) / den, (x - x0) / den


class _Interp:
    """What the three interpolators share: the device, the precision and
    the device check of a query."""

    precision: str

    @property
    def device(self) -> torch.device:
        return self.vals_f64.device

    def _query(self, *coords):
        out = []
        for axis, x in zip(self.axes, coords):
            x = torch.as_tensor(x)
            if x.device != self.device:
                raise ValueError(
                    f"{type(self).__name__} holds its table on {self.device} "
                    f"and was queried on {x.device}; build it on the query's "
                    f"device (device=) instead")
            out.append(torch.clamp(x.to(torch.float64), axis.lo, axis.hi))
        return [t.contiguous() for t in torch.broadcast_tensors(*out)]

    def _table(self):
        return self.vals_f64 if self.precision == "f64" else self.vals_f32

    def _set_table(self, vals: np.ndarray, precision: str):
        _check_precision(precision)
        self.vals_f64 = torch.as_tensor(vals, dtype=torch.float64,
                                        device=self.axes[0].knots.device)
        self.vals_f32 = self.vals_f64.to(torch.float32)
        self.precision = precision

    def with_precision(self, precision: str):
        """Same table (shared, not copied), another value precision."""
        _check_precision(precision)
        obj = type(self).__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.precision = precision
        return obj

    def _weights(self, *ws):
        """The weights in the values' type."""
        dt = self._table().dtype
        return [w.to(dt) for w in ws]


class Interp1D(_Interp):
    """Clamped linear interpolation through (xs, zs)."""

    def __init__(self, xs, zs, *, precision: str = "f64", device=None):
        xs = np.asarray(xs, np.float64)
        zs = np.asarray(zs, np.float64)
        if xs.ndim != 1 or xs.shape != zs.shape:
            raise ValueError("Interp1D needs equal-length 1-D xs/zs")
        _check_precision(precision)
        xs, zs = _ascending(xs, zs, 0)
        self.axes = (_Axis(xs, _device(device)),)
        self._set_table(zs, precision)

    @property
    def xs(self):
        return self.axes[0].knots

    @property
    def zs(self):
        return self.vals_f64

    def min_x(self):
        return self.axes[0].lo

    def max_x(self):
        return self.axes[0].hi

    def clamp(self, x):
        return self._query(x)[0]

    def eval(self, x):
        """Interpolation at ``x`` in the domain (no clamp)."""
        i, w0, w1 = self.axes[0].cell(x)
        w0, w1 = self._weights(w0, w1)
        z = self._table()
        return (w0 * z[i] + w1 * z[i + 1]).to(torch.float64)

    def __call__(self, x):
        """Clamped evaluation (the reference's operator() clamps out-of-
        range queries to the edge values)."""
        return self.eval(*self._query(x))

    @classmethod
    def from_text(cls, text: str, *, device=None) -> "Interp1D":
        """Reference stream format: one line of hexfloat xs, one line of
        zs (Interp1D.cuh:226-233).  A single-line dump is read as the
        legacy format (count, xs..., count, zs...)."""
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if len(lines) == 1:
            vals = _parse_doubles(text)
            n = int(vals[0])
            xs = vals[1:1 + n]
            m = int(vals[1 + n])
            zs = vals[2 + n:2 + n + m]
            if m != n:
                raise ValueError("xs/zs length mismatch in Interp1D dump")
            return cls(xs, zs, device=device)
        xs, zs = _parse_lines(text, 2, "Interp1D")
        if xs.shape != zs.shape:
            raise ValueError("xs/zs length mismatch in Interp1D dump")
        return cls(xs, zs, device=device)

    def to_text(self) -> str:
        """Reference dump format: xs line, zs line (hexfloats)."""
        return (f"{_format_doubles(self.xs.cpu().numpy())}\n"
                f"{_format_doubles(self.zs.cpu().numpy())}\n")


class Interp2D(_Interp):
    """Bilinear interpolation on a rectilinear (xs, ys) grid.

    zs has shape (len(ys), len(xs)) -- row-major over ys like the
    reference's interpT table (Interp2D.cuh ctor)."""

    def __init__(self, xs, ys, zs, *, precision: str = "f64", device=None):
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        zs = np.asarray(zs, np.float64)
        if zs.shape != (ys.shape[0], xs.shape[0]):
            raise ValueError(f"zs shape {zs.shape} != (len(ys), len(xs))")
        _check_precision(precision)
        xs, zs = _ascending(xs, zs, 1)
        ys, zs = _ascending(ys, zs, 0)
        dev = _device(device)
        self.axes = (_Axis(xs, dev), _Axis(ys, dev))
        self._set_table(zs, precision)

    @property
    def xs(self):
        return self.axes[0].knots

    @property
    def ys(self):
        return self.axes[1].knots

    @property
    def zs(self):
        return self.vals_f64

    def clamp(self, x, y):
        return self._query(x, y)

    def eval(self, x, y):
        """Interpolation at (x, y) in the domain (no clamp)."""
        i, wx0, wx1 = self.axes[0].cell(x)
        j, wy0, wy1 = self.axes[1].cell(y)
        wx0, wx1, wy0, wy1 = self._weights(wx0, wx1, wy0, wy1)
        z = self._table().reshape(-1)
        nx = self.axes[0].knots.shape[0]
        base = j * nx + i
        top = wx0 * z[base] + wx1 * z[base + 1]
        bot = wx0 * z[base + nx] + wx1 * z[base + nx + 1]
        return (wy0 * top + wy1 * bot).to(torch.float64)

    def __call__(self, x, y):
        return self.eval(*self._query(x, y))

    @classmethod
    def from_text(cls, text: str, *, device=None) -> "Interp2D":
        """Reference stream format: xs line (cols), ys line (rows), table
        line of rows*cols values, x fastest (Interp2D.cuh:172-190; the
        format of the reference's data/HMF_t.dump)."""
        xs, ys, zs = _parse_lines(text, 3, "Interp2D")
        nx, ny = xs.shape[0], ys.shape[0]
        if zs.shape[0] != nx * ny:
            raise ValueError(
                f"Interp2D table length {zs.shape[0]} != "
                f"len(xs)*len(ys) = {nx * ny}")
        return cls(xs, ys, zs.reshape(ny, nx), device=device)

    def to_text(self) -> str:
        """Reference dump format: xs line, ys line, table line."""
        return (f"{_format_doubles(self.xs.cpu().numpy())}\n"
                f"{_format_doubles(self.ys.cpu().numpy())}\n"
                f"{_format_doubles(self.zs.cpu().numpy())}\n")


class Interp3D(_Interp):
    """Trilinear interpolation on a rectilinear (xs, ys, zs) grid; vals has
    shape (len(zs), len(ys), len(xs))."""

    def __init__(self, xs, ys, zs, vals, *, precision: str = "f64",
                 device=None):
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        zs = np.asarray(zs, np.float64)
        vals = np.asarray(vals, np.float64)
        if vals.shape != (zs.shape[0], ys.shape[0], xs.shape[0]):
            raise ValueError(
                f"vals shape {vals.shape} != (len(zs), len(ys), len(xs))")
        _check_precision(precision)
        xs, vals = _ascending(xs, vals, 2)
        ys, vals = _ascending(ys, vals, 1)
        zs, vals = _ascending(zs, vals, 0)
        dev = _device(device)
        self.axes = (_Axis(xs, dev), _Axis(ys, dev), _Axis(zs, dev))
        self._set_table(vals, precision)

    @property
    def xs(self):
        return self.axes[0].knots

    @property
    def ys(self):
        return self.axes[1].knots

    @property
    def zs(self):
        return self.axes[2].knots

    @property
    def vals(self):
        return self.vals_f64

    def clamp(self, x, y, z):
        return self._query(x, y, z)

    def eval(self, x, y, z):
        """Interpolation at (x, y, z) in the domain (no clamp)."""
        i, wx0, wx1 = self.axes[0].cell(x)
        j, wy0, wy1 = self.axes[1].cell(y)
        k, wz0, wz1 = self.axes[2].cell(z)
        wx0, wx1, wy0, wy1, wz0, wz1 = self._weights(wx0, wx1, wy0, wy1,
                                                     wz0, wz1)
        v = self._table().reshape(-1)
        nx = self.axes[0].knots.shape[0]
        ny = self.axes[1].knots.shape[0]
        base = (k * ny + j) * nx + i

        def along_x(b):
            return wx0 * v[b] + wx1 * v[b + 1]

        def along_y(b):
            return wy0 * along_x(b) + wy1 * along_x(b + nx)

        return (wz0 * along_y(base)
                + wz1 * along_y(base + nx * ny)).to(torch.float64)

    def __call__(self, x, y, z):
        return self.eval(*self._query(x, y, z))

    @classmethod
    def from_text(cls, text: str, *, device=None) -> "Interp3D":
        """Four hexfloat lines: xs, ys, zs, vals (x fastest, the
        reference's interpT index x + nx*y + nx*ny*z, Interp3D.cuh:199-204)."""
        xs, ys, zs, vals = _parse_lines(text, 4, "Interp3D")
        nx, ny, nz = xs.shape[0], ys.shape[0], zs.shape[0]
        if vals.shape[0] != nx * ny * nz:
            raise ValueError(
                f"Interp3D table length {vals.shape[0]} != "
                f"len(xs)*len(ys)*len(zs) = {nx * ny * nz}")
        return cls(xs, ys, zs, vals.reshape(nz, ny, nx), device=device)

    def to_text(self) -> str:
        return (f"{_format_doubles(self.xs.cpu().numpy())}\n"
                f"{_format_doubles(self.ys.cpu().numpy())}\n"
                f"{_format_doubles(self.zs.cpu().numpy())}\n"
                f"{_format_doubles(self.vals.cpu().numpy())}\n")
