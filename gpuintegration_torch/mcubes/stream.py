"""The VEGAS sampling stream in plain PyTorch: the Philox4x32-10
counter-based generator and the cube decode, word for word what
csrc/philox.cuh computes on the card; beside the decode, the host side of
the kernels' 32-bit reciprocal division (``decode_reciprocal``,
``reciprocal_divmod``).

The reference draws from Threefry (XLA path) or the TPU's hardware PRNG
(Pallas path); neither exists here.  Philox has no state: the key is the
run's seed, and the counter of a draw is

    (cube id low word, cube id high word, absolute iteration, B*slot + d//4)

with coordinate ``d`` of sample slot ``slot`` taking word ``d % 4`` of the
block, and B = max(4, ceil(ndim / 4)) blocks a slot (``slot_blocks``): a
slot's blocks never reach the next slot's, so no two coordinates of a cube
share a word.  Up to 16D B is 4.  The word is 32 bits, so B * npg must stay
below 2^32 (``check_counter``).  That keeps what the reference promises -- a fixed seed repeats
bitwise, a resumed run (``VegasState.it0``) draws fresh streams, streams do
not depend on which device owns a cube -- and adds that they do not depend
on ``chunk_cubes`` either.  A run on the CPU and a run on the card with the
same seed draw the same uniforms.

Integers are int64 tensors holding 32-bit words; a 32x32 -> 64 bit product
is split so that nothing exceeds 2^49.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments


def _mulhilo(m: int, x):
    """(high word, low word) of the 64-bit product m * x, x an int64 tensor
    of 32-bit words."""
    ml = m * (x & 0xFFFF)
    mh = m * (x >> 16)
    lo = (ml + ((mh & 0xFFFF) << 16)) & MASK32
    hi = (mh + (ml >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10: four int64 tensors of 32-bit counter words and a
    two-word key give four tensors of 32-bit output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK32
        k1 = (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """The generator's key words (low, high) of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def slot_blocks(ndim: int) -> int:
    """B, the Philox blocks of four words a sample slot owns in the fourth
    counter word: max(4, ceil(ndim / 4))."""
    return max(4, -(-ndim // 4))


def check_counter(npg: int, ndim: int) -> int:
    """``slot_blocks(ndim)``, or ValueError where a cube's npg slots of it
    would pass the 32-bit counter word (B * npg >= 2^32: only a one-cube
    lattice has so many samples a cube)."""
    blocks = slot_blocks(ndim)
    if blocks * npg >= 2 ** 32:
        raise ValueError(
            f"npg={npg} samples a cube at {ndim}D: the stream's 32-bit "
            f"counter word takes {blocks} blocks a sample slot, so npg * "
            f"{blocks} must stay below 2^32")
    return blocks


def stream_bits(seed: int, iteration, cube_ids, npg: int, ndim: int):
    """The stream's words for cubes ``cube_ids`` ((C,) int64) in absolute
    iteration ``iteration``: (npg * ndim, C) int64 in [0, 2^32), row
    ``slot * ndim + d`` the word of coordinate d of sample slot ``slot``.
    ``iteration`` is a host integer or a 0-d integer tensor whose value the
    card holds (a counter a captured graph advances; no host read); both
    give the same words.  ValueError where B * npg >= 2^32
    (``check_counter``)."""
    blocks = check_counter(npg, ndim)
    k0, k1 = seed_key(seed)
    c0, c1 = cube_ids & MASK32, cube_ids >> 32
    if isinstance(iteration, torch.Tensor):
        c2 = (iteration.to(device=cube_ids.device, dtype=torch.int64)
              & MASK32).expand_as(cube_ids)
    else:
        c2 = torch.full_like(cube_ids, int(iteration) & MASK32)
    # every (slot, block) of a pass of slots at once: rows (slot, block)
    # against the cubes, about 2^22 words a pass
    nb, n = -(-ndim // 4), cube_ids.shape[0]
    per_pass = max(1, (1 << 22) // max(nb * n, 1))
    rows = []
    for s0 in range(0, npg, per_pass):
        slot = torch.arange(s0, min(npg, s0 + per_pass), dtype=torch.int64,
                            device=cube_ids.device)
        c3 = (blocks * slot[:, None] + torch.arange(
            nb, dtype=torch.int64, device=cube_ids.device)).reshape(-1, 1)
        words = torch.stack(philox4x32(c0, c1, c2, c3.expand(-1, n), k0, k1),
                            dim=1)                     # (slots * nb, 4, C)
        rows.append(words.reshape(slot.shape[0], 4 * nb, n)[:, :ndim]
                    .reshape(-1, n))
    return torch.cat(rows)


def counter(iteration, dev):
    """The 0-d int64 counter on ``dev`` whose low 32 bits the kernels read
    as the iteration word (the first four bytes on the little-endian card):
    ``iteration`` itself when it is such a tensor (a counter a captured
    graph advances), else a new one filled with the host integer (a fill,
    no host-to-device copy)."""
    if not isinstance(iteration, torch.Tensor):
        return torch.full((), int(iteration) & MASK32, dtype=torch.int64,
                          device=dev)
    if (iteration.device != dev or iteration.dim() != 0
            or iteration.dtype != torch.int64):
        raise ValueError(f"iteration: a host integer or a 0-d int64 tensor "
                         f"on {dev}, not {iteration.dtype} "
                         f"{tuple(iteration.shape)} on {iteration.device}")
    return iteration


def bits_to_uniform(bits):
    """24-bit uniforms in [0, 1), float32: (bits >> 8) * 2^-24, exact.
    ``bits`` holds 32-bit words as int64, or as int32 bit patterns."""
    words = bits.to(torch.int64) & MASK32
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def decode_cube(cube_id, ng: int, ndim: int):
    """Mixed-radix decode of a cube index into per-dim interval coordinates
    kg in [1, ng], most-significant digit first (get_indx,
    vegasT.cuh:141-162).  cube_id: (...,) int64 -> (..., ndim)."""
    digits = []
    m = cube_id
    for j in range(ndim):
        p = ng ** (ndim - j - 1)
        t = torch.div(m, p, rounding_mode="floor")
        digits.append(1 + t)
        m = m - t * p
    return torch.stack(digits, dim=-1)


def decode_reciprocal(ng: int) -> int:
    """The 32-bit word M = min(floor(2^32 / ng), 2^32 - 1) with which the
    kernels divide by ng (philox.cuh): for every m < 2^32, (m * M) >> 32 is
    floor(m / ng) or one less (``reciprocal_divmod``)."""
    if not 1 <= ng < 2 ** 32:
        raise ValueError(f"ng={ng} (1 .. 2^32 - 1)")
    return min(2 ** 32 // ng, 2 ** 32 - 1)


def reciprocal_divmod(m, ng: int, recip: int):
    """(m // ng, m % ng) of 32-bit words ``m`` (a uint64 array of values
    below 2^32) by the kernels' steps: the high word of m * recip, one
    multiply and subtract, and one correction."""
    m = np.asarray(m, dtype=np.uint64)
    q = (m * np.uint64(recip)) >> np.uint64(32)
    r = m - q * np.uint64(ng)
    over = r >= np.uint64(ng)
    return q + over, r - over * np.uint64(ng)
