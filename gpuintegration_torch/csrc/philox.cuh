// The VEGAS sampling stream on the card, and the cube decode that goes with
// it; included by vegas_sample.cu and vegas_lookup.cu.
//
// The generator is Philox4x32-10 (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", SC'11) written out by hand.  The stream has no state.
// The key is the run's seed (low word, high word).  The counter of one draw
// is
//   (cube id low word, cube id high word, absolute iteration, B*slot + d/4)
// and coordinate d of sample slot ``slot`` of that cube takes word d % 4 of
// the block, B = max(4, ceil(ndim / 4)) blocks a slot (slot_blocks), so
// that a slot's blocks never reach the next slot's.  Up to 16D B is 4; the
// wrappers refuse B * npg >= 2^32 (mcubes/stream.py check_counter).  So
// the uniforms of a cube depend on the seed, the iteration
// and the cube only: not on the chunk decomposition, nor on which device or
// which kernel draws them.  mcubes/stream.py::philox4x32 is the same
// generator in integer tensor operations, word for word.
//
// The cube decode (cube_digits) turns a cube id into its stratification
// digits, most significant first, as mcubes/stream.py::decode_cube does
// (there 1-based).  Below 2^32 cubes it divides in 32-bit arithmetic by the
// reciprocal of ng (mcubes/stream.py::decode_reciprocal and
// ::reciprocal_divmod are the same steps on the host); larger lattices take
// 64-bit divisions.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// B, the blocks of four words a sample slot owns: max(4, ceil(ndim / 4)).
__host__ __device__ constexpr unsigned slot_blocks(int ndim) {
  return ndim <= 16 ? 4u : static_cast<unsigned>(ndim + 3) >> 2;
}

// The block of four 32-bit words that holds coordinates 4*(d/4)..4*(d/4)+3
// of sample slot ``slot`` of ``cube`` in iteration ``iteration``, ``blocks``
// (slot_blocks of the ndim) blocks a slot.
__device__ __forceinline__ uint4 vegas_block(long long cube,
                                             unsigned iteration, int slot,
                                             int d, unsigned blocks,
                                             unsigned k0, unsigned k1) {
  const unsigned long long c = static_cast<unsigned long long>(cube);
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(c), static_cast<unsigned>(c >> 32),
                 iteration, blocks * static_cast<unsigned>(slot) + (d >> 2)),
      k0, k1);
}

__device__ __forceinline__ unsigned block_word(const uint4& b, int d) {
  const int j = d & 3;
  return j == 0 ? b.x : (j == 1 ? b.y : (j == 2 ? b.z : b.w));
}

// 24-bit uniform in [0, 1) from a 32-bit word: (bits >> 8) * 2^-24, exact.
__device__ __forceinline__ float word_uniform(unsigned bits) {
  return static_cast<float>(bits >> 8) * 0x1p-24f;
}

// q = floor(m / divisor) and r = m - q * divisor of a 32-bit word m, from
// recip = min(floor(2^32 / divisor), 2^32 - 1): the high word of m * recip
// is q or q - 1, and one correction makes it exact.
__device__ __forceinline__ unsigned recip_divmod(unsigned m, unsigned divisor,
                                                 unsigned recip,
                                                 unsigned& r) {
  unsigned q = __umulhi(m, recip);
  r = m - q * divisor;
  if (r >= divisor) {
    r -= divisor;
    ++q;
  }
  return q;
}

// The NDIM mixed-radix digits of ``cube`` in base ng, most significant
// first, 0-based.  ``small``: the lattice has fewer than 2^32 cubes, so the
// id is a 32-bit word and recip = min(floor(2^32 / ng), 2^32 - 1) divides.
template <int NDIM>
__device__ __forceinline__ void cube_digits(long long cube, unsigned ng,
                                            unsigned recip, bool small,
                                            unsigned (&digit)[NDIM]) {
  if (small) {
    unsigned m = static_cast<unsigned>(cube);
#pragma unroll
    for (int d = NDIM - 1; d >= 0; --d) m = recip_divmod(m, ng, recip, digit[d]);
  } else {
    unsigned long long m = static_cast<unsigned long long>(cube);
#pragma unroll
    for (int d = NDIM - 1; d >= 0; --d) {
      const unsigned long long t = m / ng;
      digit[d] = static_cast<unsigned>(m - t * ng);
      m = t;
    }
  }
}
