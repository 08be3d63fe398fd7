// Fused VEGAS sampler (polynomial importance map) for NVIDIA Hopper
// (sm_90a): the kernel templates.  Two sources instantiate them:
// vegas_sample.cu for the emit mode and the Genz families F1..F6,
// gen_integrand.cu for one traced per-axis callable (the family
// kGenerated, csrc/gen_integrand.cuh).  Each source defines
// launch_sampler and includes this header once, with its C entry point.
//
// Replaces gpuintegration_tpu/mcubes/pallas_vegas.py::poly_sample_chunk:
// both compute the function that the plain PyTorch version
// gpuintegration_torch/mcubes/cuda_vegas.py::sample_chunk_plain computes.
//
// Per sub-cube of a chunk: decode the cube id into its stratification
// digits, and for each of its npg samples and each dimension draw a 24-bit
// uniform u, form the stratified position s = (kg + (1 - u)) / ng, evaluate
// the joint Chebyshev recurrence for the map P_d (volume-folded, so P_d is
// the coordinate itself) and q_d, clip the coordinate to the volume and
// multiply the weight by q_d^2.  Then either
//   * fused (FAMILY 1..6): evaluate the Genz integrand (genz.cuh) in f32,
//     fx = f * (w * xjac), and reduce the cube's samples to fb = sum fx and
//     the variance proxy f2b = (sqrt(npg sum fx^2) - fb)(sqrt(..) + fb),
//     floored at TINY; or
//   * emit (FAMILY 0): write the coordinates and the weight, for an
//     integrand evaluated outside in the accumulator type.
// The generated family (kGenerated) is fused as a Genz family is, its
// sample's coordinates kept in registers for one call of gen_integrand.
// With a histogram wanted, the per-dimension bin ids of s (and, fused,
// fx^2) are written too.
//
// Two kernels compute it; mcubes/cuda_vegas.py chooses by the shape alone.
// Both: one thread per sub-cube (grid-stride); uniforms from the Philox
// stream of philox.cuh, or from a tensor of bits (the parity hook);
// sampling arithmetic f32 throughout, as in the TPU kernel; sums over cubes
// f64, each thread adding its cubes, then a warp shuffle tree and the warps
// in order, one (fb, f2b) pair per block written to a (n_blocks, 2) buffer
// that the wrapper sums.  No atomics, so two runs agree bit for bit.
// Emitted arrays are dims-major (ndim, N) in the flat order
// n = cube * npg + sample.
//
// What bounds the work: about kp + kq multiply-adds per (sample, dimension)
// for the recurrence plus the generator's rounds, against 4 (ndim + 1)
// bytes written per sample in emit mode (8 ndim + 4 with bin ids) and
// nothing but block sums in fused mode.  At the default degree the fused
// mode is bound by f32 operations and the emit modes lie near the
// crossover.  Every intermediate stays in registers and each output is
// written once.
//
// The PAIRED route (sample_pair_kernel; ndim 3..8, any degree) is built
// so that the multiply-adds are most of what a thread executes:
//   * ndim is a template argument: digits, Genz state and the loop over
//     dimensions are registers and straight code;
//   * the coefficients are packed by the host (cuda_vegas.pack_map): four
//     terms of P and four of q to a pair of 16-byte shared-memory loads, q
//     padded with zeros to a multiple of four terms (adding 0 * T_i is
//     exact), then P's remaining terms alone; the loops run four terms a
//     pass with no test of the term index;
//   * a cube's samples go through the recurrence two at a time: one load
//     feeds two independent chains, and one chain's latency hides under the
//     other's.  The order of operations within a chain is the generic
//     kernel's, so coordinates and weights keep their bits;
//   * the cube id is decoded with 32-bit arithmetic and the reciprocal of
//     ng (stream.decode_reciprocal) when the lattice has fewer than
//     2^32 cubes; 64-bit divisions remain for larger lattices (philox.cuh
//     cube_digits, which the bin resolve shares);
//   * a pair's outputs are stored as 8-byte words when npg is even, so a
//     warp writes whole sectors.
//
// The GENERIC route (sample_kernel; every ndim 1..16): sample slots,
// dimensions and terms are run-time loops, a coefficient is one 4-byte
// shared-memory load per multiply-add, the decode is 64-bit.  It takes the
// dimensions the paired route is not compiled for and is the kernel the
// paired route is timed against.
//
// Every kernel reads the iteration word of the Philox counter from device
// memory, once a thread: a launch captured in a CUDA graph then draws the
// stream of whatever iteration the card's counter holds when the graph
// replays (vegas's device-resident phases), and the host loop passes a
// counter it fills with its iteration.
//
// Built by ops/cuda_build.py; called through ctypes (C entry point below).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gen_integrand.cuh"
#include "genz.cuh"
#include "philox.cuh"

namespace {
namespace sampler {

constexpr int kMaxNdim = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1.0e-30f;   // per-cube variance floor

struct SampleArgs {
  const float* map;       // P folded (ndim*kp) | q (ndim*kq) | lo | hi
                          // (generic) or the packed map (paired)
  const unsigned* bits;   // (npg*ndim, chunk_cubes) words, or null: Philox
  double* partial;        // fused: (n_blocks, 2) block sums of fb, f2b
  float* xs;              // emit: (ndim, N) coordinates
  float* wt;              // emit: (N,) importance weights
  int* ia;                // histogram: (ndim, N) bin ids, or null
  float* f2;              // fused histogram: (N,) fx^2
  long long cube0;        // global id of the chunk's first cube
  long long ncubes;       // cubes of the whole lattice
  int chunk_cubes, ndim, ng, npg, kp, kq, nbins;
  int kp4, kq4;           // paired: terms of P and q padded to fours
  unsigned recip;         // paired: min(floor(2^32 / ng), 2^32 - 1)
  float inv_ng, xjac;
  unsigned key0, key1;
  const unsigned* iteration;  // the counter's iteration word, in device
                              // memory (a counter a graph advances)
  float coeffs[kMaxNdim];  // Genz per-axis a_i
  float bounds[kMaxNdim];  // Genz per-axis b_i
  float s0, s1;
};

// Joint T_i recurrence at t in [-1, 1]: P from kp terms, q from the first
// kq of the same T_i.
__device__ __forceinline__ void cheb_joint(const float* p, const float* q,
                                           int kp, int kq, float t,
                                           float& out_p, float& out_q) {
  float acc_p = p[0] + p[1] * t;
  float acc_q = q[0] + (kq > 1 ? q[1] * t : 0.0f);
  float t_prev = 1.0f, t_cur = t;
  const float t2 = t + t;
  for (int i = 2; i < kp; ++i) {
    const float t_next = t2 * t_cur - t_prev;
    acc_p += p[i] * t_next;
    if (i < kq) acc_q += q[i] * t_next;
    t_prev = t_cur;
    t_cur = t_next;
  }
  out_p = acc_p;
  out_q = acc_q;
}

// The block's f64 sums of fb and f2b in a fixed order: a shuffle tree per
// warp, then the warps in order; one pair per block into ``partial``.
__device__ __forceinline__ void block_sums(double sum_fb, double sum_f2b,
                                           double (*s_part)[2],
                                           double* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_fb += __shfl_down_sync(0xffffffffu, sum_fb, off);
    sum_f2b += __shfl_down_sync(0xffffffffu, sum_f2b, off);
  }
  if (lane == 0) {
    s_part[warp][0] = sum_fb;
    s_part[warp][1] = sum_f2b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t0 = s_part[0][0], t1 = s_part[0][1];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      t0 += s_part[w][0];
      t1 += s_part[w][1];
    }
    partial[2 * blockIdx.x] = t0;
    partial[2 * blockIdx.x + 1] = t1;
  }
}

// ---------------------------------------------------------------------------
// The generic route.

template <int FAMILY>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const SampleArgs a) {
  extern __shared__ float s_map[];
  __shared__ double s_part[kWarps][2];
  const unsigned it = __ldg(a.iteration);

  const int ndim = a.ndim, kp = a.kp, kq = a.kq, npg = a.npg;
  for (int i = threadIdx.x; i < ndim * (kp + kq + 2); i += kThreads)
    s_map[i] = a.map[i];
  __syncthreads();
  const float* s_p = s_map;
  const float* s_q = s_p + ndim * kp;
  const float* s_lo = s_q + ndim * kq;
  const float* s_hi = s_lo + ndim;
  const long long n_total = static_cast<long long>(a.chunk_cubes) * npg;
  const float nbins_f = static_cast<float>(a.nbins);

  double sum_fb = 0.0, sum_f2b = 0.0;
  for (int local = blockIdx.x * kThreads + threadIdx.x; local < a.chunk_cubes;
       local += gridDim.x * kThreads) {
    const long long cube = a.cube0 + local;
    const long long n0 = static_cast<long long>(local) * npg;
    if (cube >= a.ncubes) {
      // beyond the lattice: a point inside the volume with weight 0
      for (int ps = 0; ps < npg; ++ps) {
        const long long n = n0 + ps;
        for (int d = 0; d < ndim; ++d) {
          if (FAMILY == 0) a.xs[d * n_total + n] = s_lo[d];
          if (a.ia) a.ia[d * n_total + n] = 0;
        }
        if (FAMILY == 0) a.wt[n] = 0.0f;
        if (FAMILY != 0 && a.f2) a.f2[n] = 0.0f;
      }
      continue;
    }

    // mixed-radix digits of the cube, most significant first, 0-based
    float kg[kMaxNdim];
    unsigned long long m = static_cast<unsigned long long>(cube);
    for (int d = ndim - 1; d >= 0; --d) {
      const unsigned long long t = m / static_cast<unsigned>(a.ng);
      kg[d] = static_cast<float>(m - t * static_cast<unsigned>(a.ng));
      m = t;
    }

    float fb = 0.0f, f2s = 0.0f;
    for (int ps = 0; ps < npg; ++ps) {
      const long long n = n0 + ps;
      float w = 1.0f;
      GenzState<float> g;
      float xv[kMaxNdim];   // the generated family's coordinates
      uint4 block = make_uint4(0u, 0u, 0u, 0u);
      for (int d = 0; d < ndim; ++d) {
        unsigned word;
        if (a.bits) {
          word = a.bits[static_cast<long long>(ps * ndim + d) * a.chunk_cubes
                        + local];
        } else {
          if ((d & 3) == 0)
            block = vegas_block(cube, it, ps, d, a.key0, a.key1);
          word = block_word(block, d);
        }
        const float u = word_uniform(word);
        const float s = (kg[d] + (1.0f - u)) * a.inv_ng;
        float cp, cq;
        cheb_joint(s_p + d * kp, s_q + d * kq, kp, kq, 2.0f * s - 1.0f, cp,
                   cq);
        const float x = fminf(fmaxf(cp, s_lo[d]), s_hi[d]);
        w *= cq * cq;
        if (a.ia) {
          const int bin = static_cast<int>(s * nbins_f);
          a.ia[d * n_total + n] = min(max(bin, 0), a.nbins - 1);
        }
        if constexpr (FAMILY == 0) {
          a.xs[d * n_total + n] = x;
        } else if constexpr (FAMILY == kGenerated) {
          xv[d] = x;
        } else {
          genz_axis<FAMILY, float>(g, x, a.coeffs[d], a.bounds[d], a.s0,
                                   a.s1);
        }
      }
      if (FAMILY == 0) {
        a.wt[n] = w;
      } else {
        float fval;
        if constexpr (FAMILY == kGenerated)
          fval = gen_integrand<float>(xv);
        else
          fval = genz_finish<FAMILY, float>(g, ndim, a.s0);
        const float fx = fval * (w * a.xjac);
        const float f2 = fx * fx;
        fb += fx;
        f2s += f2;
        if (a.f2) a.f2[n] = f2;
      }
    }
    if (FAMILY != 0) {
      // npg * sum(f^2) - fb^2 in the cancellation-safe form
      const float sq = sqrtf(f2s * static_cast<float>(npg));
      float f2b = (sq - fb) * (sq + fb);
      if (f2b <= 0.0f) f2b = kTiny;
      sum_fb += static_cast<double>(fb);
      sum_f2b += static_cast<double>(f2b);
    }
  }

  if (FAMILY != 0) block_sums(sum_fb, sum_f2b, s_part, a.partial);
}

// ---------------------------------------------------------------------------
// The paired route.

// One term of the joint recurrence for S chains: T_next = 2t T_cur - T_prev,
// then P (and, JOINT, q) take their term.
template <int S, bool JOINT>
__device__ __forceinline__ void cheb_term(float cp, float cq,
                                          const float (&t2)[S],
                                          float (&t_prev)[S],
                                          float (&t_cur)[S],
                                          float (&acc_p)[S],
                                          float (&acc_q)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float t_next = t2[k] * t_cur[k] - t_prev[k];
    acc_p[k] += cp * t_next;
    if (JOINT) acc_q[k] += cq * t_next;
    t_prev[k] = t_cur[k];
    t_cur[k] = t_next;
  }
}

// The joint recurrence of one dimension at S points t[] from its packed
// coefficients m: groups of (4 terms of P, 4 of q) up to kq4 terms, then
// groups of 4 terms of P up to kp4.
template <int S>
__device__ __forceinline__ void cheb_packed(const float4* m, int kp4, int kq4,
                                            const float (&t)[S],
                                            float (&acc_p)[S],
                                            float (&acc_q)[S]) {
  float t2[S], t_prev[S], t_cur[S];
  float4 p = m[0], q = m[1];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    acc_p[k] = p.x + p.y * t[k];
    // the generic kernel's first q term is a product, then a sum (its
    // kq > 1 test keeps the two apart); rounded alike here
    acc_q[k] = q.x + __fmul_rn(q.y, t[k]);
    t_prev[k] = 1.0f;
    t_cur[k] = t[k];
    t2[k] = t[k] + t[k];
  }
  cheb_term<S, true>(p.z, q.z, t2, t_prev, t_cur, acc_p, acc_q);
  cheb_term<S, true>(p.w, q.w, t2, t_prev, t_cur, acc_p, acc_q);
  const int gq = kq4 >> 2, gp = kp4 >> 2;
  for (int g = 1; g < gq; ++g) {
    p = m[2 * g];
    q = m[2 * g + 1];
    cheb_term<S, true>(p.x, q.x, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, true>(p.y, q.y, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, true>(p.z, q.z, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, true>(p.w, q.w, t2, t_prev, t_cur, acc_p, acc_q);
  }
  const float4* mp = m + 2 * gq;
  for (int g = gq; g < gp; ++g) {
    p = mp[g - gq];
    cheb_term<S, false>(p.x, 0.0f, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, false>(p.y, 0.0f, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, false>(p.z, 0.0f, t2, t_prev, t_cur, acc_p, acc_q);
    cheb_term<S, false>(p.w, 0.0f, t2, t_prev, t_cur, acc_p, acc_q);
  }
}

// Store the first ``live`` of a pair of neighbouring values at dst: one
// 8-byte word for the pair when ``wide`` says dst is 8-byte aligned.
template <typename V>
__device__ __forceinline__ void store_slots(V* dst, const V (&v)[2], int live,
                                            bool wide) {
  if (live == 2 && wide) {
    struct alignas(8) Pair { V a, b; };
    *reinterpret_cast<Pair*>(dst) = Pair{v[0], v[1]};
  } else {
    dst[0] = v[0];
    if (live == 2) dst[1] = v[1];
  }
}

// Sample slots ps and ps + 1 of one cube with digits kg[], through the
// recurrence together: outputs written, fb and f2s advanced (fused).  With
// ``live`` 1 (the last slot of an odd npg) the second chain runs on the
// first's uniforms and is dropped.
template <int FAMILY, int NDIM>
__device__ __forceinline__ void sample_slots(
    const SampleArgs& a, unsigned it, const float* s_map,
    const float (&kg)[NDIM], long long cube, int local, int ps, int live,
    long long n, long long n_total, bool wide, float& fb, float& f2s) {
  constexpr int S = 2;
  const int per_dim = a.kp4 + a.kq4;
  const float* s_lo = s_map + NDIM * per_dim;
  const float* s_hi = s_lo + NDIM;
  const float nbins_f = static_cast<float>(a.nbins);
  float w[S];
  GenzState<float> g[S];
  float xv[S][NDIM];   // the generated family's coordinates
  uint4 block[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    w[k] = 1.0f;
    block[k] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    float s[S], t[S], cp[S], cq[S], x[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int slot = ps + (k < live ? k : 0);
      unsigned word;
      if (a.bits) {
        word = a.bits[static_cast<long long>(slot * NDIM + d) * a.chunk_cubes
                      + local];
      } else {
        if ((d & 3) == 0)
          block[k] = vegas_block(cube, it, slot, d, a.key0, a.key1);
        word = block_word(block[k], d);
      }
      const float u = word_uniform(word);
      s[k] = (kg[d] + (1.0f - u)) * a.inv_ng;
      t[k] = 2.0f * s[k] - 1.0f;
    }
    cheb_packed<S>(reinterpret_cast<const float4*>(s_map + d * per_dim),
                   a.kp4, a.kq4, t, cp, cq);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      x[k] = fminf(fmaxf(cp[k], s_lo[d]), s_hi[d]);
      w[k] *= cq[k] * cq[k];
      if constexpr (FAMILY == kGenerated)
        xv[k][d] = x[k];
      else if constexpr (FAMILY != 0)
        genz_axis<FAMILY, float>(g[k], x[k], a.coeffs[d], a.bounds[d], a.s0,
                                 a.s1);
    }
    if (a.ia) {
      int bin[S];
#pragma unroll
      for (int k = 0; k < S; ++k)
        bin[k] = min(max(static_cast<int>(s[k] * nbins_f), 0), a.nbins - 1);
      store_slots(a.ia + d * n_total + n, bin, live, wide);
    }
    if (FAMILY == 0) store_slots(a.xs + d * n_total + n, x, live, wide);
  }
  if (FAMILY == 0) {
    store_slots(a.wt + n, w, live, wide);
  } else {
    float f2[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      float fval;
      if constexpr (FAMILY == kGenerated)
        fval = gen_integrand<float>(xv[k]);
      else
        fval = genz_finish<FAMILY, float>(g[k], NDIM, a.s0);
      const float fx = fval * (w[k] * a.xjac);
      f2[k] = fx * fx;
      if (k < live) {
        fb += fx;
        f2s += f2[k];
      }
    }
    if (a.f2) store_slots(a.f2 + n, f2, live, wide);
  }
}

template <int FAMILY, int NDIM>
__global__ void __launch_bounds__(kThreads)
sample_pair_kernel(const SampleArgs a) {
  extern __shared__ __align__(16) float s_map[];
  __shared__ double s_part[kWarps][2];
  const unsigned it = __ldg(a.iteration);

  const int npg = a.npg;
  const int map_words = NDIM * (a.kp4 + a.kq4 + 2);
  for (int i = threadIdx.x; i < map_words; i += kThreads) s_map[i] = a.map[i];
  __syncthreads();
  const float* s_lo = s_map + NDIM * (a.kp4 + a.kq4);
  const long long n_total = static_cast<long long>(a.chunk_cubes) * npg;
  const bool wide = (npg & 1) == 0;   // every pair starts at an even n
  const bool small = a.ncubes <= 0xffffffffLL;
  const unsigned ng = static_cast<unsigned>(a.ng);

  double sum_fb = 0.0, sum_f2b = 0.0;
  for (int local = blockIdx.x * kThreads + threadIdx.x; local < a.chunk_cubes;
       local += gridDim.x * kThreads) {
    const long long cube = a.cube0 + local;
    const long long n0 = static_cast<long long>(local) * npg;
    if (cube >= a.ncubes) {
      // beyond the lattice: a point inside the volume with weight 0
      for (int ps = 0; ps < npg; ++ps) {
        const long long n = n0 + ps;
#pragma unroll
        for (int d = 0; d < NDIM; ++d) {
          if (FAMILY == 0) a.xs[d * n_total + n] = s_lo[d];
          if (a.ia) a.ia[d * n_total + n] = 0;
        }
        if (FAMILY == 0) a.wt[n] = 0.0f;
        if (FAMILY != 0 && a.f2) a.f2[n] = 0.0f;
      }
      continue;
    }

    // mixed-radix digits of the cube, most significant first, 0-based
    unsigned digit[NDIM];
    cube_digits<NDIM>(cube, ng, a.recip, small, digit);
    float kg[NDIM];
#pragma unroll
    for (int d = 0; d < NDIM; ++d) kg[d] = static_cast<float>(digit[d]);

    float fb = 0.0f, f2s = 0.0f;
    for (int ps = 0; ps < npg; ps += 2)
      sample_slots<FAMILY, NDIM>(a, it, s_map, kg, cube, local, ps,
                                 min(2, npg - ps), n0 + ps, n_total, wide, fb,
                                 f2s);
    if (FAMILY != 0) {
      // npg * sum(f^2) - fb^2 in the cancellation-safe form
      const float sq = sqrtf(f2s * static_cast<float>(npg));
      float f2b = (sq - fb) * (sq + fb);
      if (f2b <= 0.0f) f2b = kTiny;
      sum_fb += static_cast<double>(fb);
      sum_f2b += static_cast<double>(f2b);
    }
  }
  if (FAMILY != 0) block_sums(sum_fb, sum_f2b, s_part, a.partial);
}

// The launch of one sampler kernel: route 1 the paired kernel at ``ndim``,
// route 0 the generic one, for the families a source compiles; defined by
// vegas_sample.cu and gen_integrand.cu.  Returns 0 or
// cudaErrorInvalidValue for a family or dimension the source lacks.
int launch_sampler(int route, int family, int ndim, const SampleArgs& a,
                   dim3 grid, size_t smem, cudaStream_t s);

}  // namespace sampler
}  // namespace

// C entry point for ctypes.  route 0 is the generic kernel and ``map`` the
// table of fold_map; route 1 the paired kernel (ndim 3..8) and
// ``map`` the packed table of pack_map with kp4, kq4 its padded term counts
// and recip = min(floor(2^32 / ng), 2^32 - 1).  family 0 emits points (xs,
// wt[, ia]); 1..6 fuses that Genz family (partial[, ia, f2]).  Pointers are device pointers
// (null where a mode has no such array) except genz (34 host doubles:
// coeffs[16], bounds[16], s0, s1; may be null for family 0).  ``iteration``
// is the device address of the counter's iteration word, which the kernel
// reads when it runs (never null).  Returns cudaGetLastError() after the
// launch (0 on success); never synchronises.
extern "C" int vegas_sample_launch(
    int route, int kp4, int kq4, unsigned recip, int family, int n_blocks, const void* map, const void* bits,
    void* partial, void* xs, void* wt, void* ia, void* f2,
    long long cube0, long long ncubes, int chunk_cubes, int ndim, int ng,
    int npg, int kp, int kq, int nbins, float inv_ng, float xjac,
    unsigned key0, unsigned key1, const void* iteration, const double* genz,
    void* stream) {
  if (ndim < 1 || ndim > sampler::kMaxNdim || family < 0 ||
      family > kGenerated || kp < 2 ||
      kq < 1 || kq > kp || npg < 1 || chunk_cubes < 1 || n_blocks < 1 ||
      (family != 0 && genz == nullptr) || route < 0 || route > 1 ||
      iteration == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && (kp4 < kp || kq4 < kq || kq4 > kp4 || kp4 % 4 || kq4 % 4 ||
                     kq4 < 4 || ng < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  sampler::SampleArgs a;
  a.map = static_cast<const float*>(map);
  a.bits = static_cast<const unsigned*>(bits);
  a.partial = static_cast<double*>(partial);
  a.xs = static_cast<float*>(xs);
  a.wt = static_cast<float*>(wt);
  a.ia = static_cast<int*>(ia);
  a.f2 = static_cast<float*>(f2);
  a.cube0 = cube0;
  a.ncubes = ncubes;
  a.chunk_cubes = chunk_cubes;
  a.ndim = ndim;
  a.ng = ng;
  a.npg = npg;
  a.kp = kp;
  a.kq = kq;
  a.nbins = nbins;
  a.kp4 = kp4;
  a.kq4 = kq4;
  a.recip = recip;
  a.inv_ng = inv_ng;
  a.xjac = xjac;
  a.key0 = key0;
  a.key1 = key1;
  a.iteration = static_cast<const unsigned*>(iteration);
  for (int d = 0; d < sampler::kMaxNdim; ++d) {
    a.coeffs[d] = genz ? static_cast<float>(genz[d]) : 0.0f;
    a.bounds[d] =
        genz ? static_cast<float>(genz[sampler::kMaxNdim + d]) : 0.0f;
  }
  a.s0 = genz ? static_cast<float>(genz[2 * sampler::kMaxNdim]) : 0.0f;
  a.s1 = genz ? static_cast<float>(genz[2 * sampler::kMaxNdim + 1]) : 0.0f;

  const size_t smem = sizeof(float) * ndim *
                      (route == 1 ? kp4 + kq4 + 2 : kp + kq + 2);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_blocks);
  const int rc = sampler::launch_sampler(route, family, ndim, a, grid, smem,
                                         s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
