// Fused VEGAS sampler (polynomial importance map) for NVIDIA Hopper
// (sm_90a).
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
// With a histogram wanted, the per-dimension bin ids of s (and, fused,
// fx^2) are written too.
//
// Design.  One thread per sub-cube (grid-stride), the sample slots and the
// dimensions run-time loops; the Chebyshev coefficients and the bounds sit
// in shared memory, where every thread of a warp reads the same word.  The
// uniforms come from the Philox stream of philox.cuh, or from a tensor of
// bits (the parity hook).  Sampling arithmetic is f32 throughout, as in the
// TPU kernel.  Sums over cubes are f64: each thread adds its cubes, a warp
// shuffle tree and then the warps in order give one (fb, f2b) pair per
// block, written to a (n_blocks, 2) buffer that the wrapper sums.  No
// atomics, so two runs agree bit for bit.  Emitted arrays are dims-major
// (ndim, N) in the flat order n = cube * npg + sample.
//
// What bounds it: about kp + kq multiply-adds per (sample, dimension) for
// the recurrence plus the generator's rounds, against 4 (ndim + 1) bytes
// written per sample in emit mode (8 ndim + 4 with bin ids) and nothing
// but block sums in fused mode.  At the default degree the fused mode is
// bound by f32 operations and the emit modes lie near the crossover; the
// design keeps every intermediate in registers and writes each output
// once.
//
// Built by ops/cuda_build.py; called through ctypes (C entry point below).

#include <cuda_runtime.h>
#include <math.h>

#include "genz.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxNdim = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1.0e-30f;   // per-cube variance floor

struct SampleArgs {
  const float* map;       // P folded (ndim*kp) | q (ndim*kq) | lo | hi
  const unsigned* bits;   // (npg*ndim, chunk_cubes) words, or null: Philox
  double* partial;        // fused: (n_blocks, 2) block sums of fb, f2b
  float* xs;              // emit: (ndim, N) coordinates
  float* wt;              // emit: (N,) importance weights
  int* ia;                // histogram: (ndim, N) bin ids, or null
  float* f2;              // fused histogram: (N,) fx^2
  long long cube0;        // global id of the chunk's first cube
  long long ncubes;       // cubes of the whole lattice
  int chunk_cubes, ndim, ng, npg, kp, kq, nbins;
  float inv_ng, xjac;
  unsigned key0, key1, iteration;
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

template <int FAMILY>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const SampleArgs a) {
  extern __shared__ float s_map[];
  __shared__ double s_part[kWarps][2];

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
      uint4 block = make_uint4(0u, 0u, 0u, 0u);
      for (int d = 0; d < ndim; ++d) {
        unsigned word;
        if (a.bits) {
          word = a.bits[static_cast<long long>(ps * ndim + d) * a.chunk_cubes
                        + local];
        } else {
          if ((d & 3) == 0)
            block = vegas_block(cube, a.iteration, ps, d, a.key0, a.key1);
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
        if (FAMILY == 0) {
          a.xs[d * n_total + n] = x;
        } else {
          genz_axis<FAMILY, float>(g, x, a.coeffs[d], a.bounds[d], a.s0,
                                   a.s1);
        }
      }
      if (FAMILY == 0) {
        a.wt[n] = w;
      } else {
        const float fx = genz_finish<FAMILY, float>(g, ndim, a.s0)
                         * (w * a.xjac);
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

  if (FAMILY == 0) return;
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
    a.partial[2 * blockIdx.x] = t0;
    a.partial[2 * blockIdx.x + 1] = t1;
  }
}

}  // namespace

// C entry point for ctypes.  family 0 emits points (xs, wt[, ia]); 1..6
// fuses that Genz family (partial[, ia, f2]).  Pointers are device pointers
// (null where a mode has no such array) except genz (34 host doubles:
// coeffs[16], bounds[16], s0, s1; may be null for family 0).  Returns
// cudaGetLastError() after the launch (0 on success); never synchronises.
extern "C" int vegas_sample_launch(
    int family, int n_blocks, const void* map, const void* bits,
    void* partial, void* xs, void* wt, void* ia, void* f2,
    long long cube0, long long ncubes, int chunk_cubes, int ndim, int ng,
    int npg, int kp, int kq, int nbins, float inv_ng, float xjac,
    unsigned key0, unsigned key1, unsigned iteration, const double* genz,
    void* stream) {
  if (ndim < 1 || ndim > kMaxNdim || family < 0 || family > 6 || kp < 2 ||
      kq < 1 || kq > kp || npg < 1 || chunk_cubes < 1 || n_blocks < 1 ||
      (family != 0 && genz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SampleArgs a;
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
  a.inv_ng = inv_ng;
  a.xjac = xjac;
  a.key0 = key0;
  a.key1 = key1;
  a.iteration = iteration;
  for (int d = 0; d < kMaxNdim; ++d) {
    a.coeffs[d] = genz ? static_cast<float>(genz[d]) : 0.0f;
    a.bounds[d] = genz ? static_cast<float>(genz[kMaxNdim + d]) : 0.0f;
  }
  a.s0 = genz ? static_cast<float>(genz[2 * kMaxNdim]) : 0.0f;
  a.s1 = genz ? static_cast<float>(genz[2 * kMaxNdim + 1]) : 0.0f;

  const size_t smem = sizeof(float) * ndim * (kp + kq + 2);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_blocks);
  switch (family) {
    case 0: sample_kernel<0><<<grid, kThreads, smem, s>>>(a); break;
    case 1: sample_kernel<1><<<grid, kThreads, smem, s>>>(a); break;
    case 2: sample_kernel<2><<<grid, kThreads, smem, s>>>(a); break;
    case 3: sample_kernel<3><<<grid, kThreads, smem, s>>>(a); break;
    case 4: sample_kernel<4><<<grid, kThreads, smem, s>>>(a); break;
    case 5: sample_kernel<5><<<grid, kThreads, smem, s>>>(a); break;
    default: sample_kernel<6><<<grid, kThreads, smem, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
