// Genz-Malik rule evaluation over a PAGANI region pool, fused with the
// integrand, for NVIDIA Hopper (sm_90a).
//
// Replaces gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule (the
// f32 Pallas kernel) and, in f64, the XLA path rule_eval._eval_chunk: both
// compute the function that the plain PyTorch version
// gpuintegration_torch/ops/rule_eval.py::apply_rule_plain computes.
//
// Design (the reference's SampleRegionBlock, Sample.cuh:152-290):
//   * one thread block per real region; 128 threads stride over the rule
//     points, form x_d = center_g[d] - gen[d][p] * len_g[d] in registers,
//     evaluate the Genz integrand and add the value into a running sum of
//     the point's orbit (the point list is orbit-contiguous);
//   * the values of points 0..4n (center and the two single-axis orbits
//     that enter the fourth difference) are kept in shared memory;
//   * the 9 orbit sums are reduced in a fixed order -- warp shuffles, then
//     the 4 warp partials summed by one thread -- so results repeat
//     bitwise from run to run; no atomics;
//   * one thread runs the epilogue: the 5 rule sums (orbit sums times the
//     orbit weights, times the jacobian), the gated null-rule error model,
//     the unit-space volume and the split-dimension rule.
// Each region reads 2*ndim values and writes 3, so the kernel is bound by
// f64 (or f32) arithmetic, not by memory: feval * (~6 ndim + 3) operations
// per region against 16 ndim + 20 bytes.  The design keeps every point
// and value out of device memory and uses plain FP64/FP32 FMA units: no
// tensor cores and no TF32, because the null-rule sums cancel and a
// reduced-precision contraction would destroy them.
//
// Built by ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <math.h>

#include "genz.cuh"

namespace {

constexpr int kMaxNdim = 16;
constexpr int kNsets = 9;
constexpr int kNrules = 5;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct RuleArgs {
  const T* lows;        // (ndim, cap) unit-space lower bounds
  const T* lengths;     // (ndim, cap) unit-space lengths
  const T* glo;         // (ndim,) global lower bounds
  const T* grange;      // (ndim,) global ranges
  const T* gen;         // (ndim, feval) signed generators, dims-major
  const T* orbit_wts;   // (9, 5)
  const T* scale;       // (9, 5)
  const T* norm;        // (9, 5)
  T* est;               // (cap,)
  T* err;               // (cap,)
  int* split_dim;       // (cap,)
  int ndim, feval, cap, n, blocked;
  T ratio;
  int orbit_bounds[kNsets + 1];
  T coeffs[kMaxNdim];   // per-axis a_i (F1, F3, F6)
  T bounds[kMaxNdim];   // per-axis b_i (F6)
  T s0, s1;             // F1: offset | F2: 1/a^2, b | F4: a*a, b | F5: a, b
};

// max that propagates NaN, like jnp.maximum / torch.maximum
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

// The Genz integrand (genz.cuh) at rule point p of a region with
// global-space center cen[] and length len[] (shared memory).
template <int FAMILY, typename T>
__device__ __forceinline__ T genz_value(const RuleArgs<T>& a, const T* cen,
                                        const T* len, const T* coeffs,
                                        const T* bounds, int p) {
  const T* gen = a.gen;
  const int feval = a.feval;
  GenzState<T> g;
  for (int d = 0; d < a.ndim; ++d) {
    const T x = cen[d] - __ldg(gen + d * feval + p) * len[d];
    genz_axis<FAMILY, T>(g, x, coeffs[d], bounds[d], a.s0, a.s1);
  }
  return genz_finish<FAMILY, T>(g, a.ndim, a.s0);
}

template <typename T>
__device__ __forceinline__ void add_to_orbit(T (&acc)[kNsets], int s, T v) {
#pragma unroll
  for (int k = 0; k < kNsets; ++k)
    if (k == s) acc[k] += v;
}

template <int FAMILY, typename T>
__global__ void __launch_bounds__(kThreads)
rule_kernel(const RuleArgs<T> a) {
  __shared__ T s_cen[kMaxNdim], s_len[kMaxNdim];
  __shared__ T s_coeffs[kMaxNdim], s_bounds[kMaxNdim];
  __shared__ T s_vals[4 * kMaxNdim + 1];
  __shared__ T s_part[kWarps][kNsets];
  __shared__ int s_ob[kNsets + 1];

  const int tid = threadIdx.x;
  const int ndim = a.ndim;
  // real region -> pool slot: [0, n) or, blocked, the first n/2 of each
  // static half (region_pool.block_mask)
  const int r = blockIdx.x;
  const int half_n = a.n / 2;
  const int slot = (a.blocked && r >= half_n) ? a.cap / 2 + (r - half_n) : r;

  if (tid < ndim) {
    const T lo = a.lows[tid * a.cap + slot];
    const T ln = a.lengths[tid * a.cap + slot];
    const T rg = a.grange[tid];
    s_cen[tid] = a.glo[tid] + (lo + T(0.5) * ln) * rg;
    s_len[tid] = ln * rg;
    s_coeffs[tid] = a.coeffs[tid];
    s_bounds[tid] = a.bounds[tid];
  }
  if (tid <= kNsets) s_ob[tid] = a.orbit_bounds[tid];
  __syncthreads();

  T acc[kNsets];
#pragma unroll
  for (int k = 0; k < kNsets; ++k) acc[k] = T(0);
  const int n_kept = 4 * ndim + 1;
  int orbit = 0;
  T run = T(0);
  for (int p = tid; p < a.feval; p += kThreads) {
    const T v = genz_value<FAMILY, T>(a, s_cen, s_len, s_coeffs, s_bounds, p);
    int o = orbit;
    while (p >= s_ob[o + 1]) ++o;
    if (o != orbit) {
      add_to_orbit(acc, orbit, run);
      run = T(0);
      orbit = o;
    }
    run += v;
    if (p < n_kept) s_vals[p] = v;
  }
  add_to_orbit(acc, orbit, run);

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kNsets; ++k) {
    T v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_part[warp][k] = v;
  }
  __syncthreads();
  if (tid != 0) return;

  // ---- epilogue, one thread ------------------------------------------
  T jac = T(1), vol = T(1);
  for (int d = 0; d < ndim; ++d) {
    jac *= a.grange[d];
    vol *= a.lengths[d * a.cap + slot];
  }
  T orbit_sum[kNsets];
#pragma unroll
  for (int k = 0; k < kNsets; ++k) {
    T v = s_part[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += s_part[w][k];
    orbit_sum[k] = v;
  }
  T sums[kNrules];
#pragma unroll
  for (int q = 0; q < kNrules; ++q) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < kNsets; ++k)
      v += orbit_sum[k] * __ldg(a.orbit_wts + k * kNrules + q);
    sums[q] = v * jac;
  }

  // split dimension: strict '>' scan from 0 over the fourth differences;
  // the widest unit-space dimension when none is positive or any is NaN
  // (Sample.cuh:194-218, rule_eval.py "Reference semantics")
  const T f0 = s_vals[0];
  const T c0 = T(2) * (T(1) - a.ratio);
  int best = -1;
  bool any_nan = false;
  T maxdiff = T(0);
  for (int d = 0; d < ndim; ++d) {
    const T o1 = s_vals[1 + 2 * d] + s_vals[2 + 2 * d];
    const T o2 = s_vals[1 + 2 * ndim + 2 * d] + s_vals[2 + 2 * ndim + 2 * d];
    const T diff = m_abs(c0 * f0 + a.ratio * o1 - o2);
    if (diff != diff) {
      any_nan = true;
    } else if (diff > maxdiff) {
      maxdiff = diff;
      best = d;
    }
  }
  int widest = 0;
  T wl = a.lengths[slot];
  for (int d = 1; d < ndim; ++d) {
    const T l = a.lengths[d * a.cap + slot];
    if (l > wl) {
      wl = l;
      widest = d;
    }
  }

  // null-rule error model: e_r = max_s |S[r+1] + scale[s,r] S[r]| norm[s,r]
  T e[3];
#pragma unroll
  for (int q = 1; q <= 3; ++q) {
    T m = T(-1);
#pragma unroll
    for (int k = 0; k < kNsets; ++k) {
      const T v = m_abs(sums[q + 1] + __ldg(a.scale + k * kNrules + q) * sums[q])
                  * __ldg(a.norm + k * kNrules + q);
      m = nan_max(m, v);
    }
    e[q - 1] = m;
  }
  const T gated = (T(5) * e[0] <= e[1] && T(5) * e[1] <= e[2])
                      ? e[0]
                      : T(5) * nan_max(nan_max(e[0], e[1]), e[2]);

  a.est[slot] = vol * sums[0];
  a.err[slot] = vol * gated;
  a.split_dim[slot] = (any_nan || best < 0) ? widest : best;
}

// est = err = 0 and split_dim 0 in every padding slot of the pool
template <typename T>
__global__ void fill_padding(T* est, T* err, int* split_dim, int cap, int n,
                             int blocked) {
  const int half = cap / 2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += gridDim.x * blockDim.x) {
    const bool real = blocked ? (i % half) < n / 2 : i < n;
    if (!real) {
      est[i] = T(0);
      err[i] = T(0);
      split_dim[i] = 0;
    }
  }
}

template <typename T>
int launch(int family, const RuleArgs<T>& a, cudaStream_t stream) {
  if (a.n < a.cap) {
    const int blocks = (a.cap + 255) / 256 < 4096 ? (a.cap + 255) / 256 : 4096;
    fill_padding<T><<<blocks, 256, 0, stream>>>(a.est, a.err, a.split_dim,
                                                a.cap, a.n, a.blocked);
  }
  if (a.n > 0) {
    const dim3 grid(a.n);
    switch (family) {
      case 1: rule_kernel<1, T><<<grid, kThreads, 0, stream>>>(a); break;
      case 2: rule_kernel<2, T><<<grid, kThreads, 0, stream>>>(a); break;
      case 3: rule_kernel<3, T><<<grid, kThreads, 0, stream>>>(a); break;
      case 4: rule_kernel<4, T><<<grid, kThreads, 0, stream>>>(a); break;
      case 5: rule_kernel<5, T><<<grid, kThreads, 0, stream>>>(a); break;
      case 6: rule_kernel<6, T><<<grid, kThreads, 0, stream>>>(a); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int build_and_launch(int family, int ndim, int feval, int cap, int n,
                     int blocked, const void* lows, const void* lengths,
                     const void* glo, const void* grange, const void* gen,
                     const void* orbit_wts, const void* scale,
                     const void* norm, double ratio, const int* orbit_bounds,
                     const double* params, void* est, void* err,
                     int* split_dim, cudaStream_t stream) {
  RuleArgs<T> a;
  a.lows = static_cast<const T*>(lows);
  a.lengths = static_cast<const T*>(lengths);
  a.glo = static_cast<const T*>(glo);
  a.grange = static_cast<const T*>(grange);
  a.gen = static_cast<const T*>(gen);
  a.orbit_wts = static_cast<const T*>(orbit_wts);
  a.scale = static_cast<const T*>(scale);
  a.norm = static_cast<const T*>(norm);
  a.est = static_cast<T*>(est);
  a.err = static_cast<T*>(err);
  a.split_dim = split_dim;
  a.ndim = ndim;
  a.feval = feval;
  a.cap = cap;
  a.n = n;
  a.blocked = blocked;
  a.ratio = static_cast<T>(ratio);
  for (int k = 0; k <= kNsets; ++k) a.orbit_bounds[k] = orbit_bounds[k];
  for (int d = 0; d < kMaxNdim; ++d) {
    a.coeffs[d] = static_cast<T>(params[d]);
    a.bounds[d] = static_cast<T>(params[kMaxNdim + d]);
  }
  a.s0 = static_cast<T>(params[2 * kMaxNdim]);
  a.s1 = static_cast<T>(params[2 * kMaxNdim + 1]);
  return launch<T>(family, a, stream);
}

}  // namespace

// C entry point for ctypes.  Pointers are device pointers except
// orbit_bounds (10 ints) and params (34 doubles: coeffs[16], bounds[16],
// s0, s1), which are host arrays.  Returns cudaGetLastError() after the
// launches (0 on success); never synchronises.
extern "C" int rule_eval_launch(
    int family, int is_double, int ndim, int feval, int cap, int n,
    int blocked, const void* lows, const void* lengths, const void* glo,
    const void* grange, const void* gen, const void* orbit_wts,
    const void* scale, const void* norm, double ratio,
    const int* orbit_bounds, const double* params, void* est, void* err,
    int* split_dim, void* stream) {
  if (ndim < 2 || ndim > kMaxNdim || family < 1 || family > 6 || n > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return build_and_launch<double>(family, ndim, feval, cap, n, blocked,
                                    lows, lengths, glo, grange, gen,
                                    orbit_wts, scale, norm, ratio,
                                    orbit_bounds, params, est, err,
                                    split_dim, s);
  return build_and_launch<float>(family, ndim, feval, cap, n, blocked, lows,
                                 lengths, glo, grange, gen, orbit_wts, scale,
                                 norm, ratio, orbit_bounds, params, est, err,
                                 split_dim, s);
}
