// Genz-Malik rule evaluation past 16 dimensions, fused with a Genz family,
// for NVIDIA Hopper (sm_90a): the 'wide' route of the rule kernel
// (ops/cuda_rule.py chooses it for a Genz family at ndim 17..24).
// rule_eval.cu includes it after rule_eval.cuh, whose device functions it
// shares (region_axis, fourth_diff, region_outputs, the padding fill).
//
// Replaces gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule (the
// f32 Pallas kernel, which loops over any ndim) and, in f64, the XLA path
// rule_eval._eval_chunk at 17..24D: both compute the function that the
// plain PyTorch version gpuintegration_torch/ops/rule_eval.py::
// apply_rule_plain computes.
//
// Why not the generic route: it packs a point's codes at 4 bits an axis in
// a 64-bit word, spreads them to a byte an axis in shared memory (11,561
// points x 20 bytes at 20D, past a block's 227 KB) and keeps a block table
// of 2^(n-5) corner words; and it gives a region one group of 32 lanes,
// which at 20D would walk 1,060,137 points.  Here:
//   * one block of 16 warps a region; persistent blocks walk the pool's
//     real regions r = blockIdx.x, blockIdx.x + gridDim.x, ...;
//   * ndim at run time; the axis loops unroll to 24 and skip the axes past
//     ndim (a branch the whole block takes alike);
//   * the region's coordinate table in shared memory: genz_pre of the 11
//     coordinates an axis (0, +-lambda_1..5), as on the other routes;
//   * points 0..k8-1 (orbits 0-7: 7,209 at 17D, 19,697 at 24D) from a
//     table of one 32-bit word a point (cuda_rule.wide_orbit_codes): up to
//     three (axis, code) pairs of 5 + 4 bits; every axis no pair names takes
//     the centre.  The words are read from global memory (L1/L2), one a
//     point;
//   * the 2^n corners (94.8 % of the points at 17D, 99.9 % at 24D) from the
//     point index: axis d at -lambda_5 where bit n-1-d of corner k is set
//     (the generic route's convention, cuda_rule.generic_point_codes).
//     Thread t takes corners k = it * 512 + t: its 9 low axes are the same
//     in all of them and are read once a region into registers; the n - 9
//     high axes come from ``it``'s bits, a shift, a mask and one
//     shared-memory read an axis.  Every axis is folded in order 0..n-1,
//     so a value has the bits of the fold of its n coordinates;
//   * sums: each thread keeps running sums of its points of orbits 5, 6, 7
//     and of its corners, the corners in runs of 32 whose sums add into
//     runs of 1024 (an f32 running sum of 32,768 corners would lose ~200
//     ulps); a warp adds its lanes' by an xor-shuffle tree, and warp 0
//     adds the 16 warps' by another: the order is fixed by ndim alone, not
//     by n, the capacity, the pool's layout or the number of SMs, so a
//     region gives the same bits in any pool, in the host loop and in the
//     fused phase.  No atomics;
//   * the epilogue is the generic route's on warp 0: lane d takes axis d's
//     pair sums of orbits 1-4 and its fourth difference (24 axes fit a
//     warp), the split axis by a shuffle argmax, the rule sums and the
//     gated null-rule error (region_outputs).
// No tensor cores, no TF32: the null-rule sums cancel.  No crease fraction
// and no generated family: those runs raise past 16D (cuda_rule.rule_route).

#pragma once

#include "rule_eval.cuh"

namespace {
namespace rule {

constexpr int kWideMinNdim = kMaxNdim + 1;
constexpr int kWideMaxNdim = 24;
constexpr int kWideWarps = 16;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideLowAxes = 9;    // log2(kWideThreads): a thread's corners
constexpr int kWideHighAxes = kWideMaxNdim - kWideLowAxes;
constexpr int kWideRun = 32;       // corners of a thread's inner running sum
constexpr int kPairBits = 9;       // a pair: axis (5 bits), code (4 bits)
static_assert(1 << kWideLowAxes == kWideThreads, "a corner bit a thread bit");
static_assert(kWideMinNdim > kWideLowAxes + 3, "at least 256 corners a thread");

template <typename T>
struct WideArgs {
  const T* lows;          // (ndim, cap) unit-space lower bounds
  const T* lengths;       // (ndim, cap) unit-space lengths
  const T* glo;           // (ndim,) global lower bounds
  const T* grange;        // (ndim,) global ranges
  const uint32_t* codes;  // (k8,) orbits 0..7: three (axis, code) pairs
  const T* lam;           // (16,) the signed generator of each code
  const T* orbit_wts;     // (9, 5)
  const T* scale;         // (9, 5)
  const T* norm;          // (9, 5)
  T* est;                 // (cap,)
  T* err;                 // (cap,)
  int* split_dim;         // (cap,)
  int ndim, cap, n, blocked;
  T ratio;
  T coeffs[kWideMaxNdim];  // per-axis a_i (F1, F3, F6); 0 past ndim
  T bounds[kWideMaxNdim];  // per-axis b_i (F6); 0 past ndim
  T s0, s1;                // as RuleArgs'
};

template <typename T>
struct WideSmem {
  T xt[kWideMaxNdim][kCodeRow];    // genz_pre of the region's coordinates
  T corner[kWideMaxNdim][2];       // xt[d][5], xt[d][10]: a corner's axis d
  T vals[8 * kWideMaxNdim + 2];    // values of points 0..8n
  T wsum[kWideWarps][4];           // each warp's orbit 5, 6, 7, corner sums
  T lo[kWideMaxNdim], ln[kWideMaxNdim];
  T glo[kWideMaxNdim], grange[kWideMaxNdim];
  T coeff[kWideMaxNdim], bound[kWideMaxNdim];
  T wts[kTab], scale[kTab], norm[kTab], lam[kCodeRow];
};

template <int FAMILY, typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
rule_wide_kernel(const WideArgs<T> a) {
  __shared__ WideSmem<T> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ndim = a.ndim;
  const int high = ndim - kWideLowAxes;      // corner axes from ``it``

  // the orbits' bounds: points 0..8n (centre, orbits 1-4), orbits 5, 6, 7,
  // then the 2^n corners, 2^high a thread
  const int k5 = 8 * ndim + 1;
  const int k6 = k5 + 2 * ndim * (ndim - 1);
  const int k7 = k6 + 4 * ndim * (ndim - 1);
  const int k8 = k7 + 4 * ndim * (ndim - 1) * (ndim - 2) / 3;
  const int its = 1 << high;

  // ---- prologue: the block's tables --------------------------------------
  for (int i = tid; i < kTab; i += kWideThreads) {
    sm.wts[i] = a.orbit_wts[i];
    sm.scale[i] = a.scale[i];
    sm.norm[i] = a.norm[i];
  }
  if (tid < kCodeRow) sm.lam[tid] = a.lam[tid];
  if (tid < ndim) {
    sm.glo[tid] = a.glo[tid];
    sm.grange[tid] = a.grange[tid];
  }
#pragma unroll
  for (int d = 0; d < kWideMaxNdim; ++d) {
    if (tid == d) {
      sm.coeff[d] = a.coeffs[d];
      sm.bound[d] = a.bounds[d];
    }
  }

  // the value of point p < k8: its pairs' byte offsets on their axes, the
  // centre on every other axis
  auto orbit_value = [&](int p) -> T {
    const uint32_t w = __ldg(a.codes + p);
    int axis[3];
    uint32_t off[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint32_t pair = w >> (kPairBits * i);
      axis[i] = static_cast<int>(pair & 31u);
      off[i] = ((pair >> 5) & 15u) * static_cast<uint32_t>(sizeof(T));
    }
    GenzState<T> g;
#pragma unroll
    for (int d = 0; d < kWideMaxNdim; ++d) {
      if (d < kWideMinNdim || d < ndim) {
        const uint32_t o = (d == axis[0] ? off[0] : 0u) |
                           (d == axis[1] ? off[1] : 0u) |
                           (d == axis[2] ? off[2] : 0u);
        genz_fold<FAMILY, T>(
            g, *reinterpret_cast<const T*>(
                   reinterpret_cast<const char*>(sm.xt[d]) + o),
            a.coeffs[d], a.bounds[d], a.s0);
      }
    }
    return genz_finish<FAMILY, T>(g, ndim, a.s0);
  };

  // a thread's running sum of points lo .. hi - 1 of the orbit table
  auto orbit_sum = [&](int lo, int hi) -> T {
    T acc0 = T(0), acc1 = T(0);
    int p = lo + tid;
    for (; p + kWideThreads < hi; p += 2 * kWideThreads) {
      acc0 += orbit_value(p);
      acc1 += orbit_value(p + kWideThreads);
    }
    if (p < hi) acc0 += orbit_value(p);
    return acc0 + acc1;
  };

  const T c0 = T(2) * (T(1) - a.ratio);
  const int per_part = a.blocked ? a.n / 2 : a.n;

  for (int r = blockIdx.x; r < a.n; r += gridDim.x) {
    const int slot = r < per_part ? r : a.cap / 2 + (r - per_part);
    __syncthreads();   // the previous region's tables are read out
    if (tid < ndim) {
      sm.lo[tid] = a.lows[static_cast<size_t>(tid) * a.cap + slot];
      sm.ln[tid] = a.lengths[static_cast<size_t>(tid) * a.cap + slot];
    }
    __syncthreads();
    // the region's 11 coordinates an axis, through genz_pre
    if (tid < ndim * kCodes) {
      const int d = tid / kCodes, c = tid - d * kCodes;
      T cen, len;
      region_axis(sm.lo[d], sm.ln[d], sm.glo[d], sm.grange[d], cen, len);
      const T x = cen - sm.lam[c] * len;
      const T v = genz_pre<FAMILY, T>(x, a.s0, a.s1);
      sm.xt[d][c] = v;
      if (c == 5) sm.corner[d][0] = v;
      if (c == 10) sm.corner[d][1] = v;
    }
    __syncthreads();

    // points 0..8n, kept; orbits 5, 6, 7, summed
    if (tid < k5) sm.vals[tid] = orbit_value(tid);
    T s5 = orbit_sum(k5, k6);
    T s6 = orbit_sum(k6, k7);
    T s7 = orbit_sum(k7, k8);

    // the corners: this thread's low axes, then it = 0 .. its - 1
    T lv[kWideLowAxes], lc[kWideLowAxes], lb[kWideLowAxes];
#pragma unroll
    for (int i = 0; i < kWideLowAxes; ++i) {
      const int d = high + i;
      lv[i] = sm.corner[d][(tid >> (kWideLowAxes - 1 - i)) & 1];
      lc[i] = sm.coeff[d];
      lb[i] = sm.bound[d];
    }
    constexpr int kShift = sizeof(T) == 8 ? 3 : 2;
    auto corner_value = [&](int it) -> T {
      // bit high-1-d of it, axis d's, at bit 31-d of u
      const uint32_t u = static_cast<uint32_t>(it) << (32 - high);
      GenzState<T> g;
#pragma unroll
      for (int d = 0; d < kWideHighAxes; ++d) {
        if (d < kWideMinNdim - kWideLowAxes || d < high) {
          const uint32_t o = (u >> (31 - kShift - d)) &
                             static_cast<uint32_t>(sizeof(T));
          genz_fold<FAMILY, T>(
              g, *reinterpret_cast<const T*>(
                     reinterpret_cast<const char*>(sm.corner[d]) + o),
              a.coeffs[d], a.bounds[d], a.s0);
        }
      }
#pragma unroll
      for (int i = 0; i < kWideLowAxes; ++i)
        genz_fold<FAMILY, T>(g, lv[i], lc[i], lb[i], a.s0);
      return genz_finish<FAMILY, T>(g, ndim, a.s0);
    };
    T s8 = T(0);
    for (int i2 = 0; i2 < its; i2 += kWideRun * kWideRun) {
      const int e2 = min(its, i2 + kWideRun * kWideRun);
      T mid = T(0);
      for (int i1 = i2; i1 < e2; i1 += kWideRun) {
        T acc0 = T(0), acc1 = T(0);
#pragma unroll 2
        for (int it = i1; it < i1 + kWideRun; it += 2) {
          acc0 += corner_value(it);
          acc1 += corner_value(it + 1);
        }
        mid += acc0 + acc1;
      }
      s8 += mid;
    }

    s5 = warp_sum(s5);
    s6 = warp_sum(s6);
    s7 = warp_sum(s7);
    s8 = warp_sum(s8);
    if (lane == 0) {
      sm.wsum[warp][0] = s5;
      sm.wsum[warp][1] = s6;
      sm.wsum[warp][2] = s7;
      sm.wsum[warp][3] = s8;
    }
    __syncthreads();

    // ---- the region's epilogue, on warp 0 ---------------------------------
    if (warp == 0) {
      T q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = warp_sum(lane < kWideWarps ? sm.wsum[lane][k] : T(0));
      // lane d: the pair sums of axis d in orbits 1..4, its fourth
      // difference
      const T f0 = sm.vals[0];
      T o1 = T(0), o2 = T(0), o3 = T(0), o4 = T(0), diff = T(0);
      if (lane < ndim) {
        const T* v = sm.vals;
        o1 = v[1 + 2 * lane] + v[2 + 2 * lane];
        o2 = v[1 + 2 * ndim + 2 * lane] + v[2 + 2 * ndim + 2 * lane];
        o3 = v[1 + 4 * ndim + 2 * lane] + v[2 + 4 * ndim + 2 * lane];
        o4 = v[1 + 6 * ndim + 2 * lane] + v[2 + 6 * ndim + 2 * lane];
        diff = fourth_diff(c0, f0, a.ratio, o1, o2);
      }
      const bool any_nan = __any_sync(kFull, diff != diff);
      // the first largest positive difference: a NaN never wins
      T top = (diff != diff) ? T(0) : diff;
      int arg = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T v = __shfl_xor_sync(kFull, top, off);
        const int i = __shfl_xor_sync(kFull, arg, off);
        if (v > top || (v == top && i < arg)) {
          top = v;
          arg = i;
        }
      }
      o1 = warp_sum(o1);
      o2 = warp_sum(o2);
      o3 = warp_sum(o3);
      o4 = warp_sum(o4);
      if (lane == 0) {
        const T orbit_sums[kNsets] = {f0, o1, o2, o3, o4,
                                      q[0], q[1], q[2], q[3]};
        T jac = T(1), vol = T(1), wl = sm.ln[0];
        int widest = 0;
        for (int d = 0; d < ndim; ++d) {
          jac *= sm.grange[d];
          const T len = sm.ln[d];
          vol *= len;
          if (d > 0 && len > wl) {
            wl = len;
            widest = d;
          }
        }
        const int best = any_nan ? -2 : (top > T(0) ? arg : -1);
        T est, err;
        int sdim;
        region_outputs(orbit_sums, jac, vol, widest, best, best == -2,
                       sm.wts, sm.scale, sm.norm, est, err, sdim);
        a.est[slot] = est;
        a.err[slot] = err;
        a.split_dim[slot] = sdim;
      }
    }
  }
}

template <int FAMILY, typename T>
int launch_wide_kernel(const WideArgs<T>& a, int blocks,
                       cudaStream_t stream) {
  rule_wide_kernel<FAMILY, T><<<blocks, kWideThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide(int family, const WideArgs<T>& a, int blocks,
                cudaStream_t stream) {
  launch_fill<T>(a.est, a.err, a.split_dim, nullptr, a.cap, a.n, a.blocked,
                 stream);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  switch (family) {
    case 1: return launch_wide_kernel<1, T>(a, blocks, stream);
    case 2: return launch_wide_kernel<2, T>(a, blocks, stream);
    case 3: return launch_wide_kernel<3, T>(a, blocks, stream);
    case 4: return launch_wide_kernel<4, T>(a, blocks, stream);
    case 5: return launch_wide_kernel<5, T>(a, blocks, stream);
    case 6: return launch_wide_kernel<6, T>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int wide_route(int family, int ndim, int cap, int n, int blocked,
               const void* lows, const void* lengths, const void* glo,
               const void* grange, const void* codes, const void* lam,
               const void* orbit_wts, const void* scale, const void* norm,
               double ratio, const double* params, int blocks, void* est,
               void* err, int* split_dim, cudaStream_t stream) {
  WideArgs<T> a;
  a.lows = static_cast<const T*>(lows);
  a.lengths = static_cast<const T*>(lengths);
  a.glo = static_cast<const T*>(glo);
  a.grange = static_cast<const T*>(grange);
  a.codes = static_cast<const uint32_t*>(codes);
  a.lam = static_cast<const T*>(lam);
  a.orbit_wts = static_cast<const T*>(orbit_wts);
  a.scale = static_cast<const T*>(scale);
  a.norm = static_cast<const T*>(norm);
  a.est = static_cast<T*>(est);
  a.err = static_cast<T*>(err);
  a.split_dim = split_dim;
  a.ndim = ndim;
  a.cap = cap;
  a.n = n;
  a.blocked = blocked;
  a.ratio = static_cast<T>(ratio);
  for (int d = 0; d < kWideMaxNdim; ++d) {
    a.coeffs[d] = static_cast<T>(params[d]);
    a.bounds[d] = static_cast<T>(params[kWideMaxNdim + d]);
  }
  a.s0 = static_cast<T>(params[2 * kWideMaxNdim]);
  a.s1 = static_cast<T>(params[2 * kWideMaxNdim + 1]);
  return launch_wide<T>(family, a, blocks, stream);
}

}  // namespace rule
}  // namespace

// C entry point of the wide route for ctypes: a Genz family (1..6) at
// ndim 17..24.  Pointers are device pointers except params (50 doubles:
// coeffs[24], bounds[24], s0, s1), a host array copied into the launch's
// arguments.  ``codes``: cuda_rule.wide_orbit_codes (k8,) uint32;
// ``lam`` (16,), orbit_wts, scale and norm (9, 5) of the working type;
// ``blocks``: persistent blocks of 16 warps (cuda_rule.wide_plan).
// Returns cudaGetLastError() after its launches (0 on success) and never
// synchronises.
extern "C" int rule_wide_launch(int family, int is_double, int ndim, int cap,
                                int n, int blocked, const void* lows,
                                const void* lengths, const void* glo,
                                const void* grange, const void* codes,
                                const void* lam, const void* orbit_wts,
                                const void* scale, const void* norm,
                                double ratio, const double* params,
                                int blocks, void* est, void* err,
                                int* split_dim, void* stream) {
  if (family < 1 || family > 6 || ndim < rule::kWideMinNdim ||
      ndim > rule::kWideMaxNdim || n < 0 || n > cap || blocks < 1 ||
      (blocked && (n % 2 || cap % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? rule::wide_route<double>(family, ndim, cap, n, blocked, lows,
                                        lengths, glo, grange, codes, lam,
                                        orbit_wts, scale, norm, ratio, params,
                                        blocks, est, err, split_dim, s)
             : rule::wide_route<float>(family, ndim, cap, n, blocked, lows,
                                       lengths, glo, grange, codes, lam,
                                       orbit_wts, scale, norm, ratio, params,
                                       blocks, est, err, split_dim, s);
}
