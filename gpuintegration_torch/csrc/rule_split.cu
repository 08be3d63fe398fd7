// Genz-Malik rule evaluation of ANY integrand over a PAGANI region pool,
// for NVIDIA Hopper (sm_90a): the split route of ops/cuda_rule.py.
//
// Replaces gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule for an
// integrand that is not a Genz family.  The Pallas kernel fuses a traced
// integrand into its tile; a kernel written by hand cannot trace a torch
// callable, so the work is split in three on the card, chunk by chunk:
//
//   1. rule_points_kernel writes every rule point of a chunk of C real
//      regions, x[c, p, d] = center_g[d] - gen[p, d] * len_g[d], as the
//      (C, feval, ndim) tensor that rule_eval.rule_points gives, in its
//      layout too: PyTorch lays that broadcast out as coordinate planes,
//      region fastest (strides 1, C, C*feval; one region: points-major),
//      and a callable that reduces over the axes rounds alike only on
//      tensors of the same strides;
//   2. the user's callable runs on those points as ordinary torch ops;
//   3. rule_contract_kernel reduces the values (C, feval) to est, err and
//      split_dim and writes them into the region's pool slot.
//
// Both keep the plain version's roundings where the arithmetic is
// elementwise, each product and sum rounded on its own (never contracted
// into a fused multiply-add): center_g and len_g as rule_points forms them,
// then one rounded multiply and one rounded subtract per coordinate, so the
// points are EQUAL to the plain version's and the callable sees the same
// bits; the fourth differences, the weight table, the null-rule terms and
// the gate as rule_eval.rule_outputs rounds them.  Only the per-orbit sums
// of the values are taken in another order (16 strided partial sums added
// in a fixed order).  So split_dim, an argmax of the fourth differences,
// is the plain version's, NaN included (a NaN difference makes the widest
// axis the split axis, as torch.amax's NaN does in rule_outputs).
//
// What bounds them: both move bytes and do little arithmetic.  The points
// kernel writes 8 * feval * ndim bytes a region (70.7 KB at 8D f64) and
// reads a few; the contraction reads 8 * feval bytes a region (8.8 KB) and
// does some 2 operations a value.  At the Workspace's 8D f64 chunk of 4096
// regions that is 289.7 MB written (0.0865 ms at 3.35 TB/s) and 36.2 MB
// read (0.0108 ms).  The design follows the bytes and the planes' layout:
//   * points: a thread per region, neighbouring threads on neighbouring
//     regions, so a warp's stores of one (point, axis) are one contiguous
//     row of 32 values.  A block takes 128 regions and a tile of 32 points;
//     a thread forms its region's centre and length of an axis once and
//     writes the tile's 32 coordinates of that axis.  The generator is the
//     same for the whole warp (a broadcast load);
//   * contraction: the values come back from the callable in the same
//     layout, point-major planes with the region fastest.  A block takes 32
//     neighbouring regions, a lane per region, and 16 warps: warp g sums
//     points g, g + 16, ... of each orbit, so a warp's loads are contiguous
//     rows; warp 0 adds the 16 partial sums in a fixed order and runs the
//     epilogue, a lane per region.  The same bits from launch to launch, no
//     atomics.  Any other strides are read correctly, if less well.
// Neither uses tensor cores or TF32: the null-rule sums cancel.  Indices
// are 64-bit: a chunk may hold more than 2^31 coordinates.
//
// Built by ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --split-compile 0 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxNdim = 16;
constexpr int kNsets = 9;
constexpr int kNrules = 5;
constexpr int kPointThreads = 128;  // regions of a points block
constexpr int kPointTile = 32;      // points of a points block
constexpr int kContractGroups = 16; // warps of a contraction block

// Arithmetic rounded as the plain version's separate tensor operations
// round it: the compiler may not fuse these into a multiply-add.
__device__ __forceinline__ float r_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double r_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float r_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double r_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float r_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double r_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// max that propagates NaN, like torch.maximum and torch.amax
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (is_nan(a) || is_nan(b)) ? (is_nan(a) ? a : b) : (a > b ? a : b);
}

// The pool slot of real region r: [0, n) or, blocked, the first n/2 slots
// of each static half (region_pool.block_mask).
__device__ __forceinline__ int64_t real_slot(int64_t r, int64_t cap,
                                             int64_t n, int blocked) {
  const int64_t half_n = n / 2;
  return (blocked && r >= half_n) ? cap / 2 + (r - half_n) : r;
}

// ---------------------------------------------------------------------------
// 1. The points.

template <typename T>
struct PointArgs {
  const T* lows;      // (ndim, cap) unit-space lower bounds
  const T* lengths;   // (ndim, cap) unit-space lengths
  const T* glo;       // (ndim,) global lower bounds
  const T* grange;    // (ndim,) global ranges
  const T* gen;       // (feval, ndim) signed generators, points-major
  T* x;               // (count, feval, ndim) at strides sc, sp, sd
  int64_t cap, n, first, count;
  int64_t sc, sp, sd;
  int ndim, feval, blocked;
};

// A thread per region and axis of a block's tile of points: threadIdx.x
// walks the regions (neighbouring regions, neighbouring addresses at the
// planes' layout), blockIdx.y the tiles of kPointTile points.
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
rule_points_kernel(const PointArgs<T> a) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kPointThreads + threadIdx.x;
  if (c >= a.count) return;
  const int p0 = blockIdx.y * kPointTile;
  const int p1 = p0 + kPointTile < a.feval ? p0 + kPointTile : a.feval;
  const int ndim = a.ndim;
  const int64_t slot = real_slot(a.first + c, a.cap, a.n, a.blocked);
  for (int d = 0; d < ndim; ++d) {
    const T lo = a.lows[d * a.cap + slot];
    const T ln = a.lengths[d * a.cap + slot];
    const T rg = a.grange[d];
    // rule_eval.rule_points: len_g = lengths * range, center_g = gl +
    // (lows + 0.5 lengths) * range, each operation rounded on its own
    const T len = r_mul(ln, rg);
    const T cen = r_add(a.glo[d], r_mul(r_add(lo, r_mul(T(0.5), ln)), rg));
    T* out = a.x + c * a.sc + d * a.sd;
    for (int p = p0; p < p1; ++p)
      out[p * a.sp] = r_sub(cen, r_mul(__ldg(a.gen + p * ndim + d), len));
  }
}

// ---------------------------------------------------------------------------
// 2. The contraction.

template <typename T>
struct ContractArgs {
  const T* vals;       // (count, feval) values at strides sc, sp
  const T* lengths;    // (ndim, cap) unit-space lengths
  const T* grange;     // (ndim,) global ranges
  const T* orbit_wts;  // (9, 5)
  const T* scale;      // (9, 5)
  const T* norm;       // (9, 5)
  T* est;              // (cap,)
  T* err;              // (cap,)
  int* split_dim;      // (cap,)
  int64_t cap, n, first, count;
  int64_t sc, sp;
  int ndim, feval, blocked;
  T ratio;
  int orbit_bounds[kNsets + 1];
};

// A block of kContractGroups warps takes 32 neighbouring regions, a lane
// per region: warp g sums the values of points g, g + kContractGroups, ...
// of each orbit, and warp 0 adds the groups' partial sums in a fixed order
// and runs the epilogue, a lane per region.
template <typename T>
__global__ void __launch_bounds__(32 * kContractGroups)
rule_contract_kernel(const ContractArgs<T> a) {
  __shared__ T s_part[kContractGroups][kNsets][32];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool real = c < a.count;
  const T* row = a.vals + c * a.sc;
#pragma unroll
  for (int s = 0; s < kNsets; ++s) {
    T v = T(0);
    if (real)
      for (int p = a.orbit_bounds[s] + g; p < a.orbit_bounds[s + 1];
           p += kContractGroups)
        v += row[p * a.sp];
    s_part[g][s][lane] = v;
  }
  __syncthreads();
  if (g != 0 || !real) return;

  // ---- epilogue, a lane per region, rounded as rule_eval.rule_outputs ---
  T orbit_sum[kNsets];
#pragma unroll
  for (int s = 0; s < kNsets; ++s) {
    T v = s_part[0][s][lane];
    for (int k = 1; k < kContractGroups; ++k) v += s_part[k][s][lane];
    orbit_sum[s] = v;
  }
  // rule_eval.fourth_differences: |c0 f0 + ratio (f1+ + f1-) - (f2+ +
  // f2-)| with c0 = 2 (1 - ratio); the first largest (torch.argmax), and
  // whether one is NaN
  const int ndim = a.ndim;
  const T c0 = T(2) * r_sub(T(1), a.ratio);
  const T c0f0 = r_mul(c0, row[0]);
  int best = 0;
  bool any_nan = false;
  T top = T(0);
  for (int d = 0; d < ndim; ++d) {
    const T o1 = r_add(row[(1 + 2 * d) * a.sp], row[(2 + 2 * d) * a.sp]);
    const T o2 = r_add(row[(1 + 2 * ndim + 2 * d) * a.sp],
                       row[(2 + 2 * ndim + 2 * d) * a.sp]);
    const T v = r_abs(r_sub(r_add(c0f0, r_mul(a.ratio, o1)), o2));
    if (is_nan(v)) {
      any_nan = true;
    } else if (d == 0 || v > top) {
      top = v;
      best = d;
    }
  }
  const int64_t slot = real_slot(a.first + c, a.cap, a.n, a.blocked);
  T jac = a.grange[0];
  T vol = a.lengths[slot];
  T wl = vol;
  int widest = 0;
  for (int d = 1; d < ndim; ++d) {
    jac = r_mul(jac, a.grange[d]);
    const T l = a.lengths[d * a.cap + slot];
    vol = r_mul(vol, l);
    // torch.argmax: the first largest, a NaN counting as the largest
    if (!is_nan(wl) && (is_nan(l) || l > wl)) {
      wl = l;
      widest = d;
    }
  }
  T sums[kNrules];
#pragma unroll
  for (int q = 0; q < kNrules; ++q) {
    T v = r_mul(orbit_sum[0], a.orbit_wts[q]);
#pragma unroll
    for (int k = 1; k < kNsets; ++k)
      v = r_add(v, r_mul(orbit_sum[k], a.orbit_wts[k * kNrules + q]));
    sums[q] = r_mul(v, jac);
  }
  T e[3];
#pragma unroll
  for (int q = 1; q <= 3; ++q) {
    T m = T(0);
#pragma unroll
    for (int k = 0; k < kNsets; ++k) {
      const T v = r_mul(
          r_abs(r_add(sums[q + 1], r_mul(a.scale[k * kNrules + q], sums[q]))),
          a.norm[k * kNrules + q]);
      m = k == 0 ? v : nan_max(m, v);
    }
    e[q - 1] = m;
  }
  // the (5,1,5) gate of rule_eval.gate_errors
  const T gated = (r_mul(T(5), e[0]) <= e[1] && r_mul(T(5), e[1]) <= e[2])
                      ? e[0]
                      : r_mul(T(5), nan_max(nan_max(e[0], e[1]), e[2]));
  a.est[slot] = r_mul(vol, sums[0]);
  a.err[slot] = r_mul(vol, gated);
  // rule_outputs: the argmax where the largest difference is positive,
  // else (all 0, or a NaN among them) the widest axis
  a.split_dim[slot] = (!any_nan && top > T(0)) ? best : widest;
}

// ---------------------------------------------------------------------------
// Launches.

struct HostArgs {
  int ndim, feval, blocked;
  int64_t cap, n, first, count;
  int64_t sc, sp, sd;  // strides of x (points) or vals (contraction)
};

template <typename T>
int points_launch(const HostArgs& h, const void* lows, const void* lengths,
                  const void* glo, const void* grange, const void* gen,
                  void* x, cudaStream_t stream) {
  PointArgs<T> a;
  a.lows = static_cast<const T*>(lows);
  a.lengths = static_cast<const T*>(lengths);
  a.glo = static_cast<const T*>(glo);
  a.grange = static_cast<const T*>(grange);
  a.gen = static_cast<const T*>(gen);
  a.x = static_cast<T*>(x);
  a.cap = h.cap;
  a.n = h.n;
  a.first = h.first;
  a.count = h.count;
  a.ndim = h.ndim;
  a.feval = h.feval;
  a.blocked = h.blocked;
  a.sc = h.sc;
  a.sp = h.sp;
  a.sd = h.sd;
  const dim3 grid(static_cast<unsigned>((h.count + kPointThreads - 1) /
                                        kPointThreads),
                  (h.feval + kPointTile - 1) / kPointTile);
  rule_points_kernel<T><<<grid, kPointThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int contract_launch(const HostArgs& h, const void* vals, const void* lengths,
                    const void* grange, const void* orbit_wts,
                    const void* scale, const void* norm, double ratio,
                    const int* orbit_bounds, void* est, void* err,
                    int* split_dim, cudaStream_t stream) {
  ContractArgs<T> a;
  a.vals = static_cast<const T*>(vals);
  a.lengths = static_cast<const T*>(lengths);
  a.grange = static_cast<const T*>(grange);
  a.orbit_wts = static_cast<const T*>(orbit_wts);
  a.scale = static_cast<const T*>(scale);
  a.norm = static_cast<const T*>(norm);
  a.est = static_cast<T*>(est);
  a.err = static_cast<T*>(err);
  a.split_dim = split_dim;
  a.cap = h.cap;
  a.n = h.n;
  a.first = h.first;
  a.count = h.count;
  a.ndim = h.ndim;
  a.feval = h.feval;
  a.blocked = h.blocked;
  a.sc = h.sc;
  a.sp = h.sp;
  a.ratio = static_cast<T>(ratio);
  for (int k = 0; k <= kNsets; ++k) a.orbit_bounds[k] = orbit_bounds[k];
  const unsigned blocks = static_cast<unsigned>((h.count + 31) / 32);
  rule_contract_kernel<T><<<blocks, dim3(32, kContractGroups), 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(const HostArgs& h) {
  return h.ndim < 2 || h.ndim > kMaxNdim || h.feval < 4 * h.ndim + 1 ||
         h.n > h.cap || h.first < 0 || h.count < 1 ||
         h.first + h.count > h.n || (h.blocked && (h.n % 2 || h.cap % 2)) ||
         h.count >= (int64_t(1) << 36) || h.feval > 65535 * kPointTile;
}

}  // namespace

// C entry points for ctypes.  Pointers are device pointers except
// orbit_bounds (10 ints, a host array).  Both walk the real regions
// first .. first + count - 1 of a pool of ``n`` real regions in ``cap``
// slots (blocked: the first n/2 of each half).  Each returns
// cudaGetLastError() after its launch (0 on success) and never
// synchronises.

// Writes x (count, feval, ndim) of the working type at strides (sc, sp,
// sd) in elements: the layout rule_eval.rule_points gives.
extern "C" int rule_split_points_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, long long sc,
    long long sp, long long sd, const void* lows, const void* lengths,
    const void* glo, const void* grange, const void* gen, void* x,
    void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, sd};
  if (bad_args(h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? points_launch<double>(h, lows, lengths, glo, grange, gen, x, s)
             : points_launch<float>(h, lows, lengths, glo, grange, gen, x, s);
}

// Reads vals (count, feval) at strides (sc, sp) in elements; writes est,
// err, split_dim at the regions' pool slots and nowhere else.
extern "C" int rule_split_contract_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, long long sc,
    long long sp, const void* vals, const void* lengths, const void* grange,
    const void* orbit_wts, const void* scale, const void* norm, double ratio,
    const int* orbit_bounds, void* est, void* err, int* split_dim,
    void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, 0};
  if (bad_args(h) || orbit_bounds[kNsets] != feval)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? contract_launch<double>(h, vals, lengths, grange, orbit_wts,
                                       scale, norm, ratio, orbit_bounds, est,
                                       err, split_dim, s)
             : contract_launch<float>(h, vals, lengths, grange, orbit_wts,
                                      scale, norm, ratio, orbit_bounds, est,
                                      err, split_dim, s);
}
