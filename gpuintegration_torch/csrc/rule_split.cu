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
//   3. a contraction kernel reduces the values (C, feval) to est, err and
//      split_dim and writes them into the region's pool slot.  This is the
//      contraction half of the Pallas kernel (its MXU product of the values
//      against the (P, 6 + 2n) column matrix, pallas_rule.py:86), in one of
//      two routes that cuda_rule.contract_route chooses by the shape:
//      rule_contract_cluster_kernel ('cluster') where a region's points or
//      a point's regions lie contiguous, rule_contract_kernel ('generic',
//      the first design) at any strides.  A vector integrand's values
//      (C, feval, ncomp), the counterpart of the reference's XLA
//      _eval_chunk_vector (est and err per component, one split axis from
//      all components' fourth differences), take one of two routes of
//      their own: rule_contract_comp_cluster_kernel
//      ('components_cluster') where they lie component-minor,
//      rule_contract_comp_kernel ('components', the first design) at any
//      strides.
//
// All keep the plain version's roundings where the arithmetic is
// elementwise, each product and sum rounded on its own (never contracted
// into a fused multiply-add): center_g and len_g as rule_points forms them,
// then one rounded multiply and one rounded subtract per coordinate, so the
// points are EQUAL to the plain version's and the callable sees the same
// bits; the fourth differences, the weight table, the null-rule terms and
// the gate as rule_eval.rule_outputs rounds them.  Only the per-orbit sums
// of the values are taken in another order, a fixed one.  So split_dim, an
// argmax of the fourth differences, is the plain version's, NaN included
// (a NaN difference makes the widest axis the split axis, as torch.amax's
// NaN does in rule_outputs).
//
// What bounds them: both move bytes and do little arithmetic.  The points
// kernel writes 8 * feval * ndim bytes a region (70.7 KB at 8D f64) and
// reads a few; the contraction reads 8 * feval bytes a region (8.8 KB) and
// does some 2 operations a value.  At the Workspace's 8D f64 chunk of 4096
// regions that is 289.7 MB written (0.0865 ms at 3.35 TB/s) and 36.2 MB
// read (0.0108 ms); at its 16D chunk of 1024 regions the contraction reads
// 586 MB (0.175 ms).  The designs follow the bytes and the planes' layout:
//   * points: a thread per region, neighbouring threads on neighbouring
//     regions, so a warp's stores of one (point, axis) are one contiguous
//     row of 32 values.  A block takes 128 regions and a tile of 32 points;
//     a thread forms its region's centre and length of an axis once and
//     writes the tile's 32 coordinates of that axis.  The generator is the
//     same for the whole warp (a broadcast load);
//   * contraction, 'generic': a block takes 32 neighbouring regions, a lane
//     per region, and 16 warps: warp g sums points g, g + 16, ... of each
//     orbit; warp 0 adds the 16 partial sums in a fixed order and runs the
//     epilogue.  Any strides.  At the Workspace's chunks it launches 32 to
//     512 blocks with about one 8-byte load in flight a thread: 41.7 % of
//     its bound at 8D, and a quarter of the card at 11-16D;
//   * contraction, 'components': the generic design over a vector's
//     values at any strides, the components in passes of one 32-byte
//     sector (4 f64 or 8 f32), a lane reading a point's components of the
//     pass together; each component summed in the generic kernel's order,
//     so its est and err are that kernel's on the component's plane, bit
//     for bit.  It reads 8 * feval * ncomp bytes a region: at the
//     Workspace's 8D f64 chunk and 4 components 144.8 MB (0.0432 ms);
//   * contraction, 'cluster': a group of 32 neighbouring regions, a lane
//     per region; its points are split across the K CTAs of a thread
//     block cluster, K from (count, feval) alone (cuda_rule.cluster_plan),
//     so that every chunk shape from 2D to 16D launches at least 224 CTAs,
//     two an SM, all resident at once from 6D up.  Each CTA streams its stages (128 points of
//     the 32 regions, 32 KB in f64) through a ring of two in shared memory:
//     one producer warp keeps bulk asynchronous copies (cp.async.bulk, the
//     TMA's copy engine) in flight under mbarriers, and eight consumer
//     warps add from shared memory, warp w the points w, w + 8, ... of each
//     stage, a running sum per orbit.  The values come from the callable in
//     one of two layouts: rows (strides (feval, 1): a callable that reduces
//     over the axes, the common case) or planes ((1, C): a per-axis
//     callable).  Either way a stage is 32 contiguous segments (a region's
//     128 points, or a point's 32 regions), each copied in whole 16-byte
//     units around it, from any address and for any count.  The copies'
//     size is what bounds the route on the H100 (PERF.md): rows
//     segments of 1 KB stream near the bound, planes segments of 256 bytes
//     do not, so planes take this route only from 4096 points a region up.
//     The leader (rank 0) also holds the 4n + 1 points of orbits 0-2 apart,
//     for the fourth differences.  The CTA's partial orbit sums are added
//     in warp order, then the leader adds the cluster's in rank order
//     through distributed shared memory, and spreads the epilogue over its
//     nine warps (fourth differences by axis, rule sums by rule, null-rule
//     terms by term).  No atomics: the same bits from launch to launch, on
//     any card;
//   * contraction, 'components_cluster': the cluster design over a
//     vector's values component-minor (strides (sc, ncomp, 1), what
//     torch.stack(..., -1) gives), where a region's points of a stage are
//     one contiguous segment of points x ncomp values.  The ranks take the
//     scalar cluster route's point ranges (its stages of 128 f64 or 256 f32
//     points), each cut into stages of ~1 KB a region's segment (32 points
//     of four f64 components), and warp w the points w, w + 8, ... of each,
//     so that component k is summed in the scalar route's order and its est
//     and err are bit for bit that route's on the component's plane.  A
//     warp keeps a running sum per component; as an orbit ends each warp
//     leaves its sums in a mailbox, and the last warp to do so adds the
//     eight up in warp order (a counter per orbit in shared memory), so
//     that no [warp][orbit][component] array has to fit beside the ring
//     and no warp waits for another's turn (a chain of turns cost ~7 us a
//     launch at the 8D chunk on an H100, PERF.md).  The leader's head
//     tile (points 0..4n, every component) lies at the end of the ring:
//     its sums and the component-wise maximum of the fourth differences
//     are taken from it while the first stage streams in beside it.  At
//     the Workspace's 8D f64 chunk and 4 components the values are 144.8
//     MB (0.0432 ms), at its 12D chunk 221 MB (0.0660 ms).
// In a crease run the scalar contractions also write the crease/jump-aware
// cut fraction and the split axis a jump overrides (the reference's XLA
// _split_fraction, gpuintegration_tpu/ops/rule_eval.py:184), from the
// 4n + 1 collinear values of each region, with split_frac.cuh's per-region
// form, a lane per region: the generic route reads them at the chunk's
// strides, the cluster route from the leader's head tile (points 0..4n),
// its warp 1 beside warp 0's est and err.  Every operation is rounded on
// its own, so the fraction is EQUAL to rule_eval.split_fraction and to the
// standalone kernel of split_frac.cu.  The vector contractions carry none:
// crease runs are scalar-only.
// None uses tensor cores or TF32: the null-rule sums cancel.  Indices are
// 64-bit: a chunk may hold more than 2^31 coordinates.
//
// Built by ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --split-compile 0 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_frac.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNdim = 16;
// Past kMaxNdim, up to kWideMaxNdim: the wide points kernel and the
// contractions' wide instances (fourth-difference rows for 24 axes, sums in
// runs of kRun values whose sums add into runs of kRun * kRun)
constexpr int kWideMaxNdim = 24;
constexpr int kRun = 32;
constexpr int kNsets = 9;
constexpr int kNrules = 5;
constexpr int kPointThreads = 128;  // regions of a points block
constexpr int kPointTile = 32;      // points of a points block
constexpr int kContractGroups = 16; // warps of a contraction block
// the cluster route
constexpr int kClusterWarps = 8;     // consumer warps of a CTA
constexpr int kClusterThreads = 32 * (kClusterWarps + 1);  // + the producer
constexpr int kMaxStages = 8;        // stages of a CTA's ring, at most
constexpr int kMaxSmem = 227 * 1024; // dynamic shared memory of a CTA
// clusters above 8 CTAs are not portable: CUDA refuses them unless a kernel
// allows them, which this one does not; the argument check lets them through
// so that the refusal is CUDA's own
constexpr int kMaxClusterArg = 16;

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

// N running sums that take one value each a point.  RUNS (the wide
// instances, 17..24D): each sum in runs of kRun points, a run's sum added
// into a run of kRun runs, that one's into the total, so that an f32 sum of
// 2^18 corners loses some hundred ulps less; the order is fixed by the
// points' order alone.  Without RUNS one running sum each, the ≤ 16D
// kernels' own arithmetic.
template <typename T, int N, bool RUNS>
struct Sums {
  T acc[N];
  T mid[RUNS ? N : 1], total[RUNS ? N : 1];
  int n_run, n_mid;

  __device__ __forceinline__ void zero(int k) {
    acc[k] = T(0);
    if constexpr (RUNS) mid[k] = total[k] = T(0);
  }
  __device__ __forceinline__ void restart() {
    if constexpr (RUNS) n_run = n_mid = 0;
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < N; ++k) zero(k);
    restart();
  }
  __device__ __forceinline__ void add(int k, T v) { acc[k] += v; }
  // after each point's values
  __device__ __forceinline__ void next() {
    if constexpr (RUNS) {
      if (++n_run == kRun) {
        n_run = 0;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          mid[k] += acc[k];
          acc[k] = T(0);
        }
        if (++n_mid == kRun) {
          n_mid = 0;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            total[k] += mid[k];
            mid[k] = T(0);
          }
        }
      }
    }
  }
  __device__ __forceinline__ T get(int k) const {
    if constexpr (RUNS) return total[k] + (mid[k] + acc[k]);
    return acc[k];
  }
};

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

// The points past kMaxNdim, where the (feval, ndim) generator table is 170 MB
// (20D) to 3.2 GB (24D) in f64 and feval passes gridDim.y's reach.
template <typename T>
struct WidePointArgs {
  const T* lows;          // (ndim, cap) unit-space lower bounds
  const T* lengths;       // (ndim, cap) unit-space lengths
  const T* glo;           // (ndim,) global lower bounds
  const T* grange;        // (ndim,) global ranges
  const uint32_t* codes;  // (k8,) orbits 0-7: three (axis, code) pairs
  const T* lam;           // (16,) the signed generator of each code
  T* x;                   // (count, feval, ndim) at strides sc, sp, sd
  int64_t cap, n, first, count;
  int64_t sc, sp, sd;
  int ndim, feval, k8, blocked;
};

// One thread an element of x, in the order of its layout so that a warp's
// stores are contiguous: the planes' (sc = 1: region fastest, then point;
// blockIdx.y the axis) or any other (axis fastest, then point, then
// region).  Point p < k8 takes its generator codes from its word of the
// orbit table (cuda_rule.wide_orbit_codes: up to three (axis, code) pairs
// of 5 + 4 bits, every axis no pair names the centre, code 0), corner k =
// p - k8 from its index: axis d at -lambda_5 (code 10) where bit ndim-1-d
// of k is set, else +lambda_5 (code 5), the generic route's convention.
// Each coordinate is rounded as rule_eval.rule_points rounds it.
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
rule_points_wide_kernel(const WidePointArgs<T> a) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kPointThreads + threadIdx.x;
  int64_t c, p;
  int d;
  if (a.sc == 1) {
    if (i >= a.count * a.feval) return;
    p = i / a.count;
    c = i - p * a.count;
    d = blockIdx.y;
  } else {
    if (i >= a.count * a.feval * a.ndim) return;
    const int64_t q = i / a.ndim;
    d = static_cast<int>(i - q * a.ndim);
    c = q / a.feval;
    p = q - c * a.feval;
  }
  int code = 0;
  if (p < a.k8) {
    const uint32_t w = __ldg(a.codes + p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t pair = w >> (9 * k);
      if (static_cast<int>(pair & 31u) == d) code |= (pair >> 5) & 15u;
    }
  } else {
    code = ((p - a.k8) >> (a.ndim - 1 - d)) & 1 ? 10 : 5;
  }
  const int64_t slot = real_slot(a.first + c, a.cap, a.n, a.blocked);
  const T lo = a.lows[d * a.cap + slot];
  const T ln = a.lengths[d * a.cap + slot];
  const T rg = a.grange[d];
  // rule_eval.rule_points: len_g = lengths * range, center_g = gl +
  // (lows + 0.5 lengths) * range, then center_g - gen * len_g, each
  // operation rounded on its own
  const T len = r_mul(ln, rg);
  const T cen = r_add(a.glo[d], r_mul(r_add(lo, r_mul(T(0.5), ln)), rg));
  a.x[c * a.sc + p * a.sp + d * a.sd] = r_sub(cen, r_mul(__ldg(a.lam + code),
                                                         len));
}

// ---------------------------------------------------------------------------
// 2. The contraction.

template <typename T>
struct ContractArgs {
  const T* vals;       // (count, feval[, ncomp]) at strides sc, sp[, sk]
  const T* lengths;    // (ndim, cap) unit-space lengths
  const T* grange;     // (ndim,) global ranges
  const T* orbit_wts;  // (9, 5)
  const T* scale;      // (9, 5)
  const T* norm;       // (9, 5)
  T* est;              // (cap,), or (ncomp, cap) for the components kernel
  T* err;              // the same
  int* split_dim;      // (cap,)
  int64_t cap, n, first, count;
  int64_t sc, sp, sk;
  int ndim, feval, blocked, ncomp;
  T ratio;
  int orbit_bounds[kNsets + 1];
  // the scalar contractions in a crease run: the cut fraction (cap,),
  // null otherwise, and the collinear stencil (split_frac.cuh)
  T* frac;
  sfrac::Stencil<T> st;
};

// The jacobian prod(range), the region's unit-space volume prod(lengths)
// and its widest axis (torch.argmax: the first largest, a NaN counting as
// the largest), each product rounded on its own as torch.prod's.
template <typename T>
__device__ __forceinline__ void region_geometry(const ContractArgs<T>& a,
                                                int64_t slot, T& jac, T& vol,
                                                int& widest) {
  jac = a.grange[0];
  vol = a.lengths[slot];
  T wl = vol;
  widest = 0;
  for (int d = 1; d < a.ndim; ++d) {
    jac = r_mul(jac, a.grange[d]);
    const T l = a.lengths[d * a.cap + slot];
    vol = r_mul(vol, l);
    if (!is_nan(wl) && (is_nan(l) || l > wl)) {
      wl = l;
      widest = d;
    }
  }
}

// rule_eval.fourth_differences of axis d: |c0 f0 + ratio (f1+ + f1-) -
// (f2+ + f2-)| with c0f0 = c0 f0, c0 = 2 (1 - ratio), from the values of
// one region at point stride sp.
template <typename T>
__device__ __forceinline__ T fourth_difference(const T* row, int64_t sp,
                                               int ndim, int d, T c0f0,
                                               T ratio) {
  const T o1 = r_add(row[(1 + 2 * d) * sp], row[(2 + 2 * d) * sp]);
  const T o2 = r_add(row[(1 + 2 * ndim + 2 * d) * sp],
                     row[(2 + 2 * ndim + 2 * d) * sp]);
  return r_abs(r_sub(r_add(c0f0, r_mul(ratio, o1)), o2));
}

// est and err of one region and one component from its nine orbit sums,
// rounded as rule_eval.rule_outputs: the rule sums from the weight table,
// the null-rule terms, the (5,1,5) gate of rule_eval.gate_errors, each
// scaled by the region's volume.
template <typename T>
__device__ __forceinline__ void rule_epilogue(const ContractArgs<T>& a,
                                              const T* orbit_sum, T jac,
                                              T vol, T& est, T& err) {
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
  const T gated = (r_mul(T(5), e[0]) <= e[1] && r_mul(T(5), e[1]) <= e[2])
                      ? e[0]
                      : r_mul(T(5), nan_max(nan_max(e[0], e[1]), e[2]));
  est = r_mul(vol, sums[0]);
  err = r_mul(vol, gated);
}

// A block of kContractGroups warps takes 32 neighbouring regions, a lane
// per region: warp g sums the values of points g, g + kContractGroups, ...
// of each orbit, and warp 0 adds the groups' partial sums in a fixed order
// and runs the epilogue, a lane per region.  WITH_FRAC (a crease run's):
// the epilogue's lane also takes the region's cut fraction.  WIDE (17..24D,
// rule_contract_wide_kernel): each warp's sums in runs (Sums).
template <typename T, bool WITH_FRAC, bool WIDE>
__device__ __forceinline__ void contract_body(const ContractArgs<T>& a) {
  __shared__ T s_part[kContractGroups][kNsets][32];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool real = c < a.count;
  const T* row = a.vals + c * a.sc;
#pragma unroll
  for (int s = 0; s < kNsets; ++s) {
    Sums<T, 1, WIDE> v;
    v.clear();
    if (real)
      for (int p = a.orbit_bounds[s] + g; p < a.orbit_bounds[s + 1];
           p += kContractGroups) {
        v.add(0, row[p * a.sp]);
        v.next();
      }
    s_part[g][s][lane] = v.get(0);
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
  // the first largest fourth difference (torch.argmax), and whether one is
  // NaN
  const int ndim = a.ndim;
  const T c0f0 = r_mul(T(2) * r_sub(T(1), a.ratio), row[0]);
  int best = 0;
  bool any_nan = false;
  T top = T(0);
  for (int d = 0; d < ndim; ++d) {
    const T v = fourth_difference(row, a.sp, ndim, d, c0f0, a.ratio);
    if (is_nan(v)) {
      any_nan = true;
    } else if (d == 0 || v > top) {
      top = v;
      best = d;
    }
  }
  const int64_t slot = real_slot(a.first + c, a.cap, a.n, a.blocked);
  T jac, vol;
  int widest;
  region_geometry(a, slot, jac, vol, widest);
  rule_epilogue(a, orbit_sum, jac, vol, a.est[slot], a.err[slot]);
  // rule_outputs: the argmax where the largest difference is positive,
  // else (all 0, or a NaN among them) the widest axis
  int sd = (!any_nan && top > T(0)) ? best : widest;
  if constexpr (WITH_FRAC) {
    // a crease run's cut fraction from the region's collinear values at
    // the chunk's strides (split_frac.cuh's per-region form)
    const int64_t sp = a.sp;
    a.frac[slot] = sfrac::region_frac([&](int p) { return row[p * sp]; },
                                      ndim, a.st, sd);
  }
  a.split_dim[slot] = sd;
}

template <typename T, bool WITH_FRAC>
__global__ void __launch_bounds__(32 * kContractGroups)
rule_contract_kernel(const ContractArgs<T> a) {
  contract_body<T, WITH_FRAC, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(32 * kContractGroups)
rule_contract_wide_kernel(const ContractArgs<T> a) {
  contract_body<T, false, true>(a);
}

// Components of a point the components kernel reads in one pass: one
// 32-byte sector of them where they lie component-minor (4 f64, 8 f32).
template <typename T>
__host__ __device__ constexpr int comp_group() {
  return 32 / static_cast<int>(sizeof(T));
}

// The contraction of a vector integrand's values (count, feval, ncomp) at
// any strides (sc, sp, sk), what rule_eval.rule_outputs_vector computes.
// The generic kernel's design and order of summation, component by
// component, so that component k's est and err are bitwise those of
// rule_contract_kernel on the values' plane k: a block of kContractGroups
// warps takes 32 neighbouring regions, a lane per region; the components
// go in passes of comp_group() (any ncomp >= 1), each pass over the same
// points, a lane reading a point's components of the pass together (one
// sector where they lie component-minor).  In each pass, orbit by orbit,
// warp g adds the values of points g, g + kContractGroups, ... of the
// orbit, a running sum a component; warp k then adds the 16 warps' sums of
// component k in warp order, and runs that component's epilogue.  After
// the passes warp 0 takes the split axis from the component-wise maximum
// of the fourth differences, a NaN in any component propagating (as
// torch.amax does in the plain version), so that the widest axis is then
// the split axis.  No atomics.  WIDE (17..24D,
// rule_contract_comp_wide_kernel): each warp's sums in runs (Sums).
template <typename T, bool WIDE>
__device__ __forceinline__ void contract_comp_body(const ContractArgs<T>& a) {
  constexpr int G = comp_group<T>();
  static_assert(G <= kContractGroups, "a warp reduces each component");
  __shared__ T s_part[kContractGroups][G][32];
  __shared__ T s_osum[G][kNsets][32];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool real = c < a.count;
  const T* row = a.vals + c * a.sc;
  const int64_t slot =
      real ? real_slot(a.first + c, a.cap, a.n, a.blocked) : 0;
  T jac = T(0), vol = T(0);
  int widest = 0;
  if (real) region_geometry(a, slot, jac, vol, widest);

  for (int k0 = 0; k0 < a.ncomp; k0 += G) {
    const int nk = a.ncomp - k0 < G ? a.ncomp - k0 : G;
    for (int s = 0; s < kNsets; ++s) {
      Sums<T, G, WIDE> v;
      v.clear();
      if (real)
        for (int p = a.orbit_bounds[s] + g; p < a.orbit_bounds[s + 1];
             p += kContractGroups) {
          const T* pt = row + p * a.sp + k0 * a.sk;
#pragma unroll
          for (int k = 0; k < G; ++k)
            if (k < nk) v.add(k, pt[k * a.sk]);
          v.next();
        }
#pragma unroll
      for (int k = 0; k < G; ++k) s_part[g][k][lane] = v.get(k);
      __syncthreads();
      if (g < nk) {
        T w = s_part[0][g][lane];
        for (int j = 1; j < kContractGroups; ++j) w += s_part[j][g][lane];
        s_osum[g][s][lane] = w;
      }
      __syncthreads();
    }
    // the epilogue of component k0 + g; s_osum is written again only after
    // the next pass's first barrier, which every warp reaches after this
    if (g < nk && real) {
      T orbit_sum[kNsets];
#pragma unroll
      for (int s = 0; s < kNsets; ++s) orbit_sum[s] = s_osum[g][s][lane];
      const int64_t at = (k0 + g) * a.cap + slot;
      rule_epilogue(a, orbit_sum, jac, vol, a.est[at], a.err[at]);
    }
  }
  if (g != 0 || !real) return;

  // the split axis from the component-wise maximum of the fourth
  // differences: the first largest, the widest axis where the largest is 0
  // or a NaN is among them
  const int ndim = a.ndim;
  const T c0 = T(2) * r_sub(T(1), a.ratio);
  int best = 0;
  bool any_nan = false;
  T top = T(0);
  for (int d = 0; d < ndim; ++d) {
    T m = T(0);
    for (int k = 0; k < a.ncomp; ++k) {
      const T* rk = row + k * a.sk;
      const T v = fourth_difference(rk, a.sp, ndim, d, r_mul(c0, rk[0]),
                                    a.ratio);
      m = k == 0 ? v : nan_max(m, v);
    }
    if (is_nan(m)) {
      any_nan = true;
    } else if (d == 0 || m > top) {
      top = m;
      best = d;
    }
  }
  a.split_dim[slot] = (!any_nan && top > T(0)) ? best : widest;
}

template <typename T>
__global__ void __launch_bounds__(32 * kContractGroups)
rule_contract_comp_kernel(const ContractArgs<T> a) {
  contract_comp_body<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(32 * kContractGroups)
rule_contract_comp_wide_kernel(const ContractArgs<T> a) {
  contract_comp_body<T, true>(a);
}

// ---------------------------------------------------------------------------
// 3. The contraction, cluster route.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// 1-D bulk asynchronous copy global -> shared; its bytes complete on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the phase of parity ``parity`` has completed.  A copy that
// never completes traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// Elements of T in 16 bytes: a bulk copy moves whole 16-byte units from a
// 16-byte address, so a segment of the values is copied with up to this
// many elements before it and after it (within its 16-byte units: never
// another page), and read from its offset in the copy.
template <typename T>
__host__ __device__ constexpr int slack() {
  return 16 / static_cast<int>(sizeof(T));
}

// The pitch of a tile's segments, in elements: 32 + S a point in the
// planes' layout, points + S a region in the rows' (S = slack), rounded up
// to whole 16-byte units, so that each segment starts on a 16-byte
// boundary.
template <typename T>
__host__ __device__ constexpr int seg_pitch(bool rows, int points) {
  return ((rows ? points : 32) + 2 * slack<T>() - 1) / slack<T>() *
         slack<T>();
}

// Elements of a tile that stages ``points`` points of 32 regions, in
// either layout.
template <typename T>
__host__ __device__ constexpr size_t tile_elements(int points) {
  return static_cast<size_t>(seg_pitch<T>(true, points)) *
         seg_pitch<T>(false, points);
}

// The dynamic shared memory of a CTA, in elements of T: the ring of
// ``stages`` tiles of ``points`` points, the head tile (points 0..4n,
// orbits 0-2: the leader's), the warps' partial orbit sums [warps][9][32],
// the CTA's [9][32] and the cluster's [9][32].  The epilogue's rows reuse
// the warps' partial sums once the CTA's are formed: fourth differences
// [FD][32] (FD: kMaxNdim, or kWideMaxNdim in the wide instances), rule
// sums [5][32], null-rule terms [3][32], volumes [32], and two int rows
// [32] (widest axis, split axis by fourth difference).
template <typename T, int FD>
struct ClusterSmem {
  T *ring, *head, *part, *cta, *osum, *fd, *sums, *e, *vol;
  int *widest, *best;

  static_assert((FD + kNrules + 3 + 1) * 32 * sizeof(T) +
                        2 * 32 * sizeof(int) <=
                    kClusterWarps * kNsets * 32 * sizeof(T),
                "the epilogue's rows fit in the warps' partial sums");
  __host__ __device__ static size_t bytes(int ndim, int points, int stages) {
    return (stages * tile_elements<T>(points) +
            tile_elements<T>(4 * ndim + 1) +
            (kClusterWarps + 2) * kNsets * 32) * sizeof(T);
  }
  __device__ ClusterSmem(T* base, int ndim, int points, int stages) {
    ring = base;
    head = ring + stages * tile_elements<T>(points);
    part = head + tile_elements<T>(4 * ndim + 1);
    cta = part + kClusterWarps * kNsets * 32;
    osum = cta + kNsets * 32;
    fd = part;
    sums = fd + FD * 32;
    e = sums + kNrules * 32;
    vol = e + 3 * 32;
    widest = reinterpret_cast<int*>(vol + 32);
    best = widest + 32;
  }
};

// The stages [lo, hi) that cluster rank ``rank`` of ``k`` sums: the points
// past the head's ``head`` in stages of ``rows``, stage t holding points
// head + rows t .. (cuda_rule.cluster_partition computes the same).
__device__ __forceinline__ void rank_stages(int feval, int head, int rows,
                                            int rank, int k, int& lo,
                                            int& hi) {
  const int64_t total = (feval - head + rows - 1) / rows;
  lo = static_cast<int>(rank * total / k);
  hi = static_cast<int>((rank + 1) * total / k);
}

// The values of one group of 32 regions (c0 .. c0 + valid - 1) as
// contiguous segments: ROWS, a region's points (sp = 1); else the planes,
// a point's 32 regions (sc = 1).  A tile of ``cap`` points from point p0
// holds each segment at a 16-byte boundary, its first value ``off`` in.
template <typename T, bool ROWS>
struct Segments {
  const T* vals;
  int64_t sc, sp, c0;
  int base_mod;  // the values' address in elements, modulo the slack

  // element index of (region lane, point p) from vals
  __device__ __forceinline__ int64_t at(int lane, int p) const {
    return (c0 + lane) * sc + static_cast<int64_t>(p) * sp;
  }
  __device__ __forceinline__ int off(int64_t g) const {
    return static_cast<int>((base_mod + g) & (slack<T>() - 1));
  }
  // segment s of a tile (ROWS: region s, else point p0 + s): its element
  // index, its length, its place in the tile
  __device__ __forceinline__ int64_t seg_start(int s, int p0) const {
    return ROWS ? at(s, p0) : at(0, p0 + s);
  }
  __device__ __forceinline__ uint32_t seg_bytes(int64_t g, int len) const {
    return static_cast<uint32_t>(((off(g) + len) * sizeof(T) + 15) / 16 * 16);
  }
  // copy the tile's segments (``points`` points from p0, ``valid``
  // regions), a lane a segment, completing on ``bar``
  __device__ void load(T* tile, int cap, int p0, int points, int valid,
                       uint32_t bar, int lane) const {
    const int segs = ROWS ? valid : points, len = ROWS ? points : valid;
    uint32_t bytes = 0;
    for (int s = lane; s < segs; s += 32) bytes += seg_bytes(seg_start(s, p0), len);
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) {
      // order the consumers' reads of the tile before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, bytes);
    }
    __syncwarp();
    for (int s = lane; s < segs; s += 32) {
      const int64_t g = seg_start(s, p0);
      bulk_load(smem_addr(tile + s * seg_pitch<T>(ROWS, cap)),
                vals + (g - off(g)),
                seg_bytes(g, len), bar);
    }
  }
  // the value of region ``lane`` at point p0 + j of a tile
  __device__ __forceinline__ T get(const T* tile, int cap, int p0, int j,
                                   int lane) const {
    const int64_t g = at(lane, p0 + j);
    return ROWS ? tile[lane * seg_pitch<T>(ROWS, cap) + off(g - j) + j]
                : tile[j * seg_pitch<T>(ROWS, cap) + off(g - lane) + lane];
  }
};

// The shape of the cluster route's launch: clusters of ``k`` CTAs, a ring
// of ``stages`` tiles of ``points`` points (cuda_rule.cluster_plan).
struct ClusterShape {
  int k, points, stages;
};

// A cluster of ``k`` CTAs takes a group of 32 neighbouring regions, a lane
// per region; its CTAs split the group's points (cuda_rule.cluster_plan).
// Warp kClusterWarps of a CTA is the producer: it copies the CTA's points
// into the ring, a segment (ROWS: a region's points of the stage, else a
// point's 32 regions) a lane.  Warps 0..7 sum them, warp w the points w,
// w + 8, ... of each stage, a running sum per orbit and region.  Then the
// warps' sums in warp order, the ranks' in rank order, and the leader's
// epilogue, rounded as rule_eval.rule_outputs.  WITH_FRAC (a crease
// run's): the leader's warp 1 also takes the regions' cut fractions.  WIDE
// (17..24D, rule_contract_cluster_wide_kernel): fourth-difference rows for
// kWideMaxNdim axes, each warp's sums in runs (Sums).
template <typename T, bool ROWS, bool WITH_FRAC, bool WIDE>
__device__ __forceinline__ void contract_cluster_body(const ContractArgs<T>& a,
                                                      const ClusterShape& cs) {
  extern __shared__ __align__(128) unsigned char s_dyn[];
  __shared__ unsigned long long s_full[kMaxStages];
  __shared__ unsigned long long s_empty[kMaxStages];
  __shared__ unsigned long long s_headbar;
  __shared__ int s_ob[kNsets + 1];
  __shared__ T s_jac;
  const int ndim = a.ndim, feval = a.feval, head_pts = 4 * ndim + 1;
  const int k = cs.k, R = cs.points, stages = cs.stages;
  const ClusterSmem<T, WIDE ? kWideMaxNdim : kMaxNdim> sm(
      reinterpret_cast<T*>(s_dyn), ndim, R, stages);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / k) * 32;
  const int valid = static_cast<int>(a.count - c0 < 32 ? a.count - c0 : 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Segments<T, ROWS> seg{
      a.vals, a.sc, a.sp, c0,
      static_cast<int>((reinterpret_cast<uintptr_t>(a.vals) / sizeof(T)) &
                       (slack<T>() - 1))};
  const size_t tile = tile_elements<T>(R);
  int st_lo, st_hi;
  rank_stages(feval, head_pts, R, rank, k, st_lo, st_hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&s_full[s]), 1);
      mbar_init(smem_addr(&s_empty[s]), kClusterWarps);
    }
    mbar_init(smem_addr(&s_headbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x <= kNsets) s_ob[threadIdx.x] = a.orbit_bounds[threadIdx.x];
  __syncthreads();

  if (warp == kClusterWarps) {
    // ---- producer: the head (leader only), then the stages in turn ----
    if (rank == 0)
      seg.load(sm.head, head_pts, 0, head_pts, valid, smem_addr(&s_headbar),
               lane);
    for (int t = st_lo; t < st_hi; ++t) {
      const int use = t - st_lo, slot = use % stages;
      if (use >= stages)
        mbar_wait(smem_addr(&s_empty[slot]), ((use / stages) - 1) & 1);
      const int p0 = head_pts + t * R;
      seg.load(sm.ring + slot * tile, R, p0, feval - p0 < R ? feval - p0 : R,
               valid, smem_addr(&s_full[slot]), lane);
    }
  } else {
    // ---- consumers: a running sum per orbit over the warp's points ----
    T* part = sm.part + warp * kNsets * 32 + lane;
#pragma unroll
    for (int s = 0; s < kNsets; ++s) part[s * 32] = T(0);
    Sums<T, 1, WIDE> acc;
    acc.clear();
    int s = 0, bound = s_ob[1];
    // the warp's points j = warp, warp + 8, ... < points of a tile from
    // point p0, in order: ROWS, region lane's segment is contiguous (one
    // offset a tile); planes, point j's segment holds the 32 regions
    auto sum_tile = [&](const T* t, int cap, int p0, int points) {
      const int pitch = seg_pitch<T>(ROWS, cap);
      const T* row = ROWS ? t + lane * pitch + seg.off(seg.at(lane, p0))
                          : t + lane;
      for (int j = warp; j < points; j += kClusterWarps) {
        const T v = ROWS ? row[j] : row[j * pitch + seg.off(seg.at(0, p0 + j))];
        while (p0 + j >= bound) {
          part[s * 32] = acc.get(0);
          acc.clear();
          bound = s_ob[++s + 1];
        }
        acc.add(0, v);
        acc.next();
      }
    };
    if (rank == 0) {
      mbar_wait(smem_addr(&s_headbar), 0);
      sum_tile(sm.head, head_pts, 0, head_pts);
    }
    for (int t = st_lo; t < st_hi; ++t) {
      const int use = t - st_lo, slot = use % stages;
      const int p0 = head_pts + t * R;
      mbar_wait(smem_addr(&s_full[slot]), (use / stages) & 1);
      sum_tile(sm.ring + slot * tile, R, p0, feval - p0 < R ? feval - p0 : R);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&s_empty[slot]));
    }
    part[s * 32] = acc.get(0);
  }
  __syncthreads();

  // the warps' partial sums in warp order: kClusterThreads = 9 * 32
  // threads, an (orbit, lane) pair each
  const int i = threadIdx.x;
  {
    T v = sm.part[i];
#pragma unroll
    for (int w = 1; w < kClusterWarps; ++w) v += sm.part[w * kNsets * 32 + i];
    sm.cta[i] = v;
  }
  cluster.sync();
  if (rank != 0) {
    cluster.sync();  // no CTA leaves while the leader reads its sums
    return;
  }

  // ---- the leader: the cluster's sums in rank order, then the epilogue
  // spread over its nine warps, a lane per region, rounded as
  // rule_eval.rule_outputs ----
  {
    T v = sm.cta[i];
    for (int r = 1; r < k; ++r) v += cluster.map_shared_rank(sm.cta, r)[i];
    sm.osum[i] = v;
  }
  const bool real = lane < valid;
  const int64_t slot = real_slot(a.first + c0 + lane, a.cap, a.n, a.blocked);
  // rule_eval.fourth_differences: |c0 f0 + ratio (f1+ + f1-) - (f2+ +
  // f2-)|, c0 = 2 (1 - ratio), from the head tile; axis d by warp d mod 9
  {
    auto h = [&](int p) { return seg.get(sm.head, head_pts, 0, p, lane); };
    const T c0f0 = r_mul(T(2) * r_sub(T(1), a.ratio), h(0));
    for (int d = warp; d < ndim; d += kClusterWarps + 1) {
      const T o1 = r_add(h(1 + 2 * d), h(2 + 2 * d));
      const T o2 = r_add(h(1 + 2 * ndim + 2 * d), h(2 + 2 * ndim + 2 * d));
      sm.fd[d * 32 + lane] = r_abs(r_sub(r_add(c0f0, r_mul(a.ratio, o1)), o2));
    }
  }
  if (warp == kClusterWarps) {
    // the jacobian, and the region's volume and widest axis
    T jac = a.grange[0];
    for (int d = 1; d < ndim; ++d) jac = r_mul(jac, a.grange[d]);
    if (lane == 0) s_jac = jac;
    if (real) {
      T vol = a.lengths[slot];
      T wl = vol;
      int widest = 0;
      for (int d = 1; d < ndim; ++d) {
        const T l = a.lengths[d * a.cap + slot];
        vol = r_mul(vol, l);
        // torch.argmax: the first largest, a NaN counting as the largest
        if (!is_nan(wl) && (is_nan(l) || l > wl)) {
          wl = l;
          widest = d;
        }
      }
      sm.vol[lane] = vol;
      sm.widest[lane] = widest;
    }
  }
  cluster.sync();  // the peers may leave; the leader's rows are all in

  if (warp < kNrules) {
    // rule sum q = warp
    const T* o = sm.osum + lane;
    T v = r_mul(o[0], a.orbit_wts[warp]);
#pragma unroll
    for (int s = 1; s < kNsets; ++s)
      v = r_add(v, r_mul(o[s * 32], a.orbit_wts[s * kNrules + warp]));
    sm.sums[warp * 32 + lane] = r_mul(v, s_jac);
  } else if (warp == kNrules) {
    // the first largest fourth difference (torch.argmax) where it is
    // positive and none is NaN, else -1: the widest axis
    int best = 0;
    bool any_nan = false;
    T top = T(0);
    for (int d = 0; d < ndim; ++d) {
      const T v = sm.fd[d * 32 + lane];
      if (is_nan(v)) {
        any_nan = true;
      } else if (d == 0 || v > top) {
        top = v;
        best = d;
      }
    }
    sm.best[lane] = (!any_nan && top > T(0)) ? best : -1;
  }
  __syncthreads();

  if (warp < 3) {
    // null-rule term e_q, q = warp + 1
    const int q = warp + 1;
    const T s1 = sm.sums[(q + 1) * 32 + lane], s0 = sm.sums[q * 32 + lane];
    T m = T(0);
#pragma unroll
    for (int s = 0; s < kNsets; ++s) {
      const T v = r_mul(r_abs(r_add(s1, r_mul(a.scale[s * kNrules + q], s0))),
                        a.norm[s * kNrules + q]);
      m = s == 0 ? v : nan_max(m, v);
    }
    sm.e[warp * 32 + lane] = m;
  }
  __syncthreads();

  if (warp == 0 && real) {
    const T e0 = sm.e[lane], e1 = sm.e[32 + lane], e2 = sm.e[64 + lane];
    // the (5,1,5) gate of rule_eval.gate_errors
    const T gated = (r_mul(T(5), e0) <= e1 && r_mul(T(5), e1) <= e2)
                        ? e0
                        : r_mul(T(5), nan_max(nan_max(e0, e1), e2));
    const T vol = sm.vol[lane];
    a.est[slot] = r_mul(vol, sm.sums[lane]);
    a.err[slot] = r_mul(vol, gated);
    if constexpr (!WITH_FRAC) {
      const int best = sm.best[lane];
      a.split_dim[slot] = best >= 0 ? best : sm.widest[lane];
    }
  } else if constexpr (WITH_FRAC) {
    if (warp == 1 && real) {
      // the cut fraction from the head tile (points 0..4n), a lane per
      // region, beside warp 0's est and err (split_frac.cuh's per-region
      // form)
      const int best = sm.best[lane];
      int sd = best >= 0 ? best : sm.widest[lane];
      a.frac[slot] = sfrac::region_frac(
          [&](int p) { return seg.get(sm.head, head_pts, 0, p, lane); },
          ndim, a.st, sd);
      a.split_dim[slot] = sd;
    }
  }
}

template <typename T, bool ROWS, bool WITH_FRAC>
__global__ void __launch_bounds__(kClusterThreads)
rule_contract_cluster_kernel(const ContractArgs<T> a, const ClusterShape cs) {
  contract_cluster_body<T, ROWS, WITH_FRAC, false>(a, cs);
}

template <typename T, bool ROWS>
__global__ void __launch_bounds__(kClusterThreads)
rule_contract_cluster_wide_kernel(const ContractArgs<T> a,
                                  const ClusterShape cs) {
  contract_cluster_body<T, ROWS, false, true>(a, cs);
}

// ---------------------------------------------------------------------------
// 4. The contraction of a vector's values, cluster route.

constexpr int kMaxComp = 8;  // components of the route (a warp's sums)

// The launch shape: clusters of ``k`` CTAs; rank r sums the points of the
// scalar cluster route's stages of ``rows`` points (rank_stages), in stages
// of ``points`` points through a ring of ``stages`` tiles
// (cuda_rule.comp_cluster_plan).
struct CompClusterShape {
  int k, rows, points, stages;
};

// The dynamic shared memory up to which two CTAs share an SM (228 KB, less
// each CTA's reserved 1 KB and static shared memory).
constexpr size_t kPairSmem = 112 * 1024;

// The dynamic shared memory of a CTA, in elements of T: the ring of
// ``stages`` tiles of 32 segments of ``points`` x ncomp values, whose end
// the leader first fills with its head tile (points 0..4n, every
// component), leaving room for one tile before it where two CTAs still
// share an SM, so that the first stage streams in beside the head; the
// CTA's orbit sums [9][ncomp][32]; the fourth differences [FD][32] (FD:
// kMaxNdim, or kWideMaxNdim in the wide instance); the mailbox of the
// warps' sums of the orbit being added up [8][ncomp][32].
template <typename T, int FD>
struct CompClusterSmem {
  T *ring, *head, *cta, *fd, *mbox;
  int stage_pitch, head_pitch;
  size_t tile, head_elements;

  __host__ __device__ static size_t other_elements(int ncomp) {
    return (kNsets + kClusterWarps) * ncomp * 32 + FD * 32;
  }
  __host__ __device__ static size_t ring_elements(int ndim, int ncomp,
                                                  int points, int stages) {
    const size_t tile =
        static_cast<size_t>(32) * seg_pitch<T>(true, points * ncomp);
    const size_t head =
        static_cast<size_t>(32) * seg_pitch<T>(true, (4 * ndim + 1) * ncomp);
    const size_t ring = stages * tile;
    const size_t beside = ring > head + tile ? ring : head + tile;
    if ((beside + other_elements(ncomp)) * sizeof(T) <= kPairSmem)
      return beside;
    return ring > head ? ring : head;
  }
  __host__ __device__ static size_t bytes(int ndim, int ncomp, int points,
                                          int stages) {
    return (ring_elements(ndim, ncomp, points, stages) +
            other_elements(ncomp)) *
           sizeof(T);
  }
  __device__ CompClusterSmem(T* base, int ndim, int ncomp, int points,
                             int stages) {
    stage_pitch = seg_pitch<T>(true, points * ncomp);
    head_pitch = seg_pitch<T>(true, (4 * ndim + 1) * ncomp);
    tile = static_cast<size_t>(32) * stage_pitch;
    head_elements = static_cast<size_t>(32) * head_pitch;
    ring = base;
    cta = ring + ring_elements(ndim, ncomp, points, stages);
    head = cta - head_elements;
    fd = cta + kNsets * ncomp * 32;
    mbox = fd + FD * 32;
  }
};

// The orbit of point p (orbit_bounds ob: ob[s] <= p < ob[s + 1]).
__device__ __forceinline__ int orbit_of(const int* ob, int p) {
  int s = 0;
  while (s + 1 < kNsets && ob[s + 1] <= p) ++s;
  return s;
}

// Wait until the flag in shared memory is set; a flag that is never set
// traps instead of hanging the card.
__device__ __forceinline__ void wait_flag(const int* flag) {
  for (uint32_t spins = 0;; ++spins) {
    if (*reinterpret_cast<const volatile int*>(flag)) break;
    if (spins > (1u << 26)) __trap();
  }
  __threadfence_block();
}

// A cluster of ``cs.k`` CTAs takes a group of 32 neighbouring regions, a
// lane per region, its ranks the scalar cluster route's point ranges.  The
// values lie component-minor, so a region's points of a stage are one
// segment of points x ncomp values, copied as the rows' segments are (a
// Segments over single values).  Warp kClusterWarps is the producer: the
// leader's head tile, then the rank's stages, a segment a lane.  Warps 0..7
// sum them, warp w the points w, w + 8, ... of each stage, a running sum per
// component; when a warp's orbit ends (at its first point past it, or at
// the end of the tile in which it ends) the warp leaves its sums in the
// mailbox, and the last of the eight warps to do so adds them up in warp
// order into the CTA's [orbit][component][lane], as the scalar route adds
// its warps' sums (a counter per orbit; the mailbox is taken again only
// once the orbit before is added up); an orbit with no point in the CTA's
// range has the sum +0, as the scalar route's warps' zeros add up to.  The
// leader's head tile lies at the end of the ring; a stage whose slot
// overlaps it is copied only once the head is summed (none, where the
// first stage fits beside it: CompClusterSmem).  The leader then adds the
// ranks' in rank order through distributed shared memory; warp k runs component k's epilogue, the
// producer warp the split axis from the fourth differences, which the
// consumer warps took from the head tile (every component, the largest,
// NaN propagating) before the stages overwrote it.  WIDE (17..24D,
// rule_contract_comp_cluster_wide_kernel): fourth-difference rows for
// kWideMaxNdim axes, each warp's sums in runs (Sums).
template <typename T, bool WIDE>
__device__ __forceinline__ void contract_comp_cluster_body(
    const ContractArgs<T>& a, const CompClusterShape& cs) {
  extern __shared__ __align__(128) unsigned char s_dyn[];
  __shared__ unsigned long long s_full[kMaxStages];
  __shared__ unsigned long long s_empty[kMaxStages];
  __shared__ unsigned long long s_headbar, s_headfree;
  __shared__ int s_ob[kNsets + 2];
  __shared__ int s_closed[kNsets], s_added[kNsets];
  const int ndim = a.ndim, feval = a.feval, head_pts = 4 * ndim + 1;
  const int nk = a.ncomp, k = cs.k, R = cs.points, stages = cs.stages;
  const CompClusterSmem<T, WIDE ? kWideMaxNdim : kMaxNdim> sm(
      reinterpret_cast<T*>(s_dyn), ndim, nk, R, stages);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / k) * 32;
  const int valid = static_cast<int>(a.count - c0 < 32 ? a.count - c0 : 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the values as rows of feval * ncomp single values (sp = ncomp, sk = 1)
  const Segments<T, true> seg{
      a.vals, a.sc, 1, c0,
      static_cast<int>((reinterpret_cast<uintptr_t>(a.vals) / sizeof(T)) &
                       (slack<T>() - 1))};
  // this rank's points [p_lo, p_hi), in stages of R from p_lo
  int st_lo, st_hi;
  rank_stages(feval, head_pts, cs.rows, rank, k, st_lo, st_hi);
  const int p_lo = head_pts + st_lo * cs.rows;
  const int p_hi =
      head_pts + st_hi * cs.rows < feval ? head_pts + st_hi * cs.rows : feval;
  const int n_use = p_hi > p_lo ? (p_hi - p_lo + R - 1) / R : 0;
  // the orbits of the CTA's first and last points: the others' sums are 0
  const int first_orbit = rank == 0 ? 0 : orbit_of(a.orbit_bounds, p_lo);
  const int last_orbit = orbit_of(a.orbit_bounds, p_hi - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&s_full[s]), 1);
      mbar_init(smem_addr(&s_empty[s]), kClusterWarps);
    }
    mbar_init(smem_addr(&s_headbar), 1);
    mbar_init(smem_addr(&s_headfree), kClusterWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x <= kNsets) s_ob[threadIdx.x] = a.orbit_bounds[threadIdx.x];
  if (threadIdx.x == kNsets + 1) s_ob[kNsets + 1] = 0x7fffffff;
  if (threadIdx.x < kNsets) s_closed[threadIdx.x] = s_added[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < kNsets * nk * 32; i += kClusterThreads) {
    const int o = i / (nk * 32);
    if (o < first_orbit || o > last_orbit) sm.cta[i] = T(0);
  }
  __syncthreads();

  if (warp == kClusterWarps) {
    // ---- producer: the head (leader only), then the stages in turn; a
    // slot that overlaps the head only once the head is summed ----
    if (rank == 0)
      seg.load(sm.head, head_pts * nk, 0, head_pts * nk, valid,
               smem_addr(&s_headbar), lane);
    bool head_free = rank != 0;
    for (int u = 0; u < n_use; ++u) {
      const int slot = u % stages;
      if (!head_free && (slot + 1) * sm.tile >
                            static_cast<size_t>(sm.head - sm.ring)) {
        mbar_wait(smem_addr(&s_headfree), 0);
        head_free = true;
      }
      if (u >= stages)
        mbar_wait(smem_addr(&s_empty[slot]), ((u / stages) - 1) & 1);
      const int p0 = p_lo + u * R;
      seg.load(sm.ring + slot * sm.tile, R * nk, p0 * nk,
               (p_hi - p0 < R ? p_hi - p0 : R) * nk, valid,
               smem_addr(&s_full[slot]), lane);
    }
  } else {
    // ---- consumers: a running sum per component over the warp's points
    Sums<T, kMaxComp, WIDE> acc;
    acc.clear();
    int s = first_orbit, bound = s_ob[first_orbit + 1];
    // the warp's sums of orbit s into the mailbox; the last warp to leave
    // them adds the eight up in warp order into the CTA's sums
    auto close = [&]() {
      if (s > first_orbit) {
        if (lane == 0) wait_flag(&s_added[s - 1]);
        __syncwarp();
      }
      T* box = sm.mbox + warp * nk * 32 + lane;
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c)
        if (c < nk) {
          box[c * 32] = acc.get(c);
          acc.zero(c);
        }
      acc.restart();
      __syncwarp();
      int last = 0;
      if (lane == 0) {
        __threadfence_block();
        last = atomicAdd(&s_closed[s], 1) == kClusterWarps - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence_block();
        const T* from = sm.mbox + lane;
        T* to = sm.cta + s * nk * 32 + lane;
        for (int c = 0; c < nk; ++c) {
          T v = from[c * 32];
#pragma unroll
          for (int w = 1; w < kClusterWarps; ++w) v += from[(w * nk + c) * 32];
          to[c * 32] = v;
        }
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          *reinterpret_cast<volatile int*>(&s_added[s]) = 1;
        }
      }
      bound = s_ob[++s + 1];
    };
    // the warp's points j = warp, warp + 8, ... < n of a tile of points
    // p0 .. p0 + n - 1 at ``pitch``, in order
    auto sum_tile = [&](const T* t, int pitch, int p0, int n) {
      const T* row = t + lane * pitch + seg.off(seg.at(lane, p0 * nk));
      for (int j = warp; j < n; j += kClusterWarps) {
        while (p0 + j >= bound) close();
        const T* v = row + j * nk;
#pragma unroll
        for (int c = 0; c < kMaxComp; ++c)
          if (c < nk) acc.add(c, v[c]);
        acc.next();
      }
      // an orbit that ends within the tile has no point left for any warp
      while (s <= last_orbit && bound <= p0 + n) close();
    };
    if (rank == 0) {
      mbar_wait(smem_addr(&s_headbar), 0);
      sum_tile(sm.head, sm.head_pitch, 0, head_pts);
      // rule_eval.fourth_differences of axes warp, warp + 8, the largest
      // over the components (a NaN propagating, as torch.amax)
      const T* h = sm.head + lane * sm.head_pitch + seg.off(seg.at(lane, 0));
      const T cr = T(2) * r_sub(T(1), a.ratio);
      for (int d = warp; d < ndim; d += kClusterWarps) {
        T m = T(0);
        for (int c = 0; c < nk; ++c) {
          const T o1 = r_add(h[(1 + 2 * d) * nk + c], h[(2 + 2 * d) * nk + c]);
          const T o2 = r_add(h[(1 + 2 * ndim + 2 * d) * nk + c],
                             h[(2 + 2 * ndim + 2 * d) * nk + c]);
          const T v = r_abs(
              r_sub(r_add(r_mul(cr, h[c]), r_mul(a.ratio, o1)), o2));
          m = c == 0 ? v : nan_max(m, v);
        }
        sm.fd[d * 32 + lane] = m;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&s_headfree));
    }
    for (int u = 0; u < n_use; ++u) {
      const int slot = u % stages, p0 = p_lo + u * R;
      mbar_wait(smem_addr(&s_full[slot]), (u / stages) & 1);
      sum_tile(sm.ring + slot * sm.tile, sm.stage_pitch, p0,
               p_hi - p0 < R ? p_hi - p0 : R);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&s_empty[slot]));
    }
    while (s <= last_orbit) close();
  }
  __syncthreads();
  cluster.sync();
  if (rank != 0) {
    cluster.sync();  // no CTA leaves while the leader reads its sums
    return;
  }

  // ---- the leader: the cluster's sums in rank order ----
  for (int i = threadIdx.x; i < kNsets * nk * 32; i += kClusterThreads) {
    T v = sm.cta[i];
    for (int r = 1; r < k; ++r) v += cluster.map_shared_rank(sm.cta, r)[i];
    sm.cta[i] = v;
  }
  cluster.sync();  // the peers may leave; the sums are all in
  if (lane >= valid || (warp >= nk && warp != kClusterWarps)) return;
  const int64_t slot = real_slot(a.first + c0 + lane, a.cap, a.n, a.blocked);
  T jac, vol;
  int widest;
  region_geometry(a, slot, jac, vol, widest);
  if (warp < nk) {
    // component warp's est and err, rounded as rule_eval.rule_outputs
    T orbit_sum[kNsets];
#pragma unroll
    for (int o = 0; o < kNsets; ++o)
      orbit_sum[o] = sm.cta[(o * nk + warp) * 32 + lane];
    const int64_t at = warp * a.cap + slot;
    rule_epilogue(a, orbit_sum, jac, vol, a.est[at], a.err[at]);
  } else if (warp == kClusterWarps) {
    // the first largest fourth difference where it is positive and none is
    // NaN, else the widest axis
    int best = 0;
    bool any_nan = false;
    T top = T(0);
    for (int d = 0; d < ndim; ++d) {
      const T v = sm.fd[d * 32 + lane];
      if (is_nan(v)) {
        any_nan = true;
      } else if (d == 0 || v > top) {
        top = v;
        best = d;
      }
    }
    a.split_dim[slot] = (!any_nan && top > T(0)) ? best : widest;
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
rule_contract_comp_cluster_kernel(const ContractArgs<T> a,
                                  const CompClusterShape cs) {
  contract_comp_cluster_body<T, false>(a, cs);
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
rule_contract_comp_cluster_wide_kernel(const ContractArgs<T> a,
                                       const CompClusterShape cs) {
  contract_comp_cluster_body<T, true>(a, cs);
}

// ---------------------------------------------------------------------------
// Launches.


struct HostArgs {
  int ndim, feval, blocked;
  int64_t cap, n, first, count;
  int64_t sc, sp, sd;  // strides of x (points) or vals (contraction; sd:
                       // the components' stride of a vector's values)
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

// Points 0 .. k8 - 1 of the rule: the centre and orbits 1-7, the 2^n
// corners after them (cuda_rule.generic_orbit_bounds).
__host__ __device__ inline int64_t orbit_points(int n) {
  return 1 + 8 * n + 2 * n * (n - 1) + 4 * n * (n - 1) +
         4 * n * (n - 1) * (n - 2) / 3;
}

template <typename T>
int points_wide_launch(const HostArgs& h, const void* lows,
                       const void* lengths, const void* glo,
                       const void* grange, const void* codes,
                       const void* lam, void* x, cudaStream_t stream) {
  WidePointArgs<T> a;
  a.lows = static_cast<const T*>(lows);
  a.lengths = static_cast<const T*>(lengths);
  a.glo = static_cast<const T*>(glo);
  a.grange = static_cast<const T*>(grange);
  a.codes = static_cast<const uint32_t*>(codes);
  a.lam = static_cast<const T*>(lam);
  a.x = static_cast<T*>(x);
  a.cap = h.cap;
  a.n = h.n;
  a.first = h.first;
  a.count = h.count;
  a.sc = h.sc;
  a.sp = h.sp;
  a.sd = h.sd;
  a.ndim = h.ndim;
  a.feval = h.feval;
  a.k8 = static_cast<int>(orbit_points(h.ndim));
  a.blocked = h.blocked;
  // the planes' layout: a grid row an axis; any other: one flat span
  const int64_t span = h.count * h.feval * (h.sc == 1 ? 1 : h.ndim);
  const dim3 grid(
      static_cast<unsigned>((span + kPointThreads - 1) / kPointThreads),
      h.sc == 1 ? h.ndim : 1);
  rule_points_wide_kernel<T><<<grid, kPointThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's kernel of a type, layout, crease form and class of
// dimensions (WIDE: 17..24D).
template <typename T, bool ROWS, bool F, bool WIDE>
inline auto cluster_kernel() {
  if constexpr (WIDE)
    return rule_contract_cluster_wide_kernel<T, ROWS>;
  else
    return rule_contract_cluster_kernel<T, ROWS, F>;
}

// Let the cluster kernel have ``smem`` bytes of dynamic shared memory: the
// attribute is raised once for each size it grows to, so that a launch
// spends no host time on it.
template <typename T, bool ROWS, bool F, bool WIDE>
cudaError_t allow_cluster_smem(size_t smem) {
  static size_t granted = 48 * 1024;  // one for each kernel
  if (smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel<T, ROWS, F, WIDE>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) granted = smem;
  return e;
}

// A cluster route's launch configuration: a cluster of ``k`` CTAs of
// ``smem`` bytes of dynamic shared memory for each group of 32 regions.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  ClusterConfig(int64_t count, int k, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(static_cast<unsigned>((count + 31) / 32 * k));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = k;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, bool ROWS, bool F, bool WIDE>
cudaError_t cluster_launch(const HostArgs& h, const ClusterShape& cs,
                           const ContractArgs<T>& a, cudaStream_t stream) {
  const ClusterConfig c(
      h.count, cs.k,
      ClusterSmem<T, WIDE ? kWideMaxNdim : kMaxNdim>::bytes(h.ndim, cs.points,
                                                            cs.stages),
      stream);
  if (c.cfg.dynamicSmemBytes > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_cluster_smem<T, ROWS, F, WIDE>(c.cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&c.cfg, cluster_kernel<T, ROWS, F, WIDE>(), a,
                            cs);
}

template <typename T, bool ROWS>
cudaError_t cluster_launch(const HostArgs& h, const ClusterShape& cs,
                           const ContractArgs<T>& a, cudaStream_t stream) {
  if (h.ndim > kMaxNdim)  // no crease fraction there (bad_args)
    return cluster_launch<T, ROWS, false, true>(h, cs, a, stream);
  return a.frac != nullptr
             ? cluster_launch<T, ROWS, true, false>(h, cs, a, stream)
             : cluster_launch<T, ROWS, false, false>(h, cs, a, stream);
}

template <typename T, bool ROWS, bool WIDE>
cudaError_t cluster_occupancy(int ndim, const ClusterShape& cs,
                              int* clusters) {
  const ClusterConfig c(
      32 * 1024, cs.k,
      ClusterSmem<T, WIDE ? kWideMaxNdim : kMaxNdim>::bytes(ndim, cs.points,
                                                            cs.stages),
      nullptr);
  const cudaError_t e =
      allow_cluster_smem<T, ROWS, false, WIDE>(c.cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      clusters, cluster_kernel<T, ROWS, false, WIDE>(), &c.cfg);
}

template <typename T, bool ROWS>
cudaError_t cluster_occupancy(int ndim, const ClusterShape& cs,
                              int* clusters) {
  return ndim > kMaxNdim ? cluster_occupancy<T, ROWS, true>(ndim, cs, clusters)
                         : cluster_occupancy<T, ROWS, false>(ndim, cs,
                                                             clusters);
}

// The same for the components cluster route.
template <typename T, bool WIDE>
inline auto comp_cluster_kernel() {
  if constexpr (WIDE)
    return rule_contract_comp_cluster_wide_kernel<T>;
  else
    return rule_contract_comp_cluster_kernel<T>;
}

template <typename T, bool WIDE>
cudaError_t allow_comp_cluster_smem(size_t smem) {
  static size_t granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      comp_cluster_kernel<T, WIDE>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) granted = smem;
  return e;
}

template <typename T, bool WIDE>
size_t comp_cluster_bytes(int ndim, int ncomp, const CompClusterShape& cs) {
  return CompClusterSmem<T, WIDE ? kWideMaxNdim : kMaxNdim>::bytes(
      ndim, ncomp, cs.points, cs.stages);
}

template <typename T, bool WIDE>
cudaError_t comp_cluster_launch(int64_t count, int ncomp,
                                const CompClusterShape& cs,
                                const ContractArgs<T>& a,
                                cudaStream_t stream) {
  const ClusterConfig c(count, cs.k,
                        comp_cluster_bytes<T, WIDE>(a.ndim, ncomp, cs),
                        stream);
  if (c.cfg.dynamicSmemBytes > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_comp_cluster_smem<T, WIDE>(c.cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&c.cfg, comp_cluster_kernel<T, WIDE>(), a, cs);
}

template <typename T, bool WIDE>
cudaError_t comp_cluster_occupancy(int ndim, int ncomp,
                                   const CompClusterShape& cs,
                                   int* clusters) {
  const ClusterConfig c(32 * 1024, cs.k,
                        comp_cluster_bytes<T, WIDE>(ndim, ncomp, cs),
                        nullptr);
  if (c.cfg.dynamicSmemBytes > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      allow_comp_cluster_smem<T, WIDE>(c.cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      clusters, comp_cluster_kernel<T, WIDE>(), &c.cfg);
}

template <typename T>
cudaError_t comp_cluster_occupancy(int ndim, int ncomp,
                                   const CompClusterShape& cs,
                                   int* clusters) {
  return ndim > kMaxNdim
             ? comp_cluster_occupancy<T, true>(ndim, ncomp, cs, clusters)
             : comp_cluster_occupancy<T, false>(ndim, ncomp, cs, clusters);
}

template <typename T>
ContractArgs<T> contract_args(const HostArgs& h, const void* vals,
                              const void* lengths, const void* grange,
                              const void* orbit_wts, const void* scale,
                              const void* norm, double ratio,
                              const int* orbit_bounds, void* est, void* err,
                              int* split_dim, void* frac = nullptr,
                              const int* frac_slots = nullptr,
                              const double* frac_consts = nullptr) {
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
  a.sk = h.sd;
  a.ncomp = 1;
  a.ratio = static_cast<T>(ratio);
  for (int k = 0; k <= kNsets; ++k) a.orbit_bounds[k] = orbit_bounds[k];
  a.frac = static_cast<T*>(frac);
  if (frac != nullptr)
    sfrac::load_stencil(a.st, h.ndim, frac_slots, frac_consts);
  return a;
}

// One launch of the contraction: the generic kernel where ``cs.k`` is 0,
// else the cluster kernel of shape ``cs``; past kMaxNdim their wide
// instances.
template <typename T>
int contract_launch(const HostArgs& h, const ClusterShape& cs,
                    const ContractArgs<T>& a, cudaStream_t stream) {
  if (cs.k == 0) {
    const unsigned blocks = static_cast<unsigned>((h.count + 31) / 32);
    const dim3 block(32, kContractGroups);
    if (h.ndim > kMaxNdim)
      rule_contract_wide_kernel<T><<<blocks, block, 0, stream>>>(a);
    else if (a.frac != nullptr)
      rule_contract_kernel<T, true><<<blocks, block, 0, stream>>>(a);
    else
      rule_contract_kernel<T, false><<<blocks, block, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // the rows' layout where a region's points are contiguous, else the
  // planes' (bad_cluster_args)
  const cudaError_t e = h.sp == 1 ? cluster_launch<T, true>(h, cs, a, stream)
                                  : cluster_launch<T, false>(h, cs, a, stream);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// One launch of a vector's contraction over ``ncomp`` components: the
// components kernel where ``cs.k`` is 0, else the components cluster
// kernel of shape ``cs``; past kMaxNdim their wide instances.
template <typename T>
int contract_comp_launch(const HostArgs& h, ContractArgs<T> a, int ncomp,
                         const CompClusterShape& cs, cudaStream_t stream) {
  a.ncomp = ncomp;
  const bool wide = h.ndim > kMaxNdim;
  if (cs.k == 0) {
    const unsigned blocks = static_cast<unsigned>((h.count + 31) / 32);
    const dim3 block(32, kContractGroups);
    if (wide)
      rule_contract_comp_wide_kernel<T><<<blocks, block, 0, stream>>>(a);
    else
      rule_contract_comp_kernel<T><<<blocks, block, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e =
      wide ? comp_cluster_launch<T, true>(h.count, ncomp, cs, a, stream)
           : comp_cluster_launch<T, false>(h.count, ncomp, cs, a, stream);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

bool bad_args(const HostArgs& h) {
  return h.ndim < 2 || h.ndim > kWideMaxNdim || h.feval < 4 * h.ndim + 1 ||
         h.n > h.cap || h.first < 0 || h.count < 1 ||
         h.first + h.count > h.n || (h.blocked && (h.n % 2 || h.cap % 2)) ||
         h.count >= (int64_t(1) << 36) ||
         (h.ndim > kMaxNdim &&
          h.feval != orbit_points(h.ndim) + (int64_t(1) << h.ndim));
}

// What the cluster route takes beyond bad_args: the values as rows (sp =
// 1, a region's points contiguous) or as planes (sc = 1, a point's regions
// contiguous), at an address of whole elements, on a grid within 2^31 CTAs.
bool bad_cluster_args(const HostArgs& h, const ClusterShape& cs,
                      const void* vals, size_t item) {
  return cs.k < 1 || cs.k > kMaxClusterArg || cs.stages < 2 ||
         cs.stages > kMaxStages || cs.points < 1 ||
         cs.points % (16 / item) || !(h.sp == 1 || h.sc == 1) ||
         reinterpret_cast<uintptr_t>(vals) % item ||
         (h.count + 31) / 32 * cs.k > 0x7fffffff;
}

// What the components cluster route takes beyond bad_args: 2..kMaxComp
// components lying component-minor (sk = 1, sp = ncomp: a region's points
// one run of values), stages of whole warps' rows (multiples of
// kClusterWarps points: the scalar route's order), at an address of whole
// elements, on a grid within 2^31 CTAs.
bool bad_comp_cluster_args(const HostArgs& h, int ncomp,
                           const CompClusterShape& cs, const void* vals,
                           size_t item) {
  return ncomp < 2 || ncomp > kMaxComp || h.sd != 1 || h.sp != ncomp ||
         cs.k < 1 || cs.k > kMaxClusterArg || cs.stages < 2 ||
         cs.stages > kMaxStages || cs.rows < kClusterWarps ||
         cs.rows % kClusterWarps || cs.points < kClusterWarps ||
         cs.points % kClusterWarps ||
         reinterpret_cast<uintptr_t>(vals) % item ||
         (h.count + 31) / 32 * cs.k > 0x7fffffff;
}

}  // namespace

static_assert(kClusterThreads == kNsets * 32,
              "the cluster kernel takes an (orbit, lane) pair a thread");

// C entry points for ctypes.  Pointers are device pointers except
// orbit_bounds (10 ints, a host array).  Both walk the real regions
// first .. first + count - 1 of a pool of ``n`` real regions in ``cap``
// slots (blocked: the first n/2 of each half).  Each returns
// cudaGetLastError() after its launch (0 on success) and never
// synchronises.  ndim 2..16; the contractions and
// rule_split_points_wide_launch also 17..24.

// Writes x (count, feval, ndim) of the working type at strides (sc, sp,
// sd) in elements: the layout rule_eval.rule_points gives.  ndim 2..16.
extern "C" int rule_split_points_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, long long sc,
    long long sp, long long sd, const void* lows, const void* lengths,
    const void* glo, const void* grange, const void* gen, void* x,
    void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, sd};
  if (bad_args(h) || ndim > kMaxNdim || feval > 65535 * kPointTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? points_launch<double>(h, lows, lengths, glo, grange, gen, x, s)
             : points_launch<float>(h, lows, lengths, glo, grange, gen, x, s);
}

// The same at ndim 17..24, from the orbit table ``codes`` (k8,) uint32
// (cuda_rule.wide_orbit_codes) and ``lam`` (16,) of the working type
// (cuda_rule.generator_lam) instead of the generator table.
extern "C" int rule_split_points_wide_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, long long sc,
    long long sp, long long sd, const void* lows, const void* lengths,
    const void* glo, const void* grange, const void* codes, const void* lam,
    void* x, void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, sd};
  if (bad_args(h) || ndim <= kMaxNdim ||
      (h.sc == 1 ? h.count * h.feval : h.count * h.feval * h.ndim) /
              kPointThreads >= 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? points_wide_launch<double>(h, lows, lengths, glo, grange,
                                                codes, lam, x, s)
                   : points_wide_launch<float>(h, lows, lengths, glo, grange,
                                               codes, lam, x, s);
}

// Reads vals (count, feval) at strides (sc, sp) in elements; writes est,
// err, split_dim at the regions' pool slots and nowhere else.  ``cluster``
// 0 takes the generic route (any strides); 1..8 the cluster route on
// clusters of that many CTAs, each with a ring of ``stages`` tiles of
// ``points`` points (rows or planes: bad_cluster_args).  A cluster the
// card cannot launch is refused with the launch's error, never run
// another way.  ``frac`` (cap,), null outside a crease run (and past 16D,
// where none runs): also the cut
// fraction at the regions' slots, split_dim the axis a jump overrides,
// from the stencil frac_slots (ndim, 4) int32 and frac_consts (ndim, 5)
// float64, host arrays copied into the launch's arguments.
extern "C" int rule_split_contract_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, long long sc,
    long long sp, int cluster, int points, int stages, const void* vals,
    const void* lengths, const void* grange, const void* orbit_wts,
    const void* scale, const void* norm, double ratio,
    const int* orbit_bounds, void* est, void* err, int* split_dim,
    void* frac, const int* frac_slots, const double* frac_consts,
    void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, 0};
  const ClusterShape cs{cluster, points, stages};
  if (bad_args(h) || orbit_bounds[kNsets] != feval ||
      orbit_bounds[3] != 4 * ndim + 1 ||
      (frac != nullptr && (frac_slots == nullptr || frac_consts == nullptr ||
                           ndim > kMaxNdim)) ||
      (cluster != 0 && bad_cluster_args(h, cs, vals, is_double ? 8 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? contract_launch<double>(
                   h, cs,
                   contract_args<double>(h, vals, lengths, grange, orbit_wts,
                                         scale, norm, ratio, orbit_bounds,
                                         est, err, split_dim, frac,
                                         frac_slots, frac_consts),
                   s)
             : contract_launch<float>(
                   h, cs,
                   contract_args<float>(h, vals, lengths, grange, orbit_wts,
                                        scale, norm, ratio, orbit_bounds,
                                        est, err, split_dim, frac,
                                        frac_slots, frac_consts),
                   s);
}

// Reads vals (count, feval, ncomp) at strides (sc, sp, sk) in elements;
// writes est and err (ncomp, cap), component-major, and split_dim (cap,)
// at the regions' pool slots and nowhere else.  ``cluster`` 0 takes the
// components kernel (any strides, any ncomp >= 1); 1..8 the components
// cluster route on clusters of that many CTAs, rank r summing the points
// of the scalar cluster route's stages of ``rows`` points, in stages of
// ``points`` points through a ring of ``stages`` tiles
// (bad_comp_cluster_args).  A cluster the card cannot launch is refused
// with the launch's error, never run another way.
extern "C" int rule_split_contract_comp_launch(
    int is_double, int ndim, int feval, long long cap, long long n,
    int blocked, long long first, long long count, int ncomp, long long sc,
    long long sp, long long sk, int cluster, int rows, int points,
    int stages, const void* vals, const void* lengths, const void* grange,
    const void* orbit_wts, const void* scale, const void* norm, double ratio,
    const int* orbit_bounds, void* est, void* err, int* split_dim,
    void* stream) {
  const HostArgs h{ndim, feval, blocked, cap, n, first, count, sc, sp, sk};
  const CompClusterShape cs{cluster, rows, points, stages};
  if (bad_args(h) || ncomp < 1 || orbit_bounds[kNsets] != feval ||
      orbit_bounds[3] != 4 * ndim + 1 ||
      (cluster != 0 &&
       bad_comp_cluster_args(h, ncomp, cs, vals, is_double ? 8 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? contract_comp_launch<double>(
                   h,
                   contract_args<double>(h, vals, lengths, grange, orbit_wts,
                                         scale, norm, ratio, orbit_bounds,
                                         est, err, split_dim),
                   ncomp, cs, s)
             : contract_comp_launch<float>(
                   h,
                   contract_args<float>(h, vals, lengths, grange, orbit_wts,
                                        scale, norm, ratio, orbit_bounds,
                                        est, err, split_dim),
                   ncomp, cs, s);
}

// How many clusters of the cluster route's shape (clusters of ``cluster``
// CTAs, rings of ``stages`` tiles of ``points`` points; type by is_double,
// layout by rows, head tile and class of dimensions by ndim) the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int rule_split_cluster_occupancy(int is_double, int rows, int ndim,
                                            int cluster, int points,
                                            int stages) {
  const ClusterShape cs{cluster, points, stages};
  int got = 0;
  const cudaError_t e =
      is_double ? (rows ? cluster_occupancy<double, true>(ndim, cs, &got)
                        : cluster_occupancy<double, false>(ndim, cs, &got))
                : (rows ? cluster_occupancy<float, true>(ndim, cs, &got)
                        : cluster_occupancy<float, false>(ndim, cs, &got));
  cudaGetLastError();
  return e != cudaSuccess ? -static_cast<int>(e) : got;
}

// How many clusters of the components cluster route's shape (clusters of
// ``cluster`` CTAs, rings of ``stages`` tiles of ``points`` points of
// ``ncomp`` components; type by is_double, head tile and class of
// dimensions by ndim) the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int rule_split_comp_cluster_occupancy(int is_double, int ndim,
                                                 int ncomp, int cluster,
                                                 int points, int stages) {
  const CompClusterShape cs{cluster, 0, points, stages};
  int got = 0;
  const cudaError_t e =
      is_double ? comp_cluster_occupancy<double>(ndim, ncomp, cs, &got)
                : comp_cluster_occupancy<float>(ndim, ncomp, cs, &got);
  cudaGetLastError();
  return e != cudaSuccess ? -static_cast<int>(e) : got;
}
