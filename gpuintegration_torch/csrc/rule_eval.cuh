// Genz-Malik rule evaluation over a PAGANI region pool, fused with the
// integrand, for NVIDIA Hopper (sm_90a): the kernel templates.  Two
// sources instantiate them, each for the integrands it knows:
// rule_eval.cu for the Genz families F1..F6, gen_integrand.cu for one
// traced per-axis callable (the family kGenerated, whose value is the
// generated device function gen_integrand, csrc/gen_integrand.cuh).  Each
// source defines the dispatchers declared below and includes this header
// once, with its C entry points.
//
// Replaces gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule (the
// f32 Pallas kernel) and, in f64, the XLA path rule_eval._eval_chunk: both
// compute the function that the plain PyTorch version
// gpuintegration_torch/ops/rule_eval.py::apply_rule_plain computes.
//
// Two kernels compute it; ops/cuda_rule.py chooses by the shape alone.
//
// The TILE route (rule_tile_kernel; ndim 3..8).  What bounds the work:
// each region reads 2*ndim values and writes 3 against feval (1105 at 8D)
// integrand values, so arithmetic bounds it, and in practice the scheduler
// slots around the arithmetic.  The design spends as few instructions per
// (point, axis) as the rule allows:
//   * a coordinate of a rule point is cen_d - g*len_d with g one of 11
//     values (0, +-lambda_1..5), so a region has only 11*ndim distinct
//     coordinates.  The warp computes them once per region, applies the
//     part of the integrand that depends on the coordinate alone
//     (genz.cuh genz_pre) and keeps the 11*ndim results in shared memory.
//     A point is then ndim table reads, each folded into the running state
//     by one multiply-add (genz_fold): every value has the bits that the
//     generic kernel gives it;
//   * which of the 11 each (point, axis) takes is a 4-bit code, 8 axes to a
//     32-bit word per point (ops/cuda_rule.py::pack_generators), staged
//     once per block in shared memory (spread there to a byte per axis that
//     holds the offset into the table's row) with orbit_wts, scale and
//     norm.  No global load is left in the point loop;
//   * ndim is a template argument: the axis loop is straight code and the
//     orbit bounds are constants;
//   * one warp per region, no block barrier after the prologue.  Points
//     0..8n (the centre and the four single-axis orbits) are evaluated in
//     one strided pass into shared memory, from which the fourth
//     differences and the four orbit sums are formed; orbits 5..8 are each
//     a strided loop into one running sum with two points in flight per
//     lane.  Sums are reduced by xor-shuffle trees: the same bits from
//     launch to launch, no atomics;
//   * blocks are persistent (one per SM, 16 warps).  A warp walks over
//     tiles of R <= 32 consecutive pool slots.  The pool is dims-major, so
//     a tile is 2*ndim rows of R values: lane 0 fetches them with 1-D bulk
//     asynchronous copies (cp.async.bulk) that complete on an mbarrier, into
//     a two-stage ring, so the next tile loads under this tile's
//     arithmetic.  A ragged or unaligned tile is read by ordinary loads;
//   * the epilogue of a tile runs one lane per region (rule sums, gated
//     null-rule error, split axis) and writes est, err and split_dim of
//     the tile's neighbouring slots as coalesced rows.
// The floor of this route is the f64 (or f32) pipe: per point ndim
// multiply-adds and the family's finish, which for F4-F6 is an exp: in f64
// some 19 f64 instructions in the machine code (tools/sass_report.py).
//
// The GENERIC route (rule_kernel; every ndim 2..16): one thread block per
// region, 128 threads stride over the points and read the generator table
// from global memory, one thread runs the epilogue.  It takes the
// dimensions the tile route is not compiled for, and is the kernel the
// tile route is timed against.
//
// A crease run (Workspace.integrate(crease_split=True)) takes the same
// kernels with WITH_FRAC: each also writes the crease/jump-aware cut
// fraction (the reference's XLA _split_fraction,
// gpuintegration_tpu/ops/rule_eval.py:184) and the split axis a jump
// overrides, from the 4n + 1 collinear values it already holds (points
// 0..4n of the kept ones), with split_frac.cuh's device functions, which
// round every operation on its own, so that the fraction is EQUAL to
// rule_eval.split_fraction on those values.  Both run the per-axis form,
// lane d axis d and a reduction over the region's lanes: the tile route on
// batches of 4 (5-8D) or 8 (3-4D) regions a warp, the generic route on
// warp 0 after its epilogue.  Without WITH_FRAC the code is the first
// design's.
// A check-only ``kept`` pointer writes the collinear values out, so that a
// check can hold the fraction against the plain version on the kernel's
// own values (the values differ from the torch callable's by ulps: the
// kernels fold coordinates with multiply-adds).
//
// Neither uses tensor cores or TF32: the null-rule sums cancel, and a
// reduced-precision contraction would destroy them.
//
// The generated family takes the same kernels: where a Genz family builds
// its state axis by axis (genz_value, the tile route's fold), it keeps the
// point's ndim coordinates in registers and calls gen_integrand once, and
// the tile route's coordinate table holds the coordinates themselves
// (genz_pre of any other family is the coordinate), read by the same byte
// codes.  It is built without the crease fraction.
//
// Built by ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --split-compile 0 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gen_integrand.cuh"
#include "genz.cuh"
#include "split_frac.cuh"

namespace {
namespace rule {

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
  // a crease run's (rule_kernel<..., true>): the cut fraction (cap,), the
  // check-only collinear values (cap, 4 ndim + 1) or null, the stencil
  T* frac;
  T* kept;
  sfrac::Stencil<T> st;
};

// max that propagates NaN, like jnp.maximum / torch.maximum
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

// Global-space centre and length of a region's axis from its unit-space
// low corner and length.
template <typename T>
__device__ __forceinline__ void region_axis(T lo, T ln, T glo, T rg, T& cen,
                                            T& len) {
  cen = glo + (lo + T(0.5) * ln) * rg;
  len = ln * rg;
}

// |2(1-ratio) f0 + ratio (f1+ + f1-) - (f2+ + f2-)| of one axis.  The
// roundings are spelled out, so that both kernels, and every axis of a
// region, round alike: the split axis is an argmax over these.
template <typename T>
__device__ __forceinline__ T fourth_diff(T c0, T f0, T ratio, T o1, T o2) {
  return m_abs(m_fma(ratio, o1, m_mul(c0, f0)) - o2);
}

// The per-region epilogue from the 9 orbit sums: the 5 rule sums (orbit
// sums times the orbit weights, times the jacobian), the gated null-rule
// error model e_r = max_s |S[r+1] + scale[s,r] S[r]| norm[s,r], and the
// split axis: ``best`` (the first largest positive fourth difference, -1
// when none is positive) unless a difference was NaN, else the widest axis
// (Sample.cuh:194-218, rule_eval.py "Reference semantics").
template <typename T>
__device__ __forceinline__ void region_outputs(
    const T (&orbit_sum)[kNsets], T jac, T vol, int widest, int best,
    bool any_nan, const T* orbit_wts, const T* scale, const T* norm, T& est,
    T& err, int& split_dim) {
  T sums[kNrules];
#pragma unroll
  for (int q = 0; q < kNrules; ++q) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < kNsets; ++k)
      v += orbit_sum[k] * orbit_wts[k * kNrules + q];
    sums[q] = v * jac;
  }
  T e[3];
#pragma unroll
  for (int q = 1; q <= 3; ++q) {
    T m = T(-1);
#pragma unroll
    for (int k = 0; k < kNsets; ++k) {
      const T v = m_abs(sums[q + 1] + scale[k * kNrules + q] * sums[q])
                  * norm[k * kNrules + q];
      m = nan_max(m, v);
    }
    e[q - 1] = m;
  }
  const T gated = (T(5) * e[0] <= e[1] && T(5) * e[1] <= e[2])
                      ? e[0]
                      : T(5) * nan_max(nan_max(e[0], e[1]), e[2]);
  est = vol * sums[0];
  err = vol * gated;
  split_dim = (any_nan || best < 0) ? widest : best;
}

// ---------------------------------------------------------------------------
// The generic route: one thread block per region.

// The Genz integrand (genz.cuh) at rule point p of a region with
// global-space center cen[] and length len[] (shared memory).
// The generated family (kGenerated) keeps the point's coordinates in
// registers and calls gen_integrand once.
template <int FAMILY, typename T>
__device__ __forceinline__ T genz_value(const RuleArgs<T>& a, const T* cen,
                                        const T* len, const T* coeffs,
                                        const T* bounds, int p) {
  const T* gen = a.gen;
  const int feval = a.feval;
  if constexpr (FAMILY == kGenerated) {
    T x[kMaxNdim];
#pragma unroll
    for (int d = 0; d < kMaxNdim; ++d)
      if (d < a.ndim) x[d] = cen[d] - __ldg(gen + d * feval + p) * len[d];
    return gen_integrand<T>(x);
  } else {
    GenzState<T> g;
    for (int d = 0; d < a.ndim; ++d) {
      const T x = cen[d] - __ldg(gen + d * feval + p) * len[d];
      genz_axis<FAMILY, T>(g, x, coeffs[d], bounds[d], a.s0, a.s1);
    }
    return genz_finish<FAMILY, T>(g, a.ndim, a.s0);
  }
}

template <typename T>
__device__ __forceinline__ void add_to_orbit(T (&acc)[kNsets], int s, T v) {
#pragma unroll
  for (int k = 0; k < kNsets; ++k)
    if (k == s) acc[k] += v;
}

// WITH_FRAC: also the crease/jump-aware cut fraction (split_frac.cuh's
// per-axis form on the kept values, lane d axis d of warp 0, which runs
// the epilogue), which may override the split axis; without it the code is
// the first design's.
template <int FAMILY, typename T, bool WITH_FRAC>
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
    region_axis(lo, ln, a.glo[tid], a.grange[tid], s_cen[tid], s_len[tid]);
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
  if constexpr (WITH_FRAC) {
    if (a.kept != nullptr)
      for (int p = tid; p < n_kept; p += kThreads)
        a.kept[static_cast<size_t>(slot) * n_kept + p] = s_vals[p];
  }
  // the crease run's kernel runs the epilogue on warp 0, whose lanes then
  // take the fraction's axes
  if (WITH_FRAC ? tid >= 32 : tid != 0) return;

  // ---- epilogue, one thread (every lane of warp 0 alike, WITH_FRAC) ----
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
  // the fourth differences: strict '>' scan from 0, NaN noted
  const T f0 = s_vals[0];
  const T c0 = T(2) * (T(1) - a.ratio);
  int best = -1;
  bool any_nan = false;
  T maxdiff = T(0);
  for (int d = 0; d < ndim; ++d) {
    const T o1 = s_vals[1 + 2 * d] + s_vals[2 + 2 * d];
    const T o2 = s_vals[1 + 2 * ndim + 2 * d] + s_vals[2 + 2 * ndim + 2 * d];
    const T diff = fourth_diff(c0, f0, a.ratio, o1, o2);
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
  T est, err;
  int sdim;
  region_outputs(orbit_sum, jac, vol, widest, best, any_nan, a.orbit_wts,
                 a.scale, a.norm, est, err, sdim);
  if constexpr (WITH_FRAC) {
    // split_frac.cuh's per-axis form on the kept values, lane d axis d
    const bool active = tid < ndim;
    T kink = T(0.5), strength = T(0), jump = T(0.5);
    if (active)
      sfrac::axis_frac([&](int p) { return s_vals[p]; }, f0, a.st.axis[tid],
                       tid == sdim, kink, strength, jump);
    const T frac = sfrac::group_frac<32>(active, kink, strength, jump, sdim);
    if (tid != 0) return;
    a.frac[slot] = frac;
  }
  a.est[slot] = est;
  a.err[slot] = err;
  a.split_dim[slot] = sdim;
}

// est = err = 0, split_dim 0 and (a crease run's kernel, F) frac 0.5 in
// every padding slot of the pool; without F frac is not read
template <typename T, bool F>
__global__ void fill_padding(T* est, T* err, int* split_dim, T* frac,
                             int cap, int n, int blocked) {
  const int half = cap / 2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += gridDim.x * blockDim.x) {
    const bool real = blocked ? (i % half) < n / 2 : i < n;
    if (!real) {
      est[i] = T(0);
      err[i] = T(0);
      split_dim[i] = 0;
      if constexpr (F) frac[i] = T(0.5);
    }
  }
}

// ---------------------------------------------------------------------------
// The tile route: persistent blocks, one warp per region.

constexpr int kTileWarps = 16;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kTile = 32;      // most regions of a tile: one per lane
constexpr int kCodes = 11;     // coordinates per axis: 0, +lambda_1..5, -...
constexpr int kCodeRow = 16;   // a 4-bit code indexes a row of 16
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct TileArgs {
  const T* lows;
  const T* lengths;
  const T* glo;           // (ndim,) global lower bounds
  const T* grange;        // (ndim,) global ranges
  const uint32_t* codes;  // (feval,) 4 bits per axis, axis d in bits 4d..4d+3
  const T* lam;           // (16,) the signed generator of each code
  const T* orbit_wts;     // (9, 5)
  const T* scale;         // (9, 5)
  const T* norm;          // (9, 5)
  T* est;
  T* err;
  int* split_dim;
  int cap, n, blocked;
  int tile;               // regions per tile: a multiple of 4, at most kTile
  int bulk_ok;            // rows of a full tile are 16-byte aligned
  T ratio;
  T coeffs[kMaxNdim], bounds[kMaxNdim];
  T s0, s1;
  // a crease run's (rule_tile_kernel<..., true>), as RuleArgs'
  T* frac;
  T* kept;
  sfrac::Stencil<T> st;
};

template <int NDIM>
struct Orbits {
  static constexpr int kKept = 8 * NDIM + 1;   // centre + 4 single-axis orbits
  static constexpr int k5 = kKept;
  static constexpr int k6 = k5 + 2 * NDIM * (NDIM - 1);
  static constexpr int k7 = k6 + 4 * NDIM * (NDIM - 1);
  static constexpr int k8 = k7 + 4 * NDIM * (NDIM - 1) * (NDIM - 2) / 3;
  static constexpr int kFeval = k8 + (1 << NDIM);
};

// A warp's own shared memory.
template <typename T, int NDIM>
struct alignas(16) WarpSmem {
  alignas(16) T stage[2][2 * NDIM][kTile];  // ring: rows of lows, lengths
  alignas(8) unsigned long long bar[2];     // one mbarrier per stage
  T xt[NDIM][kCodeRow];                     // genz_pre of the 11 coordinates
  T vals[Orbits<NDIM>::kKept + 1];          // values of points 0..8n
  T osum[kTile][kNsets];                    // orbit sums of the tile's regions
  int best[kTile];                          // split axis by fourth difference
};

// A crease run's kernel only: the per-axis form of the fraction takes a
// group of kGroup lanes a region, lane d axis d, so that a warp computes
// the fractions of kRegions regions at once; a warp keeps the collinear
// values (points 0..4n) and split axes of the regions of a batch, and the
// cut fractions and split axes of its tile's regions.
template <typename T, int NDIM>
struct FracRows {
  static constexpr int kKept = 4 * NDIM + 1;
  static constexpr int kGroup = NDIM <= 4 ? 4 : 8;
  static constexpr int kRegions = 32 / kGroup;
  T frac[kTile];
  int sd[kTile];
  T kept[kRegions][kKept];
  int sd0[kRegions];
};

// The block's shared memory: the point codes, then orbit_wts, scale, norm
// (9 x 5 each), lam (16), glo and grange (ndim each), then the warps' own;
// a crease run's kernel (F) then the stencil (ndim sfrac::Axis) and the
// warps' FracRows.  Without F the layout is the first design's.
constexpr int kTab = kNsets * kNrules;

template <typename T, int NDIM, bool F>
struct TileLayout {
  static constexpr size_t kCodeBytes =
      (Orbits<NDIM>::kFeval * sizeof(uint2) + 15) / 16 * 16;
  static constexpr size_t kTableBytes =
      ((3 * kTab + kCodeRow + 2 * NDIM) * sizeof(T) + 15) / 16 * 16;
  static constexpr size_t kWarpsAt = kCodeBytes + kTableBytes;
  static constexpr size_t kStencilAt =
      kWarpsAt + kTileWarps * sizeof(WarpSmem<T, NDIM>);
  static constexpr size_t kFracAt =
      kStencilAt + (F ? (NDIM * sizeof(sfrac::Axis<T>) + 15) / 16 * 16 : 0);
  static constexpr size_t kBytes =
      kFracAt + (F ? kTileWarps * sizeof(FracRows<T, NDIM>) : 0);
};

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Tile t of the pool -> its first slot and its number of regions.  Plain
// layout: the n real regions are slots [0, n).  Blocked: the first n/2 slots
// of each half of the pool, tiled half by half (cuda_rule.tile_slots).
template <typename T>
__device__ __forceinline__ void tile_of(const TileArgs<T>& a, int t,
                                        int tiles_per_part, int& slot0,
                                        int& count) {
  const int per_part = a.blocked ? a.n / 2 : a.n;
  const int part = t / tiles_per_part;
  const int off = (t - part * tiles_per_part) * a.tile;
  slot0 = part * (a.cap / 2) + off;
  count = min(a.tile, per_part - off);
}

// WITH_FRAC: also the crease/jump-aware cut fraction from the kept values
// of points 0..4n by split_frac.cuh's per-axis form, which may override
// the split axis: each region's values and split axis join a batch of
// FracRows::kRegions regions right after its fourth differences, and the
// warp takes a batch at once, a group of lanes a region, lane d axis d (a
// warp of one region would run the fraction's ~140 f64 instructions an
// axis with 8 of 32 lanes busy: +15 % on an 8D pool on an H100, against
// +3-7 % batched).  Without it the code is the first design's.
template <int FAMILY, typename T, int NDIM, bool WITH_FRAC>
__global__ void __launch_bounds__(kTileThreads, 1)
rule_tile_kernel(const TileArgs<T> a) {
  using O = Orbits<NDIM>;
  extern __shared__ __align__(16) unsigned char smem[];
  using L = TileLayout<T, NDIM, WITH_FRAC>;
  uint2* s_codes = reinterpret_cast<uint2*>(smem);
  T* s_wts = reinterpret_cast<T*>(smem + L::kCodeBytes);
  T* s_scale = s_wts + kTab;
  T* s_norm = s_scale + kTab;
  T* s_lam = s_norm + kTab;
  T* s_glo = s_lam + kCodeRow;
  T* s_grange = s_glo + NDIM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpSmem<T, NDIM>& ws =
      reinterpret_cast<WarpSmem<T, NDIM>*>(smem + L::kWarpsAt)[warp];
  sfrac::Axis<T>* s_faxis =
      reinterpret_cast<sfrac::Axis<T>*>(smem + L::kStencilAt);
  using FR = FracRows<T, NDIM>;
  FR& fr = reinterpret_cast<FR*>(smem + L::kFracAt)[warp];

  // ---- prologue: the block's tables, the warp's barriers ----------------
  // a point's codes, spread to a byte per axis and scaled to the byte
  // offset within a row of the coordinate table: a lookup is then one
  // byte extraction and one load
  for (int i = threadIdx.x; i < O::kFeval; i += kTileThreads) {
    const uint32_t c = a.codes[i];
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int d = 0; d < NDIM; ++d)
      w[d >> 2] |= (((c >> (4 * d)) & 15u) * static_cast<uint32_t>(sizeof(T)))
                   << (8 * (d & 3));
    s_codes[i] = make_uint2(w[0], w[1]);
  }
  for (int i = threadIdx.x; i < kTab; i += kTileThreads) {
    s_wts[i] = a.orbit_wts[i];
    s_scale[i] = a.scale[i];
    s_norm[i] = a.norm[i];
  }
  if (threadIdx.x < kCodeRow) s_lam[threadIdx.x] = a.lam[threadIdx.x];
  if (threadIdx.x < NDIM) {
    s_glo[threadIdx.x] = a.glo[threadIdx.x];
    s_grange[threadIdx.x] = a.grange[threadIdx.x];
  }
  if constexpr (WITH_FRAC) {
    if (threadIdx.x < NDIM) s_faxis[threadIdx.x] = a.st.axis[threadIdx.x];
  }
  const uint32_t bar0 = smem_addr(&ws.bar[0]), bar1 = smem_addr(&ws.bar[1]);
  if (lane == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int parts = a.blocked ? 2 : 1;
  const int per_part = a.blocked ? a.n / 2 : a.n;
  const int tiles_per_part = (per_part + a.tile - 1) / a.tile;
  const int n_tiles = parts * tiles_per_part;
  const int stride = gridDim.x * kTileWarps;
  const uint32_t row_bytes = a.tile * sizeof(T);

  // Start the copies of tile t into stage s; true if they are bulk copies
  // (a full, aligned tile), false if the tile is to be read by ordinary
  // loads when its turn comes.
  auto fetch = [&](int t, int s) -> bool {
    int slot0, count;
    tile_of(a, t, tiles_per_part, slot0, count);
    if (!(a.bulk_ok && count == a.tile)) return false;
    if (lane == 0) {
      const uint32_t bar = s ? bar1 : bar0;
      // order the warp's earlier reads and writes of the stage before the
      // asynchronous writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 2 * NDIM * row_bytes);
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        bulk_load(smem_addr(&ws.stage[s][d][0]),
                  a.lows + static_cast<size_t>(d) * a.cap + slot0, row_bytes,
                  bar);
        bulk_load(smem_addr(&ws.stage[s][NDIM + d][0]),
                  a.lengths + static_cast<size_t>(d) * a.cap + slot0,
                  row_bytes, bar);
      }
    }
    return true;
  };

  // value of the rule point with the byte offsets ``code``; the generated
  // family's table holds the coordinates themselves, which it gathers into
  // registers for one call of gen_integrand
  auto value = [&](uint2 code) -> T {
    auto entry = [&](int d) -> T {
      const uint32_t off =
          __byte_perm(d < 4 ? code.x : code.y, 0u, 0x4440u + (d & 3));
      return *reinterpret_cast<const T*>(
          reinterpret_cast<const char*>(ws.xt[d]) + off);
    };
    if constexpr (FAMILY == kGenerated) {
      T x[NDIM];
#pragma unroll
      for (int d = 0; d < NDIM; ++d) x[d] = entry(d);
      return gen_integrand<T>(x);
    } else {
      GenzState<T> g;
#pragma unroll
      for (int d = 0; d < NDIM; ++d)
        genz_fold<FAMILY, T>(g, entry(d), a.coeffs[d], a.bounds[d], a.s0);
      return genz_finish<FAMILY, T>(g, NDIM, a.s0);
    }
  };

  // The point list in segments: points 0..8n (the centre and the four
  // single-axis orbits), whose values are kept, then orbits 5..8, each
  // summed.
  const int seg[6] = {0, O::k5, O::k6, O::k7, O::k8, O::kFeval};

  const T c0 = T(2) * (T(1) - a.ratio);
  T jac = T(1);
#pragma unroll
  for (int d = 0; d < NDIM; ++d) jac *= s_grange[d];

  uint32_t parity0 = 0, parity1 = 0;   // the phase each barrier completes next
  int t = blockIdx.x * kTileWarps + warp;
  bool bulk = t < n_tiles && fetch(t, 0);
  for (int s = 0; t < n_tiles; t += stride, s ^= 1) {
    const int t_next = t + stride;
    const bool bulk_next = t_next < n_tiles && fetch(t_next, s ^ 1);
    int slot0, count;
    tile_of(a, t, tiles_per_part, slot0, count);
    if (bulk) {
      if (s) {
        mbar_wait(bar1, parity1);
        parity1 ^= 1u;
      } else {
        mbar_wait(bar0, parity0);
        parity0 ^= 1u;
      }
    } else {
      if (lane < count) {
#pragma unroll
        for (int d = 0; d < NDIM; ++d) {
          ws.stage[s][d][lane] =
              a.lows[static_cast<size_t>(d) * a.cap + slot0 + lane];
          ws.stage[s][NDIM + d][lane] =
              a.lengths[static_cast<size_t>(d) * a.cap + slot0 + lane];
        }
      }
      __syncwarp();
    }

    for (int j = 0; j < count; ++j) {
      // the region's 11 coordinates per axis, through genz_pre (the
      // coordinate itself for the generated family)
      for (int e = lane; e < kCodes * NDIM; e += 32) {
        const int c = e / NDIM, d = e - c * NDIM;
        T cen, len;
        region_axis(ws.stage[s][d][j], ws.stage[s][NDIM + d][j], s_glo[d],
                    s_grange[d], cen, len);
        const T x = cen - s_lam[c] * len;
        ws.xt[d][c] = genz_pre<FAMILY, T>(x, a.s0, a.s1);
      }
      __syncwarp();

      // lanes stride over a segment's points, two in flight per lane
#pragma unroll 1
      for (int g = 0; g < 5; ++g) {
        const int end = seg[g + 1];
        T acc0 = T(0), acc1 = T(0);
        int p = seg[g] + lane;
        for (; p + 32 < end; p += 64) {
          const T v0 = value(s_codes[p]);
          const T v1 = value(s_codes[p + 32]);
          if (g == 0) {
            ws.vals[p] = v0;
            ws.vals[p + 32] = v1;
          } else {
            acc0 += v0;
            acc1 += v1;
          }
        }
        if (p < end) {
          const T v = value(s_codes[p]);
          if (g == 0) ws.vals[p] = v; else acc0 += v;
        }
        if (g > 0) {
          const T total = warp_sum(acc0 + acc1);
          if (lane == 0) ws.osum[j][4 + g] = total;
        }
      }
      __syncwarp();

      // lane d: the pair sums of axis d in orbits 1..4, its fourth difference
      const T f0 = ws.vals[0];
      T o1 = T(0), o2 = T(0), o3 = T(0), o4 = T(0), diff = T(0);
      if (lane < NDIM) {
        o1 = ws.vals[1 + 2 * lane] + ws.vals[2 + 2 * lane];
        o2 = ws.vals[1 + 2 * NDIM + 2 * lane] + ws.vals[2 + 2 * NDIM + 2 * lane];
        o3 = ws.vals[1 + 4 * NDIM + 2 * lane] + ws.vals[2 + 4 * NDIM + 2 * lane];
        o4 = ws.vals[1 + 6 * NDIM + 2 * lane] + ws.vals[2 + 6 * NDIM + 2 * lane];
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
        T* o = ws.osum[j];
        o[0] = f0; o[1] = o1; o[2] = o2; o[3] = o3; o[4] = o4;
        ws.best[j] = any_nan ? -2 : (top > T(0) ? arg : -1);
      }
      if constexpr (WITH_FRAC) {
        // the region joins the batch: its collinear values, and its split
        // axis as region_outputs takes it (the widest axis by the
        // epilogue's scan where no positive difference wins)
        const int b = j % FR::kRegions;
        T wl = ws.stage[s][NDIM][j];
        int widest = 0;
#pragma unroll
        for (int d = 1; d < NDIM; ++d) {
          const T l = ws.stage[s][NDIM + d][j];
          if (l > wl) {
            wl = l;
            widest = d;
          }
        }
        if (lane == 0) fr.sd0[b] = (any_nan || !(top > T(0))) ? widest : arg;
        for (int p = lane; p < FR::kKept; p += 32) {
          fr.kept[b][p] = ws.vals[p];
          if (a.kept != nullptr)
            a.kept[static_cast<size_t>(slot0 + j) * FR::kKept + p] =
                ws.vals[p];
        }
        if (b == FR::kRegions - 1 || j == count - 1) {
          // the batch's fractions: group g region j - b + g, lane d of
          // the group axis d
          __syncwarp();
          const int g = lane / FR::kGroup, d = lane % FR::kGroup;
          const bool active = g <= b && d < NDIM;
          const T* kv = fr.kept[g <= b ? g : 0];
          int sd = fr.sd0[g <= b ? g : 0];
          T kink = T(0.5), strength = T(0), jump = T(0.5);
          if (active)
            sfrac::axis_frac([&](int p) { return kv[p]; }, kv[0], s_faxis[d],
                             d == sd, kink, strength, jump);
          const T frac =
              sfrac::group_frac<FR::kGroup>(active, kink, strength, jump, sd);
          if (d == 0 && g <= b) {
            fr.frac[j - b + g] = frac;
            fr.sd[j - b + g] = sd;
          }
        }
      }
    }
    __syncwarp();

    // ---- the tile's epilogue: lane j finishes region j -------------------
    if (lane < count) {
      T orbit_sum[kNsets];
#pragma unroll
      for (int k = 0; k < kNsets; ++k) orbit_sum[k] = ws.osum[lane][k];
      // WITH_FRAC: the split axis is fr.sd, decided in the region loop;
      // the widest axis is not scanned again and sdim is not used
      T vol = T(1), wl = ws.stage[s][NDIM][lane];
      int widest = 0;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        const T l = ws.stage[s][NDIM + d][lane];
        vol *= l;
        if (!WITH_FRAC && d > 0 && l > wl) {
          wl = l;
          widest = d;
        }
      }
      const int best = ws.best[lane];
      T est, err;
      int sdim;
      region_outputs(orbit_sum, jac, vol, widest, best, best == -2, s_wts,
                     s_scale, s_norm, est, err, sdim);
      a.est[slot0 + lane] = est;
      a.err[slot0 + lane] = err;
      if constexpr (WITH_FRAC) {
        a.split_dim[slot0 + lane] = fr.sd[lane];
        a.frac[slot0 + lane] = fr.frac[lane];
      } else {
        a.split_dim[slot0 + lane] = sdim;
      }
    }
    __syncwarp();
    bulk = bulk_next;
  }
}

// ---------------------------------------------------------------------------
// Launches.

template <typename T>
void launch_fill(T* est, T* err, int* split_dim, T* frac, int cap, int n,
                 int blocked, cudaStream_t stream) {
  if (n >= cap) return;
  const int blocks = (cap + 255) / 256 < 4096 ? (cap + 255) / 256 : 4096;
  if (frac != nullptr)
    fill_padding<T, true><<<blocks, 256, 0, stream>>>(est, err, split_dim,
                                                      frac, cap, n, blocked);
  else
    fill_padding<T, false><<<blocks, 256, 0, stream>>>(est, err, split_dim,
                                                       frac, cap, n, blocked);
}

template <int FAMILY, typename T>
void launch_generic_kernel(const RuleArgs<T>& a, cudaStream_t stream) {
  const dim3 grid(a.n);
  if (a.frac != nullptr)
    rule_kernel<FAMILY, T, true><<<grid, kThreads, 0, stream>>>(a);
  else
    rule_kernel<FAMILY, T, false><<<grid, kThreads, 0, stream>>>(a);
}

template <int FAMILY, typename T, int NDIM, bool F>
int launch_tile_kernel(const TileArgs<T>& a, int blocks, cudaStream_t stream) {
  auto kernel = rule_tile_kernel<FAMILY, T, NDIM, F>;
  constexpr size_t smem = TileLayout<T, NDIM, F>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kTileThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launches of the families (and, tile route, dimensions) a source
// compiles: defined by rule_eval.cu and gen_integrand.cu.  Each returns 0
// or the error of the launch it could not make (cudaErrorInvalidValue for
// a family or dimension the source lacks).
template <typename T>
int launch_generic_family(int family, const RuleArgs<T>& a,
                          cudaStream_t stream);
template <typename T>
int launch_tile_dims(int family, int ndim, const TileArgs<T>& a, int blocks,
                     cudaStream_t stream);

template <typename T>
int launch_generic(int family, const RuleArgs<T>& a, cudaStream_t stream) {
  launch_fill(a.est, a.err, a.split_dim, a.frac, a.cap, a.n, a.blocked,
              stream);
  if (a.n > 0) {
    const int rc = launch_generic_family<T>(family, a, stream);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(int family, int ndim, const TileArgs<T>& a, int blocks,
                cudaStream_t stream) {
  launch_fill(a.est, a.err, a.split_dim, a.frac, a.cap, a.n, a.blocked,
              stream);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  return launch_tile_dims<T>(family, ndim, a, blocks, stream);
}

struct HostArgs {
  int family, ndim, feval, cap, n, blocked;
  const void *lows, *lengths, *glo, *grange, *gen, *orbit_wts, *scale, *norm;
  double ratio;
  const int* orbit_bounds;
  const double* params;
  void *est, *err;
  int* split_dim;
  // a crease run's: frac (cap,) or null; the stencil (host arrays); the
  // check-only kept values (cap, 4 ndim + 1) or null
  void* frac;
  const int* frac_slots;
  const double* frac_consts;
  void* kept;
};

// The crease run's arguments of either kernel: a null frac leaves them
// unset (the kernel without the fraction reads none of them).
template <typename T, typename Args>
void frac_args(const HostArgs& h, Args& a) {
  a.frac = static_cast<T*>(h.frac);
  a.kept = static_cast<T*>(h.kept);
  if (h.frac != nullptr)
    sfrac::load_stencil(a.st, h.ndim, h.frac_slots, h.frac_consts);
}

template <typename T>
int generic_route(const HostArgs& h, cudaStream_t stream) {
  RuleArgs<T> a;
  a.lows = static_cast<const T*>(h.lows);
  a.lengths = static_cast<const T*>(h.lengths);
  a.glo = static_cast<const T*>(h.glo);
  a.grange = static_cast<const T*>(h.grange);
  a.gen = static_cast<const T*>(h.gen);
  a.orbit_wts = static_cast<const T*>(h.orbit_wts);
  a.scale = static_cast<const T*>(h.scale);
  a.norm = static_cast<const T*>(h.norm);
  a.est = static_cast<T*>(h.est);
  a.err = static_cast<T*>(h.err);
  a.split_dim = h.split_dim;
  a.ndim = h.ndim;
  a.feval = h.feval;
  a.cap = h.cap;
  a.n = h.n;
  a.blocked = h.blocked;
  a.ratio = static_cast<T>(h.ratio);
  for (int k = 0; k <= kNsets; ++k) a.orbit_bounds[k] = h.orbit_bounds[k];
  for (int d = 0; d < kMaxNdim; ++d) {
    a.coeffs[d] = static_cast<T>(h.params[d]);
    a.bounds[d] = static_cast<T>(h.params[kMaxNdim + d]);
  }
  a.s0 = static_cast<T>(h.params[2 * kMaxNdim]);
  a.s1 = static_cast<T>(h.params[2 * kMaxNdim + 1]);
  frac_args<T>(h, a);
  return launch_generic<T>(h.family, a, stream);
}

template <typename T>
int tile_route(const HostArgs& h, const void* codes, const void* lam,
               int tile, int blocks, cudaStream_t stream) {
  TileArgs<T> a;
  a.lows = static_cast<const T*>(h.lows);
  a.lengths = static_cast<const T*>(h.lengths);
  a.glo = static_cast<const T*>(h.glo);
  a.grange = static_cast<const T*>(h.grange);
  a.codes = static_cast<const uint32_t*>(codes);
  a.lam = static_cast<const T*>(lam);
  a.orbit_wts = static_cast<const T*>(h.orbit_wts);
  a.scale = static_cast<const T*>(h.scale);
  a.norm = static_cast<const T*>(h.norm);
  a.est = static_cast<T*>(h.est);
  a.err = static_cast<T*>(h.err);
  a.split_dim = h.split_dim;
  a.cap = h.cap;
  a.n = h.n;
  a.blocked = h.blocked;
  a.tile = tile;
  const uintptr_t align = reinterpret_cast<uintptr_t>(h.lows) |
                          reinterpret_cast<uintptr_t>(h.lengths) |
                          (static_cast<uintptr_t>(h.cap) * sizeof(T)) |
                          (h.blocked ? static_cast<uintptr_t>(h.cap / 2) *
                                           sizeof(T)
                                     : 0) |
                          (static_cast<uintptr_t>(tile) * sizeof(T));
  a.bulk_ok = (align & 15u) == 0;
  a.ratio = static_cast<T>(h.ratio);
  for (int d = 0; d < kMaxNdim; ++d) {
    a.coeffs[d] = static_cast<T>(h.params[d]);
    a.bounds[d] = static_cast<T>(h.params[kMaxNdim + d]);
  }
  a.s0 = static_cast<T>(h.params[2 * kMaxNdim]);
  a.s1 = static_cast<T>(h.params[2 * kMaxNdim + 1]);
  frac_args<T>(h, a);
  return launch_tile<T>(h.family, h.ndim, a, blocks, stream);
}

}  // namespace rule
}  // namespace

// C entry points for ctypes.  Pointers are device pointers except
// orbit_bounds (10 ints), params (34 doubles: coeffs[16], bounds[16], s0,
// s1), frac_slots (ndim, 4) int32 and frac_consts (ndim, 5) float64 (the
// stencil, cuda_rule._frac_tables), which are host arrays copied into the
// launch's arguments.  ``frac`` null launches the kernel without the cut
// fraction; else the crease run's kernel writes it into frac (cap,), 0.5
// in the padding slots, and split_dim the axis a jump overrides.
// ``kept``, check-only and null on every production path, takes each real
// region's 4 ndim + 1 collinear values as (cap, 4 ndim + 1) rows (with
// frac only).  Each returns cudaGetLastError() after its launches (0 on
// success) and never synchronises.

static bool bad_frac_args(const void* frac, const int* frac_slots,
                          const double* frac_consts, const void* kept) {
  return (frac != nullptr && (frac_slots == nullptr || frac_consts == nullptr))
         || (kept != nullptr && frac == nullptr);
}

// The generic route, every ndim 2..16.
extern "C" int rule_eval_launch(
    int family, int is_double, int ndim, int feval, int cap, int n,
    int blocked, const void* lows, const void* lengths, const void* glo,
    const void* grange, const void* gen, const void* orbit_wts,
    const void* scale, const void* norm, double ratio,
    const int* orbit_bounds, const double* params, void* est, void* err,
    int* split_dim, void* frac, const int* frac_slots,
    const double* frac_consts, void* kept, void* stream) {
  if (ndim < 2 || ndim > rule::kMaxNdim || family < 1 ||
      family > kGenerated || n > cap ||
      bad_frac_args(frac, frac_slots, frac_consts, kept))
    return static_cast<int>(cudaErrorInvalidValue);
  const rule::HostArgs h{family, ndim,  feval,     cap,   n,    blocked,
                         lows,   lengths, glo,     grange, gen,  orbit_wts,
                         scale,  norm,  ratio,     orbit_bounds, params,
                         est,    err,   split_dim, frac, frac_slots,
                         frac_consts, kept};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? rule::generic_route<double>(h, s)
                   : rule::generic_route<float>(h, s);
}

// The tile route, ndim 3..8.  ``codes`` (feval,) uint32 and ``lam``
// (16,) of the working type: cuda_rule.pack_generators.  ``tile``: regions
// per tile, a multiple of 4 in 4..32.  ``blocks``: persistent blocks of 16
// warps.
extern "C" int rule_eval_tile_launch(
    int family, int is_double, int ndim, int cap, int n, int blocked,
    const void* lows, const void* lengths, const void* glo,
    const void* grange, const void* codes, const void* lam,
    const void* orbit_wts, const void* scale, const void* norm, double ratio,
    const double* params, int tile, int blocks, void* est, void* err,
    int* split_dim, void* frac, const int* frac_slots,
    const double* frac_consts, void* kept, void* stream) {
  if (family < 1 || family > kGenerated || n > cap || tile < 4 ||
      tile > rule::kTile || tile % 4 || blocks < 1 ||
      (blocked && (n % 2 || cap % 2)) ||
      bad_frac_args(frac, frac_slots, frac_consts, kept))
    return static_cast<int>(cudaErrorInvalidValue);
  const rule::HostArgs h{family, ndim,    0,   cap,    n,       blocked,
                         lows,   lengths, glo, grange, nullptr, orbit_wts,
                         scale,  norm,    ratio, nullptr, params,
                         est,    err,     split_dim, frac, frac_slots,
                         frac_consts, kept};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? rule::tile_route<double>(h, codes, lam, tile, blocks, s)
                   : rule::tile_route<float>(h, codes, lam, tile, blocks, s);
}
