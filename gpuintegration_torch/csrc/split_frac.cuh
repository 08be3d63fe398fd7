// The crease/jump-aware cut fraction of a PAGANI region as device
// functions, shared by every kernel that holds a region's collinear rule
// values: the standalone rule_split_frac_kernel (split_frac.cu), the fused
// Genz kernels (rule_eval.cu, tile and generic) and the split route's
// scalar contractions (rule_split.cu, cluster and generic).  All of them
// compute the fraction in this one source, so they give the same bits.
//
// The counterpart of gpuintegration_tpu/ops/rule_eval.py:184
// (_split_fraction); rule_eval.split_fraction is its plain version.  Per
// axis d, two detectors on the four secants of the collinear stencil (the
// centre, orbit 1 at +-a, orbit 2 at +-b; rule_eval.split_stencil):
//   * a C0 kink between the inner samples: the outer and the inner lines
//     on either side meet at the crease; four gates; the cut at the crease
//     less a margin of 0.08 toward the centre, clipped to [0.12, 0.88];
//   * a jump: an inner gap's secant dominating every flank secant; the cut
//     at that gap's centre edge plus the margin (0.58 or 0.42).
// A region's fraction is the kink cut of its split axis sd, unless a jump
// fires on some axis: then the strongest jump's cut (the first axis of the
// largest strength, torch.argmax), and that axis becomes the split axis.
// Where nothing fires it is exactly 0.5 and sd is unchanged.
//
// Every product, quotient, sum and difference is rounded on its own
// (Rn<T>: __dmul_rn, __ddiv_rn, __dadd_rn, __dsub_rn and their f32
// twins), never contracted into a fused multiply-add (nvcc -O3 contracts
// a * b + c by default), and the comparisons and selections are the plain
// version's, so the fraction and the split axis are EQUAL to it.
//
// Two entry points, which give the same bits:
//   * region_frac: one thread loops over the axes of one region;
//   * axis_frac + group_frac: lane d of a group of P lanes takes axis d of
//     one region, a reduction over the group picks the jump axis as a
//     (strength, -index) maximum, which is the sequential loop's first
//     strongest axis.  A warp holds 32 / P regions' groups at once.
// Only the split axis' kink is needed, so axis_frac runs the kink detector
// (two intersections, four of an axis' six divisions with the relative
// breaks) only where asked; the jump detector runs on every axis.  The
// values are read through an accessor v(p), p the rule point's index
// (0 .. 4 ndim: only the collinear prefix is read).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sfrac {

constexpr int kMaxNdim = 16;
constexpr double kMargin = 0.08;      // rule_eval.SPLIT_MARGIN

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// max that propagates NaN, like torch.maximum
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (is_nan(a) || is_nan(b)) ? (is_nan(a) ? a : b) : (a > b ? a : b);
}

// The collinear stencil of one axis (cuda_rule._frac_tables): the slots
// at -b, -a, +a, +b, and the secants' abscissae [xam, xap, xam - xbm,
// 0 - xam, xbp - xap] in the working type.
template <typename T>
struct Axis {
  int slots[4];
  T consts[5];
};

// Every axis' stencil: host constants that travel in a kernel's
// arguments, so that a launch copies nothing and can be captured into a
// CUDA graph.  A kernel reads an axis' by value (never through a pointer
// into its arguments).
template <typename T>
struct Stencil {
  Axis<T> axis[kMaxNdim];
};

// Fill ``st`` from the host arrays slots (ndim, 4) int32 and consts
// (ndim, 5) float64 (values of the working type, so the cast is exact).
template <typename T>
inline void load_stencil(Stencil<T>& st, int ndim, const int* slots,
                         const double* consts) {
  for (int d = 0; d < ndim; ++d) {
    for (int k = 0; k < 4; ++k) st.axis[d].slots[k] = slots[4 * d + k];
    for (int k = 0; k < 5; ++k)
      st.axis[d].consts[k] = static_cast<T>(consts[5 * d + k]);
  }
}

// The two lines' meeting point: line L through (xl, vl) of slope sl, line R
// through (xr, vr) of slope sr; also |sl - sr| and |sl| + |sr|.
template <typename T>
__device__ __forceinline__ void intersect(T xl, T vl, T sl, T xr, T vr, T sr,
                                          T& xstar, T& dn, T& sc) {
  using R = Rn<T>;
  const T denom = R::sub(sl, sr);
  xstar = R::div(R::sub(R::add(R::sub(vr, vl), R::mul(sl, xl)),
                        R::mul(sr, xr)),
                 denom == T(0) ? T(1) : denom);
  dn = fabs(denom);
  sc = R::add(fabs(sl), fabs(sr));
}

// Axis d's detectors from f0 = v(0) and the axis' stencil ``ax``: its kink
// cut ``kink`` (0.5 where no kink fires, or where ``want_kink`` is false:
// the axis is not the split axis), its jump strength ``strength`` (0 where
// no jump fires) and its jump cut ``jump`` (0.5 where none).
template <typename T, typename V>
__device__ __forceinline__ void axis_frac(V v, T f0, const Axis<T> ax,
                                          bool want_kink, T& kink,
                                          T& strength, T& jump) {
  using R = Rn<T>;
  const T half = T(0.5), zero = T(0);
  const T margin = T(kMargin);
  const T lo = T(0.12), hi = T(0.88);
  const T vbm = v(ax.slots[0]), vam = v(ax.slots[1]);
  const T vap = v(ax.slots[2]), vbp = v(ax.slots[3]);
  const T xam = ax.consts[0], xap = ax.consts[1];
  const T g1 = R::div(R::sub(vam, vbm), ax.consts[2]);
  const T g2 = R::div(R::sub(f0, vam), ax.consts[3]);
  const T g3 = R::div(R::sub(vap, f0), xap);
  const T g4 = R::div(R::sub(vbp, vap), ax.consts[4]);

  kink = half;
  if (want_kink) {
    // H1: a kink in (-a, 0)
    T x1, dn1, sc1;
    intersect(xam, vam, g1, zero, f0, g3, x1, dn1, sc1);
    const bool ok1 = (dn1 > R::mul(half, sc1)) && (sc1 > zero) &&
                     (fabs(R::sub(g4, g3)) < R::mul(half, dn1)) &&
                     (fabs(g3) >= R::mul(T(0.9), fabs(g4))) &&
                     (R::mul(g1, g3) < zero) && (x1 > xam) && (x1 < zero);
    // H2: a kink in (0, +a)
    T x2, dn2, sc2;
    intersect(zero, f0, g2, xap, vap, g4, x2, dn2, sc2);
    const bool ok2 = (dn2 > R::mul(half, sc2)) && (sc2 > zero) &&
                     (fabs(R::sub(g2, g1)) < R::mul(half, dn2)) &&
                     (fabs(g2) >= R::mul(T(0.9), fabs(g1))) &&
                     (R::mul(g2, g4) < zero) && (x2 > zero) && (x2 < xap);
    if (ok1 || ok2) {
      // the hypothesis with the stronger relative slope break
      const T rel1 = ok1 ? R::div(dn1, sc1 == zero ? T(1) : sc1) : T(-1);
      const T rel2 = ok2 ? R::div(dn2, sc2 == zero ? T(1) : sc2) : T(-1);
      const T xstar = rel1 >= rel2 ? x1 : x2;
      const T y =
          R::add(half, R::sub(xstar, xstar >= zero ? margin : -margin));
      kink = y < lo ? lo : (y > hi ? hi : y);
    }
  }

  // jumps
  const T a1 = fabs(g1), a2 = fabs(g2), a3 = fabs(g3), a4 = fabs(g4);
  const T mag1 = nan_max(nan_max(a1, a3), a4);
  const bool j1 = (a2 > R::mul(T(2), mag1)) && (a2 > zero) &&
                  (R::mul(a2, a2) > R::mul(R::mul(T(16), a1), a3)) &&
                  (fabs(R::sub(g4, g3)) < R::mul(half, a2));
  const T mag2 = nan_max(nan_max(a1, a2), a4);
  const bool j2 = (a3 > R::mul(T(2), mag2)) && (a3 > zero) &&
                  (R::mul(a3, a3) > R::mul(R::mul(T(16), a2), a4)) &&
                  (fabs(R::sub(g1, g2)) < R::mul(half, a3));
  strength = j1 ? a2 : (j2 ? a3 : zero);
  jump = j1 ? T(0.5 + kMargin) : (j2 ? T(0.5 - kMargin) : half);
}

// The per-region form: one thread, the axes in order.  ``sd`` is the
// region's split axis by fourth difference on entry and the one a jump
// overrides on return; returns the fraction.
template <typename T, typename V>
__device__ __forceinline__ T region_frac(V v, int ndim, const Stencil<T>& st,
                                         int& sd) {
  const T f0 = v(0);
  T frac_kink = T(0.5), best = T(0), jfrac = T(0.5);
  int jdim = 0;
  for (int d = 0; d < ndim; ++d) {
    T kink, strength, jump;
    axis_frac(v, f0, st.axis[d], d == sd, kink, strength, jump);
    if (d == sd) frac_kink = kink;
    // the first axis of the strongest jump (torch.argmax)
    if (d == 0 || strength > best) {
      best = strength;
      jdim = d;
      jfrac = jump;
    }
  }
  const bool has_jump = best > T(0);
  sd = has_jump ? jdim : sd;
  return has_jump ? jfrac : frac_kink;
}

// The per-axis form's reduction, called by every lane of a warp, whose
// lanes are groups of P (a power of two, at most 32): lane d of a group
// holds axis d's axis_frac results for the group's region (``active``;
// lanes past ndim, or of a group without a region, hold none).  ``sd``
// (the same in every lane of a group) is the region's split axis on entry
// and the one a jump overrides on return; returns the fraction in every
// lane of the group.  The jump axis is a (strength, -index) maximum, the
// first strongest axis as region_frac's strict '>' from axis 0 finds it
// (a strength is never NaN, and an inactive lane's -1 loses to every
// axis'), so the two forms give the same bits.
template <int P, typename T>
__device__ __forceinline__ T group_frac(bool active, T kink, T strength,
                                        T jump, int& sd) {
  static_assert(P >= 1 && P <= 32 && (P & (P - 1)) == 0,
                "a group is a power of two of a warp's lanes");
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int base = lane & ~(P - 1);
  T top = active ? strength : T(-1);
  int arg = lane;
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
    const T v = __shfl_xor_sync(kFull, top, off);
    const int i = __shfl_xor_sync(kFull, arg, off);
    if (v > top || (v == top && i < arg)) {
      top = v;
      arg = i;
    }
  }
  const T frac_kink = __shfl_sync(kFull, kink, base + sd);
  const T jfrac = __shfl_sync(kFull, jump, arg);
  const bool has_jump = top > T(0);
  sd = has_jump ? arg - base : sd;
  return has_jump ? jfrac : frac_kink;
}

}  // namespace sfrac
