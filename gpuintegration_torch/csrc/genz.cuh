// The Genz integrand families F1..F6 as device functions, shared by the
// kernels that evaluate an integrand on the card (rule_eval.cu,
// vegas_sample.cu).  The forms are those of
// gpuintegration_torch/models/genz.py: F2 takes one division of the
// denominator product, F3 an integer power.
//
// A value is built one coordinate at a time: genz_axis() folds coordinate
// x_d into the running state, genz_finish() turns the state into f(x).
// The caller forms each x_d however it likes (a rule point, a sampled
// point) and keeps none of them.  genz_axis() is genz_fold() of genz_pre():
// a kernel that meets the same x_d in many points computes genz_pre() once
// and folds the kept value, with the same arithmetic and so the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
// A product and a multiply-add that the compiler may not re-associate:
// for an expression that two kernels must round alike.
__device__ __forceinline__ float m_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double m_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float m_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double m_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct GenzState {
  T s = T(0);
  T prod = T(1);
  bool inside = true;
};

// The part of an axis' work that depends on the coordinate x alone, not on
// the running state: what a kernel may compute once per distinct x and
// keep (rule_eval.cu's coordinate table).  s0, s1 are the family's scalars
// (F1: offset | F2: 1/a^2, b | F4: a*a, b | F5: a, b).
template <int FAMILY, typename T>
__device__ __forceinline__ T genz_pre(T x, T s0, T s1) {
  if (FAMILY == 2) {
    const T t = x - s1;
    return s0 + t * t;
  } else if (FAMILY == 4) {
    const T t = x - s1;
    return t * t;
  } else if (FAMILY == 5) {
    return m_abs(x - s1);
  }
  return x;  // F1, F3, F6 use the coordinate itself
}

// Fold v = genz_pre(x) of an axis with per-axis parameters coeff (a_i of
// F1, F3, F6) and bound (b_i of F6) into the running state.
template <int FAMILY, typename T>
__device__ __forceinline__ void genz_fold(GenzState<T>& g, T v, T coeff,
                                          T bound, T s0) {
  if (FAMILY == 1 || FAMILY == 3) {
    g.s += v * coeff;
  } else if (FAMILY == 2) {
    g.prod *= v;
  } else if (FAMILY == 4) {
    g.s += s0 * v;
  } else if (FAMILY == 5) {
    g.s += v;
  } else {  // FAMILY == 6
    g.inside = g.inside && (v <= bound);
    g.s += v * coeff;
  }
}

// Fold coordinate x of an axis: genz_fold of genz_pre.
template <int FAMILY, typename T>
__device__ __forceinline__ void genz_axis(GenzState<T>& g, T x, T coeff,
                                          T bound, T s0, T s1) {
  genz_fold<FAMILY, T>(g, genz_pre<FAMILY, T>(x, s0, s1), coeff, bound, s0);
}

template <int FAMILY, typename T>
__device__ __forceinline__ T genz_finish(const GenzState<T>& g, int ndim,
                                         T s0) {
  if (FAMILY == 1) return m_cos(s0 + g.s);
  if (FAMILY == 2) return T(1) / g.prod;
  if (FAMILY == 3) {
    // (1 + s)^-(ndim+1) by squaring, then one divide
    T base = T(1) + g.s, r = T(1);
    for (int e = ndim + 1; e > 0; e >>= 1) {
      if (e & 1) r *= base;
      base *= base;
    }
    return T(1) / r;
  }
  if (FAMILY == 4) return m_exp(-g.s);
  if (FAMILY == 5) return m_exp(-s0 * g.s);
  return g.inside ? m_exp(g.s) : T(0);
}
