// The Genz integrand families F1..F6 as device functions, shared by the
// kernels that evaluate an integrand on the card (rule_eval.cu,
// vegas_sample.cu).  The forms are those of
// gpuintegration_torch/models/genz.py: F2 takes one division of the
// denominator product, F3 an integer power.
//
// A value is built one coordinate at a time: genz_axis() folds coordinate
// x_d into the running state, genz_finish() turns the state into f(x).
// The caller forms each x_d however it likes (a rule point, a sampled
// point) and keeps none of them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T>
struct GenzState {
  T s = T(0);
  T prod = T(1);
  bool inside = true;
};

// Fold coordinate x of an axis with per-axis parameters coeff (a_i of F1,
// F3, F6) and bound (b_i of F6); s0, s1 are the family's scalars
// (F1: offset | F2: 1/a^2, b | F4: a*a, b | F5: a, b).
template <int FAMILY, typename T>
__device__ __forceinline__ void genz_axis(GenzState<T>& g, T x, T coeff,
                                          T bound, T s0, T s1) {
  if (FAMILY == 1 || FAMILY == 3) {
    g.s += x * coeff;
  } else if (FAMILY == 2) {
    const T t = x - s1;
    g.prod *= s0 + t * t;
  } else if (FAMILY == 4) {
    const T t = x - s1;
    g.s += s0 * (t * t);
  } else if (FAMILY == 5) {
    g.s += m_abs(x - s1);
  } else {  // FAMILY == 6
    g.inside = g.inside && (x <= bound);
    g.s += x * coeff;
  }
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
