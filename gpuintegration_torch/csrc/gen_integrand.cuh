// The generated integrand family: a scalar-per-axis callable traced by
// gpuintegration_torch/ops/integrand_gen.py and emitted as one device
// function, gen_integrand<T>(x) over the point's ndim coordinates, which
// the fused rule kernels (rule_eval.cuh) and the fused sampler
// (vegas_sample.cuh) call as their family kGenerated.
//
// The generated header defines kGenNdim and gen_integrand and includes
// this one for the helpers its statements call.  Every helper rounds as
// PyTorch's separate elementwise kernels do: a product, sum or difference
// through a round-to-nearest intrinsic, so that nvcc contracts none of them
// into a multiply-add; division, square root and the transcendentals are
// the CUDA math library's, which PyTorch's kernels call too.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "genz.cuh"

// The family id of the generated integrand (integrand_gen.KIND).
constexpr int kGenerated = 7;

// Defined by the generated header of the library that instantiates the
// kernels for kGenerated (gen_integrand.cu); the other sources never
// instantiate those kernels.
template <typename T>
__device__ __forceinline__ T gen_integrand(const T* x);

// A constant as PyTorch computes with it in each working type.
template <typename T>
__device__ __forceinline__ T gen_const(double d, float f);
template <>
__device__ __forceinline__ double gen_const<double>(double d, float) {
  return d;
}
template <>
__device__ __forceinline__ float gen_const<float>(double, float f) {
  return f;
}

__device__ __forceinline__ float gen_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double gen_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float gen_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double gen_sub(double a, double b) {
  return __dsub_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T gen_mul(T a, T b) {
  return m_mul(a, b);
}
__device__ __forceinline__ float gen_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double gen_div(double a, double b) {
  return __ddiv_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T gen_recip(T a) {
  return gen_div(T(1), a);
}
template <typename T>
__device__ __forceinline__ T gen_neg(T a) {
  return -a;
}

__device__ __forceinline__ float gen_exp(float a) { return expf(a); }
__device__ __forceinline__ double gen_exp(double a) { return exp(a); }
__device__ __forceinline__ float gen_log(float a) { return logf(a); }
__device__ __forceinline__ double gen_log(double a) { return log(a); }
__device__ __forceinline__ float gen_sin(float a) { return sinf(a); }
__device__ __forceinline__ double gen_sin(double a) { return sin(a); }
__device__ __forceinline__ float gen_cos(float a) { return cosf(a); }
__device__ __forceinline__ double gen_cos(double a) { return cos(a); }
__device__ __forceinline__ float gen_tan(float a) { return tanf(a); }
__device__ __forceinline__ double gen_tan(double a) { return tan(a); }
__device__ __forceinline__ float gen_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ double gen_tanh(double a) { return tanh(a); }
__device__ __forceinline__ float gen_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double gen_sqrt(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float gen_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double gen_abs(double a) { return fabs(a); }
__device__ __forceinline__ float gen_expm1(float a) { return expm1f(a); }
__device__ __forceinline__ double gen_expm1(double a) { return expm1(a); }
__device__ __forceinline__ float gen_log1p(float a) { return log1pf(a); }
__device__ __forceinline__ double gen_log1p(double a) { return log1p(a); }
__device__ __forceinline__ float gen_pow(float a, float e) {
  return powf(a, e);
}
__device__ __forceinline__ double gen_pow(double a, double e) {
  return pow(a, e);
}

// torch.minimum / torch.maximum: a NaN operand gives NaN
template <typename T>
__device__ __forceinline__ T gen_minimum(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
template <typename T>
__device__ __forceinline__ T gen_maximum(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// torch.clamp with number bounds: NaN stays NaN
template <typename T>
__device__ __forceinline__ T gen_clamp_min(T a, T lo) {
  return a != a ? a : (a < lo ? lo : a);
}
template <typename T>
__device__ __forceinline__ T gen_clamp_max(T a, T hi) {
  return a != a ? a : (a > hi ? hi : a);
}
template <typename T>
__device__ __forceinline__ T gen_clamp(T a, T lo, T hi) {
  return gen_clamp_max(gen_clamp_min(a, lo), hi);
}
