// The check of a traced callable's emitted integrand alone: the generated
// device function gen_integrand (ops/integrand_gen.py emit_cuda) at each
// of n points, a thread a point, in f64 or f32.  No path launches it:
// cuda_rule.generated_values holds its values to integrand_gen.evaluate's
// (the callable's own PyTorch calls) bit for bit, which is what the
// emitter promises of its rounding.
//
// ops/cuda_build.py builds this source apart from gen_integrand.cu, with
// the same generated header pre-included, only when a check asks for it
// (``load_generated(..., source=GEN_VALUES_SOURCE)``): the library that a
// user's run loads holds none of it.

#include "gen_integrand.cuh"

namespace {

template <typename T>
__global__ void gen_values_kernel(const T* x, long long n, T* out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    T xs[kGenNdim];
#pragma unroll
    for (int d = 0; d < kGenNdim; ++d) xs[d] = x[d * n + i];
    out[i] = gen_integrand<T>(xs);
  }
}

}  // namespace

// ``x`` (kGenNdim, n) and ``out`` (n,) device pointers of the working type.
extern "C" int gen_values_launch(int is_double, long long n, const void* x,
                                 void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    gen_values_kernel<double><<<blocks, 256, 0, s>>>(
        static_cast<const double*>(x), n, static_cast<double*>(out));
  else
    gen_values_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
