// The fused kernels for one traced per-axis callable: the rule kernels of
// rule_eval.cuh and the sampler kernels of vegas_sample.cuh instantiated
// for the generated family kGenerated at the callable's dimension only.
//
// Replaces the reference's Pallas kernels with the user's f_axes traced
// into their bodies: gpuintegration_tpu/ops/pallas_rule.py::
// pallas_apply_rule (rule_backend='pallas') and gpuintegration_tpu/mcubes/
// pallas_vegas.py::poly_sample_chunk (sampler='pallas').
//
// ops/cuda_build.py build_generated compiles this source once for each
// callable with its generated header (ops/integrand_gen.py emit_cuda:
// kGenNdim and gen_integrand) pre-included, so that a build instantiates
// four kernels: the rule's tile route (kGenNdim 3..8) and generic route in
// f64 and f32, the sampler's paired route (kGenNdim 3..8) and generic
// route in f32.  None is built with the crease fraction (a crease run
// refuses this family, as the reference's Pallas backend does), and the
// sampler has no emit mode here.  What bounds each kernel is written in
// the headers; the integrand's share is its program's steps, counted by
// integrand_gen.program_ops.

#include "rule_eval.cuh"
#include "vegas_sample.cuh"

namespace {
namespace rule {

template <typename T>
int launch_generic_family(int family, const RuleArgs<T>& a,
                          cudaStream_t stream) {
  if (family != kGenerated || a.ndim != kGenNdim || a.frac != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  rule_kernel<kGenerated, T, false><<<dim3(a.n), kThreads, 0, stream>>>(a);
  return 0;
}

template <typename T, int NDIM>
int launch_tile_generated(const TileArgs<T>& a, int blocks,
                          cudaStream_t stream) {
  if constexpr (NDIM >= 3 && NDIM <= 8)
    return launch_tile_kernel<kGenerated, T, NDIM, false>(a, blocks, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_tile_dims(int family, int ndim, const TileArgs<T>& a, int blocks,
                     cudaStream_t stream) {
  if (family != kGenerated || ndim != kGenNdim || a.frac != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile_generated<T, kGenNdim>(a, blocks, stream);
}

}  // namespace rule

namespace sampler {

template <int NDIM>
int launch_generated(int route, const SampleArgs& a, dim3 grid, size_t smem,
                     cudaStream_t s) {
  if (route == 0) {
    sample_kernel<kGenerated><<<grid, kThreads, smem, s>>>(a);
    return 0;
  }
  if constexpr (NDIM >= 3 && NDIM <= 8) {
    sample_pair_kernel<kGenerated, NDIM><<<grid, kThreads, smem, s>>>(a);
    return 0;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_sampler(int route, int family, int ndim, const SampleArgs& a,
                   dim3 grid, size_t smem, cudaStream_t s) {
  if (family != kGenerated || ndim != kGenNdim)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_generated<kGenNdim>(route, a, grid, smem, s);
}

}  // namespace sampler
}  // namespace
