// The emit mode's and the Genz families' instances of the fused VEGAS
// sampler (vegas_sample.cuh, which holds the design): the paired route at
// ndim 3..8 and the generic route at every ndim 1..16, for the emit mode
// (family 0) and F1..F6.
//
// Replaces gpuintegration_tpu/mcubes/pallas_vegas.py::poly_sample_chunk.

#include "vegas_sample.cuh"

namespace {
namespace sampler {

template <int NDIM>
int launch_pair(int family, const SampleArgs& a, dim3 grid, size_t smem,
                cudaStream_t s) {
  switch (family) {
    case 0: sample_pair_kernel<0, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 1: sample_pair_kernel<1, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 2: sample_pair_kernel<2, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 3: sample_pair_kernel<3, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 4: sample_pair_kernel<4, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 5: sample_pair_kernel<5, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    case 6: sample_pair_kernel<6, NDIM><<<grid, kThreads, smem, s>>>(a); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_sampler(int route, int family, int ndim, const SampleArgs& a,
                   dim3 grid, size_t smem, cudaStream_t s) {
  if (route == 1) {
    // the dimensions the paired route is compiled for
    // (cuda_vegas.PAIRED_NDIMS)
    switch (ndim) {
      case 3: return launch_pair<3>(family, a, grid, smem, s);
      case 4: return launch_pair<4>(family, a, grid, smem, s);
      case 5: return launch_pair<5>(family, a, grid, smem, s);
      case 6: return launch_pair<6>(family, a, grid, smem, s);
      case 7: return launch_pair<7>(family, a, grid, smem, s);
      case 8: return launch_pair<8>(family, a, grid, smem, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (family) {
    case 0: sample_kernel<0><<<grid, kThreads, smem, s>>>(a); return 0;
    case 1: sample_kernel<1><<<grid, kThreads, smem, s>>>(a); return 0;
    case 2: sample_kernel<2><<<grid, kThreads, smem, s>>>(a); return 0;
    case 3: sample_kernel<3><<<grid, kThreads, smem, s>>>(a); return 0;
    case 4: sample_kernel<4><<<grid, kThreads, smem, s>>>(a); return 0;
    case 5: sample_kernel<5><<<grid, kThreads, smem, s>>>(a); return 0;
    case 6: sample_kernel<6><<<grid, kThreads, smem, s>>>(a); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sampler
}  // namespace
