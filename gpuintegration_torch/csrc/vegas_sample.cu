// The emit mode's and the Genz families' instances of the fused VEGAS
// sampler (vegas_sample.cuh, which holds the design): the paired route at
// ndim 1..8, the wide route in its four classes of dimensions (NMAX 12 for
// ndim 9..12, 16 for 13..16, 24 for 17..24, 32 for 25..32) and the generic
// route in its two instances (NMAX 16 for ndim 1..16, 0 above), for the
// emit mode (family 0) and F1..F6.
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

template <int NMAX>
int launch_wide(int family, const SampleArgs& a, dim3 grid, size_t smem,
                cudaStream_t s) {
  switch (family) {
    case 0: sample_wide_kernel<0, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 1: sample_wide_kernel<1, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 2: sample_wide_kernel<2, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 3: sample_wide_kernel<3, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 4: sample_wide_kernel<4, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 5: sample_wide_kernel<5, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 6: sample_wide_kernel<6, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NMAX>
int launch_generic(int family, const SampleArgs& a, dim3 grid, size_t smem,
                   cudaStream_t s) {
  switch (family) {
    case 0: sample_kernel<0, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 1: sample_kernel<1, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 2: sample_kernel<2, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 3: sample_kernel<3, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 4: sample_kernel<4, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 5: sample_kernel<5, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    case 6: sample_kernel<6, NMAX><<<grid, kThreads, smem, s>>>(a); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_sampler(int route, int family, int ndim, const SampleArgs& a,
                   dim3 grid, size_t smem, cudaStream_t s) {
  if (route == 2) {
    // the wide route's classes (cuda_vegas.WIDE_NDIMS, wide_class)
    if (ndim >= 9 && ndim <= 12) return launch_wide<12>(family, a, grid, smem, s);
    if (ndim >= 13 && ndim <= 16) return launch_wide<16>(family, a, grid, smem, s);
    if (ndim >= 17 && ndim <= 24) return launch_wide<24>(family, a, grid, smem, s);
    if (ndim >= 25 && ndim <= 32) return launch_wide<32>(family, a, grid, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 1) {
    // the dimensions the paired route is compiled for
    // (cuda_vegas.PAIRED_NDIMS)
    switch (ndim) {
      case 1: return launch_pair<1>(family, a, grid, smem, s);
      case 2: return launch_pair<2>(family, a, grid, smem, s);
      case 3: return launch_pair<3>(family, a, grid, smem, s);
      case 4: return launch_pair<4>(family, a, grid, smem, s);
      case 5: return launch_pair<5>(family, a, grid, smem, s);
      case 6: return launch_pair<6>(family, a, grid, smem, s);
      case 7: return launch_pair<7>(family, a, grid, smem, s);
      case 8: return launch_pair<8>(family, a, grid, smem, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return ndim <= 16 ? launch_generic<16>(family, a, grid, smem, s)
                    : launch_generic<0>(family, a, grid, smem, s);
}

}  // namespace sampler
}  // namespace
