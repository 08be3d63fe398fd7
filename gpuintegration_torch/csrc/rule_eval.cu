// The Genz families' instances of the rule kernels (rule_eval.cuh, which
// holds the design): the generic route for F1..F6 in four classes of
// dimensions (NMAX 4, 8, 12, 16: every ndim 2..16; the crease fraction a
// run-time switch), the tile route for F1..F6 at ndim 3..8 with and
// without the crease fraction, each in f64 and f32; and the wide route for
// F1..F6 at ndim 17..24 (rule_wide.cuh, its own entry point
// rule_wide_launch), f64 and f32.
//
// Replaces gpuintegration_tpu/ops/pallas_rule.py::pallas_apply_rule (the
// f32 Pallas kernel) and, in f64, the XLA path rule_eval._eval_chunk.

#include "rule_eval.cuh"
#include "rule_wide.cuh"

namespace {
namespace rule {

template <typename T>
int launch_generic_family(int family, const RuleArgs<T>& a, int blocks,
                          cudaStream_t stream) {
  switch (family) {
    case 1: return launch_generic_classes<1, T>(a, blocks, stream);
    case 2: return launch_generic_classes<2, T>(a, blocks, stream);
    case 3: return launch_generic_classes<3, T>(a, blocks, stream);
    case 4: return launch_generic_classes<4, T>(a, blocks, stream);
    case 5: return launch_generic_classes<5, T>(a, blocks, stream);
    case 6: return launch_generic_classes<6, T>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int NDIM, bool F>
int launch_tile_family(int family, const TileArgs<T>& a, int blocks,
                       cudaStream_t stream) {
  switch (family) {
    case 1: return launch_tile_kernel<1, T, NDIM, F>(a, blocks, stream);
    case 2: return launch_tile_kernel<2, T, NDIM, F>(a, blocks, stream);
    case 3: return launch_tile_kernel<3, T, NDIM, F>(a, blocks, stream);
    case 4: return launch_tile_kernel<4, T, NDIM, F>(a, blocks, stream);
    case 5: return launch_tile_kernel<5, T, NDIM, F>(a, blocks, stream);
    case 6: return launch_tile_kernel<6, T, NDIM, F>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int NDIM>
int launch_tile_ndim(int family, const TileArgs<T>& a, int blocks,
                     cudaStream_t stream) {
  return a.frac != nullptr
             ? launch_tile_family<T, NDIM, true>(family, a, blocks, stream)
             : launch_tile_family<T, NDIM, false>(family, a, blocks, stream);
}

// The dimensions the tile route is compiled for (cuda_rule.TILE_NDIMS).
template <typename T>
int launch_tile_dims(int family, int ndim, const TileArgs<T>& a, int blocks,
                     cudaStream_t stream) {
  switch (ndim) {
    case 3: return launch_tile_ndim<T, 3>(family, a, blocks, stream);
    case 4: return launch_tile_ndim<T, 4>(family, a, blocks, stream);
    case 5: return launch_tile_ndim<T, 5>(family, a, blocks, stream);
    case 6: return launch_tile_ndim<T, 6>(family, a, blocks, stream);
    case 7: return launch_tile_ndim<T, 7>(family, a, blocks, stream);
    case 8: return launch_tile_ndim<T, 8>(family, a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rule
}  // namespace
