// The crease/jump-aware cut fraction of PAGANI regions, for NVIDIA Hopper
// (sm_90a), as a kernel of its own: rule_split_frac_kernel, launched by
// ops/cuda_rule.py::split_frac on any rule values.
//
// The counterpart of gpuintegration_tpu/ops/rule_eval.py:184
// (_split_fraction), which the reference runs in XLA beside its rule
// evaluation; it has no Pallas twin.  A crease run
// (Workspace.integrate(crease_split=True)) does not launch it: the kernels
// that already hold a region's collinear values compute the fraction in
// their epilogues (the fused Genz kernels of rule_eval.cu, the split
// route's scalar contractions of rule_split.cu), with the device functions
// of split_frac.cuh that this kernel runs too.  So this kernel is the check
// of those folded forms: on the same values they must give its bits.
//
// Per region it reads the 4 ndim + 1 collinear rule values of every axis
// (the centre, orbit 1 at +-a, orbit 2 at +-b) at the strides the values
// lie (rows (feval, 1) or planes (1, C) alike) and the split axis in the
// region's pool slot, and writes the cut fraction and the axis, which a
// confident jump overrides, into the same slot.  rule_eval.split_fraction
// is its plain version, EQUAL to it (split_frac.cuh says why).
//
// One thread a region.  The kernel reads (4 ndim + 1) values and one
// split axis a region and writes a fraction and an axis: at the
// Workspace's 8D f64 chunk of 4096 regions 1.15 MB, 0.34 us of HBM
// time, so a launch costs its launch.  The stencil's slots and the secants'
// abscissae (rule_eval.split_stencil, host constants of the pool's type)
// travel in the kernel's arguments: no table on the card, nothing to copy
// before a launch, so the launch can be captured into a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

#include "split_frac.cuh"

namespace {

constexpr int kMaxNdim = sfrac::kMaxNdim;
constexpr int kThreads = 128;

// The pool slot of real region r: [0, n) or, blocked, the first n/2 slots
// of each static half (region_pool.block_mask).
__device__ __forceinline__ int64_t real_slot(int64_t r, int64_t cap,
                                             int64_t n, int blocked) {
  const int64_t half_n = n / 2;
  return (blocked && r >= half_n) ? cap / 2 + (r - half_n) : r;
}

template <typename T>
struct FracArgs {
  const T* vals;       // (count, feval) at strides (sc, sp)
  int* split_dim;      // (cap,): read, and overwritten where a jump fires
  T* frac;             // (cap,)
  int64_t sc, sp, cap, n, first, count;
  int blocked, ndim;
  sfrac::Stencil<T> st;
};

// One thread a region: the per-region form of split_frac.cuh on the
// region's values at the chunk's strides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rule_split_frac_kernel(const FracArgs<T> a) {
  const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= a.count) return;
  const int64_t slot = real_slot(a.first + r, a.cap, a.n, a.blocked);
  const T* v = a.vals + r * a.sc;
  const int64_t sp = a.sp;
  int sd = a.split_dim[slot];
  const T frac =
      sfrac::region_frac([&](int p) { return v[p * sp]; }, a.ndim, a.st, sd);
  a.frac[slot] = frac;
  a.split_dim[slot] = sd;
}

template <typename T>
int frac_launch(FracArgs<T>& a, const int* slots, const double* consts,
                cudaStream_t stream) {
  sfrac::load_stencil(a.st, a.ndim, slots, consts);
  const int64_t blocks = (a.count + kThreads - 1) / kThreads;
  rule_split_frac_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes.  ``vals``, ``split_dim`` and ``frac`` are
// device pointers; ``slots`` (ndim, 4) int32 and ``consts`` (ndim, 5)
// float64 (values of the working type, so exact) are host arrays, copied
// into the launch's arguments.  Walks the real regions first .. first +
// count - 1 of a pool of ``n`` real regions in ``cap`` slots (blocked: the
// first n/2 of each half), reading vals (count, feval) at strides (sc, sp)
// in elements and the split axis at each region's pool slot, writing frac
// and split_dim there and nowhere else.  Returns cudaGetLastError() after
// the launch (0 on success) and never synchronises.
extern "C" int rule_split_frac_launch(
    int is_double, int ndim, long long cap, long long n, int blocked,
    long long first, long long count, long long sc, long long sp,
    const int* slots, const double* consts, const void* vals, int* split_dim,
    void* frac, void* stream) {
  if (ndim < 2 || ndim > kMaxNdim || n > cap || first < 0 || count < 1 ||
      first + count > n || (blocked && (n % 2 || cap % 2)) ||
      (count + kThreads - 1) / kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    FracArgs<double> a{};
    a.vals = static_cast<const double*>(vals);
    a.frac = static_cast<double*>(frac);
    a.split_dim = split_dim;
    a.sc = sc, a.sp = sp, a.cap = cap, a.n = n, a.first = first;
    a.count = count, a.blocked = blocked, a.ndim = ndim;
    return frac_launch<double>(a, slots, consts, s);
  }
  FracArgs<float> a{};
  a.vals = static_cast<const float*>(vals);
  a.frac = static_cast<float*>(frac);
  a.split_dim = split_dim;
  a.sc = sc, a.sp = sp, a.cap = cap, a.n = n, a.first = first;
  a.count = count, a.blocked = blocked, a.ndim = ndim;
  return frac_launch<float>(a, slots, consts, s);
}
