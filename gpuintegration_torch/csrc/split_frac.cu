// The crease/jump-aware cut fraction of PAGANI regions, for NVIDIA Hopper
// (sm_90a): the fourth kernel of ops/cuda_rule.py's split route in a crease
// run (Workspace.integrate(crease_split=True)).
//
// The counterpart of gpuintegration_tpu/ops/rule_eval.py:184
// (_split_fraction), which the reference runs in XLA beside its rule
// evaluation; it has no Pallas twin.  Per region it reads the 4 ndim + 1
// collinear rule values of every axis (the centre, orbit 1 at +-a, orbit
// 2 at +-b) from the callable's values, at the strides the callable
// returned them (rows (feval, 1) or planes (1, C) alike), and the split
// axis the contraction wrote into the region's pool slot; it writes the
// cut fraction and the axis, which a confident jump overrides, into the
// same slot.  rule_eval.split_fraction is its plain version: two
// detectors on the four secants of each axis,
//   * a C0 kink between the inner samples: the outer and the inner lines
//     on either side meet at the crease; four gates; the cut at the crease
//     less a margin of 0.08 toward the centre, clipped to [0.12, 0.88];
//   * a jump: an inner gap's secant dominating every flank secant; the cut
//     at that gap's centre edge plus the margin (0.58 or 0.42), the split
//     axis the strongest jump's.
// Every product, quotient, sum and difference is rounded on its own
// (__dmul_rn, __ddiv_rn, __dadd_rn, __dsub_rn and their f32 twins), never
// contracted into a fused multiply-add, and the comparisons and selections
// are the plain version's: so frac and split_dim are EQUAL to it.
//
// One thread a region.  The kernel reads (4 ndim + 1) values and one
// split axis a region and writes a fraction and an axis: at the
// Workspace's 8D f64 chunk of 4096 regions 1.08 MB, 0.35 us of HBM
// time, so a launch costs its launch.  The stencil's slots and the secants'
// abscissae (rule_eval.split_stencil, host constants of the pool's type)
// travel in the kernel's arguments: no table on the card, nothing to copy
// before a launch, so the launch can be captured into a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxNdim = 16;
constexpr int kThreads = 128;
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
  int slots[kMaxNdim][4];    // per axis the slots at -b, -a, +a, +b
  T consts[kMaxNdim][5];     // xam, xap, xam - xbm, 0 - xam, xbp - xap
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rule_split_frac_kernel(const FracArgs<T> a) {
  using R = Rn<T>;
  const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= a.count) return;
  const int64_t slot = real_slot(a.first + r, a.cap, a.n, a.blocked);
  const T* v = a.vals + r * a.sc;
  const T f0 = v[0];
  const int sd = a.split_dim[slot];
  const T half = T(0.5), zero = T(0);
  const T margin = T(kMargin);
  const T lo = T(0.12), hi = T(0.88);
  const T j1_frac = T(0.5 + kMargin), j2_frac = T(0.5 - kMargin);
  T frac_kink = half;
  T best = zero, jfrac = half;
  int jdim = 0;
  for (int d = 0; d < a.ndim; ++d) {
    const T vbm = v[a.slots[d][0] * a.sp], vam = v[a.slots[d][1] * a.sp];
    const T vap = v[a.slots[d][2] * a.sp], vbp = v[a.slots[d][3] * a.sp];
    const T xam = a.consts[d][0], xap = a.consts[d][1];
    const T g1 = R::div(R::sub(vam, vbm), a.consts[d][2]);
    const T g2 = R::div(R::sub(f0, vam), a.consts[d][3]);
    const T g3 = R::div(R::sub(vap, f0), xap);
    const T g4 = R::div(R::sub(vbp, vap), a.consts[d][4]);

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
    const T rel1 = ok1 ? R::div(dn1, sc1 == zero ? T(1) : sc1) : T(-1);
    const T rel2 = ok2 ? R::div(dn2, sc2 == zero ? T(1) : sc2) : T(-1);
    const T xstar = rel1 >= rel2 ? x1 : x2;
    if (d == sd && (ok1 || ok2)) {
      const T y = R::add(half, R::sub(xstar, xstar >= zero ? margin
                                                           : -margin));
      frac_kink = y < lo ? lo : (y > hi ? hi : y);
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
    const T strength = j1 ? a2 : (j2 ? a3 : zero);
    // the first axis of the strongest jump (torch.argmax)
    if (d == 0 || strength > best) {
      best = strength;
      jdim = d;
      jfrac = j1 ? j1_frac : (j2 ? j2_frac : half);
    }
  }
  const bool has_jump = best > zero;
  a.frac[slot] = has_jump ? jfrac : frac_kink;
  a.split_dim[slot] = has_jump ? jdim : sd;
}

template <typename T>
int frac_launch(FracArgs<T>& a, const double* consts, cudaStream_t stream) {
  for (int d = 0; d < a.ndim; ++d)
    for (int k = 0; k < 5; ++k)
      a.consts[d][k] = static_cast<T>(consts[5 * d + k]);
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
    for (int d = 0; d < ndim; ++d)
      for (int k = 0; k < 4; ++k) a.slots[d][k] = slots[4 * d + k];
    return frac_launch<double>(a, consts, s);
  }
  FracArgs<float> a{};
  a.vals = static_cast<const float*>(vals);
  a.frac = static_cast<float*>(frac);
  a.split_dim = split_dim;
  a.sc = sc, a.sp = sp, a.cap = cap, a.n = n, a.first = first;
  a.count = count, a.blocked = blocked, a.ndim = ndim;
  for (int d = 0; d < ndim; ++d)
    for (int k = 0; k < 4; ++k) a.slots[d][k] = slots[4 * d + k];
  return frac_launch<float>(a, consts, s);
}
