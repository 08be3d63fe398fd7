// VEGAS grid-path kernels for NVIDIA Hopper (sm_90a): the f^2 adaptation
// histogram, the bin resolve and the bin-edge lookup.
//
// They replace gpuintegration_tpu/mcubes/pallas_lookup.py::hist_pallas,
// ::bin_resolve_pallas and ::edge_lookup_pallas, and compute what the
// plain PyTorch versions hist_plain, hist_accum_plain, bin_resolve_plain and
// edge_lookup_plain of gpuintegration_torch/mcubes/cuda_lookup.py compute.
// The TPU kernels select table entries with two levels of one-hot
// products because that chip has no gather; here a lookup is a load from
// a table in shared memory.  mcubes/cuda_lookup.py chooses each kernel's
// route by the shape alone (hist_route, resolve_route, edge_route).
//
// Histogram.  out[d, b] = sum over samples n with ia[d, n] - base == b of
// min(f2[n], cap); the accumulating form writes min(acc + that, cap) into
// the accumulator acc, the bits of vegas._hist_accum.  The hazard is float
// atomicAdd: its order changes from run to run, the refined grid would
// change with it, and with the grid every later sample and the final
// estimate.  Neither route has float atomics.  Each adds in an order that
// the indices alone fix, so two launches on one input give the same bits.
// (Fixed-point integer atomics would also repeat, but they quantise bins
// 2^-42 below the chunk's largest value to zero; these are true f32 sums.)
// Bound by bytes: 4 ndim + 4 per sample read.
//   * GROUPED route (hist_grouped_kernel, the main path's).  A block takes
//     a contiguous range of samples for every dimension; f2 is read once,
//     16 bytes a lane, and each of the ndim id rows likewise.  Each warp
//     owns a private row of nbins f32 sums per dimension in shared memory.
//     A warp takes 128 samples at a time, lane l samples 4l..4l+3; in step
//     k of 4 the lanes hold samples 4l+k, ballots over the bits of the bins
//     group the lanes of one bin, the group's lowest lane adds the group's
//     values in lane order and adds that sum to the row.  ndim is compiled
//     in (1..8), so the steps of all dimensions go through together, and a
//     warp's next 128 samples are loaded while it adds these.  Then the
//     warps' rows are summed in warp order; the 8 blocks of a
//     thread-block cluster sum those in
//     block-rank order through distributed shared memory, rank r taking
//     the r-th eighth of the bins, into one partial per cluster; and the
//     last cluster to finish each eighth (an integer ticket per eighth)
//     sums the partials in cluster order and finishes the accumulator.  So
//     a bin's order of addition is: a warp's steps in sample order (group
//     sums in lane order), the warps, the cluster's blocks, the clusters:
//     fixed by indices, never by timing.  How many clusters there are is
//     set by n alone (mcubes/cuda_lookup.py hist_plan), not by the card, so
//     neither is the order.  It is not the generic route's order, so the
//     two agree within rounding, not bitwise.  The ticket
//     words are zero between launches: the last block of an eighth sets
//     its word back to 0, and the wrapper keeps one set of words per CUDA
//     stream, since two launches in flight at once on two streams would
//     count into each other's tickets.  f2 comes in f32, or in f64 and is
//     rounded by __double2float_rn, the bits of .to(float32).
//   * GENERIC route (hist_kernel, the first design).  A block takes one
//     dimension and a fixed range of samples; each of its warps owns a
//     private row of nbins sums and adds its samples 32 at a time, the
//     lanes taking turns in lane order.  The warps' rows are summed in warp
//     order into a (n_blocks, ndim, nbins) buffer that the wrapper sums
//     over blocks; the wrapper also adds and clamps the accumulator.
//
// Bin resolve, per (sample, dimension): ia = clip(int(xn), 1, nbins),
// lo = xi[d, ia-1], hi = xi[d, ia], xo = hi - lo, rc = lo + (xn - ia) * xo.
// xn comes from a tensor, or is formed in the kernel from the Philox stream
// (philox.cuh) as (kg - u) * dxg + 1.  Both that expression and rc are
// written with __fmul_rn/__fadd_rn: contracted to one FMA, a sample on a
// bin edge would land in the other bin than in the plain version.  Both
// routes compute every output by the same operations, so they agree bit
// for bit.  Bound by bytes: 12 per (sample, dimension) written, 4 more read
// when xn is given.
//   * SAMPLE route (resolve_sample_kernel, ndim 1..8 compiled in, the main
//     path's).  A persistent grid, each block filling the edges of all
//     dimensions into shared memory once.  A thread owns 4 consecutive
//     samples: it divides its first sample index by npg and decodes that
//     cube with the 32-bit reciprocal of ng (philox.cuh cube_digits; 64-bit
//     divisions above 2^32 cubes), steps to the next cube by one carry,
//     draws one Philox block per sample and 4 dimensions, and writes rc, xo
//     and ia of its 4 samples as one 16-byte store per dimension.
//   * GENERIC route (resolve_kernel, the first design, every ndim): one
//     thread per (sample, dimension), a 64-bit decode and a Philox block
//     per element, a block per (range, dimension) filling that dimension's
//     edges.
// Drawing xn, both routes read the iteration word of the Philox counter
// from device memory, once a thread: a launch captured in a CUDA graph then
// draws the stream of whatever iteration the card's counter holds when the
// graph replays (vegas's device-resident phases), and the host loop passes
// a counter it fills with its iteration.
//
// Edge lookup, per element of a cube-major (N, ndim) id array:
// (xi[d, ia-1], xi[d, ia]), ia clamped to [1, nbins].  Both outputs are
// copies of table entries, so both routes give the same bits.  Bound by
// bytes: 4 read and 8 written per element.
//   * VECTOR route (edge_vector_kernel, every ndim whose edge pairs fit a
//     block's shared memory; the frozen-grid estimate's).  A persistent
//     grid; each block stages the table once as (lo, hi) pairs per bin, a
//     float2, so one 8-byte shared load gives both edges of an element.  A
//     thread owns 4 consecutive elements: one 16-byte load of ia, one
//     16-byte store each of lo and hi.  Its dimension is carried from
//     element to element and from quad to quad in 32 bits, no modulo in
//     the loop.  Up to 3 head elements before ia's first 16-byte boundary
//     are taken one by one by block 0, the ragged last quad element by
//     element; where lo and hi do not share ia's 16-byte phase (a view of
//     ia at an odd offset) the stores are 4-byte ones.
//   * GENERIC route (edge_kernel, the first design): one thread per
//     element, the table of ndim * (nbins + 1) floats copied by every
//     block of a grid of up to 65536 blocks, a 64-bit modulo per element.
//
// Built by ops/cuda_build.py; called through ctypes (C entry points below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCluster = 8;      // blocks of a grouped-histogram cluster
constexpr int kSegment = 128;    // samples a warp takes at once: 4 a lane
constexpr int kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// Histogram, generic route.

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ ia, const float* __restrict__ f2,
            float* __restrict__ part, long long n, int nbins, int per_block,
            float cap) {
  extern __shared__ float s_rows[];   // (kWarps, nbins)
  const int d = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * nbins; i += kThreads) s_rows[i] = 0.0f;
  __syncthreads();

  float* row = s_rows + warp * nbins;
  const int* ia_d = ia + static_cast<long long>(d) * n;
  const long long start = static_cast<long long>(blockIdx.x) * per_block;
  const long long stop = start + per_block < n ? start + per_block : n;
  for (long long base = start + warp * 32; base < stop; base += kThreads) {
    const long long i = base + lane;
    int bin = -1;
    float v = 0.0f;
    if (i < stop) {
      bin = ia_d[i];
      v = f2[i];
      v = v > cap ? cap : v;      // a NaN stays a NaN, like torch.clamp
    }
    const bool counts = bin >= 0 && bin < nbins;
    for (int turn = 0; turn < 32; ++turn) {
      if (lane == turn && counts) row[bin] += v;
      __syncwarp();
    }
  }
  __syncthreads();

  float* out = part + (static_cast<long long>(blockIdx.x) * gridDim.y + d)
                          * nbins;
  for (int b = threadIdx.x; b < nbins; b += kThreads) {
    float s = s_rows[b];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += s_rows[w * nbins + b];
    out[b] = s;
  }
}

// ---------------------------------------------------------------------------
// Histogram, grouped route.

struct HistArgs {
  const int* ia;       // (ndim, n) bin ids, base-based
  const void* f2;      // (n,) f32 or f64
  float* part;         // (clusters, ndim * nbins) cluster partials
  float* out;          // (ndim, nbins): the accumulator, or the result
  int* tickets;        // (kCluster,) zero between launches
  long long n;
  int ndim, nbins, base;
  int accumulate;      // out = min(out + sum, cap), else out = sum
  int vec;             // n % 4 == 0 and every pointer 16-byte aligned
  float cap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) {
  return __double2float_rn(x);
}

// min(f2, cap) of samples s0..s0+3 (0 beyond n; a NaN stays a NaN).
template <typename T>
__device__ __forceinline__ void load_values(const T* __restrict__ f2,
                                            long long s0, long long n,
                                            bool vec, float cap,
                                            float (&v)[4]) {
  if (vec && s0 < n) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(f2 + s0);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const double2 x = *reinterpret_cast<const double2*>(f2 + s0);
      const double2 y = *reinterpret_cast<const double2*>(f2 + s0 + 2);
      v[0] = to_f32(x.x); v[1] = to_f32(x.y);
      v[2] = to_f32(y.x); v[3] = to_f32(y.y);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = s0 + k < n ? to_f32(f2[s0 + k]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = v[k] > cap ? cap : v[k];
}

// Bins of samples s0..s0+3 in one id row, -1 beyond n.
__device__ __forceinline__ void load_bins(const int* __restrict__ row,
                                          long long s0, long long n, bool vec,
                                          int base, int (&bin)[4]) {
  if (vec && s0 < n) {
    const int4 x = *reinterpret_cast<const int4*>(row + s0);
    bin[0] = x.x - base; bin[1] = x.y - base;
    bin[2] = x.z - base; bin[3] = x.w - base;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) bin[k] = s0 + k < n ? row[s0 + k] - base : -1;
  }
}

// A warp's 128 samples seg*128 .. seg*128+127, lane l holding 4l..4l+3:
// their values and, per dimension, their bins.
template <int NDIM, typename T>
__device__ __forceinline__ void load_segment(const HistArgs& a, const T* f2,
                                             long long seg, int lane,
                                             float (&v)[4],
                                             int (&bin)[NDIM][4]) {
  const long long s0 = seg * kSegment + 4 * lane;
  load_values(f2, s0, a.n, a.vec, a.cap, v);
#pragma unroll
  for (int d = 0; d < NDIM; ++d)
    load_bins(a.ia + d * a.n, s0, a.n, a.vec, a.base, bin[d]);
}

// One step of a warp, every dimension at once: lane l adds v to row d at
// bin[d].  Per dimension, the lanes of one bin are grouped; the group's
// lowest lane sums their values in lane order and adds the sum to the row.
// A lane with a bin outside [0, nbins) adds nothing.  The groups come from
// one ballot per bit of the bins' spread over the warp: __match_any_sync
// computes the same masks, but the kernel was slower with it on an H100.
// The dimensions touch different rows, so their steps go through together.
template <int NDIM>
__device__ __forceinline__ void add_grouped(float* rows, int nbins,
                                            const int (&bin)[NDIM], float v,
                                            int lane) {
  bool counts[NDIM];
  unsigned rel[NDIM], group[NDIM];
  int bits = 0;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    // the key: the bin, or nbins for a lane that adds nothing
    counts[d] = bin[d] >= 0 && bin[d] < nbins;
    const unsigned key = counts[d] ? bin[d] : nbins;
    const unsigned lo = __reduce_min_sync(kFull, key);
    const unsigned hi = __reduce_max_sync(kFull, key);
    rel[d] = key - lo;
    bits = max(bits, 32 - __clz(hi - lo));
    group[d] = kFull;
  }
  for (int b = 0; b < bits; ++b) {
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const bool one = (rel[d] >> b) & 1u;
      const unsigned voters = __ballot_sync(kFull, one);
      group[d] &= one ? voters : ~voters;
    }
  }
  bool adds[NDIM];
  unsigned rest[NDIM];
  float s[NDIM];
  bool more = false;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    adds[d] = counts[d] && (group[d] & ((1u << lane) - 1u)) == 0u;
    rest[d] = adds[d] ? group[d] & (group[d] - 1u) : 0u;
    s[d] = v;
    more |= rest[d] != 0u;
  }
  while (__any_sync(kFull, more)) {
    more = false;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const int src = rest[d] ? __ffs(rest[d]) - 1 : lane;
      const float x = __shfl_sync(kFull, v, src);
      if (rest[d]) {
        s[d] += x;
        rest[d] &= rest[d] - 1u;
      }
      more |= rest[d] != 0u;
    }
  }
  float old[NDIM];
#pragma unroll
  for (int d = 0; d < NDIM; ++d)
    old[d] = adds[d] ? rows[d * nbins + bin[d]] : 0.0f;
#pragma unroll
  for (int d = 0; d < NDIM; ++d)
    if (adds[d]) rows[d * nbins + bin[d]] = old[d] + s[d];
  __syncwarp();        // the next step's reads see this step's sums
}

template <int NDIM, typename T>
__global__ void __launch_bounds__(kThreads)
hist_grouped_kernel(const HistArgs a) {
  extern __shared__ float4 s_hist[];
  __shared__ int s_last;
  float* s_rows = reinterpret_cast<float*>(s_hist);  // (warps, NDIM, nbins)
  cg::cluster_group cluster = cg::this_cluster();
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = NDIM * a.nbins;
  for (int i = threadIdx.x; i < warps * rows; i += blockDim.x) s_rows[i] = 0.0f;
  __syncthreads();

  // this block's contiguous range of 128-sample segments, a warp taking
  // every warps-th; the next segment's loads go out before this one's adds
  const T* f2 = static_cast<const T*>(a.f2);
  const long long segments = (a.n + kSegment - 1) / kSegment;
  const long long per_block = (segments + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per_block;
  const long long stop = min(segments, first + per_block);
  float* own = s_rows + warp * rows;
  float v[4];
  int bin[NDIM][4];
  long long seg = first + warp;
  if (seg < stop) load_segment<NDIM>(a, f2, seg, lane, v, bin);
  for (; seg < stop; seg += warps) {
    float next_v[4];
    int next_bin[NDIM][4];
    if (seg + warps < stop)
      load_segment<NDIM>(a, f2, seg + warps, lane, next_v, next_bin);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int step_bin[NDIM];
#pragma unroll
      for (int d = 0; d < NDIM; ++d) step_bin[d] = bin[d][k];
      add_grouped<NDIM>(own, a.nbins, step_bin, v[k], lane);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = next_v[k];
#pragma unroll
      for (int d = 0; d < NDIM; ++d) bin[d][k] = next_bin[d][k];
    }
  }
  __syncthreads();

  // the warps' rows in warp order, into warp 0's
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float s = s_rows[i];
    for (int w = 1; w < warps; ++w) s += s_rows[w * rows + i];
    s_rows[i] = s;
  }
  cluster.sync();

  // rank r sums the r-th eighth of the bins over the cluster's blocks, in
  // rank order, into the cluster's partial
  const unsigned rank = cluster.block_rank();
  const int share = (rows + kCluster - 1) / kCluster;
  const int lo = static_cast<int>(rank) * share;
  const int hi = min(rows, lo + share);
  const int clusters = gridDim.x / kCluster;
  float* part = a.part + static_cast<long long>(blockIdx.x / kCluster) * rows;
  const float* peer[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) peer[q] = cluster.map_shared_rank(s_rows, q);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float s = peer[0][i];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) s += peer[q][i];
    part[i] = s;
  }
  cluster.sync();      // no block leaves while a peer reads its rows

  // the last cluster to finish this eighth sums the partials in cluster
  // order and finishes the output
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.tickets + rank, 1) == clusters - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float s = __ldcg(a.part + i);
    int c = 1;
    for (; c + 8 <= clusters; c += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = __ldcg(a.part + static_cast<long long>(c + j) * rows + i);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += x[j];
    }
    for (; c < clusters; ++c)
      s += __ldcg(a.part + static_cast<long long>(c) * rows + i);
    if (a.accumulate) {
      const float t = a.out[i] + s;
      s = t > a.cap ? a.cap : t;
    }
    a.out[i] = s;
  }
  if (threadIdx.x == 0) a.tickets[rank] = 0;
}

// Let ``kernel`` have ``smem`` bytes of dynamic shared memory: above the
// default 48 KB the attribute is raised, once for each kernel and size, so
// that a launch spends no host time on it.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  static size_t granted = 48 * 1024;   // one for each kernel
  if (smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) granted = smem;
  return e;
}

// One launch of the grouped kernel for NDIM and f2 of type T, on
// ``clusters`` clusters of kCluster blocks.
template <int NDIM, typename T>
cudaError_t grouped_launch(const HistArgs& a, int warps, int clusters,
                           cudaStream_t stream) {
  const auto kernel = hist_grouped_kernel<NDIM, T>;
  // the rows and the kernel's own static shared memory (s_last)
  static const size_t fixed = [] {
    cudaFuncAttributes f{};
    return cudaFuncGetAttributes(&f, hist_grouped_kernel<NDIM, T>) == cudaSuccess
               ? f.sharedSizeBytes : size_t{0};
  }();
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * NDIM * a.nbins;
  if (smem + fixed > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<hist_grouped_kernel<NDIM, T>>(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t grouped_by_ndim(const HistArgs& a, int warps, int clusters,
                            cudaStream_t stream) {
  switch (a.ndim) {   // the dimensions the grouped route is compiled for
    case 1: return grouped_launch<1, T>(a, warps, clusters, stream);
    case 2: return grouped_launch<2, T>(a, warps, clusters, stream);
    case 3: return grouped_launch<3, T>(a, warps, clusters, stream);
    case 4: return grouped_launch<4, T>(a, warps, clusters, stream);
    case 5: return grouped_launch<5, T>(a, warps, clusters, stream);
    case 6: return grouped_launch<6, T>(a, warps, clusters, stream);
    case 7: return grouped_launch<7, T>(a, warps, clusters, stream);
    case 8: return grouped_launch<8, T>(a, warps, clusters, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Bin resolve.

struct ResolveArgs {
  const float* xi;     // (ndim, nbins + 1) bin edges
  const float* xn;     // (ndim, n) grid coordinates, or null: Philox
  float* rc;           // (ndim, n)
  float* xo;           // (ndim, n)
  int* ia;             // (ndim, n) or null
  long long n;         // samples = chunk_cubes * npg
  long long cube0, ncubes;
  int ndim, nbins, ng, npg;
  float dxg;           // bin units per stratification interval
  unsigned key0, key1;
  const unsigned* iteration;   // drawing xn: the counter's iteration word,
                               // in device memory (a counter a graph
                               // advances)
  unsigned recip_ng, recip_npg;   // sample route: min(floor(2^32 / x), 2^32-1)
  int vec;             // sample route: n % 4 == 0, pointers 16-byte aligned
};

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const ResolveArgs a) {
  extern __shared__ float s_xi[];      // (nbins + 1,) edges of dimension d
  const int d = blockIdx.y;
  const unsigned it = a.xn ? 0u : __ldg(a.iteration);
  for (int i = threadIdx.x; i <= a.nbins; i += kThreads)
    s_xi[i] = a.xi[d * (a.nbins + 1) + i];
  __syncthreads();

  unsigned long long place = 1;        // ng^(ndim-1-d): the digit's weight
  for (int j = d + 1; j < a.ndim; ++j) place *= static_cast<unsigned>(a.ng);

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < a.n; i += stride) {
    const long long o = d * a.n + i;
    float xn;
    if (a.xn) {
      xn = a.xn[o];
    } else {
      const long long cube = a.cube0 + i / a.npg;
      const int slot = static_cast<int>(i % a.npg);
      if (cube >= a.ncubes) {          // beyond the lattice: weight 0
        a.rc[o] = 0.0f;
        a.xo[o] = 0.0f;
        if (a.ia) a.ia[o] = 1;
        continue;
      }
      const unsigned long long digit =
          (static_cast<unsigned long long>(cube) / place)
          % static_cast<unsigned>(a.ng);
      const float kg = static_cast<float>(digit + 1);
      const float u = word_uniform(block_word(
          vegas_block(cube, it, slot, d, a.key0, a.key1), d));
      xn = __fadd_rn(__fmul_rn(kg - u, a.dxg), 1.0f);
    }
    int bin = static_cast<int>(xn);
    bin = min(max(bin, 1), a.nbins);
    const float lo = s_xi[bin - 1], hi = s_xi[bin];
    const float width = hi - lo;
    a.rc[o] = __fadd_rn(lo, __fmul_rn(xn - static_cast<float>(bin), width));
    a.xo[o] = width;
    if (a.ia) a.ia[o] = bin;
  }
}

// rc, xo, ia of samples i0..i0+live-1 of dimension d from their xn and the
// dimension's edges; samples not ``inside`` the lattice get 0, 0, 1.
__device__ __forceinline__ void resolve_four(const ResolveArgs& a,
                                             const float* edges, int d,
                                             unsigned i0, int live,
                                             const float (&xn)[4],
                                             const bool (&inside)[4]) {
  float rc[4], xo[4];
  int ia[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int bin = static_cast<int>(xn[k]);
    bin = min(max(bin, 1), a.nbins);
    const float lo = edges[bin - 1], hi = edges[bin];
    const float width = hi - lo;
    rc[k] = inside[k]
        ? __fadd_rn(lo, __fmul_rn(xn[k] - static_cast<float>(bin), width))
        : 0.0f;
    xo[k] = inside[k] ? width : 0.0f;
    ia[k] = inside[k] ? bin : 1;
  }
  const long long o = static_cast<long long>(d) * a.n + i0;
  if (a.vec && live == 4) {
    *reinterpret_cast<float4*>(a.rc + o) = make_float4(rc[0], rc[1], rc[2], rc[3]);
    *reinterpret_cast<float4*>(a.xo + o) = make_float4(xo[0], xo[1], xo[2], xo[3]);
    if (a.ia)
      *reinterpret_cast<int4*>(a.ia + o) = make_int4(ia[0], ia[1], ia[2], ia[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < live) {
        a.rc[o + k] = rc[k];
        a.xo[o + k] = xo[k];
        if (a.ia) a.ia[o + k] = ia[k];
      }
    }
  }
}

template <int NDIM, bool DRAW>
__global__ void __launch_bounds__(kThreads)
resolve_sample_kernel(const ResolveArgs a) {
  extern __shared__ float s_edges[];   // (NDIM, nbins + 1)
  const unsigned it = DRAW ? __ldg(a.iteration) : 0u;
  const int row = a.nbins + 1;
  for (int i = threadIdx.x; i < NDIM * row; i += kThreads) s_edges[i] = a.xi[i];
  __syncthreads();

  const unsigned n = static_cast<unsigned>(a.n);     // < 2^31
  const unsigned quads = (n + 3u) >> 2;
  const unsigned ng = static_cast<unsigned>(a.ng);
  const unsigned npg = static_cast<unsigned>(a.npg);
  const bool small = a.ncubes <= 0xffffffffLL;
  for (unsigned q = blockIdx.x * kThreads + threadIdx.x; q < quads;
       q += gridDim.x * kThreads) {
    const unsigned i0 = q << 2;
    const int live = n - i0 < 4u ? static_cast<int>(n - i0) : 4;
    if (!DRAW) {
      const bool inside[4] = {true, true, true, true};
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        const float* src = a.xn + static_cast<long long>(d) * a.n + i0;
        float xn[4];
        if (a.vec && live == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          xn[0] = x.x; xn[1] = x.y; xn[2] = x.z; xn[3] = x.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) xn[k] = k < live ? src[k] : 1.0f;
        }
        resolve_four(a, s_edges + d * row, d, i0, live, xn, inside);
      }
      continue;
    }

    // the cube and slot of each of the 4 samples: one division for the
    // first, then steps; the digits decoded once, then carried
    unsigned slot;
    long long cube = a.cube0 + recip_divmod(i0, npg, a.recip_npg, slot);
    unsigned digit[NDIM];
    if (cube < a.ncubes) {
      cube_digits<NDIM>(cube, ng, a.recip_ng, small, digit);
    } else {
#pragma unroll
      for (int d = 0; d < NDIM; ++d) digit[d] = 0;
    }
    long long cubes[4];
    int slots[4];
    bool inside[4];
    float kg[4][NDIM];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > 0 && ++slot == npg) {
        slot = 0;
        ++cube;
#pragma unroll
        for (int d = NDIM - 1; d >= 0; --d) {
          if (++digit[d] < ng) break;
          digit[d] = 0;
        }
      }
      cubes[k] = cube;
      slots[k] = static_cast<int>(slot);
      inside[k] = cube < a.ncubes;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) kg[k][d] = static_cast<float>(digit[d] + 1u);
    }

#pragma unroll
    for (int g = 0; g < (NDIM + 3) / 4; ++g) {
      uint4 block[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        block[k] = vegas_block(cubes[k], it, slots[k], 4 * g, a.key0, a.key1);
#pragma unroll
      for (int d = 4 * g; d < 4 * g + 4 && d < NDIM; ++d) {
        float xn[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float u = word_uniform(block_word(block[k], d));
          xn[k] = __fadd_rn(__fmul_rn(kg[k][d] - u, a.dxg), 1.0f);
        }
        resolve_four(a, s_edges + d * row, d, i0, live, xn, inside);
      }
    }
  }
}

// The sample route's kernel for NDIM (drawing xn, or given it) on
// ``blocks`` blocks.
template <int NDIM>
cudaError_t launch_sample(const ResolveArgs& a, size_t smem, int blocks,
                          cudaStream_t stream) {
  const auto kernel = a.xn ? resolve_sample_kernel<NDIM, false>
                           : resolve_sample_kernel<NDIM, true>;
  const cudaError_t e =
      a.xn ? allow_smem<resolve_sample_kernel<NDIM, false>>(smem)
           : allow_smem<resolve_sample_kernel<NDIM, true>>(smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// How many blocks of ``Kernel`` with ``smem`` bytes of dynamic shared
// memory the card holds at once (> 0), or minus a CUDA error.
template <auto Kernel>
int resident_blocks(size_t smem) {
  cudaError_t e = allow_smem<Kernel>(smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per_sm > 0 ? sms * per_sm
                          : -static_cast<int>(cudaErrorInvalidConfiguration);
}

template <int NDIM>
int sample_resident_blocks(bool draw, size_t smem) {
  return draw ? resident_blocks<resolve_sample_kernel<NDIM, true>>(smem)
              : resident_blocks<resolve_sample_kernel<NDIM, false>>(smem);
}

// ---------------------------------------------------------------------------
// Edge lookup.

__global__ void __launch_bounds__(kThreads)
edge_kernel(const float* __restrict__ xi, const int* __restrict__ ia,
            float* __restrict__ lo, float* __restrict__ hi, long long total,
            int ndim, int nbins) {
  extern __shared__ float s_xi[];      // (ndim, nbins + 1)
  for (int i = threadIdx.x; i < ndim * (nbins + 1); i += kThreads)
    s_xi[i] = xi[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       e < total; e += stride) {
    const int d = static_cast<int>(e % ndim);
    const int bin = min(max(ia[e], 1), nbins);
    const float* row = s_xi + d * (nbins + 1);
    lo[e] = row[bin - 1];
    hi[e] = row[bin];
  }
}

struct EdgeArgs {
  const float* xi;     // (ndim, nbins + 1) bin edges
  const int* ia;       // (total,) bin ids, element e of dimension e % ndim
  float* lo;           // (total,)
  float* hi;           // (total,)
  long long total;
  int ndim, nbins;
  int head;            // elements before ia's first 16-byte boundary, 0..3
  int vec_out;         // lo + head and hi + head are 16-byte aligned
};

// The edge pair of one element: ``pairs`` (ndim, nbins) of (lo, hi).
__device__ __forceinline__ float2 edge_pair(const float2* pairs, int d,
                                            int nbins, int id) {
  return pairs[d * nbins + min(max(id, 1), nbins) - 1];
}

__global__ void __launch_bounds__(kThreads)
edge_vector_kernel(const EdgeArgs a) {
  extern __shared__ float2 s_pair[];   // (ndim, nbins): (xi[d, b], xi[d, b+1])
  const int nb = a.nbins;
  for (int i = threadIdx.x; i < a.ndim * nb; i += kThreads) {
    const int d = i / nb;
    const float* src = a.xi + d + i;   // xi[d, i - d * nb]
    s_pair[i] = make_float2(src[0], src[1]);
  }
  __syncthreads();

  if (blockIdx.x == 0 && threadIdx.x < a.head) {
    const int e = threadIdx.x;
    const float2 p = edge_pair(s_pair, e % a.ndim, nb, a.ia[e]);
    a.lo[e] = p.x;
    a.hi[e] = p.y;
  }
  // the body: quads of 4 elements from ia's first 16-byte boundary; the
  // wrapper keeps their count below 2^31, so q + stride cannot wrap
  const long long body = a.total - a.head;
  const unsigned quads = static_cast<unsigned>((body + 3) >> 2);
  const int* ia = a.ia + a.head;
  float* lo = a.lo + a.head;
  float* hi = a.hi + a.head;
  const unsigned stride = gridDim.x * kThreads;
  unsigned q = blockIdx.x * kThreads + threadIdx.x;
  // the dimension of the quad's first element, and what a step adds to it
  int d = static_cast<int>((a.head + 4ull * q) % a.ndim);
  const int step = static_cast<int>((4ull * stride) % a.ndim);
  for (; q < quads; q += stride) {
    const long long e0 = 4ll * q;
    const int live = body - e0 < 4 ? static_cast<int>(body - e0) : 4;
    int id[4];
    if (live == 4) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(ia + e0));
      id[0] = v.x; id[1] = v.y; id[2] = v.z; id[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) id[k] = k < live ? ia[e0 + k] : 1;
    }
    float2 p[4];
    int dk = d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = edge_pair(s_pair, dk, nb, id[k]);
      if (++dk == a.ndim) dk = 0;
    }
    if (live == 4 && a.vec_out) {
      __stcs(reinterpret_cast<float4*>(lo + e0),
             make_float4(p[0].x, p[1].x, p[2].x, p[3].x));
      __stcs(reinterpret_cast<float4*>(hi + e0),
             make_float4(p[0].y, p[1].y, p[2].y, p[3].y));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < live) {
          lo[e0 + k] = p[k].x;
          hi[e0 + k] = p[k].y;
        }
      }
    }
    d += step;
    if (d >= a.ndim) d -= a.ndim;
  }
}

}  // namespace

// C entry points for ctypes.  Every pointer is a device pointer.  Each
// launch returns cudaGetLastError() after its launch (0 on success) and
// never synchronises.

// Generic histogram route.  part: (n_blocks, ndim, nbins) scratch,
// n_blocks = ceil(n / per_block).
extern "C" int vegas_hist_launch(const void* ia, const void* f2, void* part,
                                 long long n, int ndim, int nbins,
                                 int per_block, int n_blocks, float cap,
                                 void* stream) {
  if (n < 1 || ndim < 1 || nbins < 1 || per_block < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * nbins;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hist_kernel<<<dim3(n_blocks, ndim), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ia), static_cast<const float*>(f2),
      static_cast<float*>(part), n, nbins, per_block, cap);
  return static_cast<int>(cudaGetLastError());
}

// Grouped histogram route (ndim 1..8): one launch of ``clusters`` clusters
// of kCluster blocks of ``warps`` warps, returning 0 or the CUDA error.
// part: (clusters, ndim * nbins) scratch; out: (ndim, nbins), read too when
// ``accumulate``; tickets: kCluster int words, zero.
extern "C" int vegas_hist_grouped_launch(
    const void* ia, const void* f2, int f2_f64, void* part, void* out,
    void* tickets, long long n, int ndim, int nbins, int base, int accumulate,
    int vec, int warps, int clusters, float cap, void* stream) {
  if (n < 1 || ndim < 1 || ndim > 8 || nbins < 1 || warps < 1 ||
      warps > kWarps || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  HistArgs a;
  a.ia = static_cast<const int*>(ia);
  a.f2 = f2;
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  a.tickets = static_cast<int*>(tickets);
  a.n = n;
  a.ndim = ndim;
  a.nbins = nbins;
  a.base = base;
  a.accumulate = accumulate;
  a.vec = vec;
  a.cap = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      f2_f64 ? grouped_by_ndim<double>(a, warps, clusters, s)
             : grouped_by_ndim<float>(a, warps, clusters, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Bin resolve.  xn null: the coordinates are drawn in the kernel for the
// chunk of n / npg cubes that starts at cube0, from the stream of the
// iteration word at the device address ``iteration`` (read when the kernel
// runs; not null).  route 0 is the generic
// kernel on n_blocks x ndim blocks; route 1 the sample kernel (ndim 1..8,
// n < 2^31) on n_blocks blocks, with recip_ng and recip_npg =
// min(floor(2^32 / x), 2^32 - 1) and vec = n % 4 == 0 with every pointer
// 16-byte aligned.
extern "C" int vegas_resolve_launch(int route, const void* xi, const void* xn,
                                    void* rc, void* xo, void* ia, long long n,
                                    long long cube0, long long ncubes,
                                    int ndim, int nbins, int ng, int npg,
                                    float dxg, unsigned key0, unsigned key1,
                                    const void* iteration, unsigned recip_ng,
                                    unsigned recip_npg, int vec, int n_blocks,
                                    void* stream) {
  if (n < 1 || ndim < 1 || nbins < 1 || ng < 1 || npg < 1 || n_blocks < 1 ||
      route < 0 || route > 1 || (!xn && !iteration))
    return static_cast<int>(cudaErrorInvalidValue);
  ResolveArgs a;
  a.xi = static_cast<const float*>(xi);
  a.xn = static_cast<const float*>(xn);
  a.rc = static_cast<float*>(rc);
  a.xo = static_cast<float*>(xo);
  a.ia = static_cast<int*>(ia);
  a.n = n;
  a.cube0 = cube0;
  a.ncubes = ncubes;
  a.ndim = ndim;
  a.nbins = nbins;
  a.ng = ng;
  a.npg = npg;
  a.dxg = dxg;
  a.key0 = key0;
  a.key1 = key1;
  a.iteration = static_cast<const unsigned*>(iteration);
  a.recip_ng = recip_ng;
  a.recip_npg = recip_npg;
  a.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const size_t smem = sizeof(float) * ndim * (nbins + 1);
    if (smem > static_cast<size_t>(kMaxSmem) || n >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e;
    switch (ndim) {   // the dimensions the sample route is compiled for
      case 1: e = launch_sample<1>(a, smem, n_blocks, s); break;
      case 2: e = launch_sample<2>(a, smem, n_blocks, s); break;
      case 3: e = launch_sample<3>(a, smem, n_blocks, s); break;
      case 4: e = launch_sample<4>(a, smem, n_blocks, s); break;
      case 5: e = launch_sample<5>(a, smem, n_blocks, s); break;
      case 6: e = launch_sample<6>(a, smem, n_blocks, s); break;
      case 7: e = launch_sample<7>(a, smem, n_blocks, s); break;
      case 8: e = launch_sample<8>(a, smem, n_blocks, s); break;
      default: e = cudaErrorInvalidValue;
    }
    return static_cast<int>(e);
  }
  const size_t smem = sizeof(float) * (nbins + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<<<dim3(n_blocks, ndim), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Edge lookup.  ia, lo, hi: (N, ndim) cube-major, total = N * ndim
// elements.  route 0 is the generic kernel on n_blocks blocks; route 1 the
// vector kernel on n_blocks blocks, with ``head`` (0..3) elements before
// ia's first 16-byte boundary, ``vec_out`` = lo + head and hi + head
// 16-byte aligned, and fewer than 2^31 quads after the head.
extern "C" int vegas_edge_launch(int route, const void* xi, const void* ia,
                                 void* lo, void* hi, long long total, int ndim,
                                 int nbins, int head, int vec_out,
                                 int n_blocks, void* stream) {
  if (total < 1 || ndim < 1 || nbins < 1 || n_blocks < 1 || route < 0 ||
      route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const size_t smem = sizeof(float2) * ndim * nbins;
    if (smem > static_cast<size_t>(kMaxSmem) || head < 0 || head > 3 ||
        head > total || ((total - head + 3) >> 2) >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = allow_smem<edge_vector_kernel>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    EdgeArgs a;
    a.xi = static_cast<const float*>(xi);
    a.ia = static_cast<const int*>(ia);
    a.lo = static_cast<float*>(lo);
    a.hi = static_cast<float*>(hi);
    a.total = total;
    a.ndim = ndim;
    a.nbins = nbins;
    a.head = head;
    a.vec_out = vec_out;
    edge_vector_kernel<<<n_blocks, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * ndim * (nbins + 1);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem<edge_kernel>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  edge_kernel<<<n_blocks, kThreads, smem, s>>>(
      static_cast<const float*>(xi), static_cast<const int*>(ia),
      static_cast<float*>(lo), static_cast<float*>(hi), total, ndim, nbins);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of a persistent-grid kernel the card holds at once for
// ndim dimensions and nbins bins (> 0), or minus a CUDA error; launches
// nothing.  kernel 0 is the bin resolve's sample route given xn, 1 the
// same drawing xn, 2 the edge lookup's vector route.
extern "C" int vegas_resident_blocks(int kernel, int ndim, int nbins) {
  const int invalid = -static_cast<int>(cudaErrorInvalidValue);
  if (ndim < 1 || nbins < 1 || kernel < 0 || kernel > 2) return invalid;
  if (kernel == 2) {
    const size_t smem = sizeof(float2) * ndim * nbins;
    if (smem > static_cast<size_t>(kMaxSmem)) return invalid;
    return resident_blocks<edge_vector_kernel>(smem);
  }
  const size_t smem = sizeof(float) * ndim * (nbins + 1);
  if (smem > static_cast<size_t>(kMaxSmem)) return invalid;
  const bool draw = kernel == 1;
  switch (ndim) {   // the dimensions the sample route is compiled for
    case 1: return sample_resident_blocks<1>(draw, smem);
    case 2: return sample_resident_blocks<2>(draw, smem);
    case 3: return sample_resident_blocks<3>(draw, smem);
    case 4: return sample_resident_blocks<4>(draw, smem);
    case 5: return sample_resident_blocks<5>(draw, smem);
    case 6: return sample_resident_blocks<6>(draw, smem);
    case 7: return sample_resident_blocks<7>(draw, smem);
    case 8: return sample_resident_blocks<8>(draw, smem);
    default: return invalid;
  }
}
