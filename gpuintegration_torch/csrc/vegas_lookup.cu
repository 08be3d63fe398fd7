// VEGAS grid-path kernels for NVIDIA Hopper (sm_90a): the f^2 adaptation
// histogram, the bin resolve and the bin-edge lookup.
//
// They replace gpuintegration_tpu/mcubes/pallas_lookup.py::hist_pallas,
// ::bin_resolve_pallas and ::edge_lookup_pallas, and compute what the
// plain PyTorch versions hist_plain, bin_resolve_plain and
// edge_lookup_plain of gpuintegration_torch/mcubes/cuda_lookup.py compute.
// The TPU kernels select table entries with two levels of one-hot
// products because that chip has no gather; here a lookup is a load from
// a table in shared memory.
//
// Histogram (hist_kernel).  out[d, b] = sum over samples n with
// ia[d, n] == b of min(f2[n], cap).  The hazard is float atomicAdd: its
// order changes from run to run, the refined grid would change with it,
// and with the grid every later sample and the final estimate.  Design:
// no atomics.  A block takes one dimension and a fixed range of samples;
// each of its warps owns a private row of nbins sums in shared memory and
// adds its samples 32 at a time, the lanes taking turns in lane order, so
// two samples of one bin are always added in the same order.  The warps'
// rows are then summed in warp order into a (n_blocks, ndim, nbins)
// buffer that the wrapper sums over blocks.  Two launches on one input
// give the same bits.  (Fixed-point integer atomics would also repeat,
// but they quantise bins 2^-42 below the chunk's largest value to zero;
// these are true f32 sums.)  Bound by bytes: 4 ndim + 4 per sample read.
//
// Bin resolve (resolve_kernel), one thread per (sample, dimension):
// ia = clip(int(xn), 1, nbins), lo = xi[d, ia-1], hi = xi[d, ia],
// xo = hi - lo, rc = lo + (xn - ia) * xo.  xn comes from a tensor, or is
// formed in the kernel from the Philox stream (philox.cuh) as
// (kg - u) * dxg + 1.  Both that expression and rc are written with
// __fmul_rn/__fadd_rn: contracted to one FMA, a sample on a bin edge
// would land in the other bin than in the plain version.  Bound by bytes:
// 8 to 12 per (sample, dimension) written, 4 read when xn is given.
//
// Edge lookup (edge_kernel), one thread per (sample, dimension) of a
// cube-major (N, ndim) id array: (xi[d, ia-1], xi[d, ia]).  Bound by bytes.
//
// Built by ops/cuda_build.py; called through ctypes (C entry points below).

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  unsigned key0, key1, iteration;
};

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const ResolveArgs a) {
  extern __shared__ float s_xi[];      // (nbins + 1,) edges of dimension d
  const int d = blockIdx.y;
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
          vegas_block(cube, a.iteration, slot, d, a.key0, a.key1), d));
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

}  // namespace

// C entry points for ctypes.  Every pointer is a device pointer.  Each
// returns cudaGetLastError() after its launch (0 on success) and never
// synchronises.

// part: (n_blocks, ndim, nbins) scratch, n_blocks = ceil(n / per_block).
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

// xn null: the coordinates are drawn in the kernel for the chunk of
// n / npg cubes that starts at cube0.
extern "C" int vegas_resolve_launch(const void* xi, const void* xn, void* rc,
                                    void* xo, void* ia, long long n,
                                    long long cube0, long long ncubes,
                                    int ndim, int nbins, int ng, int npg,
                                    float dxg, unsigned key0, unsigned key1,
                                    unsigned iteration, int n_blocks,
                                    void* stream) {
  if (n < 1 || ndim < 1 || nbins < 1 || ng < 1 || npg < 1 || n_blocks < 1)
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
  a.iteration = iteration;
  const size_t smem = sizeof(float) * (nbins + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<<<dim3(n_blocks, ndim), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ia, lo, hi: (N, ndim) cube-major, total = N * ndim elements.
extern "C" int vegas_edge_launch(const void* xi, const void* ia, void* lo,
                                 void* hi, long long total, int ndim,
                                 int nbins, int n_blocks, void* stream) {
  if (total < 1 || ndim < 1 || nbins < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ndim * (nbins + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  edge_kernel<<<n_blocks, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), static_cast<const int*>(ia),
      static_cast<float*>(lo), static_cast<float*>(hi), total, ndim, nbins);
  return static_cast<int>(cudaGetLastError());
}
