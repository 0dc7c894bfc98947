// K3: per-bin sums over a static sorted plan.
//
// Replaces: xrft_tpu/ops/binning.py::_binned_sum_pallas, the TPU kernel that
// reduces (..., P) data into nbins radial bins over static pd.cut codes,
//
//   out[r, b, c] = sum over sorted positions i of bin b of x[r, order[i], c]
//
// where order is the stable argsort of the codes (same-bin points contiguous,
// dropped code -1 points first and never read) and c runs over the complex
// components (C = 2) or is absent (C = 1).  float data accumulate in float,
// double data in double.
//
// The TPU kernel compared every point with every bin (a one-hot per chunk,
// O(P * nbins) work) because Mosaic had no gather.  Hopper gathers, so this
// kernel does O(P) work: each point is read once per row.
//
// Bound on Hopper: device memory.  Per point and row it reads one 4-byte
// index (shared by the ROWS rows a block handles) and gathers 4 or 8 bytes
// (16 for complex128).  Within a bin the order is increasing flat index, so
// a warp's 32 gathers fall on a few runs of one ring's rows.
//
// Design, two passes and no atomics, so two launches give bit-identical
// output:
//   1. chunk_sums: one block of 256 threads per (chunk, group of RB rows).
//      A chunk is at most CHUNK sorted positions of one bin (chunk_off, host
//      built), so the blocks do near-equal work however uneven the bins are.
//      Each thread sums its strided positions in order, then a fixed shuffle
//      tree and a fixed sum over the warps give the chunk's partial sum.
//   2. bin_sums: one thread per (row, bin, component) adds its bin's chunk
//      partials (bin_chunk, host built) in chunk order; an empty bin gives 0.
// A bin's value goes through at most CHUNK/256 = 16 sequential additions per
// thread, a 5-level shuffle tree, 7 additions over the warps and one per
// chunk of the bin, so its rounding error stays at a few float32 ulps of the
// bin however many points the grid has (the TPU kernel's sequential chunk
// accumulation grew as sqrt(P/512) ulps).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;  // rows per block (ops/binning.py ROWS_PER_BLOCK)

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
chunk_sums(const T* __restrict__ x, const int* __restrict__ order,
           const int* __restrict__ chunk_off, T* __restrict__ partial,
           long long R, long long P, int nchunks) {
  const int k = blockIdx.x;
  const long long r0 = (long long)blockIdx.y * RB;
  const int nr = (int)(R - r0 < RB ? R - r0 : RB);
  const int lo = chunk_off[k], hi = chunk_off[k + 1];
  T acc[RB * C];
#pragma unroll
  for (int a = 0; a < RB * C; ++a) acc[a] = T(0);
  const T* base = x + r0 * P * C;
  for (int i = lo + (int)threadIdx.x; i < hi; i += THREADS) {
    const long long p = order[i];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      if (rr < nr) {
        const T* v = base + ((long long)rr * P + p) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[rr * C + c] += v[c];
      }
    }
  }
  __shared__ T warp_sums[WARPS][RB * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < RB * C; ++a) {
    T v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < RB * C) {
    const int a = threadIdx.x, rr = a / C, c = a % C;
    if (rr < nr) {
      T s = warp_sums[0][a];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += warp_sums[w][a];
      partial[((r0 + rr) * nchunks + k) * C + c] = s;
    }
  }
}

template <typename T, int C>
__global__ void bin_sums(const T* __restrict__ partial,
                         const int* __restrict__ bin_chunk,
                         T* __restrict__ out, long long total, int nbins,
                         int nchunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % C);
  const long long rb = t / C;
  const int b = (int)(rb % nbins);
  const long long r = rb / nbins;
  T s = T(0);
  for (int k = bin_chunk[b]; k < bin_chunk[b + 1]; ++k)
    s += partial[(r * nchunks + k) * C + c];
  out[t] = s;
}

template <typename T, int C>
int launch(const void* x, const void* order, const void* chunk_off,
           const void* bin_chunk, void* partial, void* out, long long R,
           long long P, int nchunks, int nbins, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nchunks > 0) {
    dim3 grid((unsigned)nchunks, (unsigned)((R + RB - 1) / RB));
    chunk_sums<T, C><<<grid, THREADS, 0, s>>>(
        (const T*)x, (const int*)order, (const int*)chunk_off, (T*)partial,
        R, P, nchunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = R * nbins * C;
  const long long blocks = (total + THREADS - 1) / THREADS;
  bin_sums<T, C><<<(unsigned)blocks, THREADS, 0, s>>>(
      (const T*)partial, (const int*)bin_chunk, (T*)out, total, nbins,
      nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, int comps, const void* order,
             const void* chunk_off, const void* bin_chunk, void* partial,
             void* out, long long R, long long P, int nchunks, int nbins,
             void* stream) {
  if (comps == 1)
    return launch<T, 1>(x, order, chunk_off, bin_chunk, partial, out, R, P,
                        nchunks, nbins, stream);
  if (comps == 2)
    return launch<T, 2>(x, order, chunk_off, bin_chunk, partial, out, R, P,
                        nchunks, nbins, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: float32 [R, P, comps] contiguous (comps 2: complex64 viewed as real);
// order: int32 [P]; chunk_off: int32 [nchunks + 1]; bin_chunk: int32
// [nbins + 1]; partial: float32 [R, max(nchunks, 1), comps] scratch; out:
// float32 [R, nbins, comps].  Returns the cudaError_t of the launches.
extern "C" int binned_sum_f32(const void* x, int comps, const void* order,
                              const void* chunk_off, const void* bin_chunk,
                              void* partial, void* out, long long R,
                              long long P, int nchunks, int nbins,
                              void* stream) {
  return dispatch<float>(x, comps, order, chunk_off, bin_chunk, partial, out,
                         R, P, nchunks, nbins, stream);
}

// As binned_sum_f32, for float64 (complex128) data, partials and output.
extern "C" int binned_sum_f64(const void* x, int comps, const void* order,
                              const void* chunk_off, const void* bin_chunk,
                              void* partial, void* out, long long R,
                              long long P, int nchunks, int nbins,
                              void* stream) {
  return dispatch<double>(x, comps, order, chunk_off, bin_chunk, partial, out,
                          R, P, nchunks, nbins, stream);
}
