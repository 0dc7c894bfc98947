// K3: per-bin sums over a static tile plan, the data streamed in natural
// order.
//
// Replaces: xrft_tpu/ops/binning.py::_binned_sum_pallas, the TPU kernel that
// reduces (..., P) data into nbins radial bins over static pd.cut codes,
//
//   out[r, b, c] = sum over the points p with code b of x[r, p, c]
//
// where code -1 points are dropped and c runs over the complex components
// (C = 2) or is absent (C = 1).  float data accumulate in float, double data
// in double.
//
// The TPU kernel streamed the points in natural order and compared every
// point with every bin (a one-hot per chunk, O(P * nbins) work), because
// Mosaic had no gather.  This kernel streams them in natural order too, and
// sorts inside shared memory instead of comparing: O(P) work, each point
// read once per row, in whole 32-byte sectors.
//
// Bound on Hopper: device memory, the data once (537 MB at the isotropic
// flagship, 8 x 4096^2 float32), the codes once (33.6 MB as pandas' int16)
// and the output once: 0.170 ms at 3.35 TB/s.  The plan's own reads (2 bytes
// a kept point, once a tile and row group) and the partial slots come on
// top.
//
// The plan (ops/binning.py::_tile_plan, built once per grid): the points
// are cut into tiles of `tile` consecutive points (TILE = 16384); `local`
// holds each tile's kept points in the stable order of their codes, as
// 16-bit offsets into the tile, tile after tile; a run is a stretch of one
// bin in one tile, at most RUN_MAX = 128 points (longer stretches are cut
// into several runs), local[run_start[k] : run_start[k+1]]; tile t owns runs
// tile_run[t] .. tile_run[t+1]; run k writes its partial into slot
// run_slot[k], and bin b's slots are bin_off[b] .. bin_off[b+1], in tile
// order.
//
// Two passes and no atomics, so two launches give bit-identical output:
//   1. tile_sums: one block of 512 threads per (tile, group of rows).  It
//      stages the tile's offsets in shared memory once, then for each row
//      (and component) copies the row's tile into shared memory with
//      coalesced 16-byte cp.async copies where aligned (scalar loads
//      otherwise), and each thread sums whole runs out of it, thread k of
//      the block run k0 + k (+ 512 j), the points in order into four
//      accumulators taken in turn, and writes the run's partial to its
//      slot.  A tile with no kept point is not read.
//   2. bin_sums: one warp per (row, bin) adds its bin's slots, which lie
//      side by side: lane l the slots l, l + 32, ... in order, then a fixed
//      shuffle tree; an empty bin gives 0.
// A bin's value goes through at most 32 additions per accumulator of a run,
// about a 32nd of its runs per lane and a 5-level tree, so its rounding
// error stays at a few ulps of the bin.
//
// Why a run has a thread and a cap: a warp per run (the first design) paid
// a chain of dependent loads per run and left most lanes idle on the median
// run of 28 points; a thread per run keeps the loads independent.  Nearly
// every tile of the flagship holds one ring tangent to its rows, a run of up
// to 621 points that would hold the whole block for 155 steps; cutting runs
// at 128 points adds 1.9% more runs (491,195 against 482,109).
//
// The tile's size, by arithmetic at the flagship (4096^2 grid, 1024 bins
// out to the corner, so each ring is about 2.8 grid points wide): a tile of
// 16384 points is four grid rows and touches 471 bins on average.  The
// slots' write and read then cost 8 rows x 491,195 x 4 B x 2 = 31.4 MB, 5.9%
// of the data; a 32768-point tile would halve that, but its float64 copy
// (256 KB) does not fit a block's 227 KB of shared memory.  A float tile
// and its offsets take 96 KB (two blocks an SM, so one block's copy runs
// while the other sums: a block that double-buffered its rows instead, one
// an SM, measured slower), a double one 160 KB (one).
// Complex data are reduced a component at a time, the second reading the
// tile again (from L2 as a rule).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS_PER_BIN_BLOCK = 8;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Copy n values of component c of a row's tile (C values a point) from src
// into s.
template <typename T, int C>
__device__ __forceinline__ void load_tile(T* s, const T* src, int n, int c) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (C == 1 && ((uintptr_t)src & 15) == 0) {
    const int nv = n / V;
    for (int i = threadIdx.x; i < nv; i += THREADS) cp16(s + i * V, src + i * V);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS)
    s[i] = __ldcs(src + (long long)i * C + c);
  if (C == 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
tile_sums(const T* __restrict__ x, const uint16_t* __restrict__ local,
          const int* __restrict__ run_start, const int* __restrict__ run_slot,
          const int* __restrict__ tile_run, T* __restrict__ partial,
          long long R, long long P, int nslots, int tile, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  uint16_t* loc = reinterpret_cast<uint16_t*>(s + tile);
  const int t = blockIdx.x;
  const int k0 = tile_run[t], k1 = tile_run[t + 1];
  if (k0 == k1) return;  // every point of the tile dropped
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = r0 + rows < R ? r0 + rows : R;
  const long long p0 = (long long)t * tile;
  const int n = (int)(P - p0 < tile ? P - p0 : tile);
  const int a0 = run_start[k0], na = run_start[k1] - a0;
  for (int i = threadIdx.x; i < na; i += THREADS) loc[i] = local[a0 + i];
  for (long long r = r0; r < r1; ++r) {
    for (int c = 0; c < C; ++c) {
      __syncthreads();  // the last runs are summed (and loc is staged)
      load_tile<T, C>(s, x + (r * P + p0) * C, n, c);
      __syncthreads();
      for (int k = k0 + threadIdx.x; k < k1; k += THREADS) {
        const int a = run_start[k] - a0, b = run_start[k + 1] - a0;
        T acc[4] = {T(0), T(0), T(0), T(0)};
        int i = a;
#pragma unroll 2
        for (; i + 4 <= b; i += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += s[loc[i + j]];
        }
        if (i < b) acc[0] += s[loc[i]];
        if (i + 1 < b) acc[1] += s[loc[i + 1]];
        if (i + 2 < b) acc[2] += s[loc[i + 2]];
        partial[(r * nslots + run_slot[k]) * C + c] =
            (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BIN_BLOCK)
bin_sums(const T* __restrict__ partial, const int* __restrict__ bin_off,
         T* __restrict__ out, long long total, int nbins, int nslots) {
  const long long w =
      (long long)blockIdx.x * WARPS_PER_BIN_BLOCK + (threadIdx.x >> 5);
  if (w >= total) return;  // total: R * nbins warps
  const int lane = threadIdx.x & 31;
  const int b = (int)(w % nbins);
  const long long r = w / nbins;
  const T* p = partial + r * nslots * C;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  for (int k = bin_off[b] + lane; k < bin_off[b + 1]; k += 32) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += p[(long long)k * C + c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) out[w * C] = acc[0];
  if (C == 2 && lane == 1) out[w * C + 1] = acc[C - 1];
}

template <typename T, int C>
int launch(const void* x, const void* local, const void* run_start,
           const void* run_slot, const void* tile_run, const void* bin_off,
           void* partial, void* out, long long R, long long P, int ntiles,
           int nslots, int nbins, int tile, int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nslots > 0) {
    const size_t smem = (size_t)tile * (sizeof(T) + 2);
    cudaError_t err = cudaFuncSetAttribute(
        tile_sums<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long groups = (R + rows - 1) / rows;
    if (groups > 65535) return (int)cudaErrorInvalidValue;
    tile_sums<T, C><<<dim3((unsigned)ntiles, (unsigned)groups), THREADS, smem,
                      s>>>((const T*)x, (const uint16_t*)local,
                           (const int*)run_start, (const int*)run_slot,
                           (const int*)tile_run, (T*)partial, R, P, nslots,
                           tile, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = R * nbins;
  const long long blocks =
      (total + WARPS_PER_BIN_BLOCK - 1) / WARPS_PER_BIN_BLOCK;
  bin_sums<T, C><<<(unsigned)blocks, 32 * WARPS_PER_BIN_BLOCK, 0, s>>>(
      (const T*)partial, (const int*)bin_off, (T*)out, total, nbins, nslots);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, int comps, const void* local,
             const void* run_start, const void* run_slot,
             const void* tile_run, const void* bin_off, void* partial,
             void* out, long long R, long long P, int ntiles, int nslots,
             int nbins, int tile, int rows, void* stream) {
  if (tile < 1 || tile > 65536 || rows < 1) return (int)cudaErrorInvalidValue;
  if (comps == 1)
    return launch<T, 1>(x, local, run_start, run_slot, tile_run, bin_off,
                        partial, out, R, P, ntiles, nslots, nbins, tile, rows,
                        stream);
  if (comps == 2)
    return launch<T, 2>(x, local, run_start, run_slot, tile_run, bin_off,
                        partial, out, R, P, ntiles, nslots, nbins, tile, rows,
                        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: float32 [R, P, comps] contiguous (comps 2: complex64 viewed as real);
// local: uint16 [kept points]; run_start: int32 [nslots + 1]; run_slot:
// int32 [nslots]; tile_run: int32 [ntiles + 1]; bin_off: int32 [nbins + 1];
// partial: float32 [R, max(nslots, 1), comps] scratch; out: float32
// [R, nbins, comps]; tile: points a tile (<= 65536); rows: rows a pass-1
// block takes.  Returns the cudaError_t of the launches.
extern "C" int binned_sum_f32(const void* x, int comps, const void* local,
                              const void* run_start, const void* run_slot,
                              const void* tile_run, const void* bin_off,
                              void* partial, void* out, long long R,
                              long long P, int ntiles, int nslots, int nbins,
                              int tile, int rows, void* stream) {
  return dispatch<float>(x, comps, local, run_start, run_slot, tile_run,
                         bin_off, partial, out, R, P, ntiles, nslots, nbins,
                         tile, rows, stream);
}

// As binned_sum_f32, for float64 (complex128) data, partials and output.
extern "C" int binned_sum_f64(const void* x, int comps, const void* local,
                              const void* run_start, const void* run_slot,
                              const void* tile_run, const void* bin_off,
                              void* partial, void* out, long long R,
                              long long P, int ntiles, int nslots, int nbins,
                              int tile, int rows, void* stream) {
  return dispatch<double>(x, comps, local, run_start, run_slot, tile_run,
                          bin_off, partial, out, R, P, ntiles, nslots, nbins,
                          tile, rows, stream);
}
