// K4: complex DFT along the last axis in FP64, 1 <= n <= 256, as a
// shared-memory Stockham FFT (stockham.cuh).
//
// Replaces: xrft_tpu/ops/df64_fft.py:129 _df64_dft_last (kernel body
// _df64_dft_kernel), the base case of the four-step recursion df64_fft_nd.
// The TPU has no float64, so the TPU kernel carried each value as a
// double-word float32 (hi, lo) pair and ran a direct DFT with compensated
// rank-1 updates.  Hopper has FP64 units, so this kernel computes the same
// function in plain FP64:
//
//   out[r, k] = sum_{j<n} x[r, j] * exp(sign*2*pi*i*j*k/n)
//
// x and out are contiguous complex128 (rows, n), interleaved (re, im) as
// torch stores complex128; out is unnormalised, in natural frequency order.
//
// Bound on Hopper (NVIDIA H100 80GB HBM3, 700.00 W): bytes.  The hp path's
// two shapes per axis, (524288, 256) and (8388608, 16), move 8.6 GB (each
// value read once and written once, 16 bytes each way): 2.56 ms at
// 3.35 TB/s.  A direct DFT, this kernel's first form, costs 8n flops per
// output, 2.9e11 FP64 flops per axis: even DMMA (mma.sync m8n8k4) at the
// full 67 TFLOP/s of the FP64 tensor cores needs 4.4 ms for that, above the
// bytes bound, so no tensor-core form of the direct DFT can reach it.  An FFT
// needs about 5 n log2 n flops per row, 8e9 in all, 0.24 ms on the FP64
// pipes: ten times under the bytes bound.
//
// Design: a memory-bound streaming FFT.  A block of 128 threads takes a tile
// of 2048 / n whole rows (8 rows of 256, 128 of 16: 32 KB), reads it once and
// writes it once, and runs every radix stage of the host plan in shared
// memory and registers (256 = 16 x 16: two radix-16 stages, one group of 16
// a thread; 16: one stage; a prime such as 251: one direct stage).  Where a
// warp's reads of the first stage fill whole 128-byte lines (n = 256), that
// stage reads the rows from global memory and the last stage writes them
// back, so one padded buffer of 35 KB is all the shared memory it needs;
// otherwise (n = 16) the tile is copied in with 16-byte cp.async at an odd
// row stride against bank conflicts and stored from shared memory.  The
// plan's twiddles and roots come from the host table; no atomics and a fixed
// order of every sum, so two launches are bit-identical.

#include "stockham.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // values per tile

__global__ void __launch_bounds__(kThreads)
    dft64_kernel(const double2* __restrict__ x, double2* __restrict__ out,
                 const double2* __restrict__ table, stockham::Plan pl,
                 int sign, long long rows, int tile_rows, int in_direct,
                 int out_direct) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = pl.n;
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int nseq = (int)min((long long)tile_rows, rows - row0);
  double2* buf0 = reinterpret_cast<double2*>(smem);
  double2* buf1 = buf0 + tile_rows * stockham::padded_ld(n);
  const double2* in = x + row0 * n;
  int in_ld = n;
  if (!in_direct) {
    // an odd row stride: at n = 16 a thread's first-stage reads walk a row
    in_ld = n | 1;
    stockham::load_rows(buf0, in_ld, in, nseq, n);
    in = buf0;
  }
  const double2* res = stockham::run_plan<double2, double2>(
      in, in_ld, !in_direct, out_direct ? out + row0 * n : nullptr, n, buf0,
      buf1, nseq, pl, table, sign);
  if (!out_direct) stockham::store_contig(out + row0 * n, res, nseq, n);
}

}  // namespace

// x, out: complex128 (rows, n), contiguous.  plan: the int32 plan of
// fft_plan.build(n, sign) (host memory); table: its complex128 table on the
// device.  Launches on `stream`; returns the cudaError_t of the launch (0 on
// success), or cudaErrorInvalidValue for a plan it cannot run.
extern "C" int dft64_last(const void* x, void* out, const int* plan,
                          const void* table, long long rows, void* stream) {
  int n, sign, passes, inter;
  stockham::Plan pl, unused;
  int err = stockham::parse_plan(plan, &n, &sign, &passes, &inter, &pl,
                                 &unused);
  if (err) return err;
  if (passes != 1 || n > 256 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int tile_rows = n >= kTile ? 1 : kTile / n;
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bool in_direct, out_direct;
  stockham::direct_io<double2, double2>(pl, &in_direct, &out_direct);
  const size_t smem = stockham::smem_bytes<double2>(
      stockham::buffers_used(pl, !in_direct, out_direct), tile_rows, n);
  err = stockham::allow_smem(dft64_kernel, smem);
  if (err) return err;
  dft64_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)x, (double2*)out, (const double2*)table, pl, sign, rows,
      tile_rows, in_direct, out_direct);
  return (int)cudaGetLastError();
}
