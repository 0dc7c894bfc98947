// Direct complex DFT along the last axis in FP64, 1 <= n <= 256.
//
// Replaces: xrft_tpu/ops/df64_fft.py::_df64_dft_last (kernel body
// _df64_dft_kernel), the base case of the four-step recursion df64_fft_nd.
// The TPU has no float64, so the TPU kernel carried each value as a
// double-word float32 (hi, lo) pair and accumulated with compensated rank-1
// updates.  Hopper has FP64 units, so this kernel computes the same function
// in plain FP64 arithmetic:
//
//   out[r, k] = sum_{j<n} x[r, j] * W[(j*k) mod n],  W[e] = exp(sign*2*pi*i*e/n)
//
// x and out are contiguous complex128 (rows, n), interleaved (re, im) as
// torch stores complex128; out is unnormalised, in natural frequency order.
// The n-entry table W is built on the host in float64 with the angle reduced
// mod n in integers, so the device computes no trigonometry and the sign
// lives in the table.
//
// Bound on Hopper: each output costs n complex multiply-adds (4 FP64 FMAs)
// against 32 bytes of device traffic, so the FP64 pipes and the two
// shared-memory reads per step bound it, not device memory.  The table reads
// bound it first: a warp's 32 indices (j*k) mod n fall on few banks when k
// shares factors with n (5.7 TFLOP/s at n = 256 on an H100).  Design (simple
// first): one block per tile of R = 256 / n rows (R * n <= 256 threads); the
// tile (R * n values, at most 4 KB) and the table (n values, at most 4 KB)
// are staged in shared memory with one coalesced load per thread; each thread
// owns one (row, k) output and walks j in order with FP64 FMAs, advancing the
// table index by k mod n without an integer division.  No atomics and a
// fixed summation order, so two launches are bit-identical.  Offsets are 64
// bits: a full-width stack holds more than 2^31 bytes.  Tensor-core DMMA
// (mma.sync m8n8k4 f64) and register blocking over rows are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 256;

__global__ void dft64_kernel(const double2* __restrict__ x,
                             double2* __restrict__ out,
                             const double2* __restrict__ table,
                             long long rows, int n, int tile_rows) {
  __shared__ double2 xs[kMaxN];
  __shared__ double2 ws[kMaxN];
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const long long base = row0 * n;
  const long long left = (rows - row0) * n;  // values from base to the end
  const int t = threadIdx.x;                  // blockDim.x == tile_rows * n
  if (t < n) ws[t] = table[t];
  if (t < left) xs[t] = x[base + t];
  __syncthreads();
  if (t >= left) return;

  const int r = t / n;
  const int k = t - r * n;
  const double2* xr = xs + r * n;
  double re = 0.0, im = 0.0;
  int e = 0;  // (j * k) mod n
  for (int j = 0; j < n; ++j) {
    const double2 a = xr[j];
    const double2 w = ws[e];
    re = fma(a.x, w.x, re);
    re = fma(-a.y, w.y, re);
    im = fma(a.x, w.y, im);
    im = fma(a.y, w.x, im);
    e += k;
    if (e >= n) e -= n;
  }
  out[base + t] = make_double2(re, im);
}

}  // namespace

// x, out: complex128 (rows, n), contiguous.  table: complex128, n entries.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int dft64_last(const void* x, void* out, const void* table,
                          long long rows, int n, void* stream) {
  if (n < 1 || n > kMaxN || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int tile_rows = kMaxN / n;
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dft64_kernel<<<(unsigned)blocks, tile_rows * n, 0, (cudaStream_t)stream>>>(
      (const double2*)x, (double2*)out, (const double2*)table, rows, n,
      tile_rows);
  return (int)cudaGetLastError();
}
