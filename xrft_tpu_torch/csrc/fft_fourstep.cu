// K2: DFT along the last axis in float32, as a shared-memory Stockham FFT
// (stockham.cuh), for the lengths the TPU kernel's four-step form takes:
// n >= 256 with a factor pair n1 * n2 = n, n1, n2 <= 256.
//
// Replaces: xrft_tpu/ops/pallas_fft.py:284 pallas_fft_last (bodies _kernel
// and _kernel_dg), and with it pallas_fft_rowtile (:234), which computes the
// same function.  Input x (rows, n) is real float32 or complex64; the
// output is complex64 (rows, n), unnormalised, in natural frequency order:
//
//   out[r, k] = sum_{j<n} x[r, j] * exp(sign*2*pi*i*j*k/n)
//
// Bound on Hopper (NVIDIA H100 80GB HBM3, 700.00 W): bytes.  The main
// path's two launches, (32768, 4096) real and (16392, 4096) complex, move
// 2.68 GB (input read once, complex64 output written once): 0.80 ms at
// 3.35 TB/s.  This kernel's first form, the four-step order in two direct
// passes, ran two 64-point sums per point, 2.1e11 flops (3.1 ms on the FP32
// FMAs), and a scratch round trip; as tensor-core products (3xTF32 wgmma on
// 64 x 64 DFT matrices) it would cost 6.2e11 TF32 flops, 1.25 ms at
// 495 TFLOP/s: above the bound either way.  An FFT needs about 5 n log2 n
// flops per row, 1.2e10 in all (0.18 ms).
//
// Design: a memory-bound streaming FFT.  When the rows fit in shared memory
// (n <= 8192), one launch and no scratch tensor: a block of 256 threads takes
// 4096 / n whole rows and runs every stage of the host plan in shared memory
// and registers (4096 = 16 x 16 x 16: three radix-16 stages, one group of 16
// a thread).  At n = 4096 the first stage reads the row straight from global
// memory (real float32 promoted in registers) and the last stage writes it
// straight back, each access of a warp one whole 128-byte line, so the row
// is read once and written once; the middle stage goes between two padded
// buffers (70 KB), three blocks an SM.  Shorter rows are copied in with
// 16-byte cp.async and stored from shared memory.  Above 8192 (n = 65536 =
// 256 x 256), two passes through a scratch tensor in the four-step order:
// pass 1 loads 16 columns j2 of all n1 rows j1, runs the n1-point plan on
// them and multiplies by the twiddle W_n^(k1*j2); pass 2 loads 16 rows k1 of
// n2 points, runs the n2-point plan and writes out[k1 + n1*k2].  Every
// twiddle and root comes from the host table (complex64); no atomics and a
// fixed summation order, so two launches are bit-identical.

#include "stockham.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // values per tile of the one-launch form
constexpr int kStrip = 16;   // columns (pass 1) or rows (pass 2) per block
// three blocks of the one-launch form share an SM at n = 4096 (70 KB of
// shared memory each), which caps a thread at 85 registers
constexpr int kBlocksPerSm = 3;

template <typename In>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    rows_kernel(const In* __restrict__ x, float2* __restrict__ out,
                const float2* __restrict__ table, stockham::Plan pl, int sign,
                long long rows, int tile_rows, int in_direct, int out_direct) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = pl.n;
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int nseq = (int)min((long long)tile_rows, rows - row0);
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + tile_rows * stockham::padded_ld(n);
  const In* in = x + row0 * n;
  if (!in_direct) {
    In* raw = reinterpret_cast<In*>(buf0);
    stockham::load_contig(raw, in, (long long)nseq * n);
    in = raw;
  }
  const float2* res = stockham::run_plan<float2, In>(
      in, n, !in_direct, out_direct ? out + row0 * n : nullptr, n, buf0, buf1,
      nseq, pl, table, sign);
  if (!out_direct) stockham::store_contig(out + row0 * n, res, nseq, n);
}

// Pass 1, one block per (row, strip of kStrip columns j2): the n1-point
// DFTs over j1 of x[row, j1*n2 + j2], times W_n^(k1*j2), into
// B[row, k1*n2 + j2].
template <typename In>
__global__ void __launch_bounds__(kThreads)
    pass1_kernel(const In* __restrict__ x, float2* __restrict__ B,
                 const float2* __restrict__ table, stockham::Plan pl, int n2,
                 int inter, int sign, int strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = pl.n;
  const long long base = (long long)(blockIdx.x / strips) * n1 * n2;
  const int j2_0 = (blockIdx.x % strips) * kStrip;
  const int nseq = min(kStrip, n2 - j2_0);
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + kStrip * stockham::padded_ld(n1);
  In* raw = reinterpret_cast<In*>(buf0);
  for (int e = threadIdx.x; e < n1 * nseq; e += blockDim.x) {
    const int j1 = e / nseq;
    const int c = e - j1 * nseq;
    raw[c * n1 + j1] = x[base + (long long)j1 * n2 + j2_0 + c];
  }
  __syncthreads();
  const float2* res = stockham::run_plan<float2, In>(
      raw, n1, true, nullptr, 0, buf0, buf1, nseq, pl, table, sign);
  const int ld = stockham::padded_ld(n1);
  const float2* tw = table + inter;
  for (int e = threadIdx.x; e < n1 * nseq; e += blockDim.x) {
    const int k1 = e / nseq;
    const int c = e - k1 * nseq;
    const int j2 = j2_0 + c;
    B[base + (long long)k1 * n2 + j2] = stockham::cmul(
        res[c * ld + stockham::pad(k1)], __ldg(tw + k1 * n2 + j2));
  }
}

// Pass 2, one block per (row, strip of kStrip rows k1 of B): the n2-point
// DFTs of B[row, k1*n2 + j2] over j2, into out[row, k1 + n1*k2].
__global__ void __launch_bounds__(kThreads)
    pass2_kernel(const float2* __restrict__ B, float2* __restrict__ out,
                 const float2* __restrict__ table, stockham::Plan pl, int n1,
                 int sign, int strips) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = pl.n;
  const long long base = (long long)(blockIdx.x / strips) * n1 * n2;
  const int k1_0 = (blockIdx.x % strips) * kStrip;
  const int nseq = min(kStrip, n1 - k1_0);
  float2* buf0 = reinterpret_cast<float2*>(smem);
  float2* buf1 = buf0 + kStrip * stockham::padded_ld(n2);
  stockham::load_contig(buf0, B + base + (long long)k1_0 * n2,
                        (long long)nseq * n2);
  const float2* res = stockham::run_plan<float2, float2>(
      buf0, n2, true, nullptr, 0, buf0, buf1, nseq, pl, table, sign);
  const int ld = stockham::padded_ld(n2);
  for (int e = threadIdx.x; e < n2 * nseq; e += blockDim.x) {
    const int k2 = e / nseq;
    const int c = e - k2 * nseq;
    out[base + k1_0 + c + (long long)n1 * k2] =
        res[c * ld + stockham::pad(k2)];
  }
}

template <typename In>
int launch(const void* x, void* scratch, void* out, const int* plan,
           const void* table, long long rows, cudaStream_t st) {
  int n, sign, passes, inter;
  stockham::Plan p1, p2;
  int err = stockham::parse_plan(plan, &n, &sign, &passes, &inter, &p1, &p2);
  if (err) return err;
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const float2* tab = (const float2*)table;
  if (passes == 1) {
    const int tile_rows = n >= kTile ? 1 : kTile / n;
    const long long blocks = (rows + tile_rows - 1) / tile_rows;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bool in_direct, out_direct;
    stockham::direct_io<In, float2>(p1, &in_direct, &out_direct);
    const size_t smem = stockham::smem_bytes<float2>(
        stockham::buffers_used(p1, !in_direct, out_direct), tile_rows, n);
    err = stockham::allow_smem(rows_kernel<In>, smem);
    if (err) return err;
    rows_kernel<In><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const In*)x, (float2*)out, tab, p1, sign, rows, tile_rows, in_direct,
        out_direct);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int n1 = p1.n, n2 = p2.n;
  const int strips1 = (n2 + kStrip - 1) / kStrip;
  const int strips2 = (n1 + kStrip - 1) / kStrip;
  if (rows * strips1 > 0x7fffffffLL || rows * strips2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem1 = stockham::smem_bytes<float2>(2, kStrip, n1);
  const size_t smem2 = stockham::smem_bytes<float2>(2, kStrip, n2);
  err = stockham::allow_smem(pass1_kernel<In>, smem1);
  if (!err) err = stockham::allow_smem(pass2_kernel, smem2);
  if (err) return err;
  pass1_kernel<In><<<(unsigned)(rows * strips1), kThreads, smem1, st>>>(
      (const In*)x, (float2*)scratch, tab, p1, n2, inter, sign, strips1);
  err = (int)cudaGetLastError();
  if (err) return err;
  pass2_kernel<<<(unsigned)(rows * strips2), kThreads, smem2, st>>>(
      (const float2*)scratch, (float2*)out, tab, p2, n1, sign, strips2);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, n) float32 (complex_in == 0) or complex64, contiguous.  out:
// complex64 (rows, n).  plan: the int32 plan of fft_plan.build (host
// memory), one pass or two; scratch: complex64 (rows, n) for a two-pass
// plan, else unused (may be null).  table: the plan's complex64 table on
// the device.  Launches on `stream`; returns the first cudaError_t of the
// launches (0 on success), or cudaErrorInvalidValue for a plan it cannot
// run.
extern "C" int fft_fourstep_f32(const void* x, int complex_in, void* scratch,
                                void* out, const int* plan, const void* table,
                                long long rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (complex_in)
    return launch<float2>(x, scratch, out, plan, table, rows, st);
  return launch<float>(x, scratch, out, plan, table, rows, st);
}
