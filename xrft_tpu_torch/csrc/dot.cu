// Small-weight float32 products over a long column axis, at full float32
// grade: K5a (dot), K5b (dot_fold) and K5c (dot_dma).
//
// Replaces: xrft_tpu/ops/pallas_dot.py::make_dot_kernel (K5a),
// ::make_dot_fold_kernel (K5b) and ::make_dot_kernel_dma (K5c).  The TPU
// kernels run W(M, K) @ X(K, N) at Precision.HIGHEST (float32 grade) on the
// matrix unit; the matmul FFT engine's real-input level-0 product is K5a at
// W(64, 32) @ X(32, 4,194,304) on the flagship, or the G=4 block-diagonal
// packing W(256, 128) @ X(128, 1,048,576) that fills the TPU's 128x128 unit.
//
//   dot:      out[m, c] = sum_{j<K} W[m, j] X[j, c]                (M, N)
//   dot_fold: out[r, c] = (W[:K] X)[r, c] + 1e-38 (W[K:] X)[r, c]   (K, N), M = 2K
//   dot_dma:  dot's function, with the copies made explicit
//
// X is read through strides: X[j, c] = a[p, j, q] with c = p*Q + q, so the
// engine's (2, k, *rest) product of a digit axis in the middle of its array
// needs no moveaxis copy.  The wrapper passes W transposed, Wt(K, M).
//
// Bound on Hopper: TF32 keeps about three decimal digits, so every product
// is an FP32 FMA on the CUDA cores (67 TFLOP/s).  At (64,32)@(32, 4.19M) the
// kernel must move 1.61 GB (0.48 ms at 3.35 TB/s) and do 1.72e10 flop (0.26
// ms): memory-bound.  The packed (256,128)@(128, 1.05M) moves the same bytes
// but does 6.87e10 flop (1.03 ms): compute-bound.  Design (simple first): a
// block of 256 threads owns a 64-row x 128-column output tile and walks K in
// chunks of 32; each chunk of X (32 x 128) and of Wt (32 x 64, or 32 x 128
// for the fold's two halves) is copied into shared memory with cp.async
// (16-byte copies when the strides allow, 4-byte ones otherwise, zero-filled
// past the ragged edges), and each thread keeps an 8 x 4 register tile of
// outputs: per j one float4 of X, two float4 broadcasts of Wt and 32 FMAs.
// K5a runs one tile per block, copy then compute.  K5c runs persistent
// blocks that walk the tiles with a two-stage ring, the copy of step s+1 in
// flight while step s computes, the counterpart of the TPU kernel's two-slot
// make_async_copy loop.  Both sum j in ascending order with one fmaf per
// term, so K5c equals K5a bit for bit and repeats are bit-identical.  No
// atomics.  wgmma in 3xTF32 is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // output rows per tile
constexpr int kBN = 128;  // columns per tile
constexpr int kBK = 32;   // K per chunk

struct Args {
  const float* wt;  // (K, M), contiguous
  const float* a;   // X[j, p*Q + q] = a[p*sP + j*sK + q*sQ]
  float* out;       // (out_rows, N), contiguous
  int M, K, out_rows;
  long long P, Q, N, sP, sK, sQ;
  int col_tiles, row_tiles, nk;
  bool vec_in, vec_out;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of K-chunk kc of tile (rt, ct) into one stage:
// xs[kBK][kBN] and ws[kBK][WCOLS].
template <int WCOLS, bool FOLD>
__device__ __forceinline__ void load_stage(const Args& g, float* xs, float* ws,
                                           int rt, long long ct, int kc) {
  const int t = threadIdx.x;
  const int k0 = kc * kBK;
  const long long col0 = ct * kBN;
  if (g.vec_in) {
    // float4 f = t + 256 i: row (t >> 5) + 8 i, columns (t & 31) * 4 + 0..3
    const long long c = col0 + (t & 31) * 4;
    const bool col_ok = c < g.N;
    const long long p = col_ok ? c / g.Q : 0;
    const long long q = col_ok ? c - p * g.Q : 0;
    const float* src0 = g.a + p * g.sP + q;
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int jj = (t >> 5) + 8 * i;
      const bool ok = col_ok && (k0 + jj < g.K);
      const float* src = ok ? src0 + (long long)(k0 + jj) * g.sK : g.a;
      cp16(xs + jj * kBN + (t & 31) * 4, src, ok);
    }
  } else {
    // element e = t + 256 i: row (t >> 7) + 2 i, column t & 127
    const long long c = col0 + (t & (kBN - 1));
    const bool col_ok = c < g.N;
    const long long p = col_ok ? c / g.Q : 0;
    const long long q = col_ok ? c - p * g.Q : 0;
    const float* src0 = g.a + p * g.sP + q * g.sQ;
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int jj = (t >> 7) + 2 * i;
      const bool ok = col_ok && (k0 + jj < g.K);
      const float* src = ok ? src0 + (long long)(k0 + jj) * g.sK : g.a;
      cp4(xs + jj * kBN + (t & (kBN - 1)), src, ok);
    }
  }
  const int r0 = rt * kBM;
#pragma unroll
  for (int i = 0; i < kBK * WCOLS / kThreads; ++i) {
    const int e = t + kThreads * i;
    const int jj = e / WCOLS;
    const int r = e - jj * WCOLS;
    // the fold's second half reads the low rows W[K + r]
    const int lo = FOLD && r >= kBM;
    const int rr = r0 + r - (lo ? kBM : 0);
    const int m = rr + (lo ? g.out_rows : 0);
    const bool ok = (rr < g.out_rows) && (k0 + jj < g.K);
    const float* src = ok ? g.wt + (long long)(k0 + jj) * g.M + m : g.wt;
    cp4(ws + jj * WCOLS + r, src, ok);
  }
}

// One K-chunk of multiply-adds on the register tile: rows ty*8 + i,
// columns tx*4 + c.  j ascends with one fmaf per term.
template <int WCOLS, bool FOLD>
__device__ __forceinline__ void compute_stage(const float* xs, const float* ws,
                                              float (&acc)[8][4],
                                              float (&acc2)[8][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll 4
  for (int jj = 0; jj < kBK; ++jj) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + jj * kBN + tx * 4);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    const float4 w0 = *reinterpret_cast<const float4*>(ws + jj * WCOLS + ty * 8);
    const float4 w1 =
        *reinterpret_cast<const float4*>(ws + jj * WCOLS + ty * 8 + 4);
    const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wr[i], xr[c], acc[i][c]);
    if (FOLD) {
      const float4 v0 =
          *reinterpret_cast<const float4*>(ws + jj * WCOLS + kBM + ty * 8);
      const float4 v1 =
          *reinterpret_cast<const float4*>(ws + jj * WCOLS + kBM + ty * 8 + 4);
      const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc2[i][c] = fmaf(vr[i], xr[c], acc2[i][c]);
    }
  }
}

template <bool FOLD>
__device__ __forceinline__ void store_tile(const Args& g, int rt, long long ct,
                                           float (&acc)[8][4],
                                           const float (&acc2)[8][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long c = ct * kBN + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rt * kBM + ty * 8 + i;
    if (r >= g.out_rows) break;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      // the fold rounds the product and the sum apart, as torch's
      // hi + 1e-38 * lo does
      v[k] = FOLD ? __fadd_rn(acc[i][k], __fmul_rn(1e-38f, acc2[i][k]))
                  : acc[i][k];
    float* dst = g.out + (long long)r * g.N + c;
    if (g.vec_out && c + 3 < g.N) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < g.N) dst[k] = v[k];
    }
  }
}

template <int WCOLS, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    dot_tile_kernel(const Args g) {
  __shared__ __align__(16) float xs[kBK * kBN];
  __shared__ __align__(16) float ws[kBK * WCOLS];
  float acc[8][4] = {}, acc2[8][4] = {};
  const long long ct = blockIdx.x;
  const int rt = blockIdx.y;
  for (int kc = 0; kc < g.nk; ++kc) {
    load_stage<WCOLS, FOLD>(g, xs, ws, rt, ct, kc);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    compute_stage<WCOLS, FOLD>(xs, ws, acc, acc2);
    __syncthreads();
  }
  store_tile<FOLD>(g, rt, ct, acc, acc2);
}

constexpr int kStageFloats = kBK * kBN + kBK * kBM;
constexpr size_t kDmaSmem = 2 * kStageFloats * sizeof(float);

// Persistent blocks; tile id = ct * row_tiles + rt, block b takes ids
// b, b + gridDim.x, ...; step s is chunk s % nk of the block's (s / nk)-th
// tile, and stage s & 1 of the ring holds it.
__device__ __forceinline__ void step_tile(const Args& g, long long s,
                                          int& rt, long long& ct, int& kc) {
  const long long id = blockIdx.x + (s / g.nk) * gridDim.x;
  kc = (int)(s % g.nk);
  ct = id / g.row_tiles;
  rt = (int)(id - ct * g.row_tiles);
}

__global__ void __launch_bounds__(kThreads) dot_dma_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  const long long tiles = (long long)g.col_tiles * g.row_tiles;
  if ((long long)blockIdx.x >= tiles) return;
  const long long mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const long long steps = mine * g.nk;
  float acc[8][4] = {}, acc2[8][4] = {};
  int rt, kc;
  long long ct;

  step_tile(g, 0, rt, ct, kc);
  load_stage<kBM, false>(g, smem, smem + kBK * kBN, rt, ct, kc);
  cp_commit();
  for (long long s = 0; s < steps; ++s) {
    float* xs = smem + (s & 1) * kStageFloats;
    if (s + 1 < steps) {
      float* xn = smem + ((s + 1) & 1) * kStageFloats;
      step_tile(g, s + 1, rt, ct, kc);
      load_stage<kBM, false>(g, xn, xn + kBK * kBN, rt, ct, kc);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    step_tile(g, s, rt, ct, kc);
    compute_stage<kBM, false>(xs, xs + kBK * kBN, acc, acc2);
    if (kc == g.nk - 1) {
      store_tile<false>(g, rt, ct, acc, acc2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    }
    __syncthreads();
  }
}

int make_args(Args& g, const void* wt, const void* a, void* out, int M, int K,
              int out_rows, long long P, long long Q, long long sP,
              long long sK, long long sQ) {
  if (M < 1 || K < 1 || out_rows < 1 || P < 0 || Q < 0)
    return (int)cudaErrorInvalidValue;
  g.wt = (const float*)wt;
  g.a = (const float*)a;
  g.out = (float*)out;
  g.M = M;
  g.K = K;
  g.out_rows = out_rows;
  g.P = P;
  g.Q = Q;
  g.N = P * Q;
  g.sP = sP;
  g.sK = sK;
  g.sQ = sQ;
  const long long col_tiles = (g.N + kBN - 1) / kBN;
  if (col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.col_tiles = (int)col_tiles;
  g.row_tiles = (out_rows + kBM - 1) / kBM;
  g.nk = (K + kBK - 1) / kBK;
  g.vec_in = sQ == 1 && Q % 4 == 0 && sP % 4 == 0 && sK % 4 == 0 &&
             ((uintptr_t)a & 15) == 0;
  g.vec_out = g.N % 4 == 0 && ((uintptr_t)out & 15) == 0;
  return 0;
}

}  // namespace

// out(M, P*Q) = W(M, K) @ X with X[j, p*Q + q] = a[p*sP + j*sK + q*sQ];
// wt is W transposed, (K, M) contiguous; strides in elements.  Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int dot_f32(const void* wt, const void* a, void* out, int M, int K,
                       long long P, long long Q, long long sP, long long sK,
                       long long sQ, void* stream) {
  Args g;
  int err = make_args(g, wt, a, out, M, K, M, P, Q, sP, sK, sQ);
  if (err) return err;
  if (g.N == 0) return 0;
  if (g.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  dot_tile_kernel<kBM, false>
      <<<dim3(g.col_tiles, g.row_tiles), kThreads, 0, (cudaStream_t)stream>>>(
          g);
  return (int)cudaGetLastError();
}

// out(K, P*Q) = (W[:K] @ X) + 1e-38 * (W[K:] @ X) for W(2K, K).
extern "C" int dot_fold_f32(const void* wt, const void* a, void* out, int M,
                            int K, long long P, long long Q, long long sP,
                            long long sK, long long sQ, void* stream) {
  if (M != 2 * K) return (int)cudaErrorInvalidValue;
  Args g;
  int err = make_args(g, wt, a, out, M, K, K, P, Q, sP, sK, sQ);
  if (err) return err;
  if (g.N == 0) return 0;
  if (g.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  dot_tile_kernel<2 * kBM, true>
      <<<dim3(g.col_tiles, g.row_tiles), kThreads, 0, (cudaStream_t)stream>>>(
          g);
  return (int)cudaGetLastError();
}

// dot_f32's function on persistent blocks with a two-stage copy ring.
extern "C" int dot_dma_f32(const void* wt, const void* a, void* out, int M,
                           int K, long long P, long long Q, long long sP,
                           long long sK, long long sQ, void* stream) {
  Args g;
  int err = make_args(g, wt, a, out, M, K, M, P, Q, sP, sK, sQ);
  if (err) return err;
  if (g.N == 0) return 0;
  err = (int)cudaFuncSetAttribute(dot_dma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kDmaSmem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dot_dma_kernel, kThreads, kDmaSmem);
  if (err) return err;
  const long long tiles = (long long)g.col_tiles * g.row_tiles;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  dot_dma_kernel<<<(unsigned)blocks, kThreads, kDmaSmem,
                   (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
