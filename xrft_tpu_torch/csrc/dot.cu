// Small-weight float32 products over a long column axis, at full float32
// grade: K5a (dot), K5b (dot_fold) and K5c (dot_dma).
//
// Replaces: xrft_tpu/ops/pallas_dot.py::make_dot_kernel (K5a),
// ::make_dot_fold_kernel (K5b) and ::make_dot_kernel_dma (K5c).  The TPU
// kernels run W(M, K) @ X(K, N) at Precision.HIGHEST (float32 grade, six
// bf16 passes) on the matrix unit; the matmul FFT engine's real-input
// level-0 product is K5a at W(64, 32) @ X(32, 4,194,304) on the flagship,
// or the G=4 block-diagonal packing W(256, 128) @ X(128, 1,048,576) that
// fills the TPU's 128x128 unit.
//
//   dot:      out[m, c] = sum_{j<K} W[m, j] X[j, c]                (M, N)
//   dot_fold: out[r, c] = (W[:K] X)[r, c] + 1e-38 (W[K:] X)[r, c]   (K, N), M = 2K
//   dot_dma:  dot's function, with the copies made explicit
//
// X is read through strides: X[j, c] = a[p, j, q] with c = p*Q + q, so the
// engine's (2, k, *rest) product of a digit axis in the middle of its array
// needs no moveaxis copy.  The wrapper passes W transposed, Wt(K, M).
//
// K5a: 3xTF32 on the tensor cores.  Hopper's counterpart of the TPU's
// split-precision passes: each operand v is split into hi = tf32_rna(v) and
// lo = tf32_rna(v - hi) (cvt.rna.tf32.f32), and three TF32 products
// x_lo.w_hi + x_hi.w_lo + x_hi.w_hi run on wgmma with float32 accumulators;
// the two small terms go into one accumulator, the large one into another,
// and the two are added once at the end (x_lo.w_lo, below 2^-22 of each
// term, is dropped).  Bound: at 495 TFLOP/s dense TF32 the packed shape's
// 3 x 6.87e10 flop take 0.42 ms, under the 0.48 ms its 1.61 GB take at
// 3.35 TB/s, so both shapes are bound by bytes.  Design: TF32 wgmma takes
// its shared-memory operands K-major only and X is column-contiguous, so a
// block computes the transposed tile out^T(c, m) = X^T W^T: A = a 64-column
// slab of X per warpgroup, read from shared memory into registers (where
// the hi/lo split happens), B = the split W, K-major, in shared memory
// (no swizzle; core matrices of 8 rows x 4 k).  The wrapper's scratch
// holds W split once, per (M chunk of MT rows, K chunk of 32) in that
// layout, so a stage's W is one contiguous copy.  Persistent blocks walk
// (128-column tile, M chunk) tiles and their K chunks, warp-specialized: a
// producer warpgroup (40 registers, setmaxnreg) keeps a ring of 3-4 stages
// of X and W chunks filling with cp.async, each stage's mbarrier completing
// when its copies land; two consumer warpgroups (232 registers) each take
// 64 columns of the tile, run 12 wgmma per stage, release the stage on a
// second mbarrier and write a finished tile through a staging buffer of
// their own as float4 rows, so one warpgroup's stores overlap the other's
// products and the copies run on throughout.  MT = 64 for M <= 64 (wgmma
// m64n64k8), else 128 (m64n128k8) with the M chunks of one column tile on
// neighbouring blocks, so X's second read comes from L2.
//
// K5c: K5a's function and arithmetic, with the copies made explicit, as the
// TPU kernel's two-slot DMA ring in and out.  W stays resident in shared
// memory: a group of ceil(M / 64) CTAs (at most 8, so M <= 512) holds it,
// each CTA 64 rows of the split W (hi and lo, every K chunk: 16 KB a chunk,
// K <= 256), brought in once by a bulk copy, and runs wgmma m64n64k8 on it
// for its whole persistent loop.  The persistent grid holds whole groups;
// the CTAs of a group walk the same 128-column tiles, and being resident at
// once they read each X tile about the same time, one read from device
// memory and the others from L2.  X arrives by TMA (cp.async.bulk.tensor,
// 128-byte swizzle) in four 32 x 32 sub-tiles a stage, and a stage's
// mbarrier completes on its 16 KB.  (Launching a group as a thread-block
// cluster, and a multicast producer that loads each sub-tile once for the
// cluster, both measured slower on an H100: PERF.md.)  The A
// fragments are read from the swizzled stage (two-way bank conflicts at
// most) and split as K5a's.  Each consumer warpgroup writes its 64 x 64
// output block into a swizzled staging buffer and one thread stores it by
// TMA (cp.async.bulk.tensor store) while the next tile's products run.
// Layouts the TMA cannot describe (a base or stride not a multiple of 16
// bytes, Q below 32 with P > 1: ops/dot.py::dma_tensor_map decides) take a
// cp.async producer warpgroup in the same kernel, and an output whose rows
// are not 16-byte multiples is stored by the warpgroup from the staging
// buffer.  Shared memory: 1 KB of alignment + W (16 KB a K chunk: 64 KB at
// the packed shape (256, 128), 16 KB at the engine's (64, 32)) + 4 X
// stages x 16 KB + 2 x 16 KB of output staging = 161 KB at the packed
// shape, 113 KB at the engine's.  Bound: bytes, as K5a.
//
// K5b: FP32 FMAs on the CUDA cores (67 TFLOP/s).  A block of 256 threads
// owns a 64-row x 128-column output tile of each half of W and walks K in
// chunks of 32; each chunk of X (32 x 128) and of Wt (32 x 128: both
// halves) is copied into shared memory with cp.async (16-byte copies when
// the strides allow, 4-byte ones otherwise, zero-filled past the ragged
// edges), and each thread keeps two 8 x 4 register tiles of outputs: per j
// one float4 of X, four float4 broadcasts of Wt and 64 FMAs, j ascending
// with one fmaf per term.  No atomics anywhere: every kernel's repeats are
// bit-identical.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // output rows per tile (FMA kernels)
constexpr int kBN = 128;  // columns per tile
constexpr int kBK = 32;   // K per chunk

struct Args {
  const float* wt;  // (K, M), contiguous
  const float* a;   // X[j, p*Q + q] = a[p*sP + j*sK + q*sQ]
  float* out;       // (out_rows, N), contiguous
  int M, K, out_rows;
  long long P, Q, N, sP, sK, sQ;
  int col_tiles, row_tiles, nk;
  bool vec_in, vec_out, narrow;  // narrow: N < 2^32
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

// Where column col of column tile ct starts in `a` (the first of a float4
// of columns when vec_in); the one division by Q of a tile.
struct XSrc {
  const float* p;
  bool ok;
};

__device__ __forceinline__ XSrc x_src(const Args& g, long long ct, int col) {
  const long long c = ct * kBN + col;
  XSrc x{g.a, c < g.N};
  if (x.ok) {
    const long long p =
        g.narrow ? (long long)((unsigned)c / (unsigned)g.Q) : c / g.Q;
    x.p = g.a + p * g.sP + (c - p * g.Q) * g.sQ;
  }
  return x;
}

// Start the copies of K-chunk kc of X's columns at x into xs[kBK][xstride].
__device__ __forceinline__ void load_x(const Args& g, float* xs, int xstride,
                                       const XSrc& x, int kc) {
  const int t = threadIdx.x;
  const int k0 = kc * kBK;
  if (g.vec_in) {
    // float4 f = t + 256 i: row (t >> 5) + 8 i, columns (t & 31) * 4 + 0..3
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int jj = (t >> 5) + 8 * i;
      const bool ok = x.ok && (k0 + jj < g.K);
      const float* src = ok ? x.p + (long long)(k0 + jj) * g.sK : g.a;
      cp16(xs + jj * xstride + (t & 31) * 4, src, ok);
    }
  } else {
    // element e = t + 256 i: row (t >> 7) + 2 i, column t & 127
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int jj = (t >> 7) + 2 * i;
      const bool ok = x.ok && (k0 + jj < g.K);
      const float* src = ok ? x.p + (long long)(k0 + jj) * g.sK : g.a;
      cp4(xs + jj * xstride + (t & (kBN - 1)), src, ok);
    }
  }
}

// ---- K5a: 3xTF32 on the tensor cores -------------------------------------

constexpr int kTcThreads = 384;  // two consumer warpgroups, one producer
constexpr int kXS = kBN + 8;     // X stage row stride: A fragments conflict-free
constexpr int kOSW = 64 + 4;     // staging row stride: fragment stores conflict-free

template <int MT>
struct TcCfg {
  static constexpr int kStages = MT == 64 ? 4 : 3;
  static constexpr int kXFloats = kBK * kXS;
  static constexpr int kWFloats = 2 * MT * kBK;  // hi then lo
  static constexpr int kStageFloats = kXFloats + kWFloats;
  static constexpr int kOutFloats = 2 * MT * kOSW;
  static constexpr size_t kSmem =
      (size_t)(kStages * kStageFloats + kOutFloats) * sizeof(float) +
      2 * kStages * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// wgmma matrix descriptor of a K-major operand without swizzle: start
// address, LBO (bytes between core matrices adjacent in K) and SBO (bytes
// between core matrices adjacent in M/N), all in 16-byte units.
__device__ __forceinline__ uint64_t kmajor_desc(const float* p, int lbo,
                                                int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N) += A(64 x 8, registers) B(8 x N, shared memory), TF32 in,
// float32 accumulators.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// This thread's A fragments of one K chunk (kBK deep: four 8-deep steps),
// read through at(k, column): tile columns crow, crow + 8 and k = kq, kq + 4
// of each step, split into TF32 hi and lo (hi = tf32_rna(v), lo =
// tf32_rna(v - hi)).  ops/dot.py::dot_replay repeats this arithmetic.
template <typename At>
__device__ __forceinline__ void split_frags(At at, int crow, int kq,
                                            uint32_t (&hi)[kBK / 8][4],
                                            uint32_t (&lo)[kBK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const int k = kk * 8 + kq;
    const float v[4] = {at(k, crow), at(k, crow + 8), at(k + 4, crow),
                        at(k + 4, crow + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[kk][i] = tf32_rna(v[i]);
      lo[kk][i] = tf32_rna(__fsub_rn(v[i], __uint_as_float(hi[kk][i])));
    }
  }
}

// The three TF32 products of one K chunk against ws, its split W chunk (hi
// then lo, MT x kBK each, in core-matrix order): step by step x_lo.w_hi and
// x_hi.w_lo into acc_s and x_hi.w_hi into acc_b; returns when they are done.
template <int MT>
__device__ __forceinline__ void tc_chunk(float (&acc_s)[MT / 2],
                                         float (&acc_b)[MT / 2],
                                         const uint32_t (&hi)[kBK / 8][4],
                                         const uint32_t (&lo)[kBK / 8][4],
                                         const float* ws) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    // B of step kk: core matrices ki = 2 kk, 2 kk + 1 of hi and of lo
    const float* wk = ws + 2 * kk * (MT / 8) * 32;
    const uint64_t dhi = kmajor_desc(wk, MT * 16, 128);
    const uint64_t dlo = kmajor_desc(wk + MT * kBK, MT * 16, 128);
    Wgmma<MT>::run(acc_s, lo[kk], dhi);
    Wgmma<MT>::run(acc_s, hi[kk], dlo);
    Wgmma<MT>::run(acc_b, hi[kk], dhi);
  }
  wg_commit();
  wg_wait_all();
  reg_fence(acc_s);
  reg_fence(acc_b);
}

// Split W once into the scratch ws: for M chunk mc and K chunk kc, block
// (mc * nk + kc) holds hi then lo, each MT x kBK in core-matrix order:
// float (ki * (MT/8) + mi) * 32 + (m % 8) * 4 + k % 4 for m = mi*8 + m % 8,
// k = ki*4 + k % 4 within the chunk; zero past M and K.
__global__ void split_w_kernel(const float* __restrict__ wt,
                               float* __restrict__ ws, int M, int K, int MT,
                               int nk, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int per = MT * kBK;
  const long long half = i / per;  // (mc * nk + kc) * 2 + (lo ? 1 : 0)
  const int e = (int)(i - half * per);
  const long long mk = half >> 1;
  const int kc = (int)(mk % nk), mc = (int)(mk / nk);
  const int core = e >> 5, ki = core / (MT / 8), mi = core - ki * (MT / 8);
  const int m = mc * MT + mi * 8 + ((e & 31) >> 2);
  const int k = kc * kBK + ki * 4 + (e & 3);
  const float v = (m < M && k < K) ? wt[(long long)k * M + m] : 0.f;
  const uint32_t hi = tf32_rna(v);
  ws[i] = (half & 1) ? __uint_as_float(tf32_rna(__fsub_rn(v, __uint_as_float(hi))))
                     : __uint_as_float(hi);
}

// A persistent block's place in its walk: K chunk kc of its tile id (block
// b takes ids b, b + gridDim.x, ...); id = ct * m_chunks + mc, so the M
// chunks of one column tile run side by side.  Divisions once a tile.
struct Cursor {
  long long id, ct;
  int mc, kc;
};

__device__ __forceinline__ void cursor_tile(Cursor& u, int m_chunks) {
  u.ct = m_chunks == 1 ? u.id : u.id / m_chunks;
  u.mc = (int)(u.id - u.ct * m_chunks);
}

__device__ __forceinline__ void cursor_next(Cursor& u, const Args& g,
                                            int m_chunks) {
  if (++u.kc == g.nk) {
    u.kc = 0;
    u.id += gridDim.x;
    cursor_tile(u, m_chunks);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}
// Waits for the phase of parity `parity` of b to complete.  A phase that
// never completes (a lost copy or arrival) traps after about 10 s of
// waiting, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (spin == 0)
        t0 = now;
      else if (now - t0 > 10000000000ull)
        __trap();
    }
  }
}
// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Warpgroup wg writes its 64 columns of the tile (mc, ct) through its
// staging buffer stg: float4 rows, scalar stores at a ragged or unaligned
// edge.  The caller's wg_sync since the last call keeps stg free.
template <int MT>
__device__ __forceinline__ void tc_store(const Args& g, float* stg,
                                         long long ct, int mc, int wg,
                                         const float (&acc_s)[MT / 2],
                                         const float (&acc_b)[MT / 2]) {
  const int tw = threadIdx.x & 127, lane = tw & 31;
  // accumulator element i: column c0 + 8 ((i >> 1) & 1), row 8 (i >> 2) +
  // 2 (lane & 3) + (i & 1) of the warpgroup's part of the tile
  const int c0 = 16 * (tw >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) {
    const int c = c0 + 8 * ((i >> 1) & 1);
    const int m = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    stg[m * kOSW + c] = __fadd_rn(acc_s[i], acc_b[i]);
  }
  wg_sync(wg);
  const int rows = min(MT, g.out_rows - mc * MT);
  const long long c = ct * kBN + 64 * wg + 4 * (tw & 15);
  for (int r = tw >> 4; r < rows; r += 8) {
    const float4 v = *reinterpret_cast<const float4*>(stg + r * kOSW + 4 * (tw & 15));
    float* dst = g.out + (long long)(mc * MT + r) * g.N + c;
    if (g.vec_out && c + 3 < g.N) {
      __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < g.N) dst[k] = vv[k];
    }
  }
}

// arrives once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

// The producer warpgroup: fills stage after stage of the ring with X's and
// W's chunks of the block's steps (cp.async, zero-filled past the edges), a
// stage once both consumer warpgroups have released it; the stage's
// barrier completes when all 128 threads' copies have landed.
template <int MT>
__device__ __forceinline__ void tc_produce(const Args& g, const float* wsplit,
                                           int m_chunks, long long steps,
                                           float* smem, uint64_t* full,
                                           uint64_t* empty) {
  using C = TcCfg<MT>;
  constexpr int S = C::kStages;
  const int t = threadIdx.x & 127;
  // this thread's X columns: the float4 at 4 (t & 31), rows (t >> 5) + 4 i;
  // or column t, every row
  const int col = g.vec_in ? 4 * (t & 31) : t;
  Cursor u{blockIdx.x, 0, 0, 0};
  cursor_tile(u, m_chunks);
  XSrc x = x_src(g, u.ct, col);
  for (long long s = 0; s < steps; ++s) {
    const int st = (int)(s % S);
    if (s >= S) mbar_wait(&empty[st], (uint32_t)((s / S - 1) & 1));
    float* xs = smem + st * C::kStageFloats;
    const int k0 = u.kc * kBK;
    if (g.vec_in) {
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const int j = (t >> 5) + 4 * i;
        const bool ok = x.ok && k0 + j < g.K;
        cp16(xs + j * kXS + col, ok ? x.p + (long long)(k0 + j) * g.sK : g.a,
             ok);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const bool ok = x.ok && k0 + j < g.K;
        cp4(xs + j * kXS + col, ok ? x.p + (long long)(k0 + j) * g.sK : g.a,
            ok);
      }
    }
    const float* src = wsplit + ((long long)u.mc * g.nk + u.kc) * C::kWFloats;
#pragma unroll
    for (int i = t; i < C::kWFloats / 4; i += 128)
      cp16(xs + C::kXFloats + 4 * i, src + 4 * i, true);
    mbar_arrive_copies(&full[st]);
    const long long ct = u.ct;
    cursor_next(u, g, m_chunks);
    if (u.ct != ct) x = x_src(g, u.ct, col);
  }
  cp_wait<0>();
}

template <int MT>
__global__ void __launch_bounds__(kTcThreads, 1)
    dot_tc_kernel(const Args g, const float* __restrict__ wsplit,
                  int m_chunks) {
  using C = TcCfg<MT>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(128) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S * C::kStageFloats + C::kOutFloats);
  uint64_t* empty = full + S;
  const long long tiles = (long long)g.col_tiles * m_chunks;
  if ((long long)blockIdx.x >= tiles) return;
  const long long steps =
      ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * g.nk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 128);  // the producer's threads
      mbar_init(&empty[i], 2);   // the two warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    tc_produce<MT>(g, wsplit, m_chunks, steps, smem, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2;
  float* stg = smem + S * C::kStageFloats + wg * MT * kOSW;
  // this thread's A fragment: tile columns crow, crow + 8 and k = kq, kq + 4
  // of each 8-deep step
  const int crow = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int kq = lane & 3;
  Cursor u{blockIdx.x, 0, 0, 0};
  cursor_tile(u, m_chunks);
  float acc_s[MT / 2], acc_b[MT / 2];
  for (long long s = 0; s < steps; ++s) {
    const int st = (int)(s % S);
    mbar_wait(&full[st], (uint32_t)((s / S) & 1));
    // the copies were made by the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (u.kc == 0) {
#pragma unroll
      for (int i = 0; i < MT / 2; ++i) acc_s[i] = acc_b[i] = 0.f;
    }
    const float* xs = smem + st * C::kStageFloats;
    uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
    split_frags([xs](int k, int c) { return xs[k * kXS + c]; }, crow, kq, hi,
                lo);
    tc_chunk<MT>(acc_s, acc_b, hi, lo, xs + C::kXFloats);
    wg_sync(wg);  // the warpgroup is done with the stage
    if ((t & 127) == 0) mbar_arrive(&empty[st]);
    if (u.kc == g.nk - 1) tc_store<MT>(g, stg, u.ct, u.mc, wg, acc_s, acc_b);
    cursor_next(u, g, m_chunks);
  }
}

int tc_rows(int M) { return M <= 64 ? 64 : 128; }

// ---- K5b: FP32 FMAs ------------------------------------------------------

constexpr int kFoldCols = 2 * kBM;  // a tile's rows of both halves of W

// Start the copies of K-chunk kc of tile (rt, ct) into one stage:
// xs[kBK][kBN] and ws[kBK][kFoldCols], the tile's rows of W[:K] then W[K:].
__device__ __forceinline__ void load_stage(const Args& g, float* xs, float* ws,
                                           int rt, long long ct, int kc) {
  const int t = threadIdx.x;
  load_x(g, xs, kBN, x_src(g, ct, g.vec_in ? (t & 31) * 4 : (t & (kBN - 1))),
         kc);
  const int k0 = kc * kBK;
  const int r0 = rt * kBM;
#pragma unroll
  for (int i = 0; i < kBK * kFoldCols / kThreads; ++i) {
    const int e = t + kThreads * i;
    const int jj = e / kFoldCols;
    const int r = e - jj * kFoldCols;
    // the second half reads the low rows W[K + r]
    const int lo = r >= kBM;
    const int rr = r0 + r - (lo ? kBM : 0);
    const int m = rr + (lo ? g.out_rows : 0);
    const bool ok = (rr < g.out_rows) && (k0 + jj < g.K);
    const float* src = ok ? g.wt + (long long)(k0 + jj) * g.M + m : g.wt;
    cp4(ws + jj * kFoldCols + r, src, ok);
  }
}

// One K-chunk of multiply-adds on the two register tiles: rows ty*8 + i,
// columns tx*4 + c.  j ascends with one fmaf per term.
__device__ __forceinline__ void compute_stage(const float* xs, const float* ws,
                                              float (&acc)[8][4],
                                              float (&acc2)[8][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll 4
  for (int jj = 0; jj < kBK; ++jj) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + jj * kBN + tx * 4);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    const float* wj = ws + jj * kFoldCols + ty * 8;
    const float4 w0 = *reinterpret_cast<const float4*>(wj);
    const float4 w1 = *reinterpret_cast<const float4*>(wj + 4);
    const float4 v0 = *reinterpret_cast<const float4*>(wj + kBM);
    const float4 v1 = *reinterpret_cast<const float4*>(wj + kBM + 4);
    const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(wr[i], xr[c], acc[i][c]);
        acc2[i][c] = fmaf(vr[i], xr[c], acc2[i][c]);
      }
  }
}

__device__ __forceinline__ void store_tile(const Args& g, int rt, long long ct,
                                           const float (&acc)[8][4],
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
      // the product and the sum rounded apart, as torch's hi + 1e-38 * lo
      v[k] = __fadd_rn(acc[i][k], __fmul_rn(1e-38f, acc2[i][k]));
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

__global__ void __launch_bounds__(kThreads) dot_fold_kernel(const Args g) {
  __shared__ __align__(16) float xs[kBK * kBN];
  __shared__ __align__(16) float ws[kBK * kFoldCols];
  float acc[8][4] = {}, acc2[8][4] = {};
  const long long ct = blockIdx.x;
  const int rt = blockIdx.y;
  for (int kc = 0; kc < g.nk; ++kc) {
    load_stage(g, xs, ws, rt, ct, kc);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    compute_stage(xs, ws, acc, acc2);
    __syncthreads();
  }
  store_tile(g, rt, ct, acc, acc2);
}

// ---- K5c: W resident, X by TMA, output by TMA ----------------------------

constexpr int kDmaRows = 64;          // W rows a CTA holds (wgmma m64n64k8)
constexpr int kDmaMaxGroup = 8;       // CTAs of a group: M <= 512
constexpr int kDmaMaxChunks = 8;      // resident K chunks: K <= 256
constexpr int kDmaStages = 4;
constexpr int kSub = 32;              // columns of a swizzled sub-tile (128 B)
constexpr int kChunkFloats = 4096;    // an X stage, a W chunk, a staging block
constexpr int kDmaBytes = kChunkFloats * 4;

size_t dma_smem(int nk) {
  return 1024 + (size_t)(kDmaStages + 2 + nk) * kDmaBytes +
         (2 * kDmaStages + 1) * sizeof(uint64_t);
}

// Float (row, col) of a [rows][32] sub-tile under the TMA's 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B on a 1024-byte aligned base): the 16-byte
// chunk col / 4 of each 128-byte row is exchanged with chunk col / 4 ^ row % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kSub + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(bytes)
               : "memory");
}
// bytes of global memory into this CTA's shared memory (1-D bulk copy)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// One TMA tile of X at coordinates c (rank 2: c0, c1; rank 3: c0, c1, c2)
// into dst, completing its bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int rank, int c0, int c1, int c2,
                                         uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const uint32_t d = smem_addr(dst), b = smem_addr(bar);
  if (rank == 2)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(d),
        "l"(m), "r"(c0), "r"(c1), "r"(b)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(d),
        "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(b)
        : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_addr(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Dma {
  Args g;
  int cs;         // CTAs a group: W's 64-row chunks
  int xrank;      // X's tensor map rank (2 or 3), or 0: the cp.async producer
  int tma_out;    // the output's rows are 16-byte multiples: TMA stores
};

// The producer warpgroup: the W chunk of this CTA once, then stage after
// stage of X, each once both consumer warpgroups have released it.  TMA:
// one thread expects the stage's 16 KB and issues its four sub-tiles.
// cp.async: every thread copies one column of the tile, zero-filled past
// the edges, into the same swizzled layout, for its own CTA.
__device__ __forceinline__ void dma_produce(
    const Dma& d, const CUtensorMap* xmap, const float* wsplit, float* xst,
    float* wres, uint64_t* full, uint64_t* empty, uint64_t* wbar,
    long long first, long long stride, long long steps) {
  const Args& g = d.g;
  const int t = threadIdx.x & 127;
  const int rank = (int)(blockIdx.x % d.cs);
  if (t == 0) {
    mbar_expect_tx(wbar, (uint32_t)(g.nk * kDmaBytes));
    for (int kc = 0; kc < g.nk; ++kc)
      bulk_load(wres + kc * kChunkFloats,
                wsplit + ((long long)rank * g.nk + kc) * kChunkFloats,
                kDmaBytes, wbar);
  }
  if (d.xrank == 0) {
    long long ct = first;
    XSrc x = x_src(g, ct, t);
    float* col = xst + (t >> 5) * kSub * kBK;
    int kc = 0;
    for (long long s = 0; s < steps; ++s) {
      const int st = (int)(s % kDmaStages);
      if (s >= kDmaStages)
        mbar_wait(&empty[st], (uint32_t)((s / kDmaStages - 1) & 1));
      float* xs = col + st * kChunkFloats;
      const int k0 = kc * kBK;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const bool ok = x.ok && k0 + j < g.K;
        cp4(xs + swz(j, t & 31), ok ? x.p + (long long)(k0 + j) * g.sK : g.a,
            ok);
      }
      mbar_arrive_copies(&full[st]);
      if (++kc == g.nk) {
        kc = 0;
        ct += stride;
        x = x_src(g, ct, t);
      }
    }
    cp_wait<0>();
    return;
  }
  if (t != 0) return;
  long long ct = first;
  int kc = 0;
  for (long long s = 0; s < steps; ++s) {
    const int st = (int)(s % kDmaStages);
    if (s >= kDmaStages)
      mbar_wait(&empty[st], (uint32_t)((s / kDmaStages - 1) & 1));
    mbar_expect_tx(&full[st], kDmaBytes);
    for (int sub = 0; sub < kBN / kSub; ++sub) {
      const long long c = ct * kBN + sub * kSub;
      const long long p = d.xrank == 3 ? c / g.Q : 0;
      tma_load(xst + st * kChunkFloats + sub * kSub * kBK, xmap, d.xrank,
               (int)(c - p * g.Q), kc * kBK, (int)p, &full[st]);
    }
    if (++kc == g.nk) {
      kc = 0;
      ct += stride;
    }
  }
}

// Warpgroup wg writes its 64 columns x 64 rows of tile ct through its
// swizzled staging buffer stg: by TMA where the output allows, else as
// scalar rows.  The previous store has finished reading stg first.
__device__ __forceinline__ void dma_store(const Dma& d,
                                          const CUtensorMap* omap, float* stg,
                                          long long ct, int mc, int wg,
                                          const float (&acc_s)[32],
                                          const float (&acc_b)[32]) {
  const Args& g = d.g;
  const int tw = threadIdx.x & 127, lane = tw & 31;
  if (d.tma_out && tw == 0) tma_store_read_wait();
  wg_sync(wg);
  const int c0 = 16 * (tw >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + 8 * ((i >> 1) & 1);
    const int m = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    stg[(c >> 5) * kSub * kDmaRows + swz(m, c & 31)] =
        __fadd_rn(acc_s[i], acc_b[i]);
  }
  const long long col = ct * kBN + 64 * wg;
  if (d.tma_out) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
    if (tw == 0)
      for (int h = 0; h < 2; ++h)
        tma_store(omap, stg + h * kSub * kDmaRows, (int)(col + h * kSub),
                  mc * kDmaRows);
    return;
  }
  wg_sync(wg);
  const int rows = min(kDmaRows, g.M - mc * kDmaRows);
  const int c = tw & 63;
  if (col + c < g.N)
    for (int m = tw >> 6; m < rows; m += 2)
      g.out[(long long)(mc * kDmaRows + m) * g.N + col + c] =
          stg[(c >> 5) * kSub * kDmaRows + swz(m, c & 31)];
}

// Groups of d.cs neighbouring CTAs walk the 128-column tiles (group i takes
// tiles i, i + groups, ...); CTA `rank` of a group computes W rows
// 64 rank .. 64 rank + 63 of each.  Two consumer warpgroups (64 columns
// each) and a producer warpgroup, as K5a.
__global__ void __launch_bounds__(kTcThreads, 1)
    dot_dma_kernel(const Dma d, const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap omap,
                   const float* __restrict__ wsplit) {
  extern __shared__ unsigned char dsmem[];
  float* smem = reinterpret_cast<float*>(
      dsmem + ((1024 - (smem_addr(dsmem) & 1023)) & 1023));
  const Args& g = d.g;
  float* xst = smem;                                    // X stages
  float* stg_all = xst + kDmaStages * kChunkFloats;     // output staging
  float* wres = stg_all + 2 * kChunkFloats;             // resident W
  uint64_t* full = reinterpret_cast<uint64_t*>(wres + g.nk * kChunkFloats);
  uint64_t* empty = full + kDmaStages;
  uint64_t* wbar = empty + kDmaStages;
  const long long first = blockIdx.x / d.cs, stride = gridDim.x / d.cs;
  const long long steps =
      first < g.col_tiles ? ((g.col_tiles - 1 - first) / stride + 1) * g.nk
                          : 0;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    for (int i = 0; i < kDmaStages; ++i) {
      mbar_init(&full[i], d.xrank ? 1 : 128);
      mbar_init(&empty[i], 2);  // the two warpgroups
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    dma_produce(d, &xmap, wsplit, xst, wres, full, empty, wbar, first,
                stride, steps);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, tw = t & 127;
    const int mc = (int)(blockIdx.x % d.cs);
    float* stg = stg_all + wg * kChunkFloats;
    const int crow = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int kq = lane & 3;
    mbar_wait(wbar, 0);
    long long ct = first;
    int kc = 0;
    float acc_s[32], acc_b[32];
    for (long long s = 0; s < steps; ++s) {
      const int st = (int)(s % kDmaStages);
      mbar_wait(&full[st], (uint32_t)((s / kDmaStages) & 1));
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_s[i] = acc_b[i] = 0.f;
      }
      const float* xs = xst + st * kChunkFloats;
      uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
      split_frags(
          [xs](int k, int c) {
            return xs[(c >> 5) * kSub * kBK + swz(k, c & 31)];
          },
          crow, kq, hi, lo);
      // the stage is in registers: release it before the products
      wg_sync(wg);
      if (tw == 0) mbar_arrive(&empty[st]);
      tc_chunk<kDmaRows>(acc_s, acc_b, hi, lo, wres + kc * kChunkFloats);
      if (kc == g.nk - 1) dma_store(d, &omap, stg, ct, mc, wg, acc_s, acc_b);
      if (++kc == g.nk) {
        kc = 0;
        ct += stride;
      }
    }
    if (d.tma_out && tw == 0) tma_store_wait();
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
  g.narrow = g.N <= 0xffffffffLL;
  return 0;
}

// Persistent grid: as many blocks as fit on the card at once, at most one
// per tile.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem,
                      long long tiles, long long& blocks) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
  if (err) return err;
  blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  return 0;
}

template <int MT>
int launch_tc(const Args& g, float* ws, cudaStream_t stream) {
  const int m_chunks = (g.M + MT - 1) / MT;
  const long long total = (long long)m_chunks * g.nk * TcCfg<MT>::kWFloats;
  split_w_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      g.wt, ws, g.M, g.K, MT, g.nk, total);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long blocks = 0;
  err = persistent_blocks(dot_tc_kernel<MT>, kTcThreads, TcCfg<MT>::kSmem,
                          (long long)g.col_tiles * m_chunks, blocks);
  if (err) return err;
  dot_tc_kernel<MT><<<(unsigned)blocks, kTcThreads, TcCfg<MT>::kSmem,
                      stream>>>(g, ws, m_chunks);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

}  // namespace

// Floats of scratch that dot_f32 needs for W(M, K) split into hi and lo.
extern "C" long long dot_f32_scratch(int M, int K) {
  if (M < 1 || K < 1) return 0;
  const int mt = tc_rows(M);
  return (long long)((M + mt - 1) / mt) * ((K + kBK - 1) / kBK) * 2 * mt * kBK;
}

// out(M, P*Q) = W(M, K) @ X with X[j, p*Q + q] = a[p*sP + j*sK + q*sQ];
// wt is W transposed, (K, M) contiguous; strides in elements; scratch holds
// dot_f32_scratch(M, K) floats, 16-byte aligned.  Launches on `stream`;
// returns the cudaError_t of the launches (0 on success).
extern "C" int dot_f32(const void* wt, const void* a, void* out, int M, int K,
                       long long P, long long Q, long long sP, long long sK,
                       long long sQ, void* scratch, void* stream) {
  Args g;
  int err = make_args(g, wt, a, out, M, K, M, P, Q, sP, sK, sQ);
  if (err) return err;
  if (g.N == 0) return 0;
  if (((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  float* ws = (float*)scratch;
  return tc_rows(M) == 64 ? launch_tc<64>(g, ws, (cudaStream_t)stream)
                          : launch_tc<128>(g, ws, (cudaStream_t)stream);
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
  dot_fold_kernel<<<dim3(g.col_tiles, g.row_tiles), kThreads, 0,
                    (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// Floats of scratch that dot_dma_f32 needs: W(M, K) split into hi and lo
// in 64-row chunks.
extern "C" long long dot_dma_f32_scratch(int M, int K) {
  if (M < 1 || K < 1) return 0;
  return (long long)((M + kDmaRows - 1) / kDmaRows) * ((K + kBK - 1) / kBK) *
         kChunkFloats;
}

// dot_f32's function (K5c), W resident in a group's shared memory: M <=
// 512, K <= 256.  xrank 2 or 3: X is read by TMA through the tensor map of
// that rank with dims xdims (elements, innermost first), byte strides
// xstrides (xrank - 1 of them) and box xbox, from `a`; xrank 0: by cp.async
// through the strides.  scratch: dot_dma_f32_scratch(M, K) floats.
// Returns the cudaError_t of the launches, or 1000 + the CUresult of a
// failed tensor-map encoding.
extern "C" int dot_dma_f32(const void* wt, const void* a, void* out, int M,
                           int K, long long P, long long Q, long long sP,
                           long long sK, long long sQ, int xrank,
                           const unsigned long long* xdims,
                           const unsigned long long* xstrides,
                           const unsigned* xbox, void* scratch, void* stream) {
  Dma d;
  int err = make_args(d.g, wt, a, out, M, K, M, P, Q, sP, sK, sQ);
  if (err) return err;
  if (d.g.N == 0) return 0;
  d.cs = (M + kDmaRows - 1) / kDmaRows;
  if (d.cs > kDmaMaxGroup || d.g.nk > kDmaMaxChunks ||
      !(xrank == 0 || xrank == 2 || xrank == 3) ||
      ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  d.xrank = xrank;
  d.tma_out = d.g.vec_out && d.g.N < 0x7fffffffLL;
  EncodeTiled encode = nullptr;
  if (xrank || d.tma_out) {
    err = encode_tiled(&encode);
    if (err) return err;
  }
  CUtensorMap xmap = {}, omap = {};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (xrank) {
    const cuuint64_t dims[3] = {xdims[0], xdims[1], xrank == 3 ? xdims[2] : 1};
    const cuuint64_t strides[2] = {xstrides[0], xrank == 3 ? xstrides[1] : 0};
    const cuuint32_t box[3] = {xbox[0], xbox[1], xrank == 3 ? xbox[2] : 1};
    const CUresult r = encode(
        &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)xrank,
        const_cast<void*>(a), dims, strides, box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  if (d.tma_out) {
    const cuuint64_t dims[2] = {(cuuint64_t)d.g.N, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)d.g.N * 4};
    const cuuint32_t box[2] = {(cuuint32_t)kSub, (cuuint32_t)kDmaRows};
    const CUresult r = encode(
        &omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box,
        ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* ws = (float*)scratch;
  const long long total = dot_dma_f32_scratch(M, K);
  split_w_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      d.g.wt, ws, M, K, kDmaRows, d.g.nk, total);
  err = (int)cudaGetLastError();
  if (err) return err;
  long long blocks = 0;
  err = persistent_blocks(dot_dma_kernel, kTcThreads, dma_smem(d.g.nk),
                          (long long)d.g.col_tiles * d.cs, blocks);
  if (err) return err;
  blocks -= blocks % d.cs;  // whole groups
  if (blocks < d.cs) return (int)cudaErrorInvalidConfiguration;
  dot_dma_kernel<<<(unsigned)blocks, kTcThreads, dma_smem(d.g.nk), st>>>(
      d, xmap, omap, (const float*)ws);
  return (int)cudaGetLastError();
}
