// Fused two-sided PSD epilogue: |F|^2, scale, fftshift and Hermitian mirror
// in one pass.
//
// Replaces: xrft_tpu/ops/pallas_mirror.py::mirror_two_sided, the TPU kernel
// that expands a one-sided real PSD to the two-sided grid.  This version goes
// one step further, as the port's default epilogue: it reads the UNSHIFTED
// complex half spectrum F[B, NY, MH] straight from the real FFT and writes the
// scaled two-sided PSD P[B, NY, NX] in the real dtype,
//
//   ky = (oy - hy) mod NY,  k = (ox - hx) mod NX,  h* = N*/2 if shift else 0
//   k <= NX/2 :  P[b, oy, ox] = s * |F[b, ky, k]|^2
//   otherwise :  P[b, oy, ox] = s * |F[b, (NY - ky) mod NY, NX - k]|^2
//
// so the y-fftshift is done here and not by a separate pass.  Any NY and NX,
// odd or even.
//
// Bound on Hopper: device memory.  Per float32 output it must read 4 bytes
// of complex64 (each of the NX/2 + 1 stored columns once) and write 4; no
// arithmetic to speak of.  The TPU kernel's block-reversal roll cascades
// existed because Mosaic had no reverse.  Design: source row r feeds output
// row oy(r) directly and output row oy(r') mirrored, r' = (NY - r) mod NY,
// and row r' feeds the same two rows the other way round.  So a block owns
// one row pair (r, r') of one batch element and a chunk [k0, k1) of the
// stored columns (the whole NX/2 + 1 of them up to 16 KB of values a row):
//   1. it reads F[b, r, k0:k1] and F[b, r', k0:k1] once each, 16 bytes a
//      thread, and stages s * |F|^2 in shared memory (index skewed by one
//      every 32, so that strided reads hit distinct banks);
//   2. it writes four segments: oy(r) and oy(r') directly at ox(k), and
//      oy(r') from row r and oy(r) from row r' mirrored at ox(NX - k) for
//      1 <= k < NX/2, read from shared memory in descending order.  Each
//      segment wraps around the row end at most once (the x-shift), and
//      each linear piece is written as aligned 16-byte vectors between a
//      scalar head and tail, so any NX, odd or even, and any hx keep the
//      stores wide.
// Rows 0 and, for even NY, NY/2 pair with themselves and write their own
// row only.  A block finds (b, pair, chunk) from blockIdx with two 32-bit
// divisions; nothing is divided per element.  The squares, sum and scale are
// rounded separately (no FMA contraction), so the result is bit-identical
// to the plain version's (re*re + im*im) * s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBytes = 16384;  // staged values per source row, at most

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__host__ __device__ constexpr int skew(int i) { return i + (i >> 5); }

template <typename T, typename C>
__device__ __forceinline__ T power(C v, T s) {
  return mul_rn(add_rn(mul_rn(v.x, v.x), mul_rn(v.y, v.y)), s);
}

// 16 bytes of complex: two complex64 or one complex128
__device__ __forceinline__ void load16(const float2* p, float2 (&v)[2]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = make_float2(q.x, q.y);
  v[1] = make_float2(q.z, q.w);
}
__device__ __forceinline__ void load16(const double2* p, double2 (&v)[1]) {
  v[0] = __ldcs(p);
}

// 16 bytes of output: four float32 or two float64
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// Elements before the first 16-byte boundary at p, at most n.
template <typename E>
__device__ __forceinline__ int head_of(const E* p, int n) {
  const int mis = (int)((uintptr_t)p & 15);
  return mis ? min(n, (16 - mis) / (int)sizeof(E)) : 0;
}

// sv[skew(k - k0)] = s * |row[k]|^2 for k in [k0, k1), 16-byte loads.
template <typename T, typename C>
__device__ __forceinline__ void load_row(const C* __restrict__ row, int k0,
                                         int k1, T* sv, T s) {
  constexpr int V = 16 / sizeof(C);
  const int n = k1 - k0;
  const C* p = row + k0;
  const int head = head_of(p, n);
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += kThreads) sv[skew(i)] = power(p[i], s);
#pragma unroll 4
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    C c[V];
    const int i = head + v * V;
    load16(p + i, c);
#pragma unroll
    for (int e = 0; e < V; ++e) sv[skew(i + e)] = power(c[e], s);
  }
  for (int i = head + nv * V + threadIdx.x; i < n; i += kThreads)
    sv[skew(i)] = power(p[i], s);
}

// dst[j] = sv[skew(off + dir * j)] for j in [0, n): 16-byte stores between
// a scalar head and tail.
template <typename T>
__device__ __forceinline__ void store_lin(T* __restrict__ dst, int n,
                                          const T* sv, int off, int dir) {
  constexpr int V = 16 / sizeof(T);
  const int head = head_of(dst, n);
  const int nv = (n - head) / V;
  for (int j = threadIdx.x; j < head; j += kThreads)
    dst[j] = sv[skew(off + dir * j)];
#pragma unroll 2
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const int j = head + v * V;
    T w[V];
#pragma unroll
    for (int e = 0; e < V; ++e) w[e] = sv[skew(off + dir * (j + e))];
    store16(dst + j, w);
  }
  for (int j = head + nv * V + threadIdx.x; j < n; j += kThreads)
    dst[j] = sv[skew(off + dir * j)];
}

// Output columns start, start + 1, ... (mod NX) of one row, n of them.
template <typename T>
__device__ __forceinline__ void store_seg(T* __restrict__ row, int NX,
                                          int start, int n, const T* sv,
                                          int off, int dir) {
  const int n1 = min(n, NX - start);
  store_lin(row + start, n1, sv, off, dir);
  if (n > n1) store_lin(row, n - n1, sv, off + dir * n1, dir);
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    mirror_pairs_kernel(const C* __restrict__ F, T* __restrict__ P, int NY,
                        int MH, int NX, int hy, int hx, int cw, int nchunks,
                        int npairs, T s) {
  constexpr int kCap = kRowBytes / sizeof(T);
  __shared__ T sv[2][skew(kCap) + 1];
  const unsigned rest = blockIdx.x / (unsigned)nchunks;
  const int chunk = (int)(blockIdx.x - rest * nchunks);
  const long long b = rest / (unsigned)npairs;
  const int r = (int)(rest - b * npairs);
  const int rp = r == 0 ? 0 : NY - r;
  const bool two = rp != r;
  const int k0 = chunk * cw;
  const int k1 = min(NX / 2 + 1, k0 + cw);

  load_row(F + (b * NY + r) * MH, k0, k1, sv[0], s);
  if (two) load_row(F + (b * NY + rp) * MH, k0, k1, sv[1], s);
  __syncthreads();

  const int oy = r + hy < NY ? r + hy : r + hy - NY;
  const int oyp = rp + hy < NY ? rp + hy : rp + hy - NY;
  T* row = P + (b * NY + oy) * NX;
  T* rowp = P + (b * NY + oyp) * NX;
  const int ox0 = k0 + hx < NX ? k0 + hx : k0 + hx - NX;
  store_seg(row, NX, ox0, k1 - k0, sv[0], 0, 1);
  if (two) store_seg(rowp, NX, ox0, k1 - k0, sv[1], 0, 1);
  // mirrored: k in [km0, km1) goes to ox(NX - k), descending in k
  const int km0 = max(k0, 1), km1 = min(k1, (NX + 1) / 2);
  if (km1 > km0) {
    const int c = NX - km1 + 1 + hx;
    const int start = c < NX ? c : c - NX;
    store_seg(rowp, NX, start, km1 - km0, sv[0], km1 - 1 - k0, -1);
    if (two) store_seg(row, NX, start, km1 - km0, sv[1], km1 - 1 - k0, -1);
  }
}

template <typename T, typename C>
int launch(const void* F, void* P, long long B, int NY, int MH, int NX,
           int shift, double s, void* stream) {
  constexpr int kCap = kRowBytes / sizeof(T);
  if (B < 1 || NY < 1 || NX < 1 || MH < NX / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const int nh = NX / 2 + 1;
  const int nchunks = (nh + kCap - 1) / kCap;
  const int cw = (nh + nchunks - 1) / nchunks;
  const int npairs = NY / 2 + 1;
  const long long blocks = B * npairs * nchunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mirror_pairs_kernel<T, C>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const C*)F, (T*)P, NY, MH, NX, shift ? NY / 2 : 0,
          shift ? NX / 2 : 0, cw, nchunks, npairs, (T)s);
  return (int)cudaGetLastError();
}

}  // namespace

// F: complex64 [B, NY, MH] contiguous, P: float32 [B, NY, NX] contiguous,
// MH >= NX/2 + 1.  Returns the cudaError_t of the launch.
extern "C" int mirror_psd_f32(const void* F, void* P, long long B, int NY,
                              int MH, int NX, int shift, double s,
                              void* stream) {
  return launch<float, float2>(F, P, B, NY, MH, NX, shift, s, stream);
}

// F: complex128, P: float64; otherwise as mirror_psd_f32.
extern "C" int mirror_psd_f64(const void* F, void* P, long long B, int NY,
                              int MH, int NX, int shift, double s,
                              void* stream) {
  return launch<double, double2>(F, P, B, NY, MH, NX, shift, s, stream);
}
