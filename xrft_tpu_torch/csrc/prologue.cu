// K6: the detrend-and-window prologue of a real stack, in two passes over
// the data, float32 or float64.
//
// Replaces no TPU kernel: on the TPU, XLA fused xrft_tpu's detrend and
// window into the ops around them.  On the H100 the same work ran as a
// chain of PyTorch ops (a float64 copy of the stack, two marginal sums,
// two subtractions, the window's product), which moved about five times the
// bytes this kernel moves.  The plain version, and the oracle of this one,
// is ``detrend.py::_detrended`` followed by ``ops/window.py::apply_window``.
//
// Layout: x[B, NY, NX] contiguous, T = float or double: B fields of NY rows
// of NX values (NY = 1 for a detrend over the trailing axis alone).  The
// block may be one rank's stretch of a sharded field: row i and column j sit
// at the centred coordinates
//
//   c_i = cy0 + i,  c_j = cx0 + j,  cy0 = lo_y - (GY - 1)/2,  cx0 = lo_x - (GX - 1)/2,
//
// half-integers, exact in double and computed from the index, so no
// coordinate vector is read.
//
//   1. moments_rows: one warp per (row, chunk of columns) reads its values
//      once, 16 bytes a thread, and sums R = sum x and W = sum x c_j in
//      double registers (never in float: float sums of quantized data far
//      from zero are biased on the card); part[row, chunk] = (R, W).
//   2. moments_fields, the tiny stage: one group of threads per field sums
//      its partials in a fixed order, S = sum R, Y = sum c_i R, X = sum W,
//      into mom[3, B].  No atomics: the same input gives the same bits.
//      (A sharded block's mom is summed over the ranks between 2 and 3.)
//   3. apply: one warp per (row, chunk) reads its values again and writes
//      the FFT's input once,
//        mean = S / n, a_y = Y / css_y, a_x = X / css_x,
//        out  = round_T( round_T(x - trend) * round_T(wy[i] * wx[j]) ),
//      the trend subtracted in double in the plain path's parts and order
//      (``parts``): 0 x - mean; 1 x - (mean + a_y c_i); 2 x - (mean + a_x c_j);
//      3 (x - (mean + a_y c_i)) - a_x c_j; 4 (x - (mean + a_x c_j)) - a_y c_i.
//      Every operation rounds on its own (no FMA contraction), so only the
//      order of the moments' float64 sums differs from the plain version.
//
// Bound on Hopper: device memory.  The stack is read twice (a 64 MB field
// does not fit the 50 MB L2 between the passes) and written once: 12 bytes
// a float32 value, 24 a float64 one; the float64 arithmetic, about four
// operations a value, is a tenth of that time.  The passes stream: 16-byte
// loads and stores between a scalar head and tail (any NX, odd or even, and
// rows that start off a 16-byte boundary), several loads in flight a
// thread, and rows longer than 8192 values cut into chunks of 8192
// (``ops/prologue.py::chunking``), so a few long rows still spread over the
// 132 SMs.  Step 3 reads and writes with the streaming hints (evict
// first) and loads the window's factors 16 bytes at a time where they
// align with the data: each was worth 2-3% of its time on an H100, where it
// then ran at 94% of the speed of a device-to-device copy of the stack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ void round_to(double d, float& r) { r = __double2float_rn(d); }
__device__ __forceinline__ void round_to(double d, double& r) { r = d; }

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load16_last(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16_last(const double* p, double (&v)[2]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void store16_last(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16_last(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// Elements before the first 16-byte boundary at p, at most n.
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int n) {
  const int mis = (int)((uintptr_t)p & 15);
  return mis ? min(n, (16 - mis) / (int)sizeof(T)) : 0;
}

// Task t of rows x nchunks: its row, first column and length.
__device__ __forceinline__ void task_of(long long t, int nchunks, int cw,
                                        int NX, long long& row, int& k0,
                                        int& n) {
  row = t / nchunks;
  k0 = (int)(t - row * nchunks) * cw;
  n = min(NX - k0, cw);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dadd(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void accumulate(double v, double c, double& s,
                                           double& w) {
  s = dadd(s, v);
  w = __fma_rn(v, c, w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moments_rows_kernel(const T* __restrict__ x, double2* __restrict__ part,
                        long long tasks, int NX, int nchunks, int cw,
                        double cx0) {
  constexpr int V = kVec<T>;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tasks) return;  // whole warps
  const int lane = threadIdx.x & 31;
  long long row;
  int k0, n;
  task_of(t, nchunks, cw, NX, row, k0, n);
  const T* p = x + row * NX + k0;
  const double c0 = cx0 + k0;
  const int head = head_of(p, n);
  const int nv = (n - head) / V;
  double s = 0.0, w = 0.0;
  for (int i = lane; i < head; i += 32) accumulate(p[i], c0 + i, s, w);
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    const int i = head + v * V;
    T q[V];
    load16(p + i, q);
    const double c = c0 + i;
#pragma unroll
    for (int e = 0; e < V; ++e) accumulate(q[e], c + e, s, w);
  }
  for (int i = head + nv * V + lane; i < n; i += 32)
    accumulate(p[i], c0 + i, s, w);
  s = warp_sum(s);
  w = warp_sum(w);
  if (lane == 0) part[t] = make_double2(s, w);
}

// G threads (a warp or the whole block) per field.
template <int G>
__global__ void __launch_bounds__(kThreads)
    moments_fields_kernel(const double2* __restrict__ part,
                          double* __restrict__ mom, long long B, int NY,
                          int nchunks, double cy0) {
  constexpr int kGroups = kThreads / G;
  const int r = threadIdx.x % G;
  const long long b = (long long)blockIdx.x * kGroups + threadIdx.x / G;
  double s = 0.0, y = 0.0, xs = 0.0;
  if (b < B) {
    const long long P = (long long)NY * nchunks;
    const double2* q = part + b * P;
    for (long long k = r; k < P; k += G) {
      const double2 v = q[k];
      s = dadd(s, v.x);
      y = __fma_rn(cy0 + (double)(k / nchunks), v.x, y);
      xs = dadd(xs, v.y);
    }
  }
  s = warp_sum(s);
  y = warp_sum(y);
  xs = warp_sum(xs);
  if (G > 32) {
    __shared__ double acc[3][kWarps];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      acc[0][warp] = s;
      acc[1][warp] = y;
      acc[2][warp] = xs;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    s = acc[0][0];
    y = acc[1][0];
    xs = acc[2][0];
    for (int k = 1; k < kWarps; ++k) {
      s = dadd(s, acc[0][k]);
      y = dadd(y, acc[1][k]);
      xs = dadd(xs, acc[2][k]);
    }
  } else if ((threadIdx.x & 31) != 0) {
    return;
  }
  if (b < B) {
    mom[b] = s;
    mom[B + b] = y;
    mom[2 * B + b] = xs;
  }
}

// x's value less the trend, rounded to T, in the plain version's parts.
struct Trend {
  int parts;
  double mean, ax, mean_y, trend_y;

  template <typename T>
  __device__ __forceinline__ T operator()(T xv, double cj) const {
    const double v = xv;
    double d;
    switch (parts) {
      case 0: d = dsub(v, mean); break;
      case 1: d = dsub(v, mean_y); break;
      case 2: d = dsub(v, dadd(mean, dmul(ax, cj))); break;
      case 3: d = dsub(dsub(v, mean_y), dmul(ax, cj)); break;
      default: d = dsub(dsub(v, dadd(mean, dmul(ax, cj))), trend_y); break;
    }
    T r;
    round_to(d, r);
    return r;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const double* __restrict__ mom, const T* __restrict__ wy,
                 const T* __restrict__ wx, long long B, long long tasks,
                 int NY, int NX, int nchunks, int cw, double cy0, double cx0,
                 int parts, double n_el, double css_y, double css_x, int vec) {
  constexpr int V = kVec<T>;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tasks) return;
  const int lane = threadIdx.x & 31;
  long long row;
  int k0, n;
  task_of(t, nchunks, cw, NX, row, k0, n);
  const long long b = row / NY;
  const int i = (int)(row - b * NY);
  const bool fit_y = parts == 1 || parts >= 3;
  const bool fit_x = parts >= 2;
  Trend f;
  f.parts = parts;
  f.mean = __ddiv_rn(mom[b], n_el);
  const double ay = fit_y ? __ddiv_rn(mom[B + b], css_y) : 0.0;
  f.ax = fit_x ? __ddiv_rn(mom[2 * B + b], css_x) : 0.0;
  f.trend_y = dmul(ay, cy0 + i);
  f.mean_y = dadd(f.mean, f.trend_y);
  // the window's factor of row i; column j's is wyi * wx[j], rounded to T
  const T wyi = wy ? wy[i] : T(1);
  const T* w = wx ? wx + k0 : nullptr;

  const T* p = x + row * NX + k0;
  T* o = out + row * NX + k0;
  const double c0 = cx0 + k0;
  const int head = vec ? head_of(p, n) : n;
  const int nv = (n - head) / V;
  // the window's factors as 16-byte loads where they align with the data's
  const bool wvec = w && head_of(w + head, V) == 0;
  for (int j = lane; j < head; j += 32) {
    const T r = f(p[j], c0 + j);
    o[j] = w ? mul_rn(r, mul_rn(wyi, w[j])) : r;
  }
#pragma unroll 4
  for (int v = lane; v < nv; v += 32) {
    const int j = head + v * V;
    T q[V], wj[V];
    load16_last(p + j, q);
    if (wvec) {
      load16(w + j, wj);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wj[e] = w ? w[j + e] : T(1);
    }
    const double c = c0 + j;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T r = f(q[e], c + e);
      q[e] = w ? mul_rn(r, mul_rn(wyi, wj[e])) : r;
    }
    store16_last(o + j, q);
  }
  for (int j = head + nv * V + lane; j < n; j += 32) {
    const T r = f(p[j], c0 + j);
    o[j] = w ? mul_rn(r, mul_rn(wyi, w[j])) : r;
  }
}

bool bad_shape(long long B, int NY, int NX, int nchunks, int cw) {
  return B < 1 || NY < 1 || NX < 1 || nchunks < 1 || cw < 1 ||
         (long long)nchunks * cw < NX || (long long)(nchunks - 1) * cw >= NX ||
         (B * NY * nchunks + kWarps - 1) / kWarps > 0x7fffffffLL;
}

template <typename T>
int moments(const void* x, void* part, void* mom, long long B, int NY, int NX,
            int nchunks, int cw, double cy0, double cx0, void* stream) {
  if (bad_shape(B, NY, NX, nchunks, cw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tasks = B * NY * nchunks;
  moments_rows_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps),
                           kThreads, 0, s>>>((const T*)x, (double2*)part,
                                             tasks, NX, nchunks, cw, cx0);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if ((long long)NY * nchunks >= 512) {
    moments_fields_kernel<kThreads><<<(unsigned)B, kThreads, 0, s>>>(
        (const double2*)part, (double*)mom, B, NY, nchunks, cy0);
  } else {
    moments_fields_kernel<32><<<(unsigned)((B + kWarps - 1) / kWarps),
                                kThreads, 0, s>>>(
        (const double2*)part, (double*)mom, B, NY, nchunks, cy0);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, void* out, const void* mom, const void* wy,
          const void* wx, long long B, int NY, int NX, int nchunks, int cw,
          double cy0, double cx0, int parts, double n_el, double css_y,
          double css_x, int vec, void* stream) {
  if (bad_shape(B, NY, NX, nchunks, cw) || parts < 0 || parts > 4)
    return (int)cudaErrorInvalidValue;
  const long long tasks = B * NY * nchunks;
  apply_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, (const double*)mom, (const T*)wy, (const T*)wx, B,
      tasks, NY, NX, nchunks, cw, cy0, cx0, parts, n_el, css_y, css_x, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Passes 1 and 2 (two launches).  x: float32 [B, NY, NX] contiguous; part:
// float64 [B * NY * nchunks, 2] scratch; mom: float64 [3, B] out (S, Y, X
// of each field).  Columns are cut into nchunks chunks of cw (the last
// shorter, none empty).  Returns the cudaError_t of the launches.
extern "C" int k6_moments_f32(const void* x, void* part, void* mom,
                              long long B, int NY, int NX, int nchunks, int cw,
                              double cy0, double cx0, void* stream) {
  return moments<float>(x, part, mom, B, NY, NX, nchunks, cw, cy0, cx0,
                        stream);
}

extern "C" int k6_moments_f64(const void* x, void* part, void* mom,
                              long long B, int NY, int NX, int nchunks, int cw,
                              double cy0, double cx0, void* stream) {
  return moments<double>(x, part, mom, B, NY, NX, nchunks, cw, cy0, cx0,
                         stream);
}

// Pass 3 (one launch).  out: like x; mom as summed over the ranks; wy
// [NY] and wx [NX] the window's factors in x's dtype, or NULL (no window:
// both; a 1-D window: wy); parts as above; n_el, css_y and css_x the
// global count and the centred coordinates' sums of squares of the fit;
// vec = 0 when x and out differ in their 16-byte alignment (scalar I/O).
extern "C" int k6_apply_f32(const void* x, void* out, const void* mom,
                            const void* wy, const void* wx, long long B,
                            int NY, int NX, int nchunks, int cw, double cy0,
                            double cx0, int parts, double n_el, double css_y,
                            double css_x, int vec, void* stream) {
  return apply<float>(x, out, mom, wy, wx, B, NY, NX, nchunks, cw, cy0, cx0,
                      parts, n_el, css_y, css_x, vec, stream);
}

extern "C" int k6_apply_f64(const void* x, void* out, const void* mom,
                            const void* wy, const void* wx, long long B,
                            int NY, int NX, int nchunks, int cw, double cy0,
                            double cx0, int parts, double n_el, double css_y,
                            double css_x, int vec, void* stream) {
  return apply<double>(x, out, mom, wy, wx, B, NY, NX, nchunks, cw, cy0, cx0,
                       parts, n_el, css_y, css_x, vec, stream);
}
