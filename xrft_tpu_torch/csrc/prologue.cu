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
// of NX values (NY = 1 for a detrend over the trailing axis alone); over
// three trailing axes x[B, NZ, NY, NX], each field NZ planes of NY rows, the
// same rows to the passes.  The block may be one rank's stretch of a sharded
// field: plane k, row i and column j sit at the centred coordinates
//
//   c_k = cz0 + k,  c_i = cy0 + i,  c_j = cx0 + j,  c?0 = lo_? - (G? - 1)/2,
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
//      into mom[3, B]; over three axes moments_fields3 adds Z = sum c_k R,
//      into mom[4, B], one cluster of 8 blocks a field (a 2048^2 plane of
//      rows gives a million partials: one block would read them serially),
//      the blocks' sums added in rank order through distributed shared
//      memory.  No atomics: the same input gives the same bits.  (A
//      sharded block's mom is summed over the ranks between 2 and 3.)
//   3. apply: one warp per (row, chunk) reads its values again and writes
//      the FFT's input once,
//        mean = S / n, a_y = Y / css_y, a_x = X / css_x,
//        out  = round_T( round_T(x - trend) * round_T(wy[i] * wx[j]) ),
//      the trend subtracted in double in the plain path's parts and order
//      (``parts``, which ``ops/prologue.py::_PARTS`` derives from the plan's
//      fitted order): 0 x - mean; 1 x - (mean + a_y c_i); 2 x - (mean + a_x c_j);
//      3 (x - (mean + a_y c_i)) - a_x c_j; 4 (x - (mean + a_x c_j)) - a_y c_i.
//      Over three axes (apply3) the fitted axes come in any order, the first
//      part with the mean (Trend3), and the window's factor is the plain
//      path's product of the three 1-D factors, the last two of the
//      transform's dims first: round_T(round_T(w_b w_c) w_a).
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

#include <cooperative_groups.h>
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

// Over three axes: one cluster of kCluster blocks per field.  Thread g of
// the cluster takes the field's rows g, g + G, g + 2G, ... (G its threads),
// carrying (plane, row) along without a division.
constexpr int kCluster = 8;
constexpr int kFieldThreads = 1024;

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kFieldThreads)
    moments_fields3_kernel(const double2* __restrict__ part,
                           double* __restrict__ mom, long long B, int NZ,
                           int NY, int nchunks, double cz0, double cy0) {
  constexpr int kW = kFieldThreads / 32;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long b = blockIdx.x / kCluster;
  const long long rows = (long long)NZ * NY;
  const double2* q = part + b * rows * nchunks;
  constexpr long long G = (long long)kCluster * kFieldThreads;
  long long r = (long long)rank * kFieldThreads + threadIdx.x;
  long long k = r / NY;
  int i = (int)(r - k * NY);
  const long long dk = G / NY;
  const int di = (int)(G - dk * NY);
  double s = 0.0, y = 0.0, xs = 0.0, z = 0.0;
  for (; r < rows; r += G) {
    double R = 0.0, W = 0.0;
    for (int c = 0; c < nchunks; ++c) {
      const double2 v = q[r * nchunks + c];
      R = dadd(R, v.x);
      W = dadd(W, v.y);
    }
    s = dadd(s, R);
    y = __fma_rn(cy0 + (double)i, R, y);
    xs = dadd(xs, W);
    z = __fma_rn(cz0 + (double)k, R, z);
    k += dk;
    i += di;
    if (i >= NY) {
      i -= NY;
      ++k;
    }
  }
  __shared__ double acc[4][kW];
  __shared__ double sums[4];
  const double v[4] = {warp_sum(s), warp_sum(y), warp_sum(xs), warp_sum(z)};
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m][threadIdx.x >> 5] = v[m];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      double t = acc[m][0];
      for (int w = 1; w < kW; ++w) t = dadd(t, acc[m][w]);
      sums[m] = t;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    double t[4] = {sums[0], sums[1], sums[2], sums[3]};
    for (unsigned c = 1; c < kCluster; ++c) {
      const double* o = cluster.map_shared_rank(sums, c);
#pragma unroll
      for (int m = 0; m < 4; ++m) t[m] = dadd(t[m], o[m]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) mom[m * B + b] = t[m];
  }
  cluster.sync();  // no block leaves while rank 0 reads its sums
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

// The same over three axes: the fitted axes in any order (``kind``, from
// the plain version's order), ra and rb the row's z and y terms in the
// order they are subtracted, m0 the mean with the first of them.
struct Trend3 {
  int kind;
  double mean, ax, m0, ra, rb;

  template <typename T>
  __device__ __forceinline__ T operator()(T xv, double cj) const {
    const double v = xv;
    double d;
    switch (kind) {
      case 0: d = dsub(v, mean); break;                                // -
      case 1: d = dsub(v, m0); break;                                  // r
      case 2: d = dsub(dsub(v, m0), rb); break;                        // r r
      case 3: d = dsub(v, dadd(mean, dmul(ax, cj))); break;            // x
      case 4: d = dsub(dsub(v, dadd(mean, dmul(ax, cj))), ra); break;  // x r
      case 5:                                                          // x r r
        d = dsub(dsub(dsub(v, dadd(mean, dmul(ax, cj))), ra), rb);
        break;
      case 6: d = dsub(dsub(v, m0), dmul(ax, cj)); break;              // r x
      case 7: d = dsub(dsub(dsub(v, m0), dmul(ax, cj)), rb); break;    // r x r
      default: d = dsub(dsub(dsub(v, m0), rb), dmul(ax, cj)); break;   // r r x
    }
    T r;
    round_to(d, r);
    return r;
  }
};

// The window's factor of column j from wx[j]: round_T(wyi * wx[j]) over
// two axes, round_T(round_T(win * wx[j]) * wout) over three.
template <typename T>
struct Win2 {
  T wyi;
  __device__ __forceinline__ T operator()(T wj) const { return mul_rn(wyi, wj); }
};

template <typename T>
struct Win3 {
  T win, wout;
  __device__ __forceinline__ T operator()(T wj) const {
    return mul_rn(mul_rn(win, wj), wout);
  }
};

// One task of the apply pass: n values of a row at p, written to o, less the
// trend f, times the window's factors wf(w[j]) where w is not null.
template <typename T, typename F, typename Wf>
__device__ __forceinline__ void apply_span(const T* __restrict__ p,
                                           T* __restrict__ o,
                                           const T* __restrict__ w, int n,
                                           double c0, int vec, int lane,
                                           const F& f, const Wf& wf) {
  constexpr int V = kVec<T>;
  const int head = vec ? head_of(p, n) : n;
  const int nv = (n - head) / V;
  // the window's factors as 16-byte loads where they align with the data's
  const bool wvec = w && head_of(w + head, V) == 0;
  for (int j = lane; j < head; j += 32) {
    const T r = f(p[j], c0 + j);
    o[j] = w ? mul_rn(r, wf(w[j])) : r;
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
      q[e] = w ? mul_rn(r, wf(wj[e])) : r;
    }
    store16_last(o + j, q);
  }
  for (int j = head + nv * V + lane; j < n; j += 32) {
    const T r = f(p[j], c0 + j);
    o[j] = w ? mul_rn(r, wf(w[j])) : r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const double* __restrict__ mom, const T* __restrict__ wy,
                 const T* __restrict__ wx, long long B, long long tasks,
                 int NY, int NX, int nchunks, int cw, double cy0, double cx0,
                 int parts, double n_el, double css_y, double css_x, int vec) {
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
  apply_span(x + row * NX + k0, out + row * NX + k0, wx ? wx + k0 : nullptr,
             n, cx0 + k0, vec, lane, f, Win2<T>{wyi});
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply3_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const double* __restrict__ mom, const T* __restrict__ wz,
                  const T* __restrict__ wy, const T* __restrict__ wx,
                  long long B, long long tasks, int NZ, int NY, int NX,
                  int nchunks, int cw, double cz0, double cy0, double cx0,
                  int order, int wlast, double n_el, double css_z,
                  double css_y, double css_x, int vec) {
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tasks) return;
  const int lane = threadIdx.x & 31;
  long long row;
  int k0, n;
  task_of(t, nchunks, cw, NX, row, k0, n);
  const long long plane = (long long)NZ * NY;
  const long long b = row / plane;
  const long long zy = row - b * plane;
  const int k = (int)(zy / NY);
  const int i = (int)(zy - (long long)k * NY);
  Trend3 f;
  f.mean = __ddiv_rn(mom[b], n_el);
  f.ax = 0.0;
  f.ra = f.rb = 0.0;
  // the fitted axes in the plain version's order, 2 bits each from the
  // lowest: 1 z, 2 y, 3 x
  int fitted = 0, rows_fitted = 0, xpos = -1;
  for (int o = order; o; o >>= 2, ++fitted) {
    const int a = o & 3;
    if (a == 3) {
      xpos = fitted;
      f.ax = __ddiv_rn(mom[2 * B + b], css_x);
      continue;
    }
    const double r = a == 1 ? dmul(__ddiv_rn(mom[3 * B + b], css_z), cz0 + k)
                            : dmul(__ddiv_rn(mom[B + b], css_y), cy0 + i);
    if (rows_fitted++ == 0) {
      f.ra = r;
    } else {
      f.rb = r;
    }
  }
  f.kind = fitted == 0 ? 0
           : xpos < 0  ? fitted
           : xpos == 0 ? 2 + fitted
           : xpos == 1 ? 4 + fitted
                       : 8;
  f.m0 = rows_fitted && xpos != 0 ? dadd(f.mean, f.ra) : f.mean;
  // the window: wlast names the factor multiplied last (0 z, 1 y, 2 x);
  // the other two are multiplied first
  T win = T(1), wout = T(1);
  if (wx) {
    const T wzk = wz[k], wyi = wy[i];
    win = wlast == 0 ? wyi : wlast == 1 ? wzk : mul_rn(wzk, wyi);
    wout = wlast == 0 ? wzk : wlast == 1 ? wyi : T(1);
  }
  apply_span(x + row * NX + k0, out + row * NX + k0, wx ? wx + k0 : nullptr,
             n, cx0 + k0, vec, lane, f, Win3<T>{win, wout});
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

// Three axes: B fields of NZ planes of NY rows, as rows to the passes.
bool bad_shape3(long long B, int NZ, int NY, int NX, int nchunks, int cw) {
  return NZ < 1 || bad_shape(B, NY, NX, nchunks, cw) ||
         B > 0x7fffffffLL / kCluster ||
         (B * NZ * NY * nchunks + kWarps - 1) / kWarps > 0x7fffffffLL;
}

template <typename T>
int moments3(const void* x, void* part, void* mom, long long B, int NZ,
             int NY, int NX, int nchunks, int cw, double cz0, double cy0,
             double cx0, void* stream) {
  if (bad_shape3(B, NZ, NY, NX, nchunks, cw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tasks = B * NZ * NY * nchunks;
  moments_rows_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps),
                           kThreads, 0, s>>>((const T*)x, (double2*)part,
                                             tasks, NX, nchunks, cw, cx0);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  moments_fields3_kernel<<<(unsigned)(B * kCluster), kFieldThreads, 0, s>>>(
      (const double2*)part, (double*)mom, B, NZ, NY, nchunks, cz0, cy0);
  return (int)cudaGetLastError();
}

template <typename T>
int apply3(const void* x, void* out, const void* mom, const void* wz,
           const void* wy, const void* wx, long long B, int NZ, int NY,
           int NX, int nchunks, int cw, double cz0, double cy0, double cx0,
           int order, int wlast, double n_el, double css_z, double css_y,
           double css_x, int vec, void* stream) {
  if (bad_shape3(B, NZ, NY, NX, nchunks, cw) || order < 0 || order >= 64 ||
      wlast < 0 || wlast > 2 || (wx && (!wy || !wz)))
    return (int)cudaErrorInvalidValue;
  const long long tasks = B * NZ * NY * nchunks;
  apply3_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, (const double*)mom, (const T*)wz, (const T*)wy,
      (const T*)wx, B, tasks, NZ, NY, NX, nchunks, cw, cz0, cy0, cx0, order,
      wlast, n_el, css_z, css_y, css_x, vec);
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

// Over three trailing axes, x: [B, NZ, NY, NX] contiguous.  Passes 1 and 2
// (two launches): mom float64 [4, B] out (S, Y, X, Z of each field); part
// as above, B * NZ * NY * nchunks rows.
extern "C" int k6_moments3_f32(const void* x, void* part, void* mom,
                               long long B, int NZ, int NY, int NX,
                               int nchunks, int cw, double cz0, double cy0,
                               double cx0, void* stream) {
  return moments3<float>(x, part, mom, B, NZ, NY, NX, nchunks, cw, cz0, cy0,
                         cx0, stream);
}

extern "C" int k6_moments3_f64(const void* x, void* part, void* mom,
                               long long B, int NZ, int NY, int NX,
                               int nchunks, int cw, double cz0, double cy0,
                               double cx0, void* stream) {
  return moments3<double>(x, part, mom, B, NZ, NY, NX, nchunks, cw, cz0, cy0,
                          cx0, stream);
}

// Pass 3 over three axes (one launch).  wz [NZ], wy [NY], wx [NX]: the
// window's factors, all three or none (NULL); order: the fitted axes in the
// plain version's order, 2 bits each from the lowest (1 z, 2 y, 3 x; 0 for
// a constant detrend); wlast: the axis whose factor multiplies last, the
// first of the transform's dims (0 z, 1 y, 2 x); css_z the z coordinate's
// sum of squares; the rest as k6_apply_*.
extern "C" int k6_apply3_f32(const void* x, void* out, const void* mom,
                             const void* wz, const void* wy, const void* wx,
                             long long B, int NZ, int NY, int NX, int nchunks,
                             int cw, double cz0, double cy0, double cx0,
                             int order, int wlast, double n_el, double css_z,
                             double css_y, double css_x, int vec,
                             void* stream) {
  return apply3<float>(x, out, mom, wz, wy, wx, B, NZ, NY, NX, nchunks, cw,
                       cz0, cy0, cx0, order, wlast, n_el, css_z, css_y, css_x,
                       vec, stream);
}

extern "C" int k6_apply3_f64(const void* x, void* out, const void* mom,
                             const void* wz, const void* wy, const void* wx,
                             long long B, int NZ, int NY, int NX, int nchunks,
                             int cw, double cz0, double cy0, double cx0,
                             int order, int wlast, double n_el, double css_z,
                             double css_y, double css_x, int vec,
                             void* stream) {
  return apply3<double>(x, out, mom, wz, wy, wx, B, NZ, NY, NX, nchunks, cw,
                        cz0, cy0, cx0, order, wlast, n_el, css_z, css_y,
                        css_x, vec, stream);
}
