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
// Layout: x[B, NZ, NY, NX] contiguous, T = float or double: B fields of NZ
// planes of NY rows of NX values, the rows the passes' unit.  A detrend
// over one or two trailing axes is the case NZ = 1 (and NY = 1 over the
// trailing axis alone).  The block may be one rank's stretch of a sharded
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
//   2. moments_fields, the tiny stage: one group of threads per field
//      strides over its P = NZ NY nchunks partials in a fixed order and sums
//      S = sum R, Y = sum c_i R, X = sum W, Z = sum c_k R into mom[nmom, B]
//      (Z, the fourth row, over three axes only).  The group grows with P:
//      a warp below 512 partials, a block of 256 threads below 2^16 (the
//      benchmark's 4096 rows of a field), else a cluster of 8 blocks of 1024
//      (a 2048^2 plane of rows gives a million partials), the blocks' sums
//      added in rank order through distributed shared memory.  No atomics:
//      the same input gives the same bits.  (A sharded block's mom is summed
//      over the ranks between 2 and 3.)
//   3. apply: one warp per (row, chunk) reads its values again and writes
//      the FFT's input once,
//        mean = S / n, a_z = Z / css_z, a_y = Y / css_y, a_x = X / css_x,
//        out  = round_T( round_T(x - trend) * round_T(round_T(w_b w_c) w_a) ),
//      the trend subtracted in double in the plain path's parts and order
//      (its shape ``kind``, which ``ops/prologue.py::trend_code`` derives
//      once from the plan's fitted order; each task's loop over its values
//      is the one compiled for its shape, with no branch on it: worth 3-7%
//      of the float32 pass on an H100 against a switch a value), and the
//      window's factor the plain path's product of the 1-D factors, those
//      of the transform's last two dims first; a missing factor (fewer
//      axes) is 1, and multiplying by 1 is exact.  Every operation rounds on
//      its own (no FMA contraction), so only the order of the moments'
//      float64 sums differs from the plain version.
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
// the fields stage's cluster: kCluster blocks of kClusterThreads a field
constexpr int kCluster = 8;
constexpr int kClusterThreads = 1024;

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

// G threads per field: a warp (32), a block (kThreads) or a cluster
// (kCluster * kClusterThreads).  Thread r of a field's group takes its
// partials r, r + G, r + 2G, ..., carrying (plane, row, chunk) along
// without a division.
template <int G>
__global__ void __launch_bounds__(G > kThreads ? kClusterThreads : kThreads)
    moments_fields_kernel(const double2* __restrict__ part,
                          double* __restrict__ mom, long long B, int nmom,
                          int NY, int nchunks, long long P, double cz0,
                          double cy0) {
  constexpr int kBlock = G > kThreads ? kClusterThreads : kThreads;
  long long b;  // the field
  int r;        // this thread's rank in the field's group
  if constexpr (G < kBlock) {
    b = (long long)blockIdx.x * (kBlock / G) + threadIdx.x / G;
    r = threadIdx.x % G;
  } else {
    b = blockIdx.x / (G / kBlock);
    r = blockIdx.x % (G / kBlock) * kBlock + threadIdx.x;
  }
  double s = 0.0, y = 0.0, xs = 0.0, z = 0.0;
  if (b < B) {
    const double2* q = part + b * P;
    long long row = r / nchunks, k = row / NY;
    int c = (int)(r - row * nchunks), i = (int)(row - k * NY);
    const long long drow = G / nchunks, dk = drow / NY;
    const int dc = (int)(G - drow * nchunks), di = (int)(drow - dk * NY);
    for (long long t = r; t < P; t += G) {
      const double2 v = q[t];
      s = dadd(s, v.x);
      y = __fma_rn(cy0 + (double)i, v.x, y);
      xs = dadd(xs, v.y);
      z = __fma_rn(cz0 + (double)k, v.x, z);
      c += dc;
      i += di;
      k += dk;
      if (c >= nchunks) {
        c -= nchunks;
        ++i;
      }
      if (i >= NY) {
        i -= NY;
        ++k;
      }
    }
  }
  double m[4] = {warp_sum(s), warp_sum(y), warp_sum(xs), warp_sum(z)};
  if constexpr (G > 32) {  // the block's warps, in order, by its thread 0
    constexpr int kW = kBlock / 32;
    __shared__ double acc[4][kW];
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e][threadIdx.x >> 5] = m[e];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = acc[e][0];
        for (int w = 1; w < kW; ++w) m[e] = dadd(m[e], acc[e][w]);
      }
    }
  }
  if constexpr (G > kBlock) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ double sums[4];
    if (threadIdx.x == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[e] = m[e];
    }
    cluster.sync();
    const bool lead = cluster.block_rank() == 0 && threadIdx.x == 0;
    if (lead) {
      for (unsigned c = 1; c < kCluster; ++c) {
        const double* o = cluster.map_shared_rank(sums, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e] = dadd(m[e], o[e]);
      }
    }
    cluster.sync();  // no block leaves while rank 0 reads its sums
    if (!lead) return;
  }
  if (threadIdx.x % G != 0 || b >= B) return;
  for (int e = 0; e < nmom; ++e) mom[e * B + b] = m[e];
}

// The trend of a row in the plain version's parts: m0 the mean, with the
// first row term where a row term comes first; ax the column's slope; ra
// and rb the row's z and y terms in the order they are subtracted.
struct Trend {
  double m0, ax, ra, rb;

  // x's value less the trend, rounded to T, for the trend's shape K (1-8):
  // the fitted axes in the plain version's order, x the column's slope and
  // r a row term (``ops/prologue.py::trend_code``; 0, the mean alone, is 1)
  template <int K, typename T>
  __device__ __forceinline__ T of(T xv, double cj) const {
    const double v = xv;
    double d;
    switch (K) {  // a constant: one case is compiled
      case 1: d = dsub(v, m0); break;                                  // r
      case 2: d = dsub(dsub(v, m0), rb); break;                        // r r
      case 3: d = dsub(v, dadd(m0, dmul(ax, cj))); break;              // x
      case 4: d = dsub(dsub(v, dadd(m0, dmul(ax, cj))), ra); break;    // x r
      case 5:                                                          // x r r
        d = dsub(dsub(dsub(v, dadd(m0, dmul(ax, cj))), ra), rb);
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

// The window's factor of column j from wx[j]: round_T(round_T(win * wx[j]) *
// wout), win the product of the row's other two factors or one of them,
// wout the third or 1.
template <typename T>
struct Win {
  T win, wout;
  __device__ __forceinline__ T operator()(T wj) const {
    return mul_rn(mul_rn(win, wj), wout);
  }
};

// One task of the apply pass: n values of a row at p, written to o, less the
// trend f of shape K, times the window's factors wf(w[j]) where w is not
// null.  K is fixed for the loop, so it holds no branch on the shape.
template <int K, typename T>
__device__ __forceinline__ void apply_span(const T* __restrict__ p,
                                           T* __restrict__ o,
                                           const T* __restrict__ w, int n,
                                           double c0, int vec, int lane,
                                           const Trend& f,
                                           const Win<T>& wf) {
  constexpr int V = kVec<T>;
  const int head = vec ? head_of(p, n) : n;
  const int nv = (n - head) / V;
  // the window's factors as 16-byte loads where they align with the data's
  const bool wvec = w && head_of(w + head, V) == 0;
  for (int j = lane; j < head; j += 32) {
    const T r = f.template of<K>(p[j], c0 + j);
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
      const T r = f.template of<K>(q[e], c + e);
      q[e] = w ? mul_rn(r, wf(wj[e])) : r;
    }
    store16_last(o + j, q);
  }
  for (int j = head + nv * V + lane; j < n; j += 32) {
    const T r = f.template of<K>(p[j], c0 + j);
    o[j] = w ? mul_rn(r, wf(w[j])) : r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const double* __restrict__ mom, const T* __restrict__ wz,
                 const T* __restrict__ wy, const T* __restrict__ wx,
                 long long B, long long tasks, int NZ, int NY, int NX,
                 int nchunks, int cw, double cz0, double cy0, double cx0,
                 int kind, int zfirst, int wlast, double n_el, double css_z,
                 double css_y, double css_x, int vec) {
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tasks) return;
  const int lane = threadIdx.x & 31;
  long long row;
  int k0, n;
  task_of(t, nchunks, cw, NX, row, k0, n);
  const long long bz = row / NY;
  const int i = (int)(row - bz * NY);
  const long long b = NZ == 1 ? bz : bz / NZ;  // one plane: no division
  const int k = (int)(bz - b * NZ);
  // the row's z and y terms where fitted (a sum of squares of 0: not)
  const double tz =
      css_z > 0.0 ? dmul(__ddiv_rn(mom[3 * B + b], css_z), cz0 + k) : 0.0;
  const double ty =
      css_y > 0.0 ? dmul(__ddiv_rn(mom[B + b], css_y), cy0 + i) : 0.0;
  const double mean = __ddiv_rn(mom[b], n_el);
  Trend f;
  f.ax = css_x > 0.0 ? __ddiv_rn(mom[2 * B + b], css_x) : 0.0;
  f.ra = zfirst ? tz : ty;
  f.rb = zfirst ? ty : tz;
  f.m0 = kind == 1 || kind == 2 || kind >= 6 ? dadd(mean, f.ra) : mean;
  // the window: wlast names the factor multiplied last (0 z, 1 y, 2 x), the
  // other two first; a missing factor is 1
  const T wzk = wz ? wz[k] : T(1), wyi = wy ? wy[i] : T(1);
  const T win = wlast == 0 ? wyi : wlast == 1 ? wzk : mul_rn(wzk, wyi);
  const T wout = wlast == 0 ? wzk : wlast == 1 ? wyi : T(1);
  const Win<T> wf{win, wout};
  const T* p = x + row * NX + k0;
  T* o = out + row * NX + k0;
  const T* w = wx ? wx + k0 : nullptr;
  const double c0 = cx0 + k0;
  switch (kind) {
    case 0:
    case 1: apply_span<1>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 2: apply_span<2>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 3: apply_span<3>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 4: apply_span<4>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 5: apply_span<5>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 6: apply_span<6>(p, o, w, n, c0, vec, lane, f, wf); break;
    case 7: apply_span<7>(p, o, w, n, c0, vec, lane, f, wf); break;
    default: apply_span<8>(p, o, w, n, c0, vec, lane, f, wf); break;
  }
}

bool bad_shape(long long B, int NZ, int NY, int NX, int nchunks, int cw) {
  return B < 1 || NZ < 1 || NY < 1 || NX < 1 || nchunks < 1 || cw < 1 ||
         (long long)nchunks * cw < NX || (long long)(nchunks - 1) * cw >= NX ||
         B > 0x7fffffffLL / kCluster ||
         (B * NZ * NY * nchunks + kWarps - 1) / kWarps > 0x7fffffffLL;
}

template <typename T>
int moments(const void* x, void* part, void* mom, long long B, int NZ, int NY,
            int NX, int nchunks, int cw, int nmom, double cz0, double cy0,
            double cx0, void* stream) {
  if (bad_shape(B, NZ, NY, NX, nchunks, cw) || nmom < 3 || nmom > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long P = (long long)NZ * NY * nchunks, tasks = B * P;
  moments_rows_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps),
                           kThreads, 0, s>>>((const T*)x, (double2*)part,
                                             tasks, NX, nchunks, cw, cx0);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const double2* q = (const double2*)part;
  double* m = (double*)mom;
  if (P < 512) {
    moments_fields_kernel<32><<<(unsigned)((B + kWarps - 1) / kWarps),
                                kThreads, 0, s>>>(q, m, B, nmom, NY, nchunks,
                                                  P, cz0, cy0);
  } else if (P < (1 << 16)) {
    moments_fields_kernel<kThreads><<<(unsigned)B, kThreads, 0, s>>>(
        q, m, B, nmom, NY, nchunks, P, cz0, cy0);
  } else {
    cudaLaunchAttribute cluster = {cudaLaunchAttributeClusterDimension};
    cluster.val.clusterDim = {kCluster, 1, 1};
    const cudaLaunchConfig_t cfg = {dim3((unsigned)(B * kCluster)),
                                    dim3(kClusterThreads), 0, s, &cluster, 1};
    return (int)cudaLaunchKernelEx(
        &cfg, moments_fields_kernel<kCluster * kClusterThreads>, q, m, B,
        nmom, NY, nchunks, P, cz0, cy0);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, void* out, const void* mom, const void* wz,
          const void* wy, const void* wx, long long B, int NZ, int NY, int NX,
          int nchunks, int cw, double cz0, double cy0, double cx0, int kind,
          int zfirst, int wlast, double n_el, double css_z, double css_y,
          double css_x, int vec, void* stream) {
  if (bad_shape(B, NZ, NY, NX, nchunks, cw) || kind < 0 || kind > 8 ||
      zfirst < 0 || zfirst > 1 || wlast < 0 || wlast > 2 ||
      (!wx && (wy || wz)))
    return (int)cudaErrorInvalidValue;
  const long long tasks = B * NZ * NY * nchunks;
  apply_kernel<T><<<(unsigned)((tasks + kWarps - 1) / kWarps), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, (const double*)mom, (const T*)wz, (const T*)wy,
      (const T*)wx, B, tasks, NZ, NY, NX, nchunks, cw, cz0, cy0, cx0, kind,
      zfirst, wlast, n_el, css_z, css_y, css_x, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Passes 1 and 2 (two launches).  x: float32 [B, NZ, NY, NX] contiguous;
// part: float64 [B * NZ * NY * nchunks, 2] scratch; mom: float64 [nmom, B]
// out (S, Y, X, and Z where nmom = 4, of each field).  Columns are cut into
// nchunks chunks of cw (the last shorter, none empty).  Returns the
// cudaError_t of the launches.
extern "C" int k6_moments_f32(const void* x, void* part, void* mom,
                              long long B, int NZ, int NY, int NX,
                              int nchunks, int cw, int nmom, double cz0,
                              double cy0, double cx0, void* stream) {
  return moments<float>(x, part, mom, B, NZ, NY, NX, nchunks, cw, nmom, cz0,
                        cy0, cx0, stream);
}

extern "C" int k6_moments_f64(const void* x, void* part, void* mom,
                              long long B, int NZ, int NY, int NX,
                              int nchunks, int cw, int nmom, double cz0,
                              double cy0, double cx0, void* stream) {
  return moments<double>(x, part, mom, B, NZ, NY, NX, nchunks, cw, nmom, cz0,
                         cy0, cx0, stream);
}

// Pass 3 (one launch).  out: like x; mom as summed over the ranks; wz [NZ],
// wy [NY], wx [NX]: the window's factors in x's dtype, NULL where missing
// (no window: all three; a missing wz or wy is 1); kind and zfirst: the
// trend (``ops/prologue.py::trend_code``); wlast: the axis whose factor
// multiplies last, the first of the transform's dims (0 z, 1 y, 2 x); n_el
// and css_? the global count and the centred coordinates' sums of squares
// of the fit (0 where an axis is not fitted); vec = 0 when x and out differ
// in their 16-byte alignment (scalar I/O).
extern "C" int k6_apply_f32(const void* x, void* out, const void* mom,
                            const void* wz, const void* wy, const void* wx,
                            long long B, int NZ, int NY, int NX, int nchunks,
                            int cw, double cz0, double cy0, double cx0,
                            int kind, int zfirst, int wlast, double n_el,
                            double css_z, double css_y, double css_x, int vec,
                            void* stream) {
  return apply<float>(x, out, mom, wz, wy, wx, B, NZ, NY, NX, nchunks, cw,
                      cz0, cy0, cx0, kind, zfirst, wlast, n_el, css_z, css_y,
                      css_x, vec, stream);
}

extern "C" int k6_apply_f64(const void* x, void* out, const void* mom,
                            const void* wz, const void* wy, const void* wx,
                            long long B, int NZ, int NY, int NX, int nchunks,
                            int cw, double cz0, double cy0, double cx0,
                            int kind, int zfirst, int wlast, double n_el,
                            double css_z, double css_y, double css_x, int vec,
                            void* stream) {
  return apply<double>(x, out, mom, wz, wy, wx, B, NZ, NY, NX, nchunks, cw,
                       cz0, cy0, cx0, kind, zfirst, wlast, n_el, css_z,
                       css_y, css_x, vec, stream);
}
