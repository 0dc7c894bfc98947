// Mixed-radix Stockham FFT of a tile of rows held in shared memory: the
// device routine that kernels K2 (fft_fourstep.cu, float) and K4
// (dft64.cu, double) share.
//
// The host plan (xrft_tpu_torch/ops/fft_plan.py) gives the radices of the
// length n, largest first, and one table of twiddles and roots per
// (plan, sign), built in float64 with integer angle reduction.  Stage s of
// radix R and stride ns (the product of the earlier radices) is, for each
// group j in [0, n/R) with k = j mod ns,
//
//   v[r] = src[j + r*n/R] * W_(ns*R)^(r*k);   v = DFT_R(v);
//   dst[(j - k)*R + k + r*ns] = v[r]
//
// and the last stage leaves the output in natural frequency order.  R in
// {16, 8, 4, 2} is a radix-2 decimation in frequency in registers, R in
// {3, 5, 7, 11, 13} the symmetric-pair butterfly in registers, and any
// other prime one direct stage over shared memory (one thread per output,
// its twiddles applied in place first).  All arithmetic is FMAs on the
// table's values: no trigonometry on the device, no atomics, and a fixed
// order of every sum, so two launches are bit-identical.
//
// Shared memory: at most two buffers per tile, each row at a stride of
// padded_ld(n) with one spare slot per 16 values, so the strided stores of
// the early stages do not pile onto a few banks; the stages alternate
// between them.  The first stage reads the input rows in their own type
// (real float32 is promoted in registers): straight from global memory
// where a warp's reads fill whole 128-byte lines, else from a raw copy of
// the tile (cp.async, 16 bytes where aligned) at the start of buffer 0.
// Likewise the last stage writes straight to global memory, or the tile is
// stored from shared memory afterwards.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stockham {

constexpr int kMaxStages = 24;   // fft_plan.MAX_STAGES
constexpr int kHeader = 5;       // [n, sign, passes, inter, table_len]
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may use

struct Stage {
  int radix, ns, tw, rt;
};

struct Plan {
  int n, nstages;
  Stage st[kMaxStages];
};

__host__ __device__ __forceinline__ int padded_ld(int n) {
  return (n + (n >> 4)) | 1;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  C r;
  r.x = a.x + b.x;
  r.y = a.y + b.y;
  return r;
}

template <typename C>
__device__ __forceinline__ C csub(C a, C b) {
  C r;
  r.x = a.x - b.x;
  r.y = a.y - b.y;
  return r;
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C w) {
  C r;
  r.x = fmadd(a.x, w.x, -a.y * w.y);
  r.y = fmadd(a.x, w.y, a.y * w.x);
  return r;
}

// a * (sign * i), exact
template <typename C>
__device__ __forceinline__ C mul_i(C a, int sign) {
  C r;
  r.x = sign > 0 ? -a.y : a.y;
  r.y = sign > 0 ? a.x : -a.x;
  return r;
}

__device__ __forceinline__ float2 widen(float v) {
  return make_float2(v, 0.f);
}
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

__host__ __device__ constexpr int log2i(int r) {
  return r <= 1 ? 0 : 1 + log2i(r >> 1);
}

// q with its low `bits` bits reversed; a loop, not a recursion, so that it
// folds to a constant inside unrolled loops.
__host__ __device__ __forceinline__ constexpr int bitrev(int q, int bits) {
  int r = 0;
  for (int t = 0; t < bits; ++t) r |= ((q >> t) & 1) << (bits - 1 - t);
  return r;
}

// DFT_R of a[] in place, R = 2^L: radix-2 decimation in frequency, then the
// bit-reversed read.  roots[e] = W_R^e.  Every loop has a constant trip
// count, so the loops unroll and a[] stays in registers.
template <int R, typename C>
__device__ __forceinline__ void butterfly_pow2(C (&a)[R],
                                               const C* __restrict__ roots,
                                               int sign) {
  constexpr int L = log2i(R);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int half = R >> (l + 1);
#pragma unroll
    for (int p = 0; p < R / 2; ++p) {
      const int i = p % half;
      const int top = (p / half) * 2 * half + i;
      const C u = a[top], w = a[top + half];
      a[top] = cadd(u, w);
      C t = csub(u, w);
      const int e = i << l;  // W_(2*half)^i = W_R^(i * 2^l)
      if (4 * e == R) {
        t = mul_i(t, sign);
      } else if (e != 0) {
        t = cmul(t, __ldg(roots + e));
      }
      a[top + half] = t;
    }
  }
  C b[R];
#pragma unroll
  for (int q = 0; q < R; ++q) b[q] = a[bitrev(q, L)];
#pragma unroll
  for (int q = 0; q < R; ++q) a[q] = b[q];
}

// DFT_R of a[] in place, R odd: X[k] = a0 + sum_m s_m Re W^mk
// + i sum_m d_m Im W^mk with s_m = a_m + a_(R-m), d_m = a_m - a_(R-m).
template <int R, typename C>
__device__ __forceinline__ void butterfly_odd(C (&a)[R],
                                              const C* __restrict__ roots) {
  constexpr int h = (R - 1) / 2;
  C s[h + 1], d[h + 1], w[R];
  const C a0 = a[0];
  C total = a0;
#pragma unroll
  for (int m = 1; m <= h; ++m) {
    s[m] = cadd(a[m], a[R - m]);
    d[m] = csub(a[m], a[R - m]);
    total = cadd(total, s[m]);
  }
#pragma unroll
  for (int e = 1; e < R; ++e) w[e] = __ldg(roots + e);
  a[0] = total;
#pragma unroll
  for (int k = 1; k <= h; ++k) {
    C A = a0, B;
    B.x = 0;
    B.y = 0;
#pragma unroll
    for (int m = 1; m <= h; ++m) {
      const C wm = w[(m * k) % R];
      A.x = A.x + s[m].x * wm.x;
      A.y = A.y + s[m].y * wm.x;
      B.x = B.x + d[m].x * wm.y;
      B.y = B.y + d[m].y * wm.y;
    }
    a[k].x = A.x - B.y;
    a[k].y = A.y + B.x;
    a[R - k].x = A.x + B.y;
    a[R - k].y = A.y - B.x;
  }
}

template <int R, typename C>
__device__ __forceinline__ void butterfly(C (&a)[R],
                                          const C* __restrict__ roots,
                                          int sign) {
  if constexpr ((R & (R - 1)) == 0) {
    butterfly_pow2<R>(a, roots, sign);
  } else {
    butterfly_odd<R>(a, roots);
  }
}

// Stage functions: src holds nseq sequences at stride src_ld, padded
// (kPadSrc: a shared buffer) or not (the input rows, in global memory or
// copied raw to shared memory, of type Src); dst takes them at stride ld,
// padded (kPadDst: a shared buffer) or not (the output rows in global
// memory).
__device__ __forceinline__ int at(bool padded, int i) {
  return padded ? pad(i) : i;
}

// One register stage of radix R.
template <int R, typename C, typename Src, bool kPadSrc, bool kPadDst>
__device__ void stage_reg(const Src* src, int src_ld, C* dst, int ld,
                          int nseq, int n, Stage st,
                          const C* __restrict__ table, int sign) {
  const int m = n / R;
  const int items = nseq * m;
  const C* tw = table + st.tw;
  const C* roots = table + st.rt;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int s = it / m;
    const int j = it - s * m;
    const int k = j % st.ns;
    const Src* row = src + s * src_ld;
    C v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = widen(row[at(kPadSrc, j + r * m)]);
    if (st.ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], __ldg(tw + (r - 1) * st.ns + k));
    }
    butterfly<R>(v, roots, sign);
    C* out = dst + s * ld;
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[at(kPadDst, d + r * st.ns)] = v[r];
  }
}

// The direct stage of a prime radix p > 13: the twiddles are applied to src
// in place (only after the first stage, where src is a padded buffer), then
// one thread per output sums its p terms in order.
template <typename C, typename Src, bool kPadSrc, bool kPadDst>
__device__ void stage_direct(const Src* src, int src_ld, C* dst, int ld,
                             int nseq, int n, Stage st,
                             const C* __restrict__ table) {
  const int p = st.radix;
  const int m = n / p;
  if constexpr (kPadSrc) {
    if (st.ns > 1) {
      const C* tw = table + st.tw;
      for (int it = threadIdx.x; it < nseq * n; it += blockDim.x) {
        const int s = it / n;
        const int i = it - s * n;
        const int r = i / m;
        if (r == 0) continue;
        const int k = (i - r * m) % st.ns;
        C* e = const_cast<C*>(src) + s * src_ld + pad(i);
        *e = cmul(*e, __ldg(tw + (r - 1) * st.ns + k));
      }
      __syncthreads();
    }
  }
  const C* roots = table + st.rt;
  for (int it = threadIdx.x; it < nseq * n; it += blockDim.x) {
    const int s = it / n;
    const int rem = it - s * n;
    const int q = rem / m;
    const int j = rem - q * m;
    const int k = j % st.ns;
    const Src* row = src + s * src_ld;
    C acc;
    acc.x = 0;
    acc.y = 0;
    int e = 0;  // (r * q) mod p
    for (int r = 0; r < p; ++r) {
      const C a = widen(row[at(kPadSrc, j + r * m)]);
      const C w = __ldg(roots + e);
      acc.x = fmadd(a.x, w.x, acc.x);
      acc.x = fmadd(-a.y, w.y, acc.x);
      acc.y = fmadd(a.x, w.y, acc.y);
      acc.y = fmadd(a.y, w.x, acc.y);
      e += q;
      if (e >= p) e -= p;
    }
    dst[s * ld + at(kPadDst, (j - k) * p + k + q * st.ns)] = acc;
  }
}

template <typename C, typename Src, bool kPadSrc, bool kPadDst>
__device__ void run_stage(const Src* src, int src_ld, C* dst, int ld,
                          int nseq, int n, Stage st,
                          const C* __restrict__ table, int sign) {
#define STOCKHAM_CASE(R)                                                  \
  case R:                                                                 \
    stage_reg<R, C, Src, kPadSrc, kPadDst>(src, src_ld, dst, ld, nseq, n, \
                                           st, table, sign);              \
    break;
  switch (st.radix) {
    STOCKHAM_CASE(16)
    STOCKHAM_CASE(8)
    STOCKHAM_CASE(4)
    STOCKHAM_CASE(2)
    STOCKHAM_CASE(3)
    STOCKHAM_CASE(5)
    STOCKHAM_CASE(7)
    STOCKHAM_CASE(11)
    STOCKHAM_CASE(13)
    default:
      stage_direct<C, Src, kPadSrc, kPadDst>(src, src_ld, dst, ld, nseq, n,
                                             st, table);
  }
#undef STOCKHAM_CASE
}

// Runs the plan on nseq sequences.  `in` holds them unpadded at stride
// in_ld: the input rows in global memory, or (in_smem) their raw copy at
// the start of buf0.  If `out` is not null, the last stage writes the result
// there unpadded at stride out_ld and run_plan returns null; otherwise it
// returns the shared buffer that holds it, padded at stride padded_ld(n).
// The stages write buf0 and buf1 in turn, starting with the one that `in`
// does not occupy (buffers_used counts those a plan touches).  Every thread
// of the block must call it.
template <typename C, typename In>
__device__ C* run_plan(const In* in, int in_ld, bool in_smem, C* out,
                       int out_ld, C* buf0, C* buf1, int nseq, const Plan& pl,
                       const C* __restrict__ table, int sign) {
  const int n = pl.n;
  const int ld = padded_ld(n);
  const int S = pl.nstages;
  int cur = in_smem ? 1 : 0;
  if (S == 0) {  // n == 1
    C* b = cur ? buf1 : buf0;
    for (int s = threadIdx.x; s < nseq; s += blockDim.x) {
      const C v = widen(in[s * in_ld]);
      if (out)
        out[s * out_ld] = v;
      else
        b[s * ld] = v;
    }
    __syncthreads();
    return out ? nullptr : b;
  }
  if (S == 1 && out)
    run_stage<C, In, false, false>(in, in_ld, out, out_ld, nseq, n, pl.st[0],
                                   table, sign);
  else
    run_stage<C, In, false, true>(in, in_ld, cur ? buf1 : buf0, ld, nseq, n,
                                  pl.st[0], table, sign);
  __syncthreads();
  for (int s = 1; s < S; ++s) {
    const C* src = cur ? buf1 : buf0;
    cur ^= 1;
    if (s == S - 1 && out)
      run_stage<C, C, true, false>(src, ld, out, out_ld, nseq, n, pl.st[s],
                                   table, sign);
    else
      run_stage<C, C, true, true>(src, ld, cur ? buf1 : buf0, ld, nseq, n,
                                  pl.st[s], table, sign);
    __syncthreads();
  }
  return out ? nullptr : (cur ? buf1 : buf0);
}

// How many of buf0, buf1 run_plan touches (the raw input copy included).
inline int buffers_used(const Plan& pl, bool in_smem, bool out_direct) {
  const int S = pl.nstages;
  int cur = in_smem ? 1 : 0, used = in_smem ? 1 : 0;
  if (S == 0) return out_direct ? used : cur + 1;
  for (int s = 0; s < S; ++s) {
    if (s > 0) cur ^= 1;
    if (!(s == S - 1 && out_direct) && cur + 1 > used) used = cur + 1;
  }
  return used;
}

// Whether the first stage reads the rows straight from global memory and
// the last stage writes them straight back: when the values of one index r
// that a warp touches fill whole 128-byte lines (n / radix values of a row
// side by side).  Otherwise the rows go through shared memory, copied with
// cp.async.
template <typename In, typename C>
inline void direct_io(const Plan& pl, bool* in_direct, bool* out_direct) {
  const int S = pl.nstages;
  *in_direct = S > 0 && (size_t)(pl.n / pl.st[0].radix) * sizeof(In) >= 128;
  *out_direct =
      S > 0 && (size_t)(pl.n / pl.st[S - 1].radix) * sizeof(C) >= 128;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copies count contiguous In values from global g to shared raw (16-byte
// cp.async chunks when g is 16-byte aligned, plain loads otherwise), then
// waits for them and synchronises the block.
template <typename In>
__device__ void load_contig(In* raw, const In* g, long long count) {
  const long long bytes = count * (long long)sizeof(In);
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const char* gb = reinterpret_cast<const char*>(g);
    char* sb = reinterpret_cast<char*>(raw);
    const long long chunks = bytes >> 4;
    for (long long i = threadIdx.x; i < chunks; i += blockDim.x)
      cp_async16(sb + 16 * i, gb + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::);
    for (long long i = (chunks << 4) / (long long)sizeof(In) + threadIdx.x;
         i < count; i += blockDim.x)
      raw[i] = g[i];
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x) raw[i] = g[i];
  }
  __syncthreads();
}

// Copies nseq rows of n contiguous In values from global g to shared raw
// at a row stride of raw_ld: load_contig when raw_ld == n, else one copy
// per value (cp.async for 16-byte values).  An odd raw_ld spreads the rows
// of a short transform over the banks for the first stage's reads.
template <typename In>
__device__ void load_rows(In* raw, int raw_ld, const In* g, int nseq, int n) {
  if (raw_ld == n) {
    load_contig(raw, g, (long long)nseq * n);
    return;
  }
  for (int e = threadIdx.x; e < nseq * n; e += blockDim.x) {
    const int s = e / n;
    In* d = raw + s * raw_ld + (e - s * n);
    if constexpr (sizeof(In) == 16) {
      cp_async16(d, g + e);
    } else {
      *d = g[e];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Copies nseq padded rows of n values (stride padded_ld(n)) from shared res
// to count = nseq * n contiguous values at global g.
template <typename C>
__device__ void store_contig(C* g, const C* res, int nseq, int n) {
  const int ld = padded_ld(n);
  const int count = nseq * n;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int s = e / n;
    const int i = e - s * n;
    g[e] = res[s * ld + pad(i)];
  }
}

// ---- host side ------------------------------------------------------------

// Parses one pass of the int32 plan at p into pl; returns the words it
// used, or -1 if the pass is malformed or reaches outside the table.
inline int parse_pass(const int* p, int table_len, Plan* pl) {
  const int n = p[0], S = p[1];
  if (n < 1 || S < 0 || S > kMaxStages) return -1;
  pl->n = n;
  pl->nstages = S;
  long long ns = 1;
  for (int s = 0; s < S; ++s) {
    const Stage st = {p[2 + 4 * s], p[3 + 4 * s], p[4 + 4 * s],
                      p[5 + 4 * s]};
    if (st.radix < 2 || st.ns != ns || n % (ns * st.radix) != 0) return -1;
    if (st.rt < 0 || st.rt + st.radix > table_len) return -1;
    if (ns > 1 &&
        (st.tw < 0 || st.tw + (long long)(st.radix - 1) * ns > table_len))
      return -1;
    pl->st[s] = st;
    ns *= st.radix;
  }
  if (ns != n) return -1;
  return 2 + 4 * S;
}

// Header of the int32 plan: fills n, sign, passes, the offset of the
// inter-pass twiddle and the passes; returns 0 or cudaErrorInvalidValue.
inline int parse_plan(const int* p, int* n, int* sign, int* passes,
                      int* inter, Plan* p1, Plan* p2) {
  *n = p[0];
  *sign = p[1];
  *passes = p[2];
  *inter = p[3];
  const int table_len = p[4];
  if ((*sign != 1 && *sign != -1) || (*passes != 1 && *passes != 2))
    return (int)cudaErrorInvalidValue;
  const int used = parse_pass(p + kHeader, table_len, p1);
  if (used < 0) return (int)cudaErrorInvalidValue;
  if (*passes == 1) return p1->n == *n ? 0 : (int)cudaErrorInvalidValue;
  if (parse_pass(p + kHeader + used, table_len, p2) < 0 ||
      (long long)p1->n * p2->n != *n || *inter < 0 ||
      *inter + (long long)*n > table_len)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Bytes of shared memory for nbuf buffers of nseq rows of n values of
// type C.
template <typename C>
inline size_t smem_bytes(int nbuf, int nseq, int n) {
  return (size_t)nbuf * nseq * padded_ld(n) * sizeof(C);
}

// Sets the dynamic shared memory a kernel may take, if above 48 KB.
template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace stockham
