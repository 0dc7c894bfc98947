// Four-step DFT along the last axis, float32, n = n1 * n2 (n1, n2 <= 256).
//
// Replaces: xrft_tpu/ops/pallas_fft.py::pallas_fft_last (bodies _kernel and
// _kernel_dg), and with it pallas_fft_rowtile, which computes the same
// function.  Input x (rows, n) is real float32 or complex64; the output is
// complex64 (rows, n) in frequency order k = k1 + n1*k2, unnormalised, with
// the sign baked into the tables:
//
//   pass 1: B[row, k1, j2] = W_n^(j2*k1) * sum_j1 x[row, j1*n2 + j2] * W_n1^(j1*k1)
//   pass 2: out[row, k1 + n1*k2] = sum_j2 B[row, k1, j2] * W_n2^(j2*k2)
//
// with W_m^e = exp(sign * 2*pi*i * e / m).  The tables t1 (n1), t2 (n2) and
// tn (n) hold W_m^e for e in [0, m), computed on the host in float64 and
// rounded to complex64; exponents are reduced mod m exactly in integers.
//
// Bound on Hopper: at n = 4096 (n1 = n2 = 64) each point costs n1 + n2 = 128
// complex FMAs (8 flops each) against about 32 bytes of device traffic over
// both passes (input, scratch out and back, output): 32 flops per byte, above
// the card's ~20 FP32 flops per byte, so the FP32 pipes bound this version.  The TPU
// kernel ran both stages as MXU matmuls on one VMEM-resident row block; here
// a block owns a strip of one row per pass: pass 1 stages the n1 x 16 input
// strip (columns j2, all j1) in shared memory with coalesced loads, pass 2
// stages 16 rows k1 of B (padded to an odd stride against bank conflicts).
// The small DFT tables live in shared memory, the twiddle table in L1/L2.
// Pass 1's stores and pass 2's loads and stores move runs of 16 consecutive
// complex values (128 bytes).  Tensor cores (wgmma at TF32x3 grade) and one
// fused pass with the row block resident in shared memory are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 w) {
  acc.x = fmaf(a.x, w.x, acc.x);
  acc.x = fmaf(-a.y, w.y, acc.x);
  acc.y = fmaf(a.x, w.y, acc.y);
  acc.y = fmaf(a.y, w.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// One block per (row, strip of kTile columns j2).
template <bool CPLX>
__global__ void fourstep_pass1(const void* __restrict__ xin,
                               float2* __restrict__ B,
                               const float2* __restrict__ t1,
                               const float2* __restrict__ tn, int n1, int n2,
                               int strips) {
  extern __shared__ float2 smem[];
  float2* xs = smem;                    // [n1][kTile]
  float2* w1 = smem + n1 * kTile;       // [n1]
  const long long row = blockIdx.x / strips;
  const int j2_0 = (blockIdx.x % strips) * kTile;
  const long long n = (long long)n1 * n2;
  const long long base = row * n;

  for (int e = threadIdx.x; e < n1 * kTile; e += blockDim.x) {
    const int j1 = e / kTile;
    const int j2 = j2_0 + e % kTile;
    float2 v = make_float2(0.f, 0.f);
    if (j2 < n2) {
      if (CPLX) {
        v = static_cast<const float2*>(xin)[base + (long long)j1 * n2 + j2];
      } else {
        v.x = static_cast<const float*>(xin)[base + (long long)j1 * n2 + j2];
      }
    }
    xs[e] = v;
  }
  for (int e = threadIdx.x; e < n1; e += blockDim.x) w1[e] = t1[e];
  __syncthreads();

  for (int o = threadIdx.x; o < n1 * kTile; o += blockDim.x) {
    const int j2l = o % kTile;
    const int k1 = o / kTile;
    const int j2 = j2_0 + j2l;
    if (j2 >= n2) continue;
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;  // (j1 * k1) mod n1
    for (int j1 = 0; j1 < n1; ++j1) {
      const float2 a = xs[j1 * kTile + j2l];
      const float2 w = w1[m];
      if (CPLX) {
        cfma(acc, a, w);
      } else {
        acc.x = fmaf(a.x, w.x, acc.x);
        acc.y = fmaf(a.x, w.y, acc.y);
      }
      m += k1;
      if (m >= n1) m -= n1;
    }
    const float2 tw = __ldg(&tn[(j2 * k1) % n]);
    B[base + (long long)k1 * n2 + j2] = cmul(acc, tw);
  }
}

// One block per (row, strip of kTile rows k1 of B).
__global__ void fourstep_pass2(const float2* __restrict__ B,
                               float2* __restrict__ out,
                               const float2* __restrict__ t2, int n1, int n2,
                               int strips) {
  extern __shared__ float2 smem[];
  const int ld = n2 | 1;                // odd stride: no bank conflicts
  float2* bs = smem;                    // [kTile][ld]
  float2* w2 = smem + kTile * ld;       // [n2]
  const long long row = blockIdx.x / strips;
  const int k1_0 = (blockIdx.x % strips) * kTile;
  const long long base = row * (long long)n1 * n2;

  for (int e = threadIdx.x; e < kTile * n2; e += blockDim.x) {
    const int k1l = e / n2;
    const int j2 = e % n2;
    const int k1 = k1_0 + k1l;
    bs[k1l * ld + j2] = k1 < n1 ? B[base + (long long)k1 * n2 + j2]
                                : make_float2(0.f, 0.f);
  }
  for (int e = threadIdx.x; e < n2; e += blockDim.x) w2[e] = t2[e];
  __syncthreads();

  for (int o = threadIdx.x; o < kTile * n2; o += blockDim.x) {
    const int k1l = o % kTile;
    const int k2 = o / kTile;
    const int k1 = k1_0 + k1l;
    if (k1 >= n1) continue;
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;  // (j2 * k2) mod n2
    for (int j2 = 0; j2 < n2; ++j2) {
      cfma(acc, bs[k1l * ld + j2], w2[m]);
      m += k2;
      if (m >= n2) m -= n2;
    }
    out[base + k1 + (long long)n1 * k2] = acc;
  }
}

}  // namespace

// x: (rows, n1*n2) float32 (complex_in == 0) or complex64, contiguous.
// scratch, out: complex64 (rows, n1*n2).  t1, t2, tn: complex64 tables of
// n1, n2 and n1*n2 entries.  Both passes go on `stream`.  Returns the first
// cudaError_t of the two launches.
extern "C" int fft_fourstep_f32(const void* x, int complex_in, void* scratch,
                                void* out, const void* t1, const void* t2,
                                const void* tn, long long rows, int n1, int n2,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int strips1 = (n2 + kTile - 1) / kTile;
  const size_t smem1 = sizeof(float2) * ((size_t)n1 * kTile + n1);
  if (complex_in) {
    fourstep_pass1<true><<<(unsigned)(rows * strips1), kThreads, smem1, st>>>(
        x, (float2*)scratch, (const float2*)t1, (const float2*)tn, n1, n2,
        strips1);
  } else {
    fourstep_pass1<false><<<(unsigned)(rows * strips1), kThreads, smem1, st>>>(
        x, (float2*)scratch, (const float2*)t1, (const float2*)tn, n1, n2,
        strips1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int strips2 = (n1 + kTile - 1) / kTile;
  const size_t smem2 = sizeof(float2) * ((size_t)kTile * (n2 | 1) + n2);
  fourstep_pass2<<<(unsigned)(rows * strips2), kThreads, smem2, st>>>(
      (const float2*)scratch, (float2*)out, (const float2*)t2, n1, n2, strips2);
  return (int)cudaGetLastError();
}
