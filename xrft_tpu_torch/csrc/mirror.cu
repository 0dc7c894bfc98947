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
// Bound on Hopper: device memory.  Per float32 output it reads 8 bytes of
// complex64 (about half of them twice, from the two rows a mirrored column
// pair touches) and writes 4; no arithmetic to speak of.  The TPU kernel's
// block-reversal roll cascades existed because Mosaic had no reverse; here a
// thread simply computes its source address.  Design: one thread per output
// element, in row-major output order, so a warp writes 32 consecutive floats
// and reads 32 consecutive (direct half) or consecutive-descending (mirrored
// half) complex values of one source row: both coalesced.  The squares, sum
// and scale are rounded separately (no FMA contraction), so the result is
// bit-identical to the plain version's (re*re + im*im) * s.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, typename C>
__global__ void mirror_psd_kernel(const C* __restrict__ F, T* __restrict__ P,
                                  long long total, int NY, int MH, int NX,
                                  int hy, int hx, T s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int ox = (int)(i % NX);
    const long long r = i / NX;            // b * NY + oy
    const int oy = (int)(r % NY);
    const long long b = r / NY;
    int ky = oy - hy;
    if (ky < 0) ky += NY;
    int k = ox - hx;
    if (k < 0) k += NX;
    int row, col;
    if (2 * k <= NX) {
      row = ky;
      col = k;
    } else {
      row = ky == 0 ? 0 : NY - ky;
      col = NX - k;
    }
    const C v = F[(b * NY + row) * MH + col];
    P[i] = mul_rn(add_rn(mul_rn(v.x, v.x), mul_rn(v.y, v.y)), s);
  }
}

template <typename T, typename C>
int launch(const void* F, void* P, long long B, int NY, int MH, int NX,
           int shift, double s, void* stream) {
  const long long total = B * NY * (long long)NX;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 waves
  mirror_psd_kernel<T, C><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const C*)F, (T*)P, total, NY, MH, NX, shift ? NY / 2 : 0,
      shift ? NX / 2 : 0, (T)s);
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
