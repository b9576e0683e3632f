// K7: the Mamba selective scan, forward (prefill).
//
//   h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t ;  y_t = C_t . h_t
//
// Replaces (TPU, Pallas):
//   src/repro/kernels/selective_scan/selective_scan.py:54
//   selective_scan_pallas (body _kernel :26).
//
// What bounds it on an H100: operations, on the special-function units.
// Every (b, t, d, s) needs one exp: 2 x 1024 x 8192 x 16 = 268 M at the
// jamba prefill shape, and the SFUs give 16 a clock per SM (~64 us at
// 1.98 GHz), while the bytes (x, dt, y in bf16, h and a in float32, B and
// C; ~102 MB) take ~31 us at 3.35 TB/s. The recurrence is sequential in t
// and independent over (b, d, s); the TPU grid walks time innermost with
// h in VMEM.
//
// Design: one CTA of 256 threads per (64 channels d, batch row b); a
// channel's S states are spread over L = 4 lanes of one warp, so each
// thread keeps S / 4 states of h in registers for the whole of T and
// y_t = sum_s h * c is a sum over its own states and two shuffles. That
// gives 4*B*D threads (65 536 at the jamba shape, ~2 CTAs per SM), each
// with S / 4 independent exp chains for the SFUs to overlap. Time
// runs in chunks of kChunk steps: the chunk's x and dt for the CTA's 64
// channels and its B and C rows (which every channel of the batch row
// reads) are staged in shared memory as float32 by coalesced loads; the
// chunk's y is staged there and written back coalesced. h_final is written
// once at the end. dt * x is multiplied in float32, as the Pallas body
// does (the jnp oracle multiplies in the input dtype first; in bfloat16
// the two differ by one rounding of dt * x). exp is expf (accurate, not
// __expf). Channels past D and steps past T are masked.
//
// ABI: x, dt [B, T, D], bc, cc [B, T, S] (one dtype: 0 = float32,
// 1 = bf16; contiguous), a float32 [D, S], y [B, T, D] in x's dtype,
// h float32 [B, D, S]; S = 8 (the tiny configs) or 16 (jamba).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChannels = 64;  // channels per CTA
constexpr int kLanes = 4;      // lanes per channel
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 32;     // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const T* __restrict__ bc, const T* __restrict__ cc,
                          const float* __restrict__ a, T* __restrict__ y,
                          float* __restrict__ h_out, int Tn, int D) {
  constexpr int L = kLanes;
  constexpr int P = S / L;  // states per thread
  constexpr int C = kChannels;
  __shared__ float xs[kChunk][C];
  __shared__ float dts[kChunk][C];
  __shared__ float ys[kChunk][C];
  __shared__ float bs[kChunk][S];
  __shared__ float cs[kChunk][S];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int ch = tid / L;    // channel within the CTA
  const int lane = tid % L;  // which slice of the states
  const int d = d0 + ch;
  const bool live = d < D;

  float av[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // a masked channel keeps h = 0: a = 0 gives exp(0) = 1, and x, dt = 0
    av[p] = live ? a[(size_t)d * S + lane * P + p] : 0.f;
    h[p] = 0.f;
  }
  const size_t row = (size_t)b * Tn;  // first (b, t) row

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int nt = min(kChunk, Tn - t0);
    // stage x, dt [nt, C] and B, C [nt, S]
    for (int i = tid; i < kChunk * C; i += kThreads) {
      const int tt = i / C, cc_ = i % C;
      float xv = 0.f, dv = 0.f;
      if (tt < nt && d0 + cc_ < D) {
        const size_t off = (row + t0 + tt) * D + d0 + cc_;
        xv = to_f32(x[off]);
        dv = to_f32(dt[off]);
      }
      xs[tt][cc_] = xv;
      dts[tt][cc_] = dv;
    }
    for (int i = tid; i < kChunk * S; i += kThreads) {
      const int tt = i / S, s = i % S;
      float bv = 0.f, cv = 0.f;
      if (tt < nt) {
        const size_t off = (row + t0 + tt) * S + s;
        bv = to_f32(bc[off]);
        cv = to_f32(cc[off]);
      }
      bs[tt][s] = bv;
      cs[tt][s] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dts[tt][ch];
      const float dtx = dtv * xs[tt][ch];
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int s = lane * P + p;
        const float da = expf(dtv * av[p]);
        h[p] = da * h[p] + dtx * bs[tt][s];
        acc += h[p] * cs[tt][s];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ys[tt][ch] = acc;
    }
    __syncthreads();
    for (int i = tid; i < nt * C; i += kThreads) {
      const int tt = i / C, cc_ = i % C;
      if (d0 + cc_ < D)
        y[(row + t0 + tt) * D + d0 + cc_] = from_f32<T>(ys[tt][cc_]);
    }
    // the next chunk's staging overwrites xs, dts, bs and cs, which every
    // thread has finished reading; ys is read above and written only after
    // the next barrier
  }
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      h_out[((size_t)b * D + d) * S + lane * P + p] = h[p];
  }
}

template <typename T, int S>
cudaError_t launch_s(const void* x, const void* dt, const void* bc,
                     const void* cc, const float* a, void* y, float* h, int B,
                     int Tn, int D, cudaStream_t st) {
  dim3 grid((D + kChannels - 1) / kChannels, B);
  selective_scan_kernel<T, S><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bc), static_cast<const T*>(cc), a,
      static_cast<T*>(y), h, Tn, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* x, const void* dt, const void* bc,
                         const void* cc, const float* a, void* y, float* h,
                         int B, int Tn, int D, int S, cudaStream_t st) {
  switch (S) {
    case 8: return launch_s<T, 8>(x, dt, bc, cc, a, y, h, B, Tn, D, st);
    case 16: return launch_s<T, 16>(x, dt, bc, cc, a, y, h, B, Tn, D, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bc, const void* cc,
                                     const void* a, void* y, void* h, int B,
                                     int Tn, int D, int S, int dtype,
                                     void* stream) {
  if (B < 1 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(h);
  if (dtype == 0)
    return (int)launch_dtype<float>(x, dt, bc, cc, af, y, hf, B, Tn, D, S,
                                    st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(x, dt, bc, cc, af, y, hf, B, Tn,
                                            D, S, st);
  return (int)cudaErrorInvalidValue;
}
