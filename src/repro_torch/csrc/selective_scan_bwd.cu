// K7's backward: the gradients of the Mamba selective scan
//
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = C_t . h_t
//
// with respect to x, dt, B, C and A, given dy [B, T, D] and, optionally,
// the gradient of h_final, dh [B, D, S] (h_0 = 0, as in K7's forward).
//
// Replaces (TPU): none. The reference trains jamba through the autodiff
// of its jnp `chunked_scan` in `mamba_full` (src/repro/models/ssm.py:108,
// chunks of 128), and the Pallas kernel
// (src/repro/kernels/selective_scan/selective_scan.py:54) has no backward.
// The port's `mamba_full` runs K7 on the card, so K7 needs one;
// kernels/selective_scan/selective_scan.py binds the two as a
// `torch.autograd.Function`.
//
// The reverse recurrence, per channel d and state s, with
// e_t = exp(dt_t A), u_t = dt_t x_t and G_T = dh (or 0):
//   g_t   = dy_t C_t + G_{t+1}         (dL/dh_t)
//   G_t   = e_t g_t                    (carried to step t - 1)
//   dx_t  = dt_t sum_s g_t B_t
//   ddt_t = x_t sum_s g_t B_t + sum_s g_t h_{t-1} e_t A
//   dB_t  = sum_d g_t u_t ;  dC_t = sum_d dy_t h_t   (over channels)
//   dA    = sum_{b,t} g_t h_{t-1} e_t dt_t
//
// What bounds it on an H100: operations, on the special-function units,
// as K7's forward: every (b, t, d, s) needs at least one exp (e_t), 268 M
// at jamba's training shape (2, 1024, 8192, 16), 64.19 us at 16 a clock
// an SM and 1.98 GHz; its bytes (x, dt, dy read, dx, ddt written in bf16,
// B, C read and dB, dC written; ~168 MB) take ~50 us at 3.35 TB/s. This
// design computes each exp three times (the forward pass below, the
// recompute of a chunk, the reverse step) and reads x and dt three times:
// it is the simple form, right first; making it fast is later work.
//
// Design: one thread a channel d (kCH = 64 channels a CTA, one CTA a
// (channel block, batch row)), its S states in registers.
//   1. A forward pass over T (K7's recurrence) writes h at the start of
//      every chunk of kTC = 8 steps to a float32 scratch hs [B, nC, D, S].
//   2. The chunks then run in reverse. A chunk's h_{t0-1} .. h_{t0+7} is
//      recomputed from hs into shared memory (each thread its own column:
//      no barrier), and the reverse recurrence steps through it. dx and
//      ddt are written per step; each step's per-channel terms of dB and
//      dC go to shared memory [kTC][2S][kCH + 1], and at the end of the
//      chunk the CTA sums them over its kCH channels in a fixed order into
//      a float32 partial [B, nblk, T, 2S] (one row a channel block).
//   3. A second kernel sums the partials over the channel blocks (dB, dC,
//      cast to the input dtype) and the per-row dA partials [B, D, S] over
//      B (float32), each in a fixed order.
// No atomics: two launches on the same inputs give the same bits. A ragged
// channel block is masked (a = x = dt = dy = 0 there keeps every term 0);
// a ragged last chunk runs its nt < kTC steps. exp is the accurate expf in
// both dtypes, and dt * x is multiplied in float32, as K7's forward does.
//
// ABI: x, dt, dy [B, T, D], bc, cc [B, T, S] (one dtype: 0 = float32,
// 1 = bf16; contiguous); a float32 [D, S]; dh float32 [B, D, S] or null;
// scratch float32: hs [B, ceil(T / tc), D, S], part [B, ceil(D / ch), T,
// 2 S], pa [B, D, S]; outputs dx, ddt [B, T, D], dbc, dcc [B, T, S] in the
// input dtype, da float32 [D, S]. (ch, tc) must be the compiled (kCH, kTC);
// S = 8 or 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCH = 64;  // channels (threads) a CTA
constexpr int kTC = 8;   // steps a chunk

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

template <int S>
struct BwdSmem {
  // hbuf: [kTC + 1][S][kCH], a thread's column its channel's states
  static constexpr int kH = (kTC + 1) * S * kCH;
  // red: [kTC][2 S][kCH + 1], padded so a row's sum reads across banks
  static constexpr int kRed = kTC * 2 * S * (kCH + 1);
  static constexpr size_t kBytes = sizeof(float) * (size_t)(kH + kRed);
};

template <typename T, int S>
__global__ void __launch_bounds__(kCH)
    scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bc, const T* __restrict__ cc,
                    const float* __restrict__ a, const T* __restrict__ dy,
                    const float* __restrict__ dh, float* __restrict__ hs,
                    float* __restrict__ part, float* __restrict__ pa,
                    T* __restrict__ dx, T* __restrict__ ddt, int Tn, int D) {
  extern __shared__ float smem[];
  float* hbuf = smem;
  float* red = smem + BwdSmem<S>::kH;

  const int ch = threadIdx.x;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int b = blockIdx.y;
  const int d = blk * kCH + ch;
  const bool live = d < D;
  const int nC = (Tn + kTC - 1) / kTC;
  const size_t row = (size_t)b * Tn;  // first (b, t) row

  float ar[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ar[s] = live ? a[(size_t)d * S + s] : 0.f;
    h[s] = 0.f;
  }

  // 1. forward: h at each chunk's start into hs
  for (int c = 0; c < nC; ++c) {
    if (live) {
      float4* dst = reinterpret_cast<float4*>(
          hs + (((size_t)b * nC + c) * D + d) * S);
#pragma unroll
      for (int q = 0; q < S / 4; ++q)
        dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                             h[4 * q + 3]);
    }
    const int t0 = c * kTC, nt = min(kTC, Tn - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const size_t r = row + t0 + tt;
      const float dtv = live ? to_f32(dt[r * D + d]) : 0.f;
      const float u = dtv * (live ? to_f32(x[r * D + d]) : 0.f);
#pragma unroll
      for (int s = 0; s < S; ++s)
        h[s] = fmaf(expf(dtv * ar[s]), h[s], u * to_f32(bc[r * S + s]));
    }
  }

  // 2. the chunks in reverse
  float G[S], dA[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    G[s] = (live && dh != nullptr) ? dh[((size_t)b * D + d) * S + s] : 0.f;
    dA[s] = 0.f;
  }
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kTC, nt = min(kTC, Tn - t0);
    // recompute h_{t0-1} .. h_{t0+nt-1} into this thread's column
    {
      const float4* src = reinterpret_cast<const float4*>(
          hs + (((size_t)b * nC + c) * D + (live ? d : 0)) * S);
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 w = live ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        h[4 * q] = w.x;
        h[4 * q + 1] = w.y;
        h[4 * q + 2] = w.z;
        h[4 * q + 3] = w.w;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) hbuf[s * kCH + ch] = h[s];
    for (int tt = 0; tt < nt; ++tt) {
      const size_t r = row + t0 + tt;
      const float dtv = live ? to_f32(dt[r * D + d]) : 0.f;
      const float u = dtv * (live ? to_f32(x[r * D + d]) : 0.f);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = fmaf(expf(dtv * ar[s]), h[s], u * to_f32(bc[r * S + s]));
        hbuf[((tt + 1) * S + s) * kCH + ch] = h[s];
      }
    }
    // the reverse recurrence through the chunk
    for (int tt = nt - 1; tt >= 0; --tt) {
      const size_t r = row + t0 + tt;
      const float dtv = live ? to_f32(dt[r * D + d]) : 0.f;
      const float xv = live ? to_f32(x[r * D + d]) : 0.f;
      const float dyv = live ? to_f32(dy[r * D + d]) : 0.f;
      const float u = dtv * xv;
      float du = 0.f, dd = 0.f;
      float* rb = red + (size_t)tt * 2 * S * (kCH + 1);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float bv = to_f32(bc[r * S + s]);
        const float cv = to_f32(cc[r * S + s]);
        const float g = fmaf(dyv, cv, G[s]);
        const float hp = hbuf[(tt * S + s) * kCH + ch];
        const float hc = hbuf[((tt + 1) * S + s) * kCH + ch];
        const float e = expf(dtv * ar[s]);
        const float ge = g * hp * e;  // dL/d(dt A) of this state
        du = fmaf(g, bv, du);
        dd = fmaf(ge, ar[s], dd);
        dA[s] = fmaf(ge, dtv, dA[s]);
        rb[s * (kCH + 1) + ch] = g * u;
        rb[(S + s) * (kCH + 1) + ch] = dyv * hc;
        G[s] = e * g;
      }
      if (live) {
        dx[r * D + d] = from_f32<T>(du * dtv);
        ddt[r * D + d] = from_f32<T>(fmaf(du, xv, dd));
      }
    }
    __syncthreads();  // every channel's terms of the chunk are in red
    for (int o = ch; o < nt * 2 * S; o += kCH) {
      const float* src = red + (size_t)o * (kCH + 1);
      float acc = 0.f;
      for (int k = 0; k < kCH; ++k) acc += src[k];
      const int tt = o / (2 * S), j = o % (2 * S);
      part[(((size_t)b * nblk + blk) * Tn + t0 + tt) * 2 * S + j] = acc;
    }
    __syncthreads();  // the sums have read red before the next chunk
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) pa[((size_t)b * D + d) * S + s] = dA[s];
  }
}

// dB, dC: the partials summed over the channel blocks; dA: the rows'
// partials summed over B; each in a fixed order
template <typename T, int S>
__global__ void __launch_bounds__(256)
    scan_bwd_sum_kernel(const float* __restrict__ part,
                        const float* __restrict__ pa, T* __restrict__ dbc,
                        T* __restrict__ dcc, float* __restrict__ da, int B,
                        int Tn, int D, int nblk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * Tn * 2 * S;
  if (i < n_bc) {
    const size_t per_b = (size_t)Tn * 2 * S;
    const size_t b = i / per_b, rr = i % per_b;
    const float* src = part + b * nblk * per_b + rr;
    float acc = 0.f;
    for (int k = 0; k < nblk; ++k) acc += src[(size_t)k * per_b];
    const size_t t = rr / (2 * S);
    const int j = (int)(rr % (2 * S));
    if (j < S)
      dbc[(b * Tn + t) * S + j] = from_f32<T>(acc);
    else
      dcc[(b * Tn + t) * S + j - S] = from_f32<T>(acc);
    return;
  }
  const size_t k = i - n_bc;
  if (k >= (size_t)D * S) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += pa[(size_t)b * D * S + k];
  da[k] = acc;
}

template <typename T, int S>
cudaError_t launch_s(const void* x, const void* dt, const void* bc,
                     const void* cc, const float* a, const void* dy,
                     const float* dh, float* hs, float* part, float* pa,
                     void* dx, void* ddt, void* dbc, void* dcc, float* da,
                     int B, int Tn, int D, cudaStream_t st) {
  static bool ready = false;
  auto kern = scan_bwd_kernel<T, S>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BwdSmem<S>::kBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int nblk = (D + kCH - 1) / kCH;
  kern<<<dim3(nblk, B), kCH, BwdSmem<S>::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bc), static_cast<const T*>(cc), a,
      static_cast<const T*>(dy), dh, hs, part, pa, static_cast<T*>(dx),
      static_cast<T*>(ddt), Tn, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * Tn * 2 * S + (size_t)D * S;
  scan_bwd_sum_kernel<T, S><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, pa, static_cast<T*>(dbc), static_cast<T*>(dcc), da, B, Tn, D,
      nblk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* x, const void* dt, const void* bc,
                         const void* cc, const float* a, const void* dy,
                         const float* dh, float* hs, float* part, float* pa,
                         void* dx, void* ddt, void* dbc, void* dcc, float* da,
                         int B, int Tn, int D, int S, cudaStream_t st) {
  switch (S) {
    case 8:
      return launch_s<T, 8>(x, dt, bc, cc, a, dy, dh, hs, part, pa, dx, ddt,
                            dbc, dcc, da, B, Tn, D, st);
    case 16:
      return launch_s<T, 16>(x, dt, bc, cc, a, dy, dh, hs, part, pa, dx, ddt,
                             dbc, dcc, da, B, Tn, D, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bc, const void* cc,
    const void* a, const void* dy, const void* dh, void* hs, void* part,
    void* pa, void* dx, void* ddt, void* dbc, void* dcc, void* da, int B,
    int Tn, int D, int S, int ch, int tc, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || D < 1 || ch != kCH || tc != kTC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dhf = static_cast<const float*>(dh);
  float* hsf = static_cast<float*>(hs);
  float* pf = static_cast<float*>(part);
  float* paf = static_cast<float*>(pa);
  float* daf = static_cast<float*>(da);
  if (dtype == 0)
    return (int)launch_dtype<float>(x, dt, bc, cc, af, dy, dhf, hsf, pf, paf,
                                    dx, ddt, dbc, dcc, daf, B, Tn, D, S, st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(x, dt, bc, cc, af, dy, dhf, hsf,
                                            pf, paf, dx, ddt, dbc, dcc, daf,
                                            B, Tn, D, S, st);
  return (int)cudaErrorInvalidValue;
}
