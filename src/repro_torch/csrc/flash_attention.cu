// K6: blocked causal grouped-query flash attention, forward
// (FlashAttention-2: online softmax over KV tiles, one flush per row).
//
// Replaces (TPU, Pallas):
//   src/repro/kernels/flash_attention/flash_attention.py:76
//   flash_attention_pallas (body _kernel :31).
//
// What bounds it on an H100: operations. A causal prefill does
// 4 * B * Hq * D * S(S+1)/2 flops over ~(2 Hq + 2 Hkv) * B * S * D elements,
// hundreds of flops per byte at S = 1024, D = 128, above the card's ~295
// bf16 flops per byte, so the floor is the flops over the tensor cores'
// 989 TFLOP/s. This first version does its products on the float32 FMA
// units (67 TFLOP/s peak), so it cannot come near that floor: wgmma tiles
// fed by TMA are the later step.
//
// Design: grid (B*Hq, ceil(S/64)); one CTA of 256 threads per (batch,
// q head, 64-row q block). q head h reads kv head h / g, as the TPU grid
// does. The CTA stages its q block (scaled by 1/sqrt(D), as the Pallas
// body) in shared memory as float32, then walks the KV tiles of 32 rows up
// to the diagonal (causal) or to S, staging K and V in shared memory. A
// thread owns 4 rows (ty + 16 i) and, for the scores, 2 columns (tx + 16 j);
// the row max and row sum are reduced over the 16 lanes that share a row
// with warp shuffles. Each thread keeps its rows' float32 (m, l) and its
// 4 x D/16 slice of acc in registers and writes the output once. Masked
// logits are -1e30, as in the Pallas body; rows and columns past S (a
// ragged last block) are masked or not written. Shared memory rows are
// padded by one float so the column walks hit distinct banks.
//
// ABI: q [B, Hq, S, D], k/v [B, Hkv, S, D] (one dtype: float32 or bf16,
// contiguous), out [B, Hq, S, D] in q's dtype; D in {16, 32, 64, 128};
// dtype 0 = float32, 1 = bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per CTA
constexpr int kBK = 32;  // KV rows per tile
constexpr int kRows = kBQ / 16;  // rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;

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

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Hq,
                     int Hkv, int S, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int ND = D / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;    // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* p_s = v_s + kBK * D;     // [kBQ][kBK + 1]

  const int bh = blockIdx.x;  // b * Hq + q head
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)kvh * S * D;
  const T* vb = v + (size_t)kvh * S * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * DP + d] =
        q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * D + d]) * scale : 0.f;
  }
  float m[kRows], l[kRows], acc[kRows][ND];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q_s is ready; the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + t < S) {
        const size_t off = (size_t)(k0 + t) * D + d;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      k_s[t * DP + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes tx = 0..15 of a half warp share this row
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int Hq, int Hkv, int S, int causal,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  auto kern = flash_fwd_kernel<T, D>;
  // raise the dynamic shared-memory cap once per instantiation, outside
  // any CUDA-graph capture of later calls
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, S, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, int B, int Hq, int Hkv, int S, int D,
                         int causal, float scale, cudaStream_t stream) {
#define K6_CASE(DD) \
  case DD:          \
    return launch_typed<T, DD>(q, k, v, out, B, Hq, Hkv, S, causal, scale, \
                               stream);
  switch (D) {
    K6_CASE(16)
    K6_CASE(32)
    K6_CASE(64)
    K6_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef K6_CASE
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, k, v, out, B, Hq, Hkv, S, D, causal, scale,
                              st);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, D, causal,
                                      scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
