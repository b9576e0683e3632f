// K5: one-token grouped-query decode attention over a KV cache
// (FlashDecoding: split the cache, then combine the partial softmaxes).
//
// Replaces (TPU, Pallas):
//   src/repro/kernels/decode_attention/decode_attention.py:70
//   decode_attention_pallas (body _kernel :30).
//
// What bounds it on an H100: bytes. One query token reads the whole valid
// part of its K/V cache once and does 4*D flops per position and head, far
// below the ~295 flops per byte at which bf16 stops being memory-bound, so
// the floor is (K/V bytes up to kv_len) / 3.35 TB/s. At the serving shapes
// (B = 4 slots, Hkv = 8) there are only 32 (batch, kv-head) pairs for 132
// SMs, so one CTA per pair, as the TPU grid walks it, would leave most of
// the card idle.
//
// Design: launch 1 has grid (B*Hkv, n_splits). Each CTA takes one chunk of
// `chunk` cache positions for ALL g = Hq/Hkv query heads of its group, so a
// K/V tile is read from device memory once and serves the whole group (the
// point of GQA). CTAs whose chunk starts at or past kv_len[b] exit at once;
// kv_len is read on the device, so the host never learns it. Inside a CTA,
// 32-position K/V tiles are staged in shared memory as float32; scores,
// the online softmax (m, l, acc in float32, masked with -1e30 as the
// Pallas body) and the P*V update run from shared memory. The CTA writes
// its unnormalised partial (m, l, acc[g, D]) to a float32 workspace.
// Launch 2, one CTA per (batch, kv-head), merges the valid partials
// (their number follows from kv_len) and writes q's dtype. Both launches
// are one K5 call. q is scaled by 1/sqrt(D) before the dot, as the Pallas
// body does. A row with kv_len = 0 comes out 0 (acc 0 / max(l, 1e-30)), as
// the Pallas kernel gives, never NaN.
//
// ABI: q [B, Hq, D], k/v [B, Hkv, S, D] (one dtype: float32 or bf16,
// contiguous), kv_len int32[B], out [B, Hq, D] in q's dtype; workspace
// part_acc f32[B*Hkv, n_splits, g, D], part_ml f32[B*Hkv, n_splits, g, 2];
// n_splits = ceil(S / chunk), chunk a multiple of 32; D in {16,32,64,128,
// 256}; dtype 0 = float32, 1 = bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // one warp's width: a head's tile scores per lane
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

__device__ __forceinline__ int valid_len(const int* kv_len, int b, int S) {
  return max(0, min(kv_len[b], S));
}

size_t split_smem_bytes(int g, int D) {
  return sizeof(float) *
         (size_t)(2 * g * D + kTile * (D + 1) + kTile * D + g * kTile + 3 * g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int Hkv, int g, int S,
                        int chunk, int n_splits, float scale) {
  const int bh = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y;
  const int len = valid_len(kv_len, bh / Hkv, S);
  const int start = split * chunk;
  if (start >= len) return;  // the combine never reads this split
  const int end = min(start + chunk, len);

  extern __shared__ float smem[];
  float* q_s = smem;                   // [g][D], scaled
  float* acc_s = q_s + g * D;          // [g][D]
  float* k_s = acc_s + g * D;          // [kTile][D + 1]
  float* v_s = k_s + kTile * (D + 1);  // [kTile][D]
  float* p_s = v_s + kTile * D;        // [g][kTile]
  float* m_s = p_s + g * kTile;        // [g]
  float* l_s = m_s + g;                // [g]
  float* a_s = l_s + g;                // [g] rescale of this tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // q [B, Hq, D] is [B*Hkv, g, D]: the group's heads are contiguous
  const T* qb = q + (size_t)bh * g * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (t < n) {
        const size_t off = (size_t)(t0 + t) * D + d;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      k_s[t * (D + 1) + d] = kx;
      v_s[t * D + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile, t = i % kTile;
      float s = kNegInf;  // past kv_len or past this chunk
      if (t < n) {
        const float* qh = q_s + h * D;
        const float* kt = k_s + t * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qh[d], kt[d], dot);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int h = warp; h < g; h += kThreads / 32) {
      const float s = p_s[h * kTile + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[h * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += kThreads) {
      const int h = i / D, d = i % D;
      const float* ph = p_s + h * kTile;
      float acc = acc_s[i] * a_s[h];
      for (int t = 0; t < n; ++t) acc = fmaf(ph[t], v_s[t * D + d], acc);
      acc_s[i] = acc;
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * n_splits + split;
  for (int i = tid; i < g * D; i += kThreads)
    part_acc[part * g * D + i] = acc_s[i];
  for (int h = tid; h < g; h += kThreads) {
    part_ml[(part * g + h) * 2] = m_s[h];
    part_ml[(part * g + h) * 2 + 1] = l_s[h];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ kv_len, T* __restrict__ out,
                          int Hkv, int g, int D, int S, int chunk,
                          int n_splits) {
  const int bh = blockIdx.x;
  const int len = valid_len(kv_len, bh / Hkv, S);
  const int used = (len + chunk - 1) / chunk;
  T* ob = out + (size_t)bh * g * D;
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float m = kNegInf;
    for (int s = 0; s < used; ++s)
      m = fmaxf(m, part_ml[(((size_t)bh * n_splits + s) * g + h) * 2]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const size_t part = (size_t)bh * n_splits + s;
      const float w = expf(part_ml[(part * g + h) * 2] - m);
      l = fmaf(part_ml[(part * g + h) * 2 + 1], w, l);
      acc = fmaf(part_acc[(part * g + h) * D + d], w, acc);
    }
    ob[i] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part_acc,
                         float* part_ml, int B, int Hkv, int g, int S,
                         int chunk, float scale, cudaStream_t stream) {
  const int n_splits = (S + chunk - 1) / chunk;
  const size_t smem = split_smem_bytes(g, D);
  auto kern = decode_split_kernel<T, D>;
  // raise the dynamic shared-memory cap once per instantiation, outside
  // any CUDA-graph capture of later calls; it only grows with g
  static int cap = 48 * 1024;
  cudaError_t err;
  if ((int)smem > cap) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cap = (int)smem;
  }
  kern<<<dim3(B * Hkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_acc, part_ml, Hkv, g, S, chunk,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * Hkv, kThreads, 0, stream>>>(
      part_acc, part_ml, kv_len, static_cast<T*>(out), Hkv, g, D, S, chunk,
      n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part_acc,
                         float* part_ml, int B, int Hkv, int g, int S, int D,
                         int chunk, float scale, cudaStream_t stream) {
#define K5_CASE(DD)                                                         \
  case DD:                                                                  \
    return launch_typed<T, DD>(q, k, v, kv_len, out, part_acc, part_ml, B, \
                               Hkv, g, S, chunk, scale, stream);
  switch (D) {
    K5_CASE(16)
    K5_CASE(32)
    K5_CASE(64)
    K5_CASE(128)
    K5_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef K5_CASE
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* part_acc,
                                       void* part_ml, int B, int Hq, int Hkv,
                                       int S, int D, int chunk, int dtype,
                                       void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || chunk < kTile ||
      chunk % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int* lens = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, k, v, lens, out, pa, pm, B, Hkv, g, S, D,
                              chunk, scale, st);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, k, v, lens, out, pa, pm, B, Hkv, g,
                                      S, D, chunk, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
