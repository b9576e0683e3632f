// K6's backward: the gradients of blocked causal grouped-query flash
// attention with respect to q, k and v (FlashAttention-2's backward).
//
// Replaces (TPU): none of its own. The reference trains through the
// autodiff of its jnp attention (`src/repro/models/attention.py:83-86`
// picks `blocked_attention` unless the backend is "pallas", and the LM's
// forward passes none), and the Pallas kernel
// (`src/repro/kernels/flash_attention/flash_attention.py:76`) has no
// backward. The port's `attn_full` runs K6 on the card, so K6 needs one;
// `kernels/flash_attention/flash_attention.py` binds the two as a
// `torch.autograd.Function`.
//
// What bounds it on an H100: operations. Over the causal half it does
// five products of 2 * S^2/2 * D flops a (batch, q head) -- S = Q K^T and
// dP = dO V^T recomputed, dV += P^T dO, dK += dS^T Q, dQ += dS K -- over
// ~(4 Hq + 4 Hkv) * B * S * D elements read or written: at minicpm-2b's
// B 4, Hq 36, S 1024, D 64 in bf16, 48.3 GFLOP, 48.9 us at the tensor
// cores' 989 TFLOP/s. This first form runs on the float32 FMA units (67
// TFLOP/s peak) and recomputes S and dP once more in the dQ kernel (seven
// products, not five), so that no tile is written by two CTAs: no
// atomics, and a rerun gives the same bits. A wgmma redesign is later
// work (ROADMAP.md §2).
//
// Three kernels, launched in order on one stream by
// flash_attention_bwd_launch:
//
// 1. delta_kernel: Dl = rowsum(dO * O) in float32 [B, Hq, S], one warp a
//    row.
// 2. dkdv_kernel: one CTA of 256 threads a (b, kv head, 64-row key
//    block). It holds its K and V block in shared memory as float32 and
//    its dK and dV accumulators in registers (a thread: 4 key rows x D/16
//    columns), and loops over the G q heads of its group and, for each,
//    over the 64-row query blocks from the diagonal on (all of them when
//    not causal): stage Q, dO, LSE and Dl; recompute S = Q K^T and
//    dP = dO V^T (a thread: 4 x 4 of the 64 x 64 tile), P = exp(scale S -
//    LSE) masked, dS = P (dP - Dl); then dV += P^T dO and dK += dS^T Q.
//    dK is scaled once at the end; each tile is written once.
// 3. dq_kernel: one CTA a (b, q head, 64-row query block), looping over
//    the key blocks up to the diagonal: recompute S, dP and dS as above,
//    dQ += dS K; scaled once, written once.
//
// Shared tiles are float32 rows padded to D + 1 (and 64 + 1), so the 16
// threads that read 16 different rows at one column hit 16 different
// banks. Inputs are float32 or bf16, accumulation float32 throughout,
// outputs in the input dtype. Any S (rows and keys past S are masked and
// never stored), D in {16, 32, 64, 128}, Hq a multiple of Hkv.
//
// ABI: q, o, do [B, Hq, S, D]; k, v [B, Hkv, S, D] (one dtype, contiguous);
// lse float32 [B, Hq, S] (the forward's, natural log); delta float32
// [B, Hq, S] scratch; dq [B, Hq, S, D], dk, dv [B, Hkv, S, D] in the
// inputs' dtype; dtype 0 = float32, 1 = bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;       // query rows and key rows per tile
constexpr int kBP = kB + 1;  // padded row of a 64-wide score tile
constexpr int kT = 4;        // rows (and score columns) per thread

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

// rows [r0, r0 + kB) of a [S, D] matrix into a [kB][D + 1] float32 tile,
// zeros past S
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int S) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f32(o[(size_t)row * D + d]) * to_f32(dout[(size_t)row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// S = A B^T and dP = C E^T over D for this thread's 4 x 4 of a 64 x 64
// tile: rows ty + 16 i of a and c, rows tx + 16 j of b and e
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e,
                                             int ty, int tx,
                                             float (&s)[kT][kT],
                                             float (&dp)[kT][kT]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kT], bv[kT], cv[kT], ev[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      av[i] = a[(ty + 16 * i) * DP + d];
      cv[i] = c[(ty + 16 * i) * DP + d];
      bv[i] = b[(tx + 16 * i) * DP + d];
      ev[i] = e[(tx + 16 * i) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
      }
  }
}

// P and dS of this thread's 4 x 4 from S, dP and its rows' LSE and Dl:
// zero where the key is past S or after the query (causal), or the query
// is past S
__device__ __forceinline__ void probs(float (&s)[kT][kT],
                                      float (&dp)[kT][kT], const float* lse,
                                      const float* dl, int q0, int k0,
                                      int ty, int tx, int S, int causal,
                                      float scale) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool live = row < S && col < S && !(causal && col > row);
      const float p = live ? expf(s[i][j] * scale - lse[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl[r]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (size_t)(4 * kB * (D + 1) + 2 * kB * kBP + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Hq, int Hkv, int S, int causal,
                float scale) {
  constexpr int DP = D + 1;
  constexpr int ND = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;              // [kB][DP]
  float* v_s = k_s + kB * DP;     // [kB][DP]
  float* q_s = v_s + kB * DP;     // [kB][DP]
  float* do_s = q_s + kB * DP;    // [kB][DP]
  float* p_s = do_s + kB * DP;    // [kB][kBP], P[q row][key]
  float* ds_s = p_s + kB * kBP;   // [kB][kBP], dS[q row][key]
  float* lse_s = ds_s + kB * kBP; // [kB]
  float* dl_s = lse_s + kB;       // [kB]

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage<T, D>(k_s, k + (size_t)bk * S * D, k0, S);
  stage<T, D>(v_s, v + (size_t)bk * S * D, k0, S);

  float acc_k[kT][ND], acc_v[kT][ND];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int q_first = causal ? k0 : 0;  // k0 is a multiple of kB
  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + kvh * G + g;
    const T* qb = q + (size_t)bh * S * D;
    const T* dob = dout + (size_t)bh * S * D;
    for (int q0 = q_first; q0 < S; q0 += kB) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(q_s, qb, q0, S);
      stage<T, D>(do_s, dob, q0, S);
      if (tid < kB) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[kT][kT], dp[kT][kT];
      two_products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
      probs(s, dp, lse_s, dl_s, q0, k0, ty, tx, S, causal, scale);
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          p_s[(ty + 16 * i) * kBP + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * kBP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK likewise with dS, Q.
      // This thread: keys ty + 16 i, columns tx + 16 j.
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float pv[kT], sv[kT], ov[ND], qv[ND];
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          pv[i] = p_s[r * kBP + ty + 16 * i];
          sv[i] = ds_s[r * kBP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          ov[j] = do_s[r * DP + tx + 16 * j];
          qv[j] = q_s[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kT; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

  T* dkb = dk + (size_t)bk * S * D;
  T* dvb = dv + (size_t)bk * S * D;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkb[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
      dvb[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(4 * kB * (D + 1) + kB * kBP + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int S, int causal,
              float scale) {
  constexpr int DP = D + 1;
  constexpr int ND = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kB][DP]
  float* do_s = q_s + kB * DP;     // [kB][DP]
  float* k_s = do_s + kB * DP;     // [kB][DP]
  float* v_s = k_s + kB * DP;      // [kB][DP]
  float* ds_s = v_s + kB * DP;     // [kB][kBP]
  float* lse_s = ds_s + kB * kBP;  // [kB]
  float* dl_s = lse_s + kB;        // [kB]

  const int bh = blockIdx.x;  // b * Hq + q head
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.y * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage<T, D>(q_s, q + (size_t)bh * S * D, q0, S);
  stage<T, D>(do_s, dout + (size_t)bh * S * D, q0, S);
  if (tid < kB) {
    const bool in = q0 + tid < S;
    lse_s[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
  }
  float acc[kT][ND];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  const T* kb = k + (size_t)kvh * S * D;
  const T* vb = v + (size_t)kvh * S * D;
  const int kv_end = causal ? min(S, q0 + kB) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(k_s, kb, k0, S);
    stage<T, D>(v_s, vb, k0, S);
    __syncthreads();
    float s[kT][kT], dp[kT][kT];
    two_products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    probs(s, dp, lse_s, dl_s, q0, k0, ty, tx, S, causal, scale);
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j)
        ds_s[(ty + 16 * i) * kBP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d]: rows ty + 16 i, columns
    // tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float sv[kT], kv[ND];
#pragma unroll
      for (int i = 0; i < kT; ++i) sv[i] = ds_s[(ty + 16 * i) * kBP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) kv[j] = k_s[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      dqb[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// raise a kernel's dynamic shared-memory cap once, outside any CUDA-graph
// capture of later calls
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int S, int causal, float scale,
                   cudaStream_t stream) {
  static bool dkdv_ready = false, dq_ready = false;
  constexpr size_t s1 = dkdv_smem<D>(), s2 = dq_smem<D>();
  cudaError_t err = allow_smem(dkdv_kernel<T, D>, s1, &dkdv_ready);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<T, D>, s2, &dq_ready);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const int rows = B * Hq * S;
  const int per_block = kThreads / 32;
  delta_kernel<T, D><<<(rows + per_block - 1) / per_block, kThreads, 0,
                       stream>>>(static_cast<const T*>(o), do_, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (S + kB - 1) / kB;
  dkdv_kernel<T, D><<<dim3(B * Hkv, blocks), kThreads, s1, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3(B * Hq, blocks), kThreads, s2, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), Hq, Hkv, S, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B,
                         int Hq, int Hkv, int S, int D, int causal,
                         float scale, cudaStream_t stream) {
#define K6B_CASE(DD)                                                      \
  case DD:                                                                \
    return launch<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, \
                         Hkv, S, causal, scale, stream);
  switch (D) {
    K6B_CASE(16)
    K6B_CASE(32)
    K6B_CASE(64)
    K6B_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef K6B_CASE
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int S, int D, int causal, int dtype,
    void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq,
                              Hkv, S, D, causal, scale, st);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                      B, Hq, Hkv, S, D, causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
