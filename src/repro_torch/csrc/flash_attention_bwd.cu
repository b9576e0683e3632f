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
// What bounds it on an H100: operations. Over the causal half the
// gradients need five products of 2 * S^2/2 * D flops a (batch, q head) --
// S = Q K^T and dP = dO V^T recomputed, dV += P^T dO, dK += dS^T Q,
// dQ += dS K -- over ~(4 Hq + 4 Hkv) * B * S * D elements read or written:
// at minicpm-2b's B 4, Hq 36, S 1024, D 64 in bf16, 48.3 GFLOP, 48.9 us at
// the tensor cores' 989 TFLOP/s. Both forms below do seven (67.6 GFLOP
// there): dQ is a second pass that recomputes S and dP, so that every
// output tile is written by one CTA and dQ needs neither atomics nor a
// float32 workspace of per-key-block partials. Each launch is
// deterministic: two launches on the same inputs give the same bits, and a
// resumed training run keeps its trajectory.
//
// Three kernels, launched in order on one stream by each entry point:
//
// 1. delta_kernel (both forms): Dl = rowsum(dO * O) in float32, a row
//    read by D / 8 (bf16) or D / 4 (float32) threads in 16-byte loads, a
//    memory pass (~38 MB at minicpm's shape). For the tensor-core form it
//    also writes the forward's LSE (natural log) times log2 e, and both
//    arrays are padded to Sp = ceil(Sq / 64) * 64 rows a head with zeros,
//    so that a 64-row tile of either is one aligned bulk copy.
// 2. a dK/dV kernel: one CTA a (b, kv head, key block); it loops over the
//    G q heads of its group and, for each, over the query tiles from the
//    diagonal on (all of them when not causal), accumulating dK and dV in
//    registers across the whole group; dK is scaled once and each tile is
//    written once.
// 3. a dQ kernel: one CTA a (b, q head, query block of 64 rows, 128 at
//    (192, 128)), looping over the key tiles up to the diagonal (all of
//    them when not causal).
//
// Two forms, chosen by dtype and widths as K6's forward chooses
// (csrc/flash_attention.cu):
//
// * tc, bfloat16 at (DQK, DV) in {(64, 64), (128, 128), (192, 128)}: every
//   product on wgmma, operands brought by TMA, every tile 64 rows, one
//   template on (DQK, DV) for the base forms and the general form. A
//   warpgroup (128 threads) owns 64 output rows: at D 128 a thread holds
//   dK and dV (64 + 64 floats) beside S^T and dP^T (32 + 32) within 255
//   registers, with no producer warp and no setmaxnreg. At the equal widths
//   each kernel's CTA is one warpgroup: three CTAs an SM at D 64 (a 3-stage
//   ring; 67 KB of shared memory for dK/dV, 65 KB for dQ), two at D 128 (2
//   stages; 98 KB, 97 KB). The CTA's first thread issues the loads: its
//   fixed operands once (K and V for dK/dV, Q and dO for dQ) and a ring of
//   64-row tiles (Q, dO and their LSE and Dl rows for dK/dV; K and V for
//   dQ) in 128-byte-swizzled shared memory, 64-column blocks of [64][64],
//   tracked by "full" mbarriers (TMA bytes) and "empty" ones (every
//   consumer thread's arrival); while tile t runs its score products, the
//   stage of tile t - 1 is refilled with the tile that many stages on. The
//   3-D tensor maps [B*H, Sq or Sk, D] zero-fill a ragged tile inside its
//   own head.
//   dK/dV, a tile of 64 queries: S^T = K Q^T (over DQK) and dP^T = V dO^T
//   (over DV) as SS m64n64k16 (both operands K-major); P^T = 2^(S^T scale
//   log2 e - LSE log2 e) and dS^T = P^T (dP^T - Dl) in float32 in the
//   accumulator registers; dV += P^T dO and dK += dS^T Q as RS m64nNk16:
//   P^T and dS^T rounded to bf16 in registers are the A operand as they lie
//   (the accumulator layout is the A layout), and dO and Q are the B
//   operand read MN-major with the transpose bit, from the same swizzled
//   copy that served as the K-major B a moment before. P^T and dS^T never
//   touch shared memory.
//   dQ, a tile of 64 keys: S = Q K^T and dP = dO V^T as SS m64n64k16, P and
//   dS in registers, dQ += dS K as RS m64nDQKk16 with K read MN-major.
//   Only tiles on the causal diagonal or past Sq or Sk are masked (P = 0
//   for keys past Sk, rows past Sq and keys after the query); rows past Sq
//   and keys past Sk are never stored.
//   At MLA's (192, 128) one warpgroup's dK (96 floats a thread) and dV (64)
//   beside S^T, dP^T and the packed P^T, dS^T (96) would spill, so each
//   kernel's CTA is two warpgroups and one CTA an SM (3-stage rings; 163 KB
//   for dK/dV, 201 KB for dQ). dK/dV: both warpgroups take the CTA's 64
//   keys and compute S^T and dP^T themselves (a tile's score products run
//   twice: 1.5x the products of one warpgroup, no exchange and no barrier
//   between the two); the first accumulates dV (n128) and dK[:, 0:64]
//   (n64), the second dK[:, 64:192] (n128, from Q's second 64-column
//   block). dQ: a warpgroup a 64-row half of a 128-row query block (dQ on
//   m64n192k16), so a CTA reads each K and V tile once for both halves;
//   when causal, the upper half's last key tile lies past its diagonal and
//   it only waits that tile out.
// * simt, float32 (any widths) and bfloat16 at (16, 16), (32, 32) and the
//   tests' (24, 16): the float32 FMA units (67 TFLOP/s peak). TF32 on the
//   tensor cores cannot hold the float32 gate of 1e-4 x max |plain|, and D
//   16 is not worth a tensor-core form. A CTA of 256 threads a 64-row block
//   holds its fixed operands in shared memory as float32 rows padded to D +
//   1 (so 16 threads reading 16 rows at one column hit 16 banks) and its
//   accumulators in registers (a thread: 4 rows x D/16 columns); P and dS
//   go through shared memory between the score products and the gradient
//   products.
//
// The general form: the backward of K6's general forward, at every (DQK,
// DV) pair it takes ((16, 16), (32, 32), (64, 64), (128, 128), (24, 16)
// and MLA's (192, 128)), with Sq and Sk apart (not causal; keys past Sk
// masked as the forward masks them) and the caller's scale, the row sums
// over DV and sized by Sq, dK and dQ DQK wide. bf16 at the three pairs
// above runs the tc kernels (flash_attention_bwd_gen_tc_launch); float32,
// and bf16 at the small widths, the FMA kernels templated on (DQK, DV)
// (flash_attention_bwd_gen_launch; at DQK = 24 a thread's second column is
// masked).
//
// Inputs are float32 or bf16, accumulation float32 throughout, outputs in
// the input dtype. Base forms: any S, D in {16, 32, 64, 128}, Hq a
// multiple of Hkv.
//
// ABI: q, o, do [B, Hq, S, D]; k, v [B, Hkv, S, D] (one dtype, contiguous,
// 16-byte aligned: TMA and the row sums' 16-byte loads);
// lse float32 [B, Hq, S] (the forward's, natural log); scratch float32
// [2, B, Hq, ceil(S / 64) * 64]; dq [B, Hq, S, D], dk, dv [B, Hkv, S, D]
// in the inputs' dtype; dtype 0 = float32, 1 = bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// Dl[bh][i] = sum_d dO . O over a row, for the rows i < Sp of each head
// (zero past S); with lse2 given, also lse2[bh][i] = LSE log2 e (zero past
// S). Rows of both are Sp apart. A row is D / V threads of a warp, each
// reading V elements (16 bytes) of O and of dO, summed by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ lse2, int heads, int S, int Sp) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kPer = D / V;        // threads a row: 2 to 32
  const int row = blockIdx.x * (256 / kPer) + threadIdx.x / kPer;
  const int part = threadIdx.x % kPer;
  const bool in = row < heads * Sp;  // every lane reaches the shuffles
  const int bh = row / Sp, i = row % Sp;
  float acc = 0.f;
  if (in && i < S) {
    const size_t at = ((size_t)bh * S + i) * D + part * V;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + at);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < V; ++e) acc += to_f32(oe[e]) * to_f32(ge[e]);
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, kPer);
  if (in && part == 0) {
    delta[row] = acc;
    if (lse2 != nullptr)
      lse2[row] = i < S ? lse[(size_t)bh * S + i] * 1.4426950408889634f : 0.f;
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
cudaError_t launch_delta(const void* o, const void* dout, const float* lse,
                         float* delta, float* lse2, int heads, int S, int Sp,
                         cudaStream_t stream) {
  const int rows = heads * Sp, per_block = 256 / (D / (16 / sizeof(T)));
  delta_kernel<T, D><<<(rows + per_block - 1) / per_block, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      lse2, heads, S, Sp);
  return cudaGetLastError();
}

// ---------------------------------------- FMA form (float32, small D)
// Templated on (DQK, DV) with Sq and Sk apart: the base forms are (D, D)
// with Sq = Sk; the general form (flash_attention_bwd_gen_launch) every
// pair of K6's general forward, non-causal across Sq != Sk.
namespace simt {

constexpr int kThreads = 256;
constexpr int kB = 64;       // query rows and key rows per tile
constexpr int kBP = kB + 1;  // padded row of a 64-wide score tile
constexpr int kT = 4;        // rows (and score columns) per thread

// a thread holds columns tx + 16 j, j < (D + 15) / 16, of a D-wide row;
// at D = 24 the second column (tx + 16) is past D for tx >= 8 and masked
template <int D>
__device__ __forceinline__ bool col_in(int tx, int j) {
  return D % 16 == 0 || tx + 16 * j < D;
}

// rows [r0, r0 + kB) of a [rows, D] matrix into a [kB][D + 1] float32
// tile, zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < rows ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// S = A B^T over DA and dP = C E^T over DC for this thread's 4 x 4 of a
// 64 x 64 tile: rows ty + 16 i of a and c, rows tx + 16 j of b and e (a, b
// rows DA + 1 apart, c, e rows DC + 1 apart)
template <int DA, int DC>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e,
                                             int ty, int tx,
                                             float (&s)[kT][kT],
                                             float (&dp)[kT][kT]) {
  constexpr int AP = DA + 1, CP = DC + 1;
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (DA == DC) {
#pragma unroll 4
    for (int d = 0; d < DA; ++d) {
      float av[kT], bv[kT], cv[kT], ev[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        av[i] = a[(ty + 16 * i) * AP + d];
        cv[i] = c[(ty + 16 * i) * CP + d];
        bv[i] = b[(tx + 16 * i) * AP + d];
        ev[i] = e[(tx + 16 * i) * CP + d];
      }
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          s[i][j] = fmaf(av[i], bv[j], s[i][j]);
          dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
        }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < DA; ++d) {
      float av[kT], bv[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        av[i] = a[(ty + 16 * i) * AP + d];
        bv[i] = b[(tx + 16 * i) * AP + d];
      }
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DC; ++d) {
      float cv[kT], ev[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        cv[i] = c[(ty + 16 * i) * CP + d];
        ev[i] = e[(tx + 16 * i) * CP + d];
      }
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
    }
  }
}

// P and dS of this thread's 4 x 4 from S, dP and its rows' LSE and Dl:
// zero where the key is past Sk or after the query (causal), or the query
// is past Sq
__device__ __forceinline__ void probs(float (&s)[kT][kT],
                                      float (&dp)[kT][kT], const float* lse,
                                      const float* dl, int q0, int k0,
                                      int ty, int tx, int Sq, int Sk,
                                      int causal, float scale) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool live = row < Sq && col < Sk && !(causal && col > row);
      const float p = live ? expf(s[i][j] * scale - lse[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl[r]);
    }
  }
}

template <int DQK, int DV>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t)(2 * kB * (DQK + 1) + 2 * kB * (DV + 1) +
                                  2 * kB * kBP + 2 * kB);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                int causal, float scale) {
  static_assert(DV % 16 == 0, "a thread owns DV / 16 dV columns");
  constexpr int QP = DQK + 1, VP = DV + 1;
  constexpr int NK = (DQK + 15) / 16, NV = DV / 16;  // acc columns
  extern __shared__ float smem[];
  float* k_s = smem;              // [kB][QP]
  float* v_s = k_s + kB * QP;     // [kB][VP]
  float* q_s = v_s + kB * VP;     // [kB][QP]
  float* do_s = q_s + kB * QP;    // [kB][VP]
  float* p_s = do_s + kB * VP;    // [kB][kBP], P[q row][key]
  float* ds_s = p_s + kB * kBP;   // [kB][kBP], dS[q row][key]
  float* lse_s = ds_s + kB * kBP; // [kB]
  float* dl_s = lse_s + kB;       // [kB]

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage<T, DQK>(k_s, k + (size_t)bk * Sk * DQK, k0, Sk);
  stage<T, DV>(v_s, v + (size_t)bk * Sk * DV, k0, Sk);

  float acc_k[kT][NK], acc_v[kT][NV];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
#pragma unroll
    for (int j = 0; j < NK; ++j) acc_k[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc_v[i][j] = 0.f;
  }

  const int q_first = causal ? k0 : 0;  // k0 is a multiple of kB
  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + kvh * G + g;
    const T* qb = q + (size_t)bh * Sq * DQK;
    const T* dob = dout + (size_t)bh * Sq * DV;
    for (int q0 = q_first; q0 < Sq; q0 += kB) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, DQK>(q_s, qb, q0, Sq);
      stage<T, DV>(do_s, dob, q0, Sq);
      if (tid < kB) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[kT][kT], dp[kT][kT];
      two_products<DQK, DV>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
      probs(s, dp, lse_s, dl_s, q0, k0, ty, tx, Sq, Sk, causal, scale);
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
        float pv[kT], sv[kT], ov[NV], qv[NK];
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          pv[i] = p_s[r * kBP + ty + 16 * i];
          sv[i] = ds_s[r * kBP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) ov[j] = do_s[r * VP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < NK; ++j)
          qv[j] = col_in<DQK>(tx, j) ? q_s[r * QP + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kT; ++i) {
#pragma unroll
          for (int j = 0; j < NV; ++j)
            acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
#pragma unroll
          for (int j = 0; j < NK; ++j)
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
      }
    }
  }

  T* dkb = dk + (size_t)bk * Sk * DQK;
  T* dvb = dv + (size_t)bk * Sk * DV;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      if (col_in<DQK>(tx, j))
        dkb[(size_t)row * DQK + tx + 16 * j] =
            from_f32<T>(acc_k[i][j] * scale);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      dvb[(size_t)row * DV + tx + 16 * j] = from_f32<T>(acc_v[i][j]);
  }
}

template <int DQK, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(2 * kB * (DQK + 1) + 2 * kB * (DV + 1) +
                                  kB * kBP + 2 * kB);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int causal,
              float scale) {
  constexpr int QP = DQK + 1, VP = DV + 1;
  constexpr int NK = (DQK + 15) / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kB][QP]
  float* do_s = q_s + kB * QP;     // [kB][VP]
  float* k_s = do_s + kB * VP;     // [kB][QP]
  float* v_s = k_s + kB * QP;      // [kB][VP]
  float* ds_s = v_s + kB * VP;     // [kB][kBP]
  float* lse_s = ds_s + kB * kBP;  // [kB]
  float* dl_s = lse_s + kB;        // [kB]

  const int bh = blockIdx.x;  // b * Hq + q head
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.y * kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage<T, DQK>(q_s, q + (size_t)bh * Sq * DQK, q0, Sq);
  stage<T, DV>(do_s, dout + (size_t)bh * Sq * DV, q0, Sq);
  if (tid < kB) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
  }
  float acc[kT][NK];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < NK; ++j) acc[i][j] = 0.f;

  const T* kb = k + (size_t)kvh * Sk * DQK;
  const T* vb = v + (size_t)kvh * Sk * DV;
  const int kv_end = causal ? min(Sk, q0 + kB) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, DQK>(k_s, kb, k0, Sk);
    stage<T, DV>(v_s, vb, k0, Sk);
    __syncthreads();
    float s[kT][kT], dp[kT][kT];
    two_products<DQK, DV>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    probs(s, dp, lse_s, dl_s, q0, k0, ty, tx, Sq, Sk, causal, scale);
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
      float sv[kT], kv[NK];
#pragma unroll
      for (int i = 0; i < kT; ++i) sv[i] = ds_s[(ty + 16 * i) * kBP + c];
#pragma unroll
      for (int j = 0; j < NK; ++j)
        kv[j] = col_in<DQK>(tx, j) ? k_s[c * QP + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + (size_t)bh * Sq * DQK;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      if (col_in<DQK>(tx, j))
        dqb[(size_t)row * DQK + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  static bool dkdv_ready = false, dq_ready = false;
  constexpr size_t s1 = dkdv_smem<DQK, DV>(), s2 = dq_smem<DQK, DV>();
  cudaError_t err = allow_smem(dkdv_kernel<T, DQK, DV>, s1, &dkdv_ready);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<T, DQK, DV>, s2, &dq_ready);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  // Dl over DV with rows Sq apart, as the kernels below read it
  err = launch_delta<T, DV>(o, dout, lse, delta, nullptr, B * Hq, Sq, Sq,
                            stream);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DQK, DV>
      <<<dim3(B * Hkv, (Sk + kB - 1) / kB), kThreads, s1, stream>>>(
          q_, k_, v_, do_, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Hq, Hkv, Sq, Sk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, DQK, DV>
      <<<dim3(B * Hq, (Sq + kB - 1) / kB), kThreads, s2, stream>>>(
          q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk,
          causal, scale);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------- tensor-core form (bf16, (64, 64), (128, 128),
// (192, 128))
namespace tc {

constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kBlk = 64;        // rows of every tile: keys or queries
constexpr int kRowBytes = 128;  // one swizzled row of 64 bf16

// Warpgroups a CTA: one at the equal widths; two at (192, 128), where one
// warpgroup's dK and dV (96 + 64 floats a thread) beside S^T and dP^T
// (32 + 32) would spill. The dK/dV kernel's two warpgroups share a CTA's 64
// keys and split the output columns (dV and dK[:, 0:64], dK[:, 64:192]),
// each computing S^T and dP^T itself; the dQ kernel's take 64 query rows
// each, so a CTA reads each K and V tile once for 128 rows.
template <int DQK, int DV>
constexpr int kWGs = DQK + DV > 256 ? 2 : 1;

// CTAs an SM: three at (64, 64), two at (128, 128), one at (192, 128)
template <int DQK, int DV>
constexpr int kCtas = DQK == 64 ? 3 : (DQK == 128 ? 2 : 1);

// ring stages: three where a CTA has the SM's shared memory to itself or a
// third of it, two at (128, 128)
template <int DQK>
constexpr int kRing = DQK == 128 ? 2 : 3;

// Shared memory of the dK/dV kernel, from a 1024-byte-aligned base: K
// [DQK / 64][64][64] and V [DV / 64][64][64], then Q[stage] and dO[stage]
// in the same 64-column blocks, then the LSE (log2) and Dl rows [stage][64]
// float32, then the mbarriers. At D 64 three stages keep a CTA under a
// third of the SM's shared memory, so three CTAs share an SM and hide each
// other's waits (deeper rings with two CTAs an SM were slower).
template <int DQK, int DV>
struct DkdvLayout {
  static constexpr int kStages = kRing<DQK>;
  static constexpr int kQTile = kBlk * DQK * 2;  // a 64-row tile of Q or K
  static constexpr int kVTile = kBlk * DV * 2;   // of dO or V
  static constexpr int kV = kQTile;              // K at 0
  static constexpr int kQ = kV + kVTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kLse = kDO + kStages * kVTile;
  static constexpr int kDl = kLse + kStages * kBlk * 4;
  static constexpr int kBars = kDl + kStages * kBlk * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kCtas<DQK, DV> * kBytes <= 232448, "over the SM's 227 KB");
};

// Shared memory of the dQ kernel: Q[warpgroup] and dO[warpgroup], then
// K[stage] and V[stage], each in 64-column blocks of [64][64], then the
// mbarriers
template <int DQK, int DV>
struct DqLayout {
  static constexpr int kStages = kRing<DQK>;
  static constexpr int kW = kWGs<DQK, DV>;
  static constexpr int kQTile = kBlk * DQK * 2;
  static constexpr int kVTile = kBlk * DV * 2;
  static constexpr int kDO = kW * kQTile;  // Q at 0
  static constexpr int kK = kDO + kW * kVTile;
  static constexpr int kV = kK + kStages * kQTile;
  static constexpr int kBars = kV + kStages * kVTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kCtas<DQK, DV> * kBytes <= 232448, "over the SM's 227 KB");
};

// C[64 x 64] = A B^T over D: the 64-row tiles at `a` and `b`, both
// K-major; in steps of 16 columns, a step inside a 64-column block moving
// the start by 32 bytes (the swizzle is applied to the absolute address),
// the next block the next [64][64]
template <int D>
__device__ __forceinline__ void scores(float (&c)[32], uint32_t a,
                                       uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int hf = kk / 4, s = kk % 4;
    wgmma_ss_n64(c, desc_sw128(a + hf * kBlk * kRowBytes + 32 * s, 0),
                 desc_sw128(b + hf * kBlk * kRowBytes + 32 * s, 0), kk > 0);
  }
}

// C[64 x N] += A[64 x 64] B[64 x N]: A from registers (a[kk], the bf16
// pairs of k step kk), B the 64-row tile at `b` read MN-major: 16 rows a
// step (2048 bytes), its 64-column blocks 64 rows apart (LBO)
template <int N>
__device__ __forceinline__ void grads(float (&c)[N / 2],
                                      const uint32_t (&a)[4][4], uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * kRowBytes,
                                   kBlk * kRowBytes);
    if constexpr (N == 192)
      wgmma_rs_n192(c, a[kk], db);
    else if constexpr (N == 128)
      wgmma_rs_n128(c, a[kk], db);
    else
      wgmma_rs_n64(c, a[kk], db);
  }
}

// one 64-row tile of [B*H, S, D] at rows r0 of head bh into `dst`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int bh) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    hopper::tma_load_3d(dst + hf * kBlk * kRowBytes, map, bar, hf * 64, r0,
                        bh);
}

template <int N>
using Cols = std::integral_constant<int, N>;

template <int DQK, int DV>
__global__ void __launch_bounds__((kWG * kWGs<DQK, DV>), (kCtas<DQK, DV>))
    dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse2,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int Sq,
                int Sk, int Sp, int causal, float scale, float scale_log2) {
  using L = DkdvLayout<DQK, DV>;
  using namespace hopper;
  constexpr int kSt = L::kStages, kW = kWGs<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023) & ~1023u) -
                       smem_u32(smem_raw);
  const uint32_t base = smem_u32(smem_raw) + pad;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + pad +
                                                      L::kLse);
  const float* dl_s = reinterpret_cast<const float*>(smem_raw + pad + L::kDl);
  const uint32_t kv_full = base + L::kBars, full = kv_full + 8,
                 empty = full + 8 * kSt;

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * kBlk;     // the grid's first blocks are the
  const int q_first = causal ? k0 : 0;  // longest: most query tiles
  const int nq = (Sq - q_first + kBlk - 1) / kBlk;  // query tiles a head
  const int n_tiles = G * nq;
  const int tid = threadIdx.x;

  auto load = [&](int t) {  // one thread: tile t into stage t % kSt
    const int s = t % kSt;
    const int bh = b * Hq + kvh * G + t / nq;
    const int q0 = q_first + (t % nq) * kBlk;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, L::kQTile + L::kVTile + 2 * kBlk * 4);
    load_tile<DQK>(base + L::kQ + s * L::kQTile, &map_q, bar, q0, bh);
    load_tile<DV>(base + L::kDO + s * L::kVTile, &map_do, bar, q0, bh);
    bulk_load(base + L::kLse + s * kBlk * 4, lse2 + (size_t)bh * Sp + q0,
              kBlk * 4, bar);
    bulk_load(base + L::kDl + s * kBlk * 4, delta + (size_t)bh * Sp + q0,
              kBlk * 4, bar);
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWG * kW);
    }
    mbar_fence_init();
    mbar_expect_tx(kv_full, L::kQTile + L::kVTile);
    load_tile<DQK>(base, &map_k, kv_full, k0, bk);
    load_tile<DV>(base + L::kV, &map_v, kv_full, k0, bk);
    for (int t = 0; t < kSt && t < n_tiles; ++t) load(t);
  }
  __syncthreads();

  const int w = (tid / 32) % 4, lane = tid % 32;
  const int kr = k0 + 16 * w + lane / 4;  // this thread's keys kr, kr + 8

  // one warpgroup's tiles: dK's columns [KC, KC + KN) and, with kDV, dV
  auto run = [&](auto kc, auto kn, auto with_dv) {
    constexpr int KC = decltype(kc)::value, KN = decltype(kn)::value;
    constexpr bool kDV = decltype(with_dv)::value;
    float acc_k[KN / 2], acc_v[kDV ? DV / 2 : 1];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kDV ? DV / 2 : 1); ++i) acc_v[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kSt;
      const int q0 = q_first + (t % nq) * kBlk;
      const uint32_t q_t = base + L::kQ + s * L::kQTile,
                     do_t = base + L::kDO + s * L::kVTile;
      float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
      mbar_wait(full + 8 * s, (t / kSt) & 1);
      wg_fence();
      scores<DQK>(st, base, q_t);
      scores<DV>(dpt, base + L::kV, do_t);
      wg_commit();
      // while the products run: refill the stage tile t - 1 released
      if (tid == 0 && t >= 1 && t + kSt - 1 < n_tiles) {
        mbar_wait(empty + 8 * ((t - 1) % kSt), ((t - 1) / kSt) & 1);
        load(t + kSt - 1);
      }
      __syncwarp();
      wg_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T in the accumulator layout, packed to bf16 as the A
      // operand: value i = 8 kk + 2 j (+1) of k step kk is key kr + 8 (j %
      // 2), query q0 + 16 kk + 8 (j / 2) + 2 (lane % 4) (+1)
      const float* lse_t = lse_s + s * kBlk;
      const float* dl_t = dl_s + s * kBlk;
      const bool mask = (causal && k0 + kBlk - 1 > q0) || q0 + kBlk > Sq ||
                        k0 + kBlk > Sk;
      uint32_t pT[4][4], dsT[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int key = kr + 8 * (j % 2);
          const int c = 16 * kk + 8 * (j / 2) + 2 * (lane % 4);
          float p[2], d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = ex2(st[i + e] * scale_log2 - lse_t[c + e]);
            if (mask) {
              const int qr = q0 + c + e;
              if (qr >= Sq || key >= Sk || (causal && key > qr)) x = 0.f;
            }
            p[e] = x;
            d[e] = x * (dpt[i + e] - dl_t[c + e]);
          }
          pT[kk][j] = pack_bf16(p[0], p[1]);
          dsT[kk][j] = pack_bf16(d[0], d[1]);
        }

      // dV += P^T dO, dK[:, KC:KC + KN] += dS^T Q[:, KC:KC + KN] (Q and dO
      // read MN-major)
      wg_fence();
      if constexpr (kDV) grads<DV>(acc_v, pT, do_t);
      grads<KN>(acc_k, dsT, q_t + (KC / 64) * kBlk * kRowBytes);
      wg_commit();
      wg_wait_all();
      if constexpr (kDV) reg_fence(acc_v);
      reg_fence(acc_k);
      mbar_arrive(empty + 8 * s);
    }

    __nv_bfloat16* dkb = dk + (size_t)bk * Sk * DQK + KC;
#pragma unroll
    for (int i = 0; i < KN / 2; i += 2) {
      const int row = kr + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      if (row < Sk)
        *reinterpret_cast<uint32_t*>(dkb + (size_t)row * DQK + col) =
            pack_bf16(acc_k[i] * scale, acc_k[i + 1] * scale);
    }
    if constexpr (kDV) {
      __nv_bfloat16* dvb = dv + (size_t)bk * Sk * DV;
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int row = kr + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        if (row < Sk)
          *reinterpret_cast<uint32_t*>(dvb + (size_t)row * DV + col) =
              pack_bf16(acc_v[i], acc_v[i + 1]);
      }
    }
  };

  if constexpr (kW == 1) {
    run(Cols<0>{}, Cols<DQK>{}, std::true_type{});
  } else {
    static_assert(DQK == 192 && DV == 128, "two warpgroups: MLA's widths");
    if (tid < kWG)
      run(Cols<0>{}, Cols<64>{}, std::true_type{});
    else
      run(Cols<64>{}, Cols<128>{}, std::false_type{});
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__((kWG * kWGs<DQK, DV>), (kCtas<DQK, DV>))
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse2,
              const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
              int Sp, int causal, float scale, float scale_log2) {
  using L = DqLayout<DQK, DV>;
  using namespace hopper;
  constexpr int kSt = L::kStages, kW = L::kW, kRows = kBlk * kW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars, full = q_full + 8,
                 empty = full + 8 * kSt;

  const int bh = blockIdx.x;  // b * Hq + q head
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  // the grid's first blocks are the last query blocks: the most key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kv_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_tiles = (kv_end + kBlk - 1) / kBlk;
  const int tid = threadIdx.x;

  auto load = [&](int t) {  // one thread: key tile t into stage t % kSt
    const int s = t % kSt;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, L::kQTile + L::kVTile);
    load_tile<DQK>(base + L::kK + s * L::kQTile, &map_k, bar, t * kBlk, kvh);
    load_tile<DV>(base + L::kV + s * L::kVTile, &map_v, bar, t * kBlk, kvh);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWG * kW);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, kW * (L::kQTile + L::kVTile));
    for (int g = 0; g < kW; ++g) {
      load_tile<DQK>(base + g * L::kQTile, &map_q, q_full, q0 + g * kBlk, bh);
      load_tile<DV>(base + L::kDO + g * L::kVTile, &map_do, q_full,
                    q0 + g * kBlk, bh);
    }
    for (int t = 0; t < kSt && t < n_tiles; ++t) load(t);
  }
  __syncthreads();

  const int wg = kW == 1 ? 0 : tid / kWG, w = (tid / 32) % 4,
            lane = tid % 32;
  const int qw = q0 + wg * kBlk;          // this warpgroup's first row
  const int r0 = qw + 16 * w + lane / 4;  // this thread's rows r0, r0 + 8
  const uint32_t q_s = base + wg * L::kQTile,
                 do_s = base + L::kDO + wg * L::kVTile;
  // the warpgroup's key tiles: causal, the upper one of two stops a tile
  // early; it waits out the CTA's last tile without a product
  const int n_own = causal ? (min(Sk, qw + kBlk) + kBlk - 1) / kBlk
                           : n_tiles;
  float lse_r[2], dl_r[2];  // rows < Sp: the padded arrays
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    const bool in = kW == 1 || row < Sp;
    lse_r[hr] = in ? lse2[(size_t)bh * Sp + row] : 0.f;
    dl_r[hr] = in ? delta[(size_t)bh * Sp + row] : 0.f;
  }
  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kSt;
    const int k0 = t * kBlk;
    const bool live = kW == 1 || t < n_own;
    const uint32_t k_t = base + L::kK + s * L::kQTile,
                   v_t = base + L::kV + s * L::kVTile;
    float sc[32], dp[32];  // S and dP: rows queries, columns keys
    mbar_wait(full + 8 * s, (t / kSt) & 1);
    if (live) {
      wg_fence();
      scores<DQK>(sc, q_s, k_t);
      scores<DV>(dp, do_s, v_t);
      wg_commit();
    }
    if (tid == 0 && t >= 1 && t + kSt - 1 < n_tiles) {
      mbar_wait(empty + 8 * ((t - 1) % kSt), ((t - 1) / kSt) & 1);
      load(t + kSt - 1);
    }
    __syncwarp();
    if (live) {
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // dS in the accumulator layout, packed to bf16 as the A operand:
      // value i = 8 kk + 2 j (+1) is row r0 + 8 (j % 2), key k0 + 16 kk +
      // 8 (j / 2) + 2 (lane % 4) (+1)
      const bool mask = (causal && k0 + kBlk - 1 > qw) || k0 + kBlk > Sk ||
                        qw + kBlk > Sq;
      uint32_t ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, hr = j % 2;
          const int row = r0 + 8 * hr;
          const int key = k0 + 16 * kk + 8 * (j / 2) + 2 * (lane % 4);
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = ex2(sc[i + e] * scale_log2 - lse_r[hr]);
            if (mask &&
                (row >= Sq || key + e >= Sk || (causal && key + e > row)))
              x = 0.f;
            d[e] = x * (dp[i + e] - dl_r[hr]);
          }
          ds[kk][j] = pack_bf16(d[0], d[1]);
        }

      // dQ += dS K (K read MN-major)
      wg_fence();
      grads<DQK>(acc, ds, k_t);
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
    }
    mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* dqb = dq + (size_t)bh * Sq * DQK;
#pragma unroll
  for (int i = 0; i < DQK / 2; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < Sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row * DQK + col) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
  }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* scratch, void* dq, void* dk, void* dv, int B,
                   int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  static bool dkdv_ready = false, dq_ready = false;
  constexpr int s1 = DkdvLayout<DQK, DV>::kBytes;
  constexpr int s2 = DqLayout<DQK, DV>::kBytes;
  constexpr int kThreads = kWG * kWGs<DQK, DV>;
  cudaError_t err = allow_smem(dkdv_kernel<DQK, DV>, s1, &dkdv_ready);
  if (err != cudaSuccess) return err;
  err = allow_smem(dq_kernel<DQK, DV>, s2, &dq_ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::encode(&mq, q, B * Hq, Sq, DQK, kBlk) ||
      !hopper::encode(&mk, k, B * Hkv, Sk, DQK, kBlk) ||
      !hopper::encode(&mv, v, B * Hkv, Sk, DV, kBlk) ||
      !hopper::encode(&mdo, dout, B * Hq, Sq, DV, kBlk))
    return cudaErrorInvalidValue;
  const int Sp = (Sq + kBlk - 1) / kBlk * kBlk;
  float* delta = scratch;
  float* lse2 = scratch + (size_t)B * Hq * Sp;
  err = launch_delta<__nv_bfloat16, DV>(o, dout, lse, delta, lse2, B * Hq,
                                        Sq, Sp, stream);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  dkdv_kernel<DQK, DV>
      <<<dim3(B * Hkv, (Sk + kBlk - 1) / kBlk), kThreads, s1, stream>>>(
          mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), Hq, Hkv, Sq, Sk, Sp, causal,
          scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kRows = kBlk * kWGs<DQK, DV>;
  dq_kernel<DQK, DV>
      <<<dim3(B * Hq, (Sq + kRows - 1) / kRows), kThreads, s2, stream>>>(
          mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), Hq,
          Hkv, Sq, Sk, Sp, causal, scale, scale_log2);
  return cudaGetLastError();
}

// bf16 at the pairs the tensor cores take: the base widths 64 and 128 and
// MLA's (192, 128)
inline cudaError_t launch_pair(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* scratch, void* dq,
                               void* dk, void* dv, int B, int Hq, int Hkv,
                               int Sq, int Sk, int Dqk, int Dv, int causal,
                               float scale, cudaStream_t stream) {
#define K6B_TC(QK, VV)                                                      \
  if (Dqk == QK && Dv == VV)                                                \
    return launch<QK, VV>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,    \
                          Hq, Hkv, Sq, Sk, causal, scale, stream);
  K6B_TC(64, 64)
  K6B_TC(128, 128)
  K6B_TC(192, 128)
  return cudaErrorInvalidValue;
#undef K6B_TC
}

}  // namespace tc

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int B,
                        int Hq, int Hkv, int S, int D, int causal,
                        float scale, cudaStream_t stream) {
#define K6B_CASE(DD)                                                      \
  case DD:                                                                \
    return simt::launch<T, DD, DD>(q, k, v, o, dout, lse, delta, dq, dk,  \
                                   dv, B, Hq, Hkv, S, S, causal, scale,   \
                                   stream);
  switch (D) {
    K6B_CASE(16)
    K6B_CASE(32)
    default:
      break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 64/128: tc form
    switch (D) {
      K6B_CASE(64)
      K6B_CASE(128)
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
#undef K6B_CASE
}

// The general form's FMA backward at (DQK, DV) with Sq and Sk apart and
// the caller's scale: float32 at every pair of K6's general forward
// (GEN_DIMS; TF32 could not hold float32's gate), bf16 at the pairs the
// tensor cores do not take (tc::launch_pair takes the rest).
template <typename T>
cudaError_t launch_gen(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int Hq, int Hkv, int Sq, int Sk, int Dqk, int Dv,
                       int causal, float scale, cudaStream_t stream) {
#define K6B_GEN(QK, VV)                                                    \
  if (Dqk == QK && Dv == VV)                                               \
    return simt::launch<T, QK, VV>(q, k, v, o, dout, lse, delta, dq, dk,   \
                                   dv, B, Hq, Hkv, Sq, Sk, causal, scale,  \
                                   stream);
  K6B_GEN(16, 16)
  K6B_GEN(32, 32)
  K6B_GEN(24, 16)
  if constexpr (std::is_same<T, float>::value) {  // bf16 at these: tc form
    K6B_GEN(64, 64)
    K6B_GEN(128, 128)
    K6B_GEN(192, 128)
  }
  return cudaErrorInvalidValue;
#undef K6B_GEN
}

bool general_args_ok(int B, int Hq, int Hkv, int Sq, int Sk, int causal) {
  return B >= 1 && Hkv >= 1 && Hq % Hkv == 0 && Sq >= 1 && Sk >= 1 &&
         !(causal && Sq != Sk);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int S, int D, int causal, int dtype,
    void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == 1 && (D == 64 || D == 128))
    err = tc::launch_pair(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq, Hkv, S,
                          S, D, D, causal, scale, st);
  else if (dtype == 1)
    err = launch_simt<__nv_bfloat16>(q, k, v, o, dout, l, sc, dq, dk, dv, B,
                                     Hq, Hkv, S, D, causal, scale, st);
  else if (dtype == 0)
    err = launch_simt<float>(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq, Hkv,
                             S, D, causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The general form's FMA backward (namespace simt): q [B, Hq, Sq, Dqk], k
// [B, Hkv, Sk, Dqk], v [B, Hkv, Sk, Dv], o and do [B, Hq, Sq, Dv], lse
// float32 [B, Hq, Sq] (the general forward's, natural log, of the logits
// times `scale`), scratch float32 [2, B, Hq, ceil(Sq / 64) * 64] (the row
// sums use its first B Hq Sq values); dq, dk, dv like q, k, v; causal only
// with Sq == Sk; (Dqk, Dv) one of launch_gen's pairs for the dtype.
extern "C" int flash_attention_bwd_gen_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int Dqk, int Dv,
    int causal, int dtype, float scale, void* stream) {
  if (!general_args_ok(B, Hq, Hkv, Sq, Sk, causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1)
    return (int)launch_gen<__nv_bfloat16>(q, k, v, o, dout, l, sc, dq, dk,
                                          dv, B, Hq, Hkv, Sq, Sk, Dqk, Dv,
                                          causal, scale, st);
  if (dtype == 0)
    return (int)launch_gen<float>(q, k, v, o, dout, l, sc, dq, dk, dv, B, Hq,
                                  Hkv, Sq, Sk, Dqk, Dv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The general form's tensor-core backward (namespace tc), bf16 only: the
// same ABI as flash_attention_bwd_gen_launch without the dtype (scratch
// [2, B, Hq, ceil(Sq / 64) * 64]: the row sums and the log2 LSE, each
// padded to 64 rows a head); (Dqk, Dv) in {(64, 64), (128, 128), (192,
// 128)}.
extern "C" int flash_attention_bwd_gen_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int Dqk, int Dv,
    int causal, float scale, void* stream) {
  if (!general_args_ok(B, Hq, Hkv, Sq, Sk, causal))
    return (int)cudaErrorInvalidValue;
  return (int)tc::launch_pair(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(scratch), dq, dk, dv, B, Hq, Hkv, Sq, Sk, Dqk, Dv,
      causal, scale, static_cast<cudaStream_t>(stream));
}
