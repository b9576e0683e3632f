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
// 989 TFLOP/s (21.7 us at B 2, Hq 40, S 1024, D 128, causal).
//
// Two CUDA kernels, chosen by dtype and head widths (both are K6):
//
// * bfloat16 at (DQK, DV) in {(64, 64), (128, 128), (192, 128)}: the
//   tensor-core path (namespace tc, tc_fwd_kernel<DQK, DV>), for the base
//   forms (D 64 / 128, one length) and the general form alike. Both
//   products run on wgmma: S = Q K^T as m64n128k16 with Q and K read from
//   shared memory (K-major), DQK / 16 k steps, O += P V as m64n{DV}k16 with
//   P taken from registers (the RS form) and V read row-major [kv, DV] from
//   shared memory with the B-transpose bit. A CTA of two warpgroups owns
//   128 q rows, 64 each; q head h reads kv head h / g. One elected thread
//   issues TMA loads (cp.async.bulk.tensor, 3-D maps [B*H, S, D] over Sq
//   rows for Q and Sk rows for K and V, so a ragged last tile is
//   zero-filled inside its own head) of the Q block and of 128-row K and V
//   tiles, DQK / 64 and DV / 64 swizzled 64-column halves each, into a
//   2-stage ring with 128-byte swizzle, tracked by mbarriers ("full" per
//   stage for K and for V, "empty" per stage released by all 256 threads);
//   the next tile's loads are in flight while the current tile's products
//   and softmax run. The online softmax (m, l, alpha) is float32 in
//   registers, in the wgmma accumulator layout: a row's max is reduced over
//   the 4 threads of a quad with shuffles, its sum is kept per thread and
//   reduced once at the end. The caller's scale (1/sqrt(D) for the base
//   forms), times log2 e for ex2, is applied to the float32 scores; P is
//   rounded to bf16 in registers for the second product, and l sums the
//   unrounded P. Only tiles on the causal diagonal or past Sk are masked
//   (-1e30, as the Pallas body); tiles above the diagonal are never loaded;
//   rows >= Sq are not stored. The launch order is a group of q heads at a
//   time, within it the q blocks from the last (longest causal band) to
//   the first: one group of every head when all of K and V fit in L2 (the
//   base forms' shapes), else the q heads of one kv head, so the CTAs that
//   read a head's tiles run together and read them again from L2. The tensor maps are encoded on the host for each call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing
//   links libcuda) and passed as __grid_constant__ parameters. At (192,
//   128) shared memory is Q 48 KiB + 2 x (K 48 + V 32 KiB) = 208 KiB, one
//   CTA an SM, as at (128, 128); the registers are D 128's (S, O, P).
//
// * float32 (any widths), and bfloat16 at D 16 / 32 and (24, 16): the FMA
//   path (namespace simt), FA-2 on the float32 FMA units (67 TFLOP/s
//   peak): a tensor core in TF32 cannot hold the 1e-5 float32 tolerance.
//   Grid (B*Hq, ceil(Sq/64)); one CTA of 256 threads per 64-row q block
//   stages its q block (scaled, as the Pallas body) and 32-row K/V tiles in
//   shared memory as float32; a thread owns 4 rows and 2 score columns, row
//   max and sum reduced over 16 lanes with shuffles; float32 (m, l, acc) in
//   registers, one write of the output. Templated on DQK and DV apart, with
//   Sq and Sk apart (a column >= Sk is masked) and the caller's scale.
//
// * The general form takes what the reference reaches through its jnp
//   blocked_attention and not through the Pallas kernel
//   (src/repro/models/blocked_attention.py:30): MLA's prefill, d_qk = 128 +
//   64 against d_v = 128 (src/repro/models/mla.py:72-84), and non-causal
//   cross-attention with Sq != Sk; causal needs Sq == Sk. The wrapper picks
//   its kernel from dtype and (Dqk, Dv): flash_attention_gen_tc_launch (the
//   tensor-core kernel) or flash_attention_gen_launch (the FMA kernel). At
//   MLA's causal prefill (B 2, H 128, S 1024) it is bound by bytes, barely:
//   q, k, v and out once are 335.5 MB, 100.16 us at 3.35 TB/s, against
//   2 B H (S^2 / 2)(DQK + DV) = 86.9 GFLOP, 86.94 us at 989 TFLOP/s. So
//   both matter: the products run on the tensor cores, and each K/V tile,
//   which every later q block of its head reads again, comes from HBM about
//   once (256 heads of 640 KB of K and V do not fit in L2; the grouped
//   launch order above keeps a head's q blocks in flight together).
//
// Both paths write, when given a non-null lse pointer, each row's
// log-sum-exp of its scaled logits (natural log, float32 [B, Hq, Sq]) in
// their epilogue: the one value the backward (csrc/flash_attention_bwd.cu)
// needs to recompute P without a second pass. A null pointer writes
// nothing and leaves the output's arithmetic unchanged.
//
// ABI: q [B, Hq, S, D], k/v [B, Hkv, S, D] (one dtype: float32 or bf16,
// contiguous), out [B, Hq, S, D] in q's dtype, lse float32 [B, Hq, S] or
// null; D in {16, 32, 64, 128}; dtype 0 = float32, 1 = bf16. The general
// form: q [B, Hq, Sq, Dqk], k [B, Hkv, Sk, Dqk], v [B, Hkv, Sk, Dv], out
// [B, Hq, Sq, Dv], lse [B, Hq, Sq] or null, a float32 scale; (Dqk, Dv) in
// {(16, 16), (32, 32), (24, 16)} and, in float32, also {(64, 64), (128,
// 128), (192, 128)} for the FMA entry point; bf16 at {(64, 64), (128, 128),
// (192, 128)} for the tensor-core one.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// --------------------------------------------- FMA path (float32, small D)
namespace simt {

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

constexpr size_t smem_bytes(int DQK, int DV) {
  return sizeof(float) * (size_t)(kBQ * (DQK + 1) + kBK * (DQK + 1) +
                                  kBK * DV + kBQ * (kBK + 1));
}

// q [B, Hq, Sq, DQK], k [B, Hkv, Sk, DQK], v [B, Hkv, Sk, DV] -> out
// [B, Hq, Sq, DV]; causal only with Sq == Sk (the launcher refuses the rest).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
    fma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                   int causal, float scale) {
  static_assert(DV % 16 == 0, "a thread owns DV / 16 output columns");
  constexpr int QP = DQK + 1;
  constexpr int ND = DV / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][QP]
  float* k_s = q_s + kBQ * QP;    // [kBK][QP]
  float* v_s = k_s + kBK * QP;    // [kBK][DV]
  float* p_s = v_s + kBK * DV;    // [kBQ][kBK + 1]

  const int bh = blockIdx.x;  // b * Hq + q head
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * Sq * DQK;
  const T* kb = k + (size_t)kvh * Sk * DQK;
  const T* vb = v + (size_t)kvh * Sk * DV;

  for (int i = tid; i < kBQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK;
    q_s[r * QP + d] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * DQK + d]) * scale : 0.f;
  }
  float m[kRows], l[kRows], acc[kRows][ND];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // q_s is ready; the previous tile's readers are done
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int t = i / DQK, d = i % DQK;
      k_s[t * QP + d] =
          k0 + t < Sk ? to_f32(kb[(size_t)(k0 + t) * DQK + d]) : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      v_s[t * DV + d] =
          k0 + t < Sk ? to_f32(vb[(size_t)(k0 + t) * DV + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + 16 * j) * QP + d];
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
        if (col >= Sk || (causal && col > row)) s[i][j] = kNegInf;
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
      for (int j = 0; j < ND; ++j) vv[j] = v_s[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = out + (size_t)bh * Sq * DV;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[(size_t)row * DV + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    // m and l are the row's over its 16 lanes: one lane writes
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(DQK, DV);
  auto kern = fma_fwd_kernel<T, DQK, DV>;
  // raise the dynamic shared-memory cap once per instantiation, outside
  // any CUDA-graph capture of later calls
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------- tensor-core path (bf16)
namespace tc {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBQ = 128;        // q rows per CTA, 64 per warpgroup
constexpr int kBN = 128;        // KV rows per tile
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kRowBytes = 128;  // one swizzled row of 64 bf16
constexpr float kNegInf = -1e30f;
// up to this many bytes of K and V in all, the launch order takes every
// head as one group (they stay in the 50 MB L2)
constexpr long long kAllInL2 = 40ll << 20;

// Shared memory, from a 1024-byte-aligned base: Q [DQK / 64][kBQ][64],
// then K [stage][DQK / 64][kBN][64], V [stage][DV / 64][kBN][64], then the
// mbarriers. Every tile and half starts on a 1024-byte boundary.
template <int DQK, int DV>
struct Layout {
  static_assert(DQK % 64 == 0 && (DV == 64 || DV == 128),
                "Q/K halves of 64 columns; P V on m64n64 or m64n128");
  static constexpr int kQKHalves = DQK / 64;
  static constexpr int kVHalves = DV / 64;
  static constexpr int kKTile = kBN * DQK * 2;  // one K tile, bytes
  static constexpr int kVTile = kBN * DV * 2;   // one V tile, bytes
  static constexpr int kK = kBQ * DQK * 2;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kVTile;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

// Two CTAs an SM where shared memory holds two (D 64: 128 registers a
// thread at most), else one
template <int DQK, int DV>
constexpr int kMinBlocks = 2 * Layout<DQK, DV>::kBytes <= 232448 ? 2 : 1;

// One CTA a (q head, q block) pair. Grid (group, q blocks, groups of q
// heads), dispatched x first: within a group of `group` q heads the q
// blocks run from the last (longest causal row band) to the first, each
// over the group's heads, so the CTAs that read one head's K and V run
// near each other in time and its tiles are read again from L2. `group`
// divides B * Hq (launch_group).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<DQK, DV>))
    tc_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int Hq, int Hkv, int Sq, int Sk, int causal,
                  float scale_log2, int group) {
  using L = Layout<DQK, DV>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  // k_full[s], v_full[s], empty[s] follow q_full
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;

  const int bh = blockIdx.z * group + blockIdx.x;  // b * Hq + q head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  const int tid = threadIdx.x;

  auto load_kv = [&](int t) {  // one thread: tile t into stage t % kStages
    const int s = t % kStages;
    mbar_expect_tx(k_full + 8 * s, L::kKTile);
#pragma unroll
    for (int hf = 0; hf < L::kQKHalves; ++hf)
      tma_load_3d(k_s + s * L::kKTile + hf * kBN * kRowBytes, &map_k,
                  k_full + 8 * s, hf * 64, t * kBN, kvh);
    mbar_expect_tx(v_full + 8 * s, L::kVTile);
#pragma unroll
    for (int hf = 0; hf < L::kVHalves; ++hf)
      tma_load_3d(v_s + s * L::kVTile + hf * kBN * kRowBytes, &map_v,
                  v_full + 8 * s, hf * 64, t * kBN, kvh);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, kBQ * DQK * 2);
#pragma unroll
    for (int hf = 0; hf < L::kQKHalves; ++hf)
      tma_load_3d(q_s + hf * kBQ * kRowBytes, &map_q, q_full, hf * 64, q0,
                  bh);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }
  __syncthreads();

  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int row_lo = q0 + 64 * wg;             // this warpgroup's first row
  const int r0 = row_lo + 16 * w + lane / 4;   // this thread's rows r0, r0+8
  const uint32_t q_wg = q_s + 64 * wg * kRowBytes;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const int k0 = t * kBN;
    const uint32_t k_t = k_s + s * L::kKTile, v_t = v_s + s * L::kVTile;

    // S = Q K^T over DQK in steps of 16: inside a 64-column half the step
    // moves the start address by 32 bytes (the swizzle is applied to the
    // absolute address), the next half is the next tile
    float sc[kBN / 2];
    mbar_wait(k_full + 8 * s, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const int hf = kk / 4, c = kk % 4;
      wgmma_ss_n128(sc, desc_sw128(q_wg + hf * kBQ * kRowBytes + 32 * c, 0),
                    desc_sw128(k_t + hf * kBN * kRowBytes + 32 * c, 0),
                    kk > 0);
    }
    wg_commit();
    // while the product runs: refill the stage tile t - 1 has released
    if (tid == 0 && t >= 1 && t + kStages - 1 < n_tiles) {
      mbar_wait(empty + 8 * ((t - 1) % kStages), ((t - 1) / kStages) & 1);
      load_kv(t + kStages - 1);
    }
    __syncwarp();
    wg_wait_all();
    reg_fence(sc);

    // online softmax in the accumulator layout, log2 domain
    const bool mask = k0 + kBN > Sk || (causal && k0 + kBN - 1 > row_lo);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (mask) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = r0 + 8 * ((i / 2) % 2);
        if (col >= Sk || (causal && col > row)) x = kNegInf;
      }
      sc[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if ((i / 2) % 2 == hr) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hr] = ex2(m[hr] - mx);
      m[hr] = mx;
    }
    uint32_t p[kBN / 16][4];  // P as the A operand, one k16 step per row
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, hr = j % 2;
        const float p0 = ex2(sc[i] - m[hr]), p1 = ex2(sc[i + 1] - m[hr]);
        rs[hr] += p0 + p1;
        p[kk][j] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + rs[hr];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V over the tile's rows in steps of 16 (16 rows = 2048 bytes);
    // V is MN-major: its 64-column halves are kBN rows apart (LBO)
    mbar_wait(v_full + 8 * s, phase);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_t + kk * 16 * kRowBytes,
                                     kBN * kRowBytes);
      if constexpr (DV == 128)
        wgmma_rs_n128(o, p[kk], dv);
      else
        wgmma_rs_n64(o, p[kk], dv);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    mbar_arrive(empty + 8 * s);
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hr] = 1.f / fmaxf(sum, 1e-30f);
    // m is the row's max in the log2 domain, shared by the quad's lanes
    const int row = r0 + 8 * hr;
    if (lse != nullptr && lane % 4 == 0 && row < Sq)
      lse[(size_t)bh * Sq + row] = (m[hr] + log2f(sum)) * 0.6931471805599453f;
  }
  __nv_bfloat16* ob = out + (size_t)bh * Sq * DV;
#pragma unroll
  for (int i = 0; i < DV / 2; i += 2) {
    const int hr = (i / 2) % 2, row = r0 + 8 * hr;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * DV + col) =
          pack_bf16(o[i] * inv[hr], o[i + 1] * inv[hr]);
  }
}

// q heads a group of the launch order: every head when all of K and V fit
// in L2 (the longest causal row bands of all heads first) or when the
// groups would pass the grid's 65 535 in z, else the q heads of one kv head
// (the CTAs that read its tiles, in flight together)
inline int launch_group(int B, int Hq, int Hkv, int Sk, int DQK, int DV) {
  const long long kv_bytes = (long long)B * Hkv * Sk * (DQK + DV) * 2;
  return kv_bytes <= kAllInL2 || B * Hkv > 65535 ? B * Hq : Hq / Hkv;
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::encode(&mq, q, B * Hq, Sq, DQK, kBQ) ||
      !hopper::encode(&mk, k, B * Hkv, Sk, DQK, kBN) ||
      !hopper::encode(&mv, v, B * Hkv, Sk, DV, kBN))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<DQK, DV>::kBytes;
  auto kern = tc_fwd_kernel<DQK, DV>;
  // raise the dynamic shared-memory cap once per instantiation, outside
  // any CUDA-graph capture of later calls
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int group = launch_group(B, Hq, Hkv, Sk, DQK, DV);
  const dim3 grid(group, (Sq + kBQ - 1) / kBQ, B * Hq / group);
  kern<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, Sq, Sk,
      causal, scale * 1.4426950408889634f, group);
  return cudaGetLastError();
}

// bf16 at the pairs the tensor cores take: the base widths 64 and 128 and
// MLA's (192, 128)
inline cudaError_t launch_pair(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int Dqk, int Dv, int causal,
                               float scale, cudaStream_t stream) {
  if (Dqk == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal,
                          scale, stream);
  if (Dqk == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal,
                            scale, stream);
  if (Dqk == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal,
                            scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

template <typename T>
cudaError_t launch_fma_dtype(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int Hq, int Hkv,
                             int S, int D, int causal, float scale,
                             cudaStream_t stream) {
#define K6_CASE(DD)                                                        \
  case DD:                                                                 \
    return simt::launch_fma<T, DD, DD>(q, k, v, out, lse, B, Hq, Hkv, S,   \
                                      S, causal, scale, stream);
  switch (D) {
    K6_CASE(16)
    K6_CASE(32)
    default:
      break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 64/128: tc path
    switch (D) {
      K6_CASE(64)
      K6_CASE(128)
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
#undef K6_CASE
}

// The general form's FMA kernel at (DQK, DV) with Sq and Sk apart and the
// caller's scale: float32 at every pair (the equal head sizes of a
// cross-attention, MLA at full width, nope 128 + rope 64 against v 128, and
// at the CPU tests' tiny size, 16 + 8 against 16), bf16 at the pairs the
// tensor cores do not take.
template <typename T>
cudaError_t launch_gen_dtype(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int Hq, int Hkv,
                             int Sq, int Sk, int Dqk, int Dv, int causal,
                             float scale, cudaStream_t stream) {
#define K6_GEN(QK, VV)                                                     \
  if (Dqk == QK && Dv == VV)                                               \
    return simt::launch_fma<T, QK, VV>(q, k, v, out, lse, B, Hq, Hkv, Sq,  \
                                      Sk, causal, scale, stream);
  K6_GEN(16, 16)
  K6_GEN(32, 32)
  K6_GEN(24, 16)
  if constexpr (std::is_same<T, float>::value) {  // bf16 at these: tc path
    K6_GEN(64, 64)
    K6_GEN(128, 128)
    K6_GEN(192, 128)
  }
  return cudaErrorInvalidValue;
#undef K6_GEN
}

bool general_args_ok(int B, int Hq, int Hkv, int Sq, int Sk, int causal) {
  return B >= 1 && Hkv >= 1 && Hq % Hkv == 0 && Sq >= 1 && Sk >= 1 &&
         !(causal && Sq != Sk);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse_p,
                                      int B, int Hq, int Hkv, int S, int D,
                                      int causal, int dtype, void* stream) {
  float* lse = static_cast<float*>(lse_p);
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && (D == 64 || D == 128))
    err = tc::launch_pair(q, k, v, out, lse, B, Hq, Hkv, S, S, D, D, causal,
                          scale, st);
  else if (dtype == 1)
    err = launch_fma_dtype<__nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv, S,
                                          D, causal, scale, st);
  else if (dtype == 0)
    err = launch_fma_dtype<float>(q, k, v, out, lse, B, Hq, Hkv, S, D,
                                  causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The general form's FMA kernel (namespace simt): q [B, Hq, Sq, Dqk], k [B,
// Hkv, Sk, Dqk], v [B, Hkv, Sk, Dv] -> out [B, Hq, Sq, Dv], logits times
// `scale`; causal only with Sq == Sk; (Dqk, Dv) one of launch_gen_dtype's
// pairs for the dtype.
extern "C" int flash_attention_gen_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse_p, int B, int Hq,
                                          int Hkv, int Sq, int Sk, int Dqk,
                                          int Dv, int causal, int dtype,
                                          float scale, void* stream) {
  float* lse = static_cast<float*>(lse_p);
  if (!general_args_ok(B, Hq, Hkv, Sq, Sk, causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_gen_dtype<__nv_bfloat16>(
        q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, Dqk, Dv, causal, scale, st);
  if (dtype == 0)
    return (int)launch_gen_dtype<float>(q, k, v, out, lse, B, Hq, Hkv, Sq,
                                        Sk, Dqk, Dv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The general form's tensor-core kernel (namespace tc), bf16 only: the
// same ABI as flash_attention_gen_launch without the dtype; (Dqk, Dv) in
// {(64, 64), (128, 128), (192, 128)}.
extern "C" int flash_attention_gen_tc_launch(const void* q, const void* k,
                                             const void* v, void* out,
                                             void* lse_p, int B, int Hq,
                                             int Hkv, int Sq, int Sk,
                                             int Dqk, int Dv, int causal,
                                             float scale, void* stream) {
  if (!general_args_ok(B, Hq, Hkv, Sq, Sk, causal))
    return (int)cudaErrorInvalidValue;
  return (int)tc::launch_pair(q, k, v, out, static_cast<float*>(lse_p), B,
                              Hq, Hkv, Sq, Sk, Dqk, Dv, causal, scale,
                              static_cast<cudaStream_t>(stream));
}
