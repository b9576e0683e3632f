// K5: one-token grouped-query decode attention over a KV cache
// (FlashDecoding: split the cache over CTAs, merge the partial softmaxes).
//
// Replaces (TPU, Pallas):
//   src/repro/kernels/decode_attention/decode_attention.py:70
//   decode_attention_pallas (body _kernel :30).
//
// What bounds it on an H100: bytes. One query token reads the whole valid
// part of its K/V cache once and does 4*D flops per position and head, far
// below the ~295 flops per byte at which bf16 stops being memory-bound, so
// the floor is (K/V bytes up to kv_len) / 3.35 TB/s: 20.06 us at B 4, Hkv 8,
// D 128, kv_len 4096 (bf16). At the serving shapes (B = 4 slots, Hkv = 8)
// there are only 32 (batch, kv-head) pairs for 132 SMs, so the cache is
// split over CTAs. The wrapper's split plan (split_plan in
// kernels/decode_attention/decode_attention.py) aims at about one CTA per
// SM, each keeping ~48 KB in flight: splits of at least 256 positions, and
// a short cache's group spread over more CTAs instead of more splits.
//
// Design (both dtypes, D in {16, 32, 64, 128, 256}): one launch, grid
// (B*Hkv*n_hc, n_splits). A CTA of 128 threads takes one chunk of `chunk`
// cache positions for GC in {1, 2, 4, 5, 8} query heads of its GQA group
// (GC = 5 is qwen3-14b's group of 40 / 8; n_hc = ceil(g / GC) CTAs share
// a chunk when g > GC, the heads split as evenly as they go, and run side
// by side), so a K/V tile is read from device memory once for the whole
// group. CTAs whose chunk starts at or past kv_len[b] exit at once; kv_len
// is read on the device.
// * Loads: 16-byte cp.async copies (8 bf16 or 4 float32 per thread) of
//   32-position K and V tiles, in their storage dtype, into a ring of
//   2-8 stages (~64 KB, so ~48 KB in flight per CTA); tail positions are
//   zero-filled. One __syncthreads per stage.
// * Scores: a position's row is held by a team of D*size/16 lanes (at most
//   32; a lane holds 16 or 32 bytes of it). Each lane keeps its slice of
//   the CTA's scaled q heads (q * 1/sqrt(D) in float32, as the Pallas
//   body, times log2 e: the softmax runs on ex2) in registers; a dot over
//   D is the lane's partial sum reduced over the team with xor shuffles,
//   which leaves the score on every lane of the team. A team takes 4 of a
//   tile's positions (bf16, D = 128) and all GC heads at once: 4 x GC
//   independent dot-and-shuffle chains, which is what hides the shuffles'
//   latency with 4 warps per CTA.
// * Softmax: each team runs its own float32 online softmax (m, l, and acc
//   for its slice of D) over its positions, one rescale per stage; masked
//   positions get p = 0 (scores -1e30, as the Pallas body).
// * Merge, in the same launch: the teams' partials are merged in shared
//   memory; a CTA that is the only split of its row writes the output,
//   otherwise it writes its partial (m, l, acc[GC, D]) to a float32
//   workspace, __threadfence()s and adds one to its (b, kv-head, head
//   chunk)'s counter. The CTA that sees the count reach the number of live
//   splits merges them all, writes q's dtype and resets the counter to 0,
//   so the next call and a CUDA-graph replay start clean. kv_len = 0 gives
//   0 (written by split 0), never NaN, as the Pallas kernel gives.
//
// ABI: q [B, Hq, D], k/v [B, Hkv, S, D] (one dtype: float32 or bf16,
// contiguous), kv_len int32[B], out [B, Hq, D] in q's dtype; workspace
// part_acc f32[B*Hkv*n_hc, n_splits, GC, D], part_ml f32[B*Hkv*n_hc,
// n_splits, GC, 2]; counter int32[B*Hkv*n_hc], all 0 before the call and
// after it; n_splits = ceil(S / chunk), chunk a multiple of 32; GC in
// {1, 2, 4, 5, 8}, n_hc = ceil(Hq / Hkv / GC); dtype 0 = float32, 1 = bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;              // cache positions per stage
constexpr int kRingBytes = 64 * 1024;  // shared memory of the ring
constexpr float kNegInf = -1e30f;

constexpr int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T, int D, int GC>
struct Cfg {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per copy
  static constexpr int kChunks = D / kVec;          // 16-byte chunks a row
  static constexpr int kTeam = kChunks < 32 ? kChunks : 32;  // lanes a row
  static constexpr int kCPL = kChunks / kTeam;      // chunks per lane
  static constexpr int kE = kCPL * kVec;            // elements per lane
  static constexpr int kTeams = kThreads / kTeam;
  static constexpr int kPos = kTile > kTeams ? kTile / kTeams : 1;
  static constexpr int kRows = kTile * D * (int)sizeof(T);  // K or V tile
  static constexpr int kStages = clamp_int(kRingBytes / (2 * kRows), 2, 8);
  static constexpr int kMerge = kTeams * GC * (D + 2) * 4;
  static constexpr int kSmem = 2 * kRows * kStages > kMerge
                                   ? 2 * kRows * kStages
                                   : kMerge;
};

__device__ __forceinline__ void to_f32(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_len,
                  T* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counter,
                  int Hkv, int g, int S, int chunk, int n_splits,
                  float scale) {
  using C = Cfg<T, D, GC>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_split;

  const int n_hc = (g + GC - 1) / GC;
  const int row = blockIdx.x;  // (b * Hkv + kv head) * n_hc + head chunk
  const int bh = row / n_hc, hc = row % n_hc;
  // the group's heads split as evenly as they go: [h_lo, h_lo + gh)
  const int h_lo = hc * g / n_hc, gh = (hc + 1) * g / n_hc - h_lo;
  const int split = blockIdx.y;
  const int len = max(0, min(kv_len[bh / Hkv], S));
  const int tid = threadIdx.x;
  const size_t head0 = (size_t)bh * g + h_lo;  // first q head, [B*Hq]
  if (len == 0) {  // nothing to attend to: 0, as the Pallas kernel
    if (split == 0)
      for (int i = tid; i < gh * D; i += kThreads)
        out[head0 * D + i] = from_f32<T>(0.f);
    return;
  }
  const int start = split * chunk;
  if (start >= len) return;  // no live position in this split
  const int end = min(start + chunk, len);
  const int used = (len + chunk - 1) / chunk;
  const int n_tiles = (end - start + kTile - 1) / kTile;

  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  auto load = [&](int t) {  // tile t of this chunk into stage t % kStages
    uint8_t* dst = smem + (t % C::kStages) * 2 * C::kRows;
    const int pos0 = start + t * kTile;
    constexpr int per = kTile * C::kChunks;  // 16-byte chunks of K (or V)
#pragma unroll
    for (int it = 0; it < 2 * per / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int which = i / per, j = i % per;
      const int pos = pos0 + j / C::kChunks;
      const bool ok = pos < end;
      const T* src = (which ? vb : kb) + (size_t)(ok ? pos : 0) * D +
                     (j % C::kChunks) * C::kVec;
      cp_async16(dst + which * C::kRows + 16 * j, src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  // this lane's slice of D: chunks lt + kTeam * c, c < kCPL
  const int team = tid / C::kTeam, lt = tid % C::kTeam;
  float qr[GC][C::kE], acc[GC][C::kE], m[GC], l[GC];
#pragma unroll
  for (int h = 0; h < GC; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCPL; ++c)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) {
        const int d = (lt + C::kTeam * c) * C::kVec + e;
        qr[h][c * C::kVec + e] =
            h < gh ? to_f32(q[(head0 + h) * D + d]) * scale : 0.f;
        acc[h][c * C::kVec + e] = 0.f;
      }
  }

  auto row_of = [&](const uint8_t* tile, int r, float* f) {
#pragma unroll
    for (int c = 0; c < C::kCPL; ++c)
      to_f32(*reinterpret_cast<const uint4*>(
                 tile + 16 * (r * C::kChunks + lt + C::kTeam * c)),
             f + c * C::kVec, T());
  };

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's readers are done
    if (t + C::kStages - 1 < n_tiles) load(t + C::kStages - 1);
    cp_async_commit();

    const uint8_t* ks = smem + (t % C::kStages) * 2 * C::kRows;
    const uint8_t* vs = ks + C::kRows;
    const int pos0 = start + t * kTile;
    // the team's positions of this tile: kPos rows, their K slices first
    bool ok[C::kPos];
    float kf[C::kPos][C::kE];
#pragma unroll
    for (int i = 0; i < C::kPos; ++i) {
      const int r = team + C::kTeams * i;
      ok[i] = r < kTile && pos0 + r < end;
      row_of(ks, r < kTile ? r : 0, kf[i]);
    }
    // every head slot runs (slots past gh hold q = 0), so the kPos x GC
    // dot-and-shuffle chains are independent and interleave
    float s[C::kPos][GC];
#pragma unroll
    for (int h = 0; h < GC; ++h)
#pragma unroll
      for (int i = 0; i < C::kPos; ++i) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < C::kE; e += 2) {
          d0 = fmaf(qr[h][e], kf[i][e], d0);
          d1 = fmaf(qr[h][e + 1], kf[i][e + 1], d1);
        }
        s[i][h] = d0 + d1;
      }
#pragma unroll
    for (int off = C::kTeam / 2; off > 0; off >>= 1)
#pragma unroll
      for (int h = 0; h < GC; ++h)
#pragma unroll
        for (int i = 0; i < C::kPos; ++i)
          s[i][h] += __shfl_xor_sync(0xffffffffu, s[i][h], off);
#pragma unroll
    for (int h = 0; h < GC; ++h) {
      float mx = m[h];
#pragma unroll
      for (int i = 0; i < C::kPos; ++i)
        if (ok[i]) mx = fmaxf(mx, s[i][h]);
      const float alpha = ex2(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < C::kE; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int i = 0; i < C::kPos; ++i) {
        s[i][h] = ok[i] ? ex2(s[i][h] - mx) : 0.f;
        l[h] += s[i][h];
      }
    }
#pragma unroll
    for (int i = 0; i < C::kPos; ++i) {
      const int r = team + C::kTeams * i;
      float vf[C::kE];
      row_of(vs, r < kTile ? r : 0, vf);
#pragma unroll
      for (int h = 0; h < GC; ++h)
#pragma unroll
        for (int e = 0; e < C::kE; ++e)
          acc[h][e] = fmaf(s[i][h], vf[e], acc[h][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the teams' partials

  float* m_s = reinterpret_cast<float*>(smem);  // [kTeams][GC]
  float* l_s = m_s + C::kTeams * GC;            // [kTeams][GC]
  float* a_s = l_s + C::kTeams * GC;            // [kTeams][GC][D]
#pragma unroll
  for (int h = 0; h < GC; ++h) {
    if (lt == 0) {
      m_s[team * GC + h] = m[h];
      l_s[team * GC + h] = l[h];
    }
#pragma unroll
    for (int c = 0; c < C::kCPL; ++c)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e)
        a_s[(team * GC + h) * D + (lt + C::kTeam * c) * C::kVec + e] =
            acc[h][c * C::kVec + e];
  }
  __syncthreads();

  const size_t part = (size_t)row * n_splits + split;
  for (int i = tid; i < gh * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mt = kNegInf;
    for (int tm = 0; tm < C::kTeams; ++tm) mt = fmaxf(mt, m_s[tm * GC + h]);
    float lsum = 0.f, at = 0.f;
    for (int tm = 0; tm < C::kTeams; ++tm) {
      const float w = ex2(m_s[tm * GC + h] - mt);
      lsum = fmaf(l_s[tm * GC + h], w, lsum);
      at = fmaf(a_s[(tm * GC + h) * D + d], w, at);
    }
    if (used == 1) {
      out[(head0 + h) * D + d] = from_f32<T>(at / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[(part * GC + h) * D + d] = at;
      if (d == 0) {
        part_ml[(part * GC + h) * 2] = mt;
        part_ml[(part * GC + h) * 2 + 1] = lsum;
      }
    }
  }
  if (used == 1) return;

  // the last live split of this row to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_split = atomicAdd(&counter[row], 1) == used - 1;
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  const size_t part0 = (size_t)row * n_splits;
  for (int i = tid; i < gh * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mt = kNegInf;
    for (int sp = 0; sp < used; ++sp)
      mt = fmaxf(mt, __ldcg(&part_ml[((part0 + sp) * GC + h) * 2]));
    float lsum = 0.f, at = 0.f;
    for (int sp = 0; sp < used; ++sp) {
      const size_t p = (part0 + sp) * GC + h;
      const float w = ex2(__ldcg(&part_ml[p * 2]) - mt);
      lsum = fmaf(__ldcg(&part_ml[p * 2 + 1]), w, lsum);
      at = fmaf(__ldcg(&part_acc[p * D + d]), w, at);
    }
    out[(head0 + h) * D + d] = from_f32<T>(at / fmaxf(lsum, 1e-30f));
  }
  if (tid == 0) counter[row] = 0;
}

template <typename T, int D, int GC>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part_acc,
                         float* part_ml, int* counter, int B, int Hkv, int g,
                         int S, int chunk, float scale, cudaStream_t stream) {
  using C = Cfg<T, D, GC>;
  const int n_splits = (S + chunk - 1) / chunk;
  const int n_hc = (g + GC - 1) / GC;
  auto kern = decode_kernel<T, D, GC>;
  // raise the dynamic shared-memory cap once per instantiation, outside
  // any CUDA-graph capture of later calls
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kern<<<dim3(B * Hkv * n_hc, n_splits), kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), part_acc,
      part_ml, counter, Hkv, g, S, chunk, n_splits, scale);
  return cudaGetLastError();
}

template <typename T, int GC>
cudaError_t launch_heads(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part_acc,
                         float* part_ml, int* counter, int B, int Hkv, int g,
                         int S, int D, int chunk, float scale,
                         cudaStream_t stream) {
#define K5_CASE(DD)                                                       \
  case DD:                                                                \
    return launch_typed<T, DD, GC>(q, k, v, kv_len, out, part_acc,       \
                                   part_ml, counter, B, Hkv, g, S, chunk, \
                                   scale, stream);
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

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part_acc,
                         float* part_ml, int* counter, int B, int Hkv, int g,
                         int S, int D, int chunk, int gc, float scale,
                         cudaStream_t stream) {
  switch (gc) {
    case 1:
      return launch_heads<T, 1>(q, k, v, kv_len, out, part_acc, part_ml,
                                counter, B, Hkv, g, S, D, chunk, scale,
                                stream);
    case 2:
      return launch_heads<T, 2>(q, k, v, kv_len, out, part_acc, part_ml,
                                counter, B, Hkv, g, S, D, chunk, scale,
                                stream);
    case 4:
      return launch_heads<T, 4>(q, k, v, kv_len, out, part_acc, part_ml,
                                counter, B, Hkv, g, S, D, chunk, scale,
                                stream);
    case 5:
      return launch_heads<T, 5>(q, k, v, kv_len, out, part_acc, part_ml,
                                counter, B, Hkv, g, S, D, chunk, scale,
                                stream);
    case 8:
      return launch_heads<T, 8>(q, k, v, kv_len, out, part_acc, part_ml,
                                counter, B, Hkv, g, S, D, chunk, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* out, void* part_acc,
                                       void* part_ml, void* counter, int B,
                                       int Hq, int Hkv, int S, int D,
                                       int chunk, int gc, int dtype,
                                       void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || chunk < kTile ||
      chunk % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  // scores in the log2 domain: softmax with ex2 is softmax with exp
  const float scale = (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
  const int* lens = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, k, v, lens, out, pa, pm, cnt, B, Hkv, g, S,
                              D, chunk, gc, scale, st);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, k, v, lens, out, pa, pm, cnt, B,
                                      Hkv, g, S, D, chunk, gc, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
