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
// design computes each exp twice (the chunk's recompute, the reverse
// step): 128.4 us on the SFUs.
//
// Design (Hopper), K7's forward run in reverse:
//   * h at the start of every chunk of TC steps comes from K7's forward:
//     its saving form (csrc/selective_scan.cu, SAVE = TC) writes the
//     float32 checkpoints hs [B, ceil(T / TC), D, S] while it runs, so
//     this kernel has no forward pass of its own.
//   * one CTA per (CH channels, batch row); a channel's S states are
//     spread over L lanes of a warp, P = S / L states a thread, as in K7's
//     forward. Chunks run from the last to the first through a ring of
//     kStages = 2 shared-memory stages, and the CTA is warp-specialised:
//   * a producer warp stages chunk c with six copies: x, dt and dy one 3-D
//     TMA tile [TC, CH] each (rows past T and channels past D read as
//     zeros), B and C [TC, S] and the checkpoint block [CH, S] one bulk
//     copy each (their ragged edge zeroed by the producer), completion
//     counted in bytes on the stage's `full` mbarrier. Once the stage's
//     `empty` mbarrier says every consumer is done with it, it stores the
//     chunk's dx and ddt tiles with two TMA tile stores (clipped at T and
//     D) and sums the consumer warps' dB and dC rows of the chunk (below)
//     into the channel block's float32 partial row, four columns a lane
//     at a time. Rows that are not whole 16-byte pieces are staged and
//     written by plain loads and stores. Padding is harmless: dt = x = dy
//     = B = C = 0 leaves h and the carried G unchanged (exp(0) = 1) and
//     adds 0 to every sum; a = 0 and a zero checkpoint keep a masked
//     channel at 0.
//   * the CH * L consumer threads wait once a chunk on `full`, compute and
//     arrive on `empty`: no __syncthreads, no staging or write-back
//     instruction on their path. bf16 B and C are converted once a chunk
//     into a float32 copy per consumer warp. Each thread recomputes its P
//     states through the chunk from the checkpoint, h_{t0-1} ..
//     h_{t0+TC-1} kept in registers (TC x P floats), then steps the
//     reverse recurrence through them, each step's inputs loaded one step
//     ahead (a shared-memory store may alias a later load, so a load
//     issued after a step's stores waits for its shuffles). At most two
//     exps a (b, t, d, s): one in the recompute, one in the reverse step.
//     bf16 takes ex2.approx.ftz on the SFU with log2(e) folded into A once
//     a thread (one FMUL and one MUFU.EX2 an exp, as K7's forward);
//     float32 keeps the accurate expf (K7's forward measured that ex2
//     misses float32's tolerance on a 4096-step scan with dt A near 0).
//     h_{t-1} e_t g_t is taken as G_t h_{t-1}, one product.
//   * the sums, each in a fixed order: du = sum_s g B and dd = sum_s g h e
//     A over a thread's P states by fmaf from 0, then (du, du x + dd)
//     reduce-scattered over the channel's L lanes by xor shuffles (dx = du
//     dt on lane 0, ddt on lane L / 2); dB and dC's per-channel terms (2P
//     a thread a step) over the warp's 32 / L channels by an xor
//     reduce-scatter (each level sends half of the values to the partner
//     and keeps the other half, so the warp's 2S sums end one a lane: 2P -
//     1 shuffles a step, not 2P log2(32 / L)); each warp's row of a step
//     goes to the stage, and the producer sums the W = CH L / 32 rows by a
//     pairwise tree. dA: per-thread accumulators over t, then over B.
//   * a second kernel sums the partial rows over the channel blocks (dB,
//     dC, cast to the input dtype) and the per-row dA [B, D, S] over B
//     (float32), each in a fixed order.
// No atomics: two launches on the same inputs give the same bits. dt * x
// is multiplied in float32, as K7's forward does.
//
// Every time below: NVIDIA H100 80GB HBM3 at 700 W, us a launch at jamba's
// training shape (2, 1024, 8192, 16) bf16. The shape K7_BWD_PROD (L, CH,
// TC) was chosen by a sweep there (chip_smoke.py phase 19(a),
// selective_scan_bwd_sweep_launch): L = 4, CH = 64, TC = 16, 410.2; CH =
// 32 424.2; L = 8: CH = 64 468.3, CH = 32 582.3, TC = 32 with CH = 32
// 629.2 and CH = 16 601.8.
// L = 2 and TC = 32 at L = 4 hold 136 registers of h and spill; a CTA of
// nine warps (eight consumers and the producer) may hold at most 168
// registers a thread (three of its warps share an SM sub-partition), so
// 154 registers leave one CTA, eight consumer warps, an SM. With one part
// taken out at a time (chip_smoke.py --k7-bwd-parts; 407.4 whole): the
// consumers' arithmetic 153.5 (and the write-back too 102.9), the reverse
// pass 196.8, its exps 402.4, the shuffle sums 273.0; a third stage
// 407.6. Forms measured and taken out: x, dt and dy staged one 128-byte
// row a bulk copy (51 copies a chunk, 596.3; 403.7 without the
// consumers' arithmetic: the producer bound it), dx and ddt written back
// by the producer's loads and stores (480.3), steps reduce-scattered in
// pairs (422.7), and each step's sums held in registers to the chunk's
// end (past the 168-register cap: spilled).
//
// ABI: x, dt, dy [B, T, D], bc, cc [B, T, S] (one dtype: 0 = float32,
// 1 = bf16; contiguous); a float32 [D, S]; dh float32 [B, D, S] or null;
// hs float32 [B, ceil(T / tc), D, S], the saving forward's checkpoints;
// scratch float32: part [B, ceil(D / ch), T, 2 S], pa [B, D, S]; outputs
// dx, ddt [B, T, D], dbc, dcc [B, T, S] in the input dtype, da float32
// [D, S]. (ch, tc) must be the compiled production (CH, TC); S = 8 or 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"
#include "scan_common.cuh"

namespace {

using hopper::bulk_load;
using hopper::ex2;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::bulk_commit;
using hopper::bulk_wait;
using hopper::bulk_wait_read;
using hopper::fence_proxy_async;
using hopper::tma_load_3d;
using hopper::tma_store_3d;
using scan::from_f32;
using scan::kLn2;
using scan::kLog2e;
using scan::load_f32;
using scan::store_f32;
using scan::to_f32;
using scan::unpack2;

constexpr int kStages = 2;

constexpr int align_up(int n, int a) { return (n + a - 1) / a * a; }

template <typename T, int S, int L, int CH, int TC>
struct BwdCfg {
  static constexpr int P = S / L;    // states a thread
  static constexpr int NT = CH * L;  // consumer threads a CTA
  static constexpr int W = NT / 32;  // consumer warps
  static constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
  // one stage: xs, dts, dys [TC][CH] | bs, cs [TC][S] (T) | h0 [CH][S]
  // (float32) | dxs, ddts [TC][CH] (T) | red [TC][W][2 S] (float32)
  static constexpr int kX = TC * CH * (int)sizeof(T);
  static constexpr int kB = TC * S * (int)sizeof(T);
  static constexpr int oH = align_up(3 * kX + 2 * kB, 128);
  static constexpr int oDx = align_up(oH + CH * S * 4, 128);
  static constexpr int oRed = align_up(oDx + 2 * kX, 128);
  static constexpr int kStage = align_up(oRed + TC * W * 2 * S * 4, 128);
  // bfloat16 B and C rows of a chunk converted once a warp: [TC][S] each
  static constexpr bool kCvt = sizeof(T) == 2;
  static constexpr int kWarpBuf = kCvt ? 2 * TC * S * 4 : 0;
  static constexpr int kSmem = kStages * kStage + W * kWarpBuf +
                               2 * kStages * 8;
  static_assert(S % L == 0 && 32 % L == 0 && L >= 2, "L lanes a channel");
  static_assert(NT % 32 == 0 && (W & (W - 1)) == 0,
                "a power of two of whole consumer warps");
  static_assert(CH % kPer == 0, "a channel block is whole 16-byte copies");
  static_assert(NT + 32 <= 1024, "at most 1024 threads a CTA");
  static_assert(kSmem <= 232448, "at most 227 KB of shared memory a CTA");
};

// v[0 .. N) summed pairwise, the second half onto the first, into v[0]
template <int N, int M>
__device__ __forceinline__ void tree_sum(float (&v)[M]) {
  if constexpr (N > 1) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) v[k] += v[k + N / 2];
    tree_sum<N / 2>(v);
  }
}

// The reduce-scatter of a thread's N values over the lanes lane ^ OFF for
// OFF = OFF0, OFF0 / 2, .., LO: at each level the lane keeps half of its
// values (the upper half where its bit OFF is set), adds the partner's of
// the same index, and sends the other half; once one value is left, the
// levels below add the partner's value (lanes pair up). Each sum halves
// its lanes: (((v_0 + v_4) + (v_2 + v_6)) + ((v_1 + v_5) + (v_3 + v_7))).
template <int N, int LO, int OFF, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int lane) {
  if constexpr (OFF >= LO) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<H, LO, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, LO, OFF / 2>(v, lane);
    }
  }
}

// one reverse step's inputs of a thread, as float32
template <int P>
struct StepIn {
  float dt, x, dy, b[P], c[P];
};

template <typename T, int P, int CH, int S>
__device__ __forceinline__ void load_step(StepIn<P>& in, const T* dr,
                                          const T* xr, const T* yr,
                                          const float* bf, const float* cf,
                                          int tt, int ch, int sl) {
  in.dt = to_f32(dr[tt * CH + ch]);
  in.x = to_f32(xr[tt * CH + ch]);
  in.dy = to_f32(yr[tt * CH + ch]);
  load_f32<P>(bf + tt * S + sl * P, in.b);
  load_f32<P>(cf + tt * S + sl * P, in.c);
}

// minBlocks = 1: without it ptxas capped the P = 2 instances at 72
// registers (three CTAs an SM) and spilled
template <typename T, int S, int L, int CH, int TC>
__global__ void __launch_bounds__(CH * L + 32, 1)
    scan_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dt,
                    const __grid_constant__ CUtensorMap map_dy,
                    const __grid_constant__ CUtensorMap map_dx,
                    const __grid_constant__ CUtensorMap map_ddt,
                    const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bc, const T* __restrict__ cc,
                    const float* __restrict__ a, const T* __restrict__ dy,
                    const float* __restrict__ dh,
                    const float* __restrict__ hs, float* __restrict__ part,
                    float* __restrict__ pa, T* __restrict__ dx,
                    T* __restrict__ ddt, int Tn, int D, int vec) {
  using C = BwdCfg<T, S, L, CH, TC>;
  constexpr int P = C::P;
  constexpr int NT = C::NT;  // consumer threads; one producer warp above
  constexpr int W = C::W;
  // float32 inputs take the accurate expf; bfloat16 ones ex2 on folded A
  constexpr bool kEx2 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 =
      smem_u32(smem + kStages * C::kStage + W * C::kWarpBuf);
  // full[s] at bar0 + 8 s, empty[s] at bar0 + 8 (kStages + s)
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  auto xs = [&](int s) {
    return reinterpret_cast<T*>(smem + s * C::kStage);
  };
  auto dts = [&](int s) { return xs(s) + TC * CH; };
  auto dys = [&](int s) { return dts(s) + TC * CH; };
  auto bs = [&](int s) { return dys(s) + TC * CH; };
  auto cs = [&](int s) { return bs(s) + TC * S; };
  auto h0s = [&](int s) {
    return reinterpret_cast<float*>(smem + s * C::kStage + C::oH);
  };
  auto dxs = [&](int s) {
    return reinterpret_cast<T*>(smem + s * C::kStage + C::oDx);
  };
  auto ddts = [&](int s) { return dxs(s) + TC * CH; };
  auto reds = [&](int s) {
    return reinterpret_cast<float*>(smem + s * C::kStage + C::oRed);
  };

  const int tid = threadIdx.x;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int b = blockIdx.y;
  const int d0 = blk * CH;
  const int ncols = min(CH, D - d0);  // live channels of the block
  const size_t row = (size_t)b * Tn;  // first (b, t) row
  const int nchunks = (Tn + TC - 1) / TC;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NT);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NT) {
    // ---- the producer warp: stages chunks last to first, writes back ----
    const int pl = tid - NT;
    const T zero = from_f32<T>(0.f);
    // iteration i is chunk nchunks - 1 - i; its x, dt, dy, B, C and
    // checkpoint into its stage, then the stage's `full` arrival
    auto stage = [&](int i) {
      const int s = i % kStages;
      const int c = nchunks - 1 - i;
      const int t0 = c * TC;
      const int nt = min(TC, Tn - t0);
      const float* hsrc = hs + (((size_t)b * nchunks + c) * D + d0) * S;
      if (vec) {
        // x, dt and dy one TMA tile [TC, CH] each (rows past T and
        // channels past D read as zeros); B, C and the checkpoint one bulk
        // copy each, their ragged edge zeroed here
        if (nt < TC || ncols < CH) {
          for (int k = nt * S + pl; k < TC * S; k += 32)
            bs(s)[k] = cs(s)[k] = zero;
          for (int k = ncols * S + pl; k < CH * S; k += 32) h0s(s)[k] = 0.f;
        }
        __syncwarp();
        if (pl == 0) {
          const uint32_t bytes = nt * S * sizeof(T);
          mbar_expect_tx(full(s), 3 * C::kX + 2 * bytes + ncols * S * 4);
          tma_load_3d(smem_u32(xs(s)), &map_x, full(s), d0, t0, b);
          tma_load_3d(smem_u32(dts(s)), &map_dt, full(s), d0, t0, b);
          tma_load_3d(smem_u32(dys(s)), &map_dy, full(s), d0, t0, b);
          bulk_load(smem_u32(bs(s)), bc + (row + t0) * S, bytes, full(s));
          bulk_load(smem_u32(cs(s)), cc + (row + t0) * S, bytes, full(s));
          bulk_load(smem_u32(h0s(s)), hsrc, ncols * S * 4, full(s));
        }
      } else {
        for (int k = pl; k < TC * CH; k += 32) {
          const int tt = k / CH, e = k % CH;
          const bool ok = tt < nt && e < ncols;
          const size_t off = (row + t0 + tt) * D + d0 + e;
          xs(s)[k] = ok ? x[off] : zero;
          dts(s)[k] = ok ? dt[off] : zero;
          dys(s)[k] = ok ? dy[off] : zero;
        }
        for (int k = pl; k < TC * S; k += 32) {
          const bool ok = k < nt * S;
          bs(s)[k] = ok ? bc[(row + t0) * S + k] : zero;
          cs(s)[k] = ok ? cc[(row + t0) * S + k] : zero;
        }
        for (int k = pl; k < CH * S; k += 32)
          h0s(s)[k] = k < ncols * S ? hsrc[k] : 0.f;
        __syncwarp();
        if (pl == 0) mbar_arrive(full(s));
      }
    };
    // iteration i's dx and ddt from its stage to device memory (t < T,
    // d < D; one TMA tile store each where the tiles are TMA's), and its
    // warps' dB and dC rows summed into the block's partial, 4 columns a
    // lane at a time
    auto write_back = [&](int i) {
      const int s = i % kStages;
      const int c = nchunks - 1 - i;
      const int t0 = c * TC;
      const int nt = min(TC, Tn - t0);
      if (vec) {
        if (pl == 0) {
          tma_store_3d(&map_dx, smem_u32(dxs(s)), d0, t0, b);
          tma_store_3d(&map_ddt, smem_u32(ddts(s)), d0, t0, b);
          bulk_commit();
        }
      } else {
        for (int k = pl; k < nt * CH; k += 32) {
          const int tt = k / CH, e = k % CH;
          if (e < ncols) {
            dx[(row + t0 + tt) * D + d0 + e] = dxs(s)[k];
            ddt[(row + t0 + tt) * D + d0 + e] = ddts(s)[k];
          }
        }
      }
      const float4* red = reinterpret_cast<const float4*>(reds(s));
      constexpr int kQ = 2 * S / 4;  // float4 columns of a row
      for (int o = pl; o < nt * kQ; o += 32) {
        const int tt = o / kQ, j = o % kQ;
        float v[4][W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float4 q = red[(tt * W + w) * kQ + j];
          v[0][w] = q.x;
          v[1][w] = q.y;
          v[2][w] = q.z;
          v[3][w] = q.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) tree_sum<W>(v[k]);
        reinterpret_cast<float4*>(
            part + (((size_t)b * nblk + blk) * Tn + t0 + tt) * 2 * S)[j] =
            make_float4(v[0][0], v[1][0], v[2][0], v[3][0]);
      }
      if (vec && pl == 0) bulk_wait_read();  // the stage may be refilled
    };
    for (int i = 0; i < nchunks; ++i) {
      if (i >= kStages) {  // the stage's last chunk is done: write it back
        mbar_wait(empty(i % kStages), ((i - kStages) / kStages) & 1);
        write_back(i - kStages);
        __syncwarp();  // every lane's reads of the stage are done
      }
      stage(i);
    }
    for (int i = max(0, nchunks - kStages); i < nchunks; ++i) {
      mbar_wait(empty(i % kStages), (i / kStages) & 1);
      write_back(i);
    }
    if (vec && pl == 0) bulk_wait();
    return;
  }

  // ---- the consumer threads: recompute, then the reverse recurrence ------
  const int ch = tid / L;       // channel within the CTA
  const int sl = tid % L;       // which slice of the states
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d = d0 + ch;
  const bool live = d < D;
  float* const warp_bc =
      reinterpret_cast<float*>(smem + kStages * C::kStage) +
      warp * (C::kWarpBuf / 4);
  // where this lane's dB / dC sum of a step ends after the reduce-scatter
  // over the warp's channels (lanes lane ^ L .. lane ^ 16): the value of
  // index j of the 2P (dB of the thread's P states, then dC's), or none
  // where the warp holds fewer than 32 sums (S = 8: lanes pair up)
  int slot = 0;
  bool owner = true;
  {
    int n = 2 * P;
    for (int off = 16; off >= L; off >>= 1) {
      const bool up = lane & off;
      if (n > 1) {
        n /= 2;
        slot += up ? n : 0;
      } else {
        owner = owner && !up;
      }
    }
    slot = slot < P ? sl * P + slot : S + sl * P + slot - P;
  }
  float a2[P], G[P], dA[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a2[p] = live ? a[(size_t)d * S + sl * P + p] * (kEx2 ? kLog2e : 1.f)
                 : 0.f;
    G[p] = (live && dh != nullptr) ? dh[((size_t)b * D + d) * S + sl * P + p]
                                   : 0.f;
    dA[p] = 0.f;
  }
  for (int i = 0; i < nchunks; ++i) {
    const int s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    const T* xr = xs(s);
    const T* dr = dts(s);
    const T* yr = dys(s);
    const float* bf;
    const float* cf;
    if constexpr (C::kCvt) {
      // the warp's float32 copy of the chunk's B and C rows
      __syncwarp();  // its reads of the last chunk's copy are done
      const uint32_t* w = reinterpret_cast<const uint32_t*>(bs(s));
      for (int q = lane; q < TC * S; q += 32)  // B, C pairs
        unpack2(w[q], warp_bc[2 * q], warp_bc[2 * q + 1]);
      __syncwarp();
      bf = warp_bc;
      cf = warp_bc + TC * S;
    } else {
      bf = reinterpret_cast<const float*>(bs(s));
      cf = reinterpret_cast<const float*>(cs(s));
    }
    // h_{t0 - 1 + k} for k = 0 .. TC: the checkpoint, then the chunk
    float hh[TC + 1][P];
    load_f32<P>(h0s(s) + ch * S + sl * P, hh[0]);
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const float dtv = to_f32(dr[tt * CH + ch]);
      const float u = dtv * to_f32(xr[tt * CH + ch]);
      float bv[P];
      load_f32<P>(bf + tt * S + sl * P, bv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x2 = dtv * a2[p];
        const float e = kEx2 ? ex2(x2) : expf(x2);
        hh[tt + 1][p] = fmaf(e, hh[tt][p], u * bv[p]);
      }
    }
    // the compiler may not carry the recompute's exps into the reverse
    // pass: kept, they cost TC x P registers
    asm volatile("" ::: "memory");
    float* const red = reds(s) + warp * 2 * S;
    T* const go = sl == 0 ? dxs(s) : ddts(s);
    // a step's inputs are loaded one step ahead, before this step's
    // stores: a shared-memory store may alias a later load, so loads
    // issued after it wait for its value, the step's shuffles
    StepIn<P> nxt;
    load_step<T, P, CH, S>(nxt, dr, xr, yr, bf, cf, TC - 1, ch, sl);
#pragma unroll
    for (int tt = TC - 1; tt >= 0; --tt) {
      const StepIn<P> in = nxt;
      if (tt > 0)
        load_step<T, P, CH, S>(nxt, dr, xr, yr, bf, cf, tt - 1, ch, sl);
      const float u = in.dt * in.x;
      float v[2 * P];
      float du = 0.f, dd = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x2 = in.dt * a2[p];
        const float e = kEx2 ? ex2(x2) : expf(x2);
        const float g = fmaf(in.dy, in.c[p], G[p]);
        G[p] = e * g;
        const float ge = G[p] * hh[tt][p];  // dL/d(dt A) of this state
        du = fmaf(g, in.b[p], du);
        dd = fmaf(ge, a2[p], dd);
        dA[p] = fmaf(ge, in.dt, dA[p]);
        v[p] = g * u;
        v[P + p] = in.dy * hh[tt + 1][p];
      }
      if constexpr (kEx2) dd *= kLn2;  // a2 = a log2(e)
      // dx's and ddt's terms of this lane's states, reduce-scattered over
      // the channel's lanes: lane sl = 0 ends with sum du, sl = L / 2 with
      // sum (du x + dd)
      float w[2] = {du, fmaf(du, in.x, dd)};
      reduce_scatter<2, 1, L / 2>(w, lane);
      reduce_scatter<2 * P, L, 16>(v, lane);  // over the warp's channels
      if (owner) red[tt * W * 2 * S + slot] = v[0];
      if (sl % (L / 2) == 0)
        go[tt * CH + ch] = from_f32<T>(sl == 0 ? w[0] * in.dt : w[0]);
    }
    fence_proxy_async();  // dx and ddt leave the stage by TMA stores
    mbar_arrive(empty(s));
  }
  if (live) store_f32<P>(pa + ((size_t)b * D + d) * S + sl * P, dA);
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

// whether the bulk copies apply: every staged or written operand 16-byte
// aligned, and rows of x, dt, dy (D values) and of B, C (S values) whole
// 16-byte pieces
template <typename T>
bool vec_ok(std::initializer_list<const void*> ptrs, int D, int S) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return (D * sizeof(T)) % 16 == 0 && (S * sizeof(T)) % 16 == 0;
}

template <typename T, int S, int L, int CH, int TC>
cudaError_t launch_cfg(const void* x, const void* dt, const void* bc,
                       const void* cc, const float* a, const void* dy,
                       const float* dh, const float* hs, float* part,
                       float* pa, void* dx, void* ddt, void* dbc, void* dcc,
                       float* da, int B, int Tn, int D, cudaStream_t st) {
  using C = BwdCfg<T, S, L, CH, TC>;
  auto kern = scan_bwd_kernel<T, S, L, CH, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int nblk = (D + CH - 1) / CH;
  int vec = vec_ok<T>({x, dt, dy, bc, cc, hs, dx, ddt}, D, S);
  CUtensorMap maps[5] = {};
  const void* tiled[5] = {x, dt, dy, dx, ddt};
  for (int i = 0; i < 5 && vec; ++i)
    vec = hopper::encode_rows(&maps[i], tiled[i], sizeof(T) == 2, B, Tn, D,
                              TC, CH);
  kern<<<dim3(nblk, B), C::NT + 32, C::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const T*>(x),
      static_cast<const T*>(dt), static_cast<const T*>(bc),
      static_cast<const T*>(cc), a,
      static_cast<const T*>(dy), dh, hs, part, pa, static_cast<T*>(dx),
      static_cast<T*>(ddt), Tn, D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * Tn * 2 * S + (size_t)D * S;
  scan_bwd_sum_kernel<T, S><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, pa, static_cast<T*>(dbc), static_cast<T*>(dcc), da, B, Tn, D,
      nblk);
  return cudaGetLastError();
}

// the production shape: lanes a channel, channels a CTA, steps a chunk
#define K7_BWD_PROD 4, 64, 16
constexpr int kProd[3] = {K7_BWD_PROD};

template <typename T>
cudaError_t launch_dtype(const void* x, const void* dt, const void* bc,
                         const void* cc, const float* a, const void* dy,
                         const float* dh, const float* hs, float* part,
                         float* pa, void* dx, void* ddt, void* dbc, void* dcc,
                         float* da, int B, int Tn, int D, int S,
                         cudaStream_t st) {
  switch (S) {
    case 8:
      return launch_cfg<T, 8, K7_BWD_PROD>(x, dt, bc, cc, a, dy, dh, hs, part,
                                           pa, dx, ddt, dbc, dcc, da, B, Tn,
                                           D, st);
    case 16:
      return launch_cfg<T, 16, K7_BWD_PROD>(x, dt, bc, cc, a, dy, dh, hs,
                                            part, pa, dx, ddt, dbc, dcc, da,
                                            B, Tn, D, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* bc, const void* cc,
    const void* a, const void* dy, const void* dh, const void* hs,
    void* part, void* pa, void* dx, void* ddt, void* dbc, void* dcc,
    void* da, int B, int Tn, int D, int S, int ch, int tc, int dtype,
    void* stream) {
  if (B < 1 || Tn < 1 || D < 1 || ch != kProd[1] || tc != kProd[2])
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dhf = static_cast<const float*>(dh);
  const float* hsf = static_cast<const float*>(hs);
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

// The production shape: out[0..2] = lanes, channels, steps a chunk.
extern "C" int selective_scan_bwd_config(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = kProd[i];
  return 0;
}

// The sweep of chip_smoke.py phase 19(a): K7's backward in bfloat16 at
// S = 16 with `lanes` lanes a channel, `channels` channels a CTA and
// chunks of `chunk` steps (hs from the saving forward at that stride); a
// shape outside the list returns cudaErrorInvalidValue.
#define K7_BWD_SWEEP(X)                                                   \
  X(4, 64, 16) X(4, 32, 16) X(8, 32, 16) X(8, 64, 16) X(8, 32, 32)       \
  X(8, 16, 32)

extern "C" int selective_scan_bwd_sweep_launch(
    const void* x, const void* dt, const void* bc, const void* cc,
    const void* a, const void* dy, const void* dh, const void* hs,
    void* part, void* pa, void* dx, void* ddt, void* dbc, void* dcc,
    void* da, int B, int Tn, int D, int lanes, int channels, int chunk,
    void* stream) {
  if (B < 1 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K7_BWD_CASE(l, c, t)                                              \
  if (lanes == l && channels == c && chunk == t)                          \
    return (int)launch_cfg<__nv_bfloat16, 16, l, c, t>(                   \
        x, dt, bc, cc, static_cast<const float*>(a), dy,                  \
        static_cast<const float*>(dh), static_cast<const float*>(hs),     \
        static_cast<float*>(part), static_cast<float*>(pa), dx, ddt, dbc, \
        dcc, static_cast<float*>(da), B, Tn, D, st);
  K7_BWD_SWEEP(K7_BWD_CASE)
#undef K7_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// The sweep's shapes: writes up to `cap` rows of (lanes, channels, chunk)
// to out and returns how many there are.
extern "C" int selective_scan_bwd_sweep_configs(int* out, int cap) {
  int n = 0;
#define K7_BWD_ROW(l, c, t)                                       \
  if (n < cap) {                                                  \
    const int row[3] = {l, c, t};                                 \
    for (int i = 0; i < 3; ++i) out[3 * n + i] = row[i];          \
  }                                                               \
  ++n;
  K7_BWD_SWEEP(K7_BWD_ROW)
#undef K7_BWD_ROW
  return n;
}
