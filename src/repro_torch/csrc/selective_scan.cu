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
// Design (Hopper): one CTA per (CH channels d, batch row b); a channel's S
// states are spread over L lanes of one warp, P = S / L states a thread,
// kept in registers for the whole of T. Time runs in chunks of TC steps
// through a ring of kStages = 3 shared-memory stages, and the CTA is
// warp-specialised:
//   * a producer warp stages chunk c's x and dt tiles [TC, CH] and its B
//     and C rows [TC, S] in their own dtype with bulk copies (one
//     cp.async.bulk a row; completion counted in bytes on the stage's
//     `full` mbarrier) up to three chunks ahead, and writes chunk c - 3's y
//     back from its stage in 16-byte stores once the stage's `empty`
//     mbarrier says every consumer is done with it. A ragged last chunk or
//     channel block is zero-filled: dt = 0 gives exp(0) = 1 and dt * x = 0,
//     so h passes the padded steps unchanged and only y is masked. Rows
//     that are not whole 16-byte pieces (D * sizeof(T) % 16 != 0) are
//     staged and written by plain loads and stores.
//   * the CH * L consumer threads wait once a chunk on `full`, compute, and
//     arrive on `empty`: no __syncthreads, and no staging or write-back
//     instruction on their path.
//   * bfloat16 B and C are converted once a chunk into a float32 copy per
//     consumer warp, not once per state and step in each thread.
//   * exp of bfloat16 inputs is ex2.approx.ftz on the SFU: log2(e) is
//     folded into A once per thread at load, so an element is one FMUL and
//     one MUFU.EX2 (expf is ~7 instructions around the same MUFU.EX2). Its
//     error, about 2^-22 relative, sits far inside the bfloat16 tolerance
//     (2e-2 + 2e-2 |y|). Float32 inputs keep the accurate expf: with ex2 a
//     4096-step scan with dt A near 0 (h accumulates every step) missed the
//     float32 tolerance of 1e-5 x max |y| (chip_smoke.py phase 10's long
//     case on the card failed, max abs error 2.4e-5 on y), with
//     expf it holds it.
//   * the chunk's TC steps are a compile-time loop, fully unrolled, and
//     each step's y stays in a register until the chunk is done, so the
//     exps and loads of later steps issue ahead of the one serial chain,
//     the FMA on h (a store of y between steps kept them in order).
//   * y: each step's P products are summed in the thread and over the
//     channel's L lanes by xor shuffles; lane 0 stages y in its output
//     dtype.
// dt * x is multiplied in float32, as the Pallas body does (the jnp oracle
// multiplies in the input dtype first; in bfloat16 the two differ by one
// rounding of dt * x). h_final is written once at the end.
//
// The saving form (template SAVE > 0, `selective_scan_save_launch`) also
// writes h at the start of every SAVE steps, the state before step
// c * SAVE, into a float32 checkpoint tensor hs [B, ceil(T / SAVE), D, S]
// that K7's backward (csrc/selective_scan_bwd.cu) recomputes its chunks
// from: the consumer threads already hold h in registers, so it adds P
// stores a thread every SAVE steps and no arithmetic, and its y and
// h_final are those of the plain form bit for bit. The plain launch
// (SAVE = 0: serving, prefill, no grad) keeps its code.
//
// The shape K7_PROD (L, CH, TC) was chosen by a sweep on the card
// (chip_smoke.py phase 12, selective_scan_sweep_launch) at the jamba
// prefill shape (2, 1024, 8192, 16) bf16 and the invariant's
// (2, 128, 8192, 16): L = 2, CH = 64, TC = 32 (NVIDIA H100 80GB HBM3,
// 700 W, us at the prefill shape: 121.0; CH = 32 125.3, CH = 128 140.8,
// TC = 16 137.5, L = 4 139.9, L = 8 206.8). Two designs an earlier form of
// that sweep held lost and were taken out: B and C converted at each use
// instead of once a warp (138.3 us), and each lane's float32 partial of y
// staged and summed by the producer at write-back instead of the shuffles
// (209.3 us; the producer warp's sums became the bottleneck).
//
// ABI: x, dt [B, T, D], bc, cc [B, T, S] (one dtype: 0 = float32,
// 1 = bf16; contiguous), a float32 [D, S], y [B, T, D] in x's dtype,
// h float32 [B, D, S]; S = 8 (the tiny configs) or 16 (jamba); the saving
// form's hs float32 [B, ceil(T / tc), D, S], tc = 16 or 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
using scan::from_f32;
using scan::kLog2e;
using scan::load_f32;
using scan::store_f32;
using scan::to_f32;
using scan::unpack2;

constexpr int kStages = 3;

template <typename T, int S, int L, int CH, int TC>
struct Cfg {
  static constexpr int P = S / L;       // states a thread
  static constexpr int NT = CH * L;     // threads a CTA
  static constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
  // one stage: xs, dts [TC][CH] | bs, cs [TC][S] | ys [TC][CH], all in T
  static constexpr int kX = TC * CH * (int)sizeof(T);
  static constexpr int kB = TC * S * (int)sizeof(T);
  static constexpr int kY = TC * CH * (int)sizeof(T);
  static constexpr int kStage = (2 * kX + 2 * kB + kY + 127) / 128 * 128;
  // bfloat16 B and C rows of a chunk converted once a warp: [TC][S] each
  static constexpr bool kCvt = sizeof(T) == 2;
  static constexpr int kWarpBuf = kCvt ? 2 * TC * S * 4 : 0;
  static constexpr int kSmem =
      kStages * kStage + NT / 32 * kWarpBuf + 2 * kStages * 8;
  static_assert(S % L == 0, "L must divide S");
  static_assert(CH % kPer == 0, "a channel block is whole 16-byte copies");
  static_assert(NT + 32 <= 1024, "at most 1024 threads a CTA");
};

template <typename T, int S, int L, int CH, int TC, int SAVE>
__global__ void __launch_bounds__(CH * L + 32)
    scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bc, const T* __restrict__ cc,
                const float* __restrict__ a, T* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ hs, int Tn,
                int D, int vec) {
  using C = Cfg<T, S, L, CH, TC>;
  static_assert(SAVE == 0 || TC % SAVE == 0, "checkpoints on chunk steps");
  constexpr int P = C::P;
  constexpr int NT = C::NT;  // consumer threads; one producer warp above
  constexpr int kPer = C::kPer;
  // float32 inputs take the accurate expf; bfloat16 ones ex2 on folded A
  constexpr bool kEx2 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 =
      smem_u32(smem + kStages * C::kStage + NT / 32 * C::kWarpBuf);
  // full[s] at bar0 + 8 s, empty[s] at bar0 + 8 (kStages + s)
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  auto xs = [&](int s) {
    return reinterpret_cast<T*>(smem + s * C::kStage);
  };
  auto dts = [&](int s) { return xs(s) + TC * CH; };
  auto bs = [&](int s) { return dts(s) + TC * CH; };
  auto cs = [&](int s) { return bs(s) + TC * S; };
  auto yst = [&](int s) {
    return smem + s * C::kStage + 2 * C::kX + 2 * C::kB;
  };

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
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
    // ---- the producer warp: stages chunks, writes y back -----------------
    const int pl = tid - NT;
    const T zero = from_f32<T>(0.f);
    // chunk c's x, dt, B and C into its stage, then the stage's `full`
    // arrival: bulk copies of whole rows where rows are 16-byte pieces,
    // plain loads otherwise; rows past T and channels past D are zeros
    auto stage = [&](int c) {
      const int s = c % kStages;
      const int t0 = c * TC;
      const int nt = min(TC, Tn - t0);
      if (vec) {
        if (nt < TC || ncols < CH) {  // the ragged edge: zeros
          for (int i = pl; i < TC * CH; i += 32) {
            const int tt = i / CH, e = i % CH;
            if (tt >= nt || e >= ncols) xs(s)[i] = dts(s)[i] = zero;
          }
          for (int i = nt * S + pl; i < TC * S; i += 32)
            bs(s)[i] = cs(s)[i] = zero;
        }
        __syncwarp();
        const uint32_t row_bytes = ncols * sizeof(T);
        if (pl == 0)
          mbar_expect_tx(full(s), (2 * nt * row_bytes) +
                                      2 * nt * S * (uint32_t)sizeof(T));
        __syncwarp();
        for (int tt = pl; tt < nt; tt += 32) {
          const size_t off = (row + t0 + tt) * D + d0;
          bulk_load(smem_u32(xs(s) + tt * CH), x + off, row_bytes, full(s));
          bulk_load(smem_u32(dts(s) + tt * CH), dt + off, row_bytes,
                    full(s));
        }
        if (pl == 0) {
          const uint32_t bytes = nt * S * sizeof(T);
          bulk_load(smem_u32(bs(s)), bc + (row + t0) * S, bytes, full(s));
          bulk_load(smem_u32(cs(s)), cc + (row + t0) * S, bytes, full(s));
        }
      } else {
        for (int i = pl; i < TC * CH; i += 32) {
          const int tt = i / CH, e = i % CH;
          const bool ok = tt < nt && e < ncols;
          const size_t off = (row + t0 + tt) * D + d0 + e;
          xs(s)[i] = ok ? x[off] : zero;
          dts(s)[i] = ok ? dt[off] : zero;
        }
        for (int i = pl; i < TC * S; i += 32) {
          const bool ok = i < nt * S;
          bs(s)[i] = ok ? bc[(row + t0) * S + i] : zero;
          cs(s)[i] = ok ? cc[(row + t0) * S + i] : zero;
        }
        __syncwarp();
        if (pl == 0) mbar_arrive(full(s));
      }
    };
    // chunk c's y from its stage to device memory, masked to t < T, d < D
    auto write_back = [&](int c) {
      const int s = c % kStages;
      const int t0 = c * TC;
      const int nt = min(TC, Tn - t0);
      const T* ys = reinterpret_cast<const T*>(yst(s));
      if (vec) {  // 16-byte pieces of whole rows (ncols is a multiple)
        const int pieces = ncols / kPer;
        for (int i = pl; i < nt * pieces; i += 32) {
          const int tt = i / pieces, e = (i % pieces) * kPer;
          *reinterpret_cast<uint4*>(y + (row + t0 + tt) * D + d0 + e) =
              *reinterpret_cast<const uint4*>(ys + tt * CH + e);
        }
      } else {
        for (int i = pl; i < nt * CH; i += 32) {
          const int tt = i / CH, e = i % CH;
          if (e < ncols) y[(row + t0 + tt) * D + d0 + e] = ys[i];
        }
      }
    };
    for (int c = 0; c < nchunks; ++c) {
      if (c >= kStages) {  // the stage's last chunk is done: its y goes out
        mbar_wait(empty(c % kStages), ((c - kStages) / kStages) & 1);
        write_back(c - kStages);
        __syncwarp();  // every lane's reads of the stage are done
      }
      stage(c);
    }
    for (int c = max(0, nchunks - kStages); c < nchunks; ++c) {
      mbar_wait(empty(c % kStages), (c / kStages) & 1);
      write_back(c);
    }
    return;
  }

  // ---- the consumer threads: the recurrence -------------------------------
  const int ch = tid / L;    // channel within the CTA
  const int lane = tid % L;  // which slice of the states
  const int d = d0 + ch;
  const bool live = d < D;
  float* const warp_bc =
      reinterpret_cast<float*>(smem + kStages * C::kStage) +
      (tid / 32) * (C::kWarpBuf / 4);
  float a2[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // a masked channel keeps h = 0: a = 0 gives exp(0) = 1, and x, dt = 0
    a2[p] = live ? a[(size_t)d * S + lane * P + p] * (kEx2 ? kLog2e : 1.f)
                 : 0.f;
    h[p] = 0.f;
  }
  const int nck = SAVE > 0 ? (Tn + SAVE - 1) / SAVE : 0;  // checkpoints
  for (int i = 0; i < nchunks; ++i) {
    const int s = i % kStages;
    const int t0 = i * TC;
    mbar_wait(full(s), (i / kStages) & 1);
    const T* xr = xs(s);
    const T* dr = dts(s);
    if constexpr (C::kCvt) {
      // the warp's float32 copy of the chunk's B and C rows
      __syncwarp();  // its reads of the last chunk's copy are done
      const uint32_t* w = reinterpret_cast<const uint32_t*>(bs(s));
      for (int q = tid % 32; q < TC * S; q += 32)  // B, C pairs
        unpack2(w[q], warp_bc[2 * q], warp_bc[2 * q + 1]);
      __syncwarp();
    }
    // each step's y (the channel's sum) stays in a register until the
    // chunk is done: no store between the steps keeps the next step's
    // loads and exps from issuing ahead
    float yv[TC];
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if constexpr (SAVE > 0) {  // h before step t0 + tt, every SAVE steps
        if (tt % SAVE == 0 && live && t0 + tt < Tn)
          store_f32<P>(hs + (((size_t)b * nck + (t0 + tt) / SAVE) * D + d) *
                                S + lane * P, h);
      }
      const float dtv = to_f32(dr[tt * CH + ch]);
      const float dtx = dtv * to_f32(xr[tt * CH + ch]);
      float bv[P], cv[P];
      if constexpr (C::kCvt) {
        load_f32<P>(warp_bc + tt * S + lane * P, bv);
        load_f32<P>(warp_bc + TC * S + tt * S + lane * P, cv);
      } else {
        load_f32<P>(bs(s) + tt * S + lane * P, bv);
        load_f32<P>(cs(s) + tt * S + lane * P, cv);
      }
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x2 = dtv * a2[p];
        const float da = kEx2 ? ex2(x2) : expf(x2);
        h[p] = fmaf(da, h[p], dtx * bv[p]);
        acc = fmaf(h[p], cv[p], acc);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      yv[tt] = acc;
    }
    if (lane == 0) {
#pragma unroll
      for (int tt = 0; tt < TC; ++tt)
        reinterpret_cast<T*>(yst(s))[tt * CH + ch] = from_f32<T>(yv[tt]);
    }
    mbar_arrive(empty(s));
  }
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      h_out[((size_t)b * D + d) * S + lane * P + p] = h[p];
  }
}

// whether the 16-byte copies apply: every operand 16-byte aligned, and
// rows of x, dt (D values) and of B, C (S values) whole 16-byte pieces
template <typename T>
bool vec_ok(const void* x, const void* dt, const void* bc, const void* cc,
            int D, int S) {
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return al(x) && al(dt) && al(bc) && al(cc) &&
         (D * sizeof(T)) % 16 == 0 && (S * sizeof(T)) % 16 == 0;
}

template <typename T, int S, int L, int CH, int TC, int SAVE = 0>
cudaError_t launch_cfg(const void* x, const void* dt, const void* bc,
                       const void* cc, const float* a, void* y, float* h,
                       int B, int Tn, int D, cudaStream_t st,
                       float* hs = nullptr) {
  using C = Cfg<T, S, L, CH, TC>;
  auto kern = scan_kernel<T, S, L, CH, TC, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((D + CH - 1) / CH, B);
  kern<<<grid, C::NT + 32, C::kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bc), static_cast<const T*>(cc), a,
      static_cast<T*>(y), h, hs, Tn, D, vec_ok<T>(x, dt, bc, cc, D, S));
  return cudaGetLastError();
}

// the production shape: lanes a channel, channels a CTA, chunk
#define K7_PROD 2, 64, 32

template <typename T, int SAVE>
cudaError_t launch_dtype(const void* x, const void* dt, const void* bc,
                         const void* cc, const float* a, void* y, float* h,
                         float* hs, int B, int Tn, int D, int S,
                         cudaStream_t st) {
  switch (S) {
    case 8:
      return launch_cfg<T, 8, K7_PROD, SAVE>(x, dt, bc, cc, a, y, h, B, Tn,
                                             D, st, hs);
    case 16:
      return launch_cfg<T, 16, K7_PROD, SAVE>(x, dt, bc, cc, a, y, h, B, Tn,
                                              D, st, hs);
    default: return cudaErrorInvalidValue;
  }
}

template <int SAVE>
int launch_any(const void* x, const void* dt, const void* bc, const void* cc,
               const void* a, void* y, void* h, void* hs, int B, int Tn,
               int D, int S, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* hf = static_cast<float*>(h);
  float* hsf = static_cast<float*>(hs);
  if (dtype == 0)
    return (int)launch_dtype<float, SAVE>(x, dt, bc, cc, af, y, hf, hsf, B,
                                          Tn, D, S, st);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16, SAVE>(x, dt, bc, cc, af, y, hf,
                                                  hsf, B, Tn, D, S, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bc, const void* cc,
                                     const void* a, void* y, void* h, int B,
                                     int Tn, int D, int S, int dtype,
                                     void* stream) {
  return launch_any<0>(x, dt, bc, cc, a, y, h, nullptr, B, Tn, D, S, dtype,
                       stream);
}

// The saving form: K7 that also writes h at the start of every tc steps
// into hs [B, ceil(T / tc), D, S] (float32); tc = 16 or 32.
extern "C" int selective_scan_save_launch(const void* x, const void* dt,
                                          const void* bc, const void* cc,
                                          const void* a, void* y, void* h,
                                          void* hs, int B, int Tn, int D,
                                          int S, int tc, int dtype,
                                          void* stream) {
  if (tc == 16)
    return launch_any<16>(x, dt, bc, cc, a, y, h, hs, B, Tn, D, S, dtype,
                          stream);
  if (tc == 32)
    return launch_any<32>(x, dt, bc, cc, a, y, h, hs, B, Tn, D, S, dtype,
                          stream);
  return (int)cudaErrorInvalidValue;
}

// The production shape: out[0..2] = lanes, channels, chunk.
extern "C" int selective_scan_config(int* out) {
  const int prod[3] = {K7_PROD};
  for (int i = 0; i < 3; ++i) out[i] = prod[i];
  return 0;
}

// The sweep of chip_smoke.py phase 12: K7 in bfloat16 at S = 16 with
// `lanes` lanes a channel, `channels` channels a CTA and chunks of `chunk`
// steps; a shape outside the list returns cudaErrorInvalidValue.
#define K7_SWEEP(X)                                                       \
  X(2, 64, 32) X(2, 32, 32) X(2, 128, 32) X(2, 64, 16) X(4, 64, 32)       \
  X(4, 32, 32) X(4, 128, 32) X(1, 128, 32) X(8, 64, 32)

extern "C" int selective_scan_sweep_launch(const void* x, const void* dt,
                                           const void* bc, const void* cc,
                                           const void* a, void* y, void* h,
                                           int B, int Tn, int D, int lanes,
                                           int channels, int chunk,
                                           void* stream) {
  if (B < 1 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K7_CASE(l, c, t)                                                  \
  if (lanes == l && channels == c && chunk == t)                          \
    return (int)launch_cfg<__nv_bfloat16, 16, l, c, t>(                   \
        x, dt, bc, cc, static_cast<const float*>(a), y,                   \
        static_cast<float*>(h), B, Tn, D, st);
  K7_SWEEP(K7_CASE)
#undef K7_CASE
  return (int)cudaErrorInvalidValue;
}

// The sweep's shapes: writes up to `cap` rows of (lanes, channels, chunk)
// to out and returns how many there are.
extern "C" int selective_scan_sweep_configs(int* out, int cap) {
  int n = 0;
#define K7_ROW(l, c, t)                                           \
  if (n < cap) {                                                  \
    const int row[3] = {l, c, t};                                 \
    for (int i = 0; i < 3; ++i) out[3 * n + i] = row[i];          \
  }                                                               \
  ++n;
  K7_SWEEP(K7_ROW)
#undef K7_ROW
  return n;
}
