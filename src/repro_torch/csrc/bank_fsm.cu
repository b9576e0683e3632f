// K1 and K2: the split bank-FSM kernels of the "split" backend.
//
// Replaces (TPU, Pallas):
//   K1 src/repro/kernels/bank_fsm/bank_fsm.py:332 bank_fsm_step_pallas
//      (body _kernel, _fsm_combinational, _resolve_rp, _tier_row)
//   K2 src/repro/kernels/bank_fsm/bank_fsm.py:300 bank_event_bound_pallas
//      (body _event_bound_kernel, _event_bound_combinational)
//
// What bounds them on an H100: nothing on the card. At the paper's Table-1
// size (B = 32 banks) K1 reads ~2.2 KB and writes ~1.7 KB and does a few
// hundred integer operations per bank, a few nanoseconds of HBM time, so a
// launch costs its fixed launch latency (microseconds) and the simulator's
// host loop, which launches one kernel per executed cycle, is the limit.
// Design: one thread per bank in blocks of 256 (ceil(B/256) blocks), no
// shared memory and no synchronisation; each thread resolves its schedule
// segment from `bounds` and its tier row at the static DRAM/CXL split, reads
// its column of the packed rows and writes its column out. `cycle` stays a
// device int32[1,1] so the cycle loop never copies it from the host. The
// launch floor is removed by batching cycles (CUDA graphs or a persistent
// kernel), not by tuning this body.
//
// ABI (int32, B banks, S segments, T tiers, NP = 17):
//   K1: state[10,B] inputs[3,B] pop[4,B] rp[T*S,NP] bounds[S,1] cycle[1,1]
//       -> new_state[10,B] flags[3,B] (want_pop, rw_done, completed)
//   K2: state[10,B] rp bounds cycle -> bound[1,B]
#include <cuda_runtime.h>

#include "bank_fsm.cuh"

static constexpr int kThreads = 256;

__global__ void bank_fsm_step_kernel(
    const int* __restrict__ state, const int* __restrict__ inputs,
    const int* __restrict__ pop, const int* __restrict__ rp,
    const int* __restrict__ bounds, const int* __restrict__ cycle_p,
    int* __restrict__ new_state, int* __restrict__ flags, int B, int S,
    int T, int tier_split, int row_shift) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int cycle = cycle_p[0];
  const int tier = (T > 1 && b >= tier_split) ? 1 : 0;
  const Rp p = resolve_rp(rp, bounds, S, tier, cycle);
  const BankRegs s = load_regs(state, B, b);
  BankRegs o;
  bool want_pop, rw_done, completed;
  fsm_edge(p, cycle, row_shift, s, inputs[0 * B + b] == 1,
           inputs[1 * B + b] == 1, inputs[2 * B + b] == 1, pop[0 * B + b],
           pop[1 * B + b], pop[2 * B + b], pop[3 * B + b], o, want_pop,
           rw_done, completed);
  store_regs(new_state, B, b, o);
  flags[0 * B + b] = want_pop;
  flags[1 * B + b] = rw_done;
  flags[2 * B + b] = completed;
}

__global__ void bank_event_bound_kernel(
    const int* __restrict__ state, const int* __restrict__ rp,
    const int* __restrict__ bounds, const int* __restrict__ cycle_p,
    int* __restrict__ out, int B, int S, int T, int tier_split) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int cycle = cycle_p[0];
  const int tier = (T > 1 && b >= tier_split) ? 1 : 0;
  const Rp p = resolve_rp(rp, bounds, S, tier, cycle);
  out[b] = event_bound(p, cycle, state[0 * B + b], state[1 * B + b],
                       state[2 * B + b], state[3 * B + b]);
}

extern "C" int bank_fsm_step_launch(const void* state, const void* inputs,
                                    const void* pop, const void* rp,
                                    const void* bounds, const void* cycle,
                                    void* new_state, void* flags, int B,
                                    int S, int T, int tier_split,
                                    int row_shift, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  bank_fsm_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)state, (const int*)inputs, (const int*)pop,
      (const int*)rp, (const int*)bounds, (const int*)cycle, (int*)new_state,
      (int*)flags, B, S, T, tier_split, row_shift);
  return (int)cudaGetLastError();
}

extern "C" int bank_event_bound_launch(const void* state, const void* rp,
                                       const void* bounds, const void* cycle,
                                       void* out, int B, int S, int T,
                                       int tier_split, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  bank_event_bound_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)state, (const int*)rp, (const int*)bounds,
      (const int*)cycle, (int*)out, B, S, T, tier_split);
  return (int)cudaGetLastError();
}
