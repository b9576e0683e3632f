// K3: the fused hot-loop kernel, in two entry points over one cycle body.
//
// Replaces (TPU, Pallas): src/repro/kernels/bank_fsm/fused.py:397
// fused_step_pallas (body _fused_kernel, _resolve_rp_lanes, _compute_cmds,
// _legal_at; it calls the shared _fsm_combinational and
// _event_bound_combinational, here fsm_edge() and event_bound() of
// bank_fsm.cuh, the same functions K1 and K2 call).
//
// cycle_core() is phases 3-7 of one executed cycle for one lane: command
// bids and timing legality, the rotating-priority command arbiter per
// channel, the rank timing-window update, the response arbiter and
// respQueue push, the FSM edge, the bank-queue pop bookkeeping, the
// flow-through response ack, and the event-horizon bound at cycle + 1 that
// gives the skip `delta`. A lane is one CTA of B / k threads, k = 1 up to
// B = LANE_THREADS (1024) banks and k = B / 1024 above (B is a power of
// two, so k is: 2, 4, 8 ...). Bank b lives in thread b / k as slot b % k,
// so a channel's banks stay on consecutive threads; every per-bank value
// is a k-long per-thread array (`Slots`): at k = 1 a register, above in a
// scratch in device memory that the host allocates (K3_SCRATCH_PER_BANK
// bytes a bank), since a 1024-thread CTA leaves a thread 64 registers and
// local arrays would cap k. Every cross-bank step reduces over the
// thread's own slots first, then over the CTA (warp shuffles when the
// group of threads fits a warp, shared memory above):
//   * the command arbiter is a min-reduction of the rotated priority key
//     over the channel's banks_per_channel banks; the key is unique within
//     a channel, so the minimum names the one winner, which sends its
//     command and rank (k = 1: a broadcast from its thread; k > 1: the
//     same min-reduction of (rank << 3 | cmd) over the winner alone). A
//     channel narrower than k lies inside one thread and reduces there;
//   * record_issue is rank-uniform: every bank updates its copy of its
//     rank's timing registers when the winner's rank is its own, and the
//     tFAW slot replaced is the first minimum (argmin's tie order);
//   * the response arbiter (its winner broadcasts the request) and the
//     event bound reduce over the lane, so every lane-uniform result
//     (delta, the response pointers) is known to every thread.
// `%` of possibly negative values is a floor-mod and sums wrap (see
// bank_fsm.cuh), matching the reference's int32 jnp semantics.
//
// fused_step_launch (fused_step_kernel): ONE executed cycle per launch for
// L lanes, the front end, record scatters and counters left to the caller.
//   in : bank[23, L*B] = state 0-9 | qhead, qcount 10-11 | last_act,
//        act_win0..3, last_rd, last_wr 12-18 | pop 19-22
//        resp[L*Qr, 4], rp[L*T*S, NP], bounds[L*S, 1],
//        scal[L, 8+C] = cycle, arrival_rel, horizon, req_count, resp_head,
//        resp_count, resp_limit, resp_rr, cmd_rr[C]
//        (cycle and horizon are read from lane 0: the shared batch clock)
//   out: bank[22, L*B] = state 0-9 | want_pop, rw_done, completed 10-12 |
//        qhead2, qcount2 13-14 | timing 15-21
//        resp[L*Qr, 4], scal[L, 9+2C] = delta, resp_rr2, resp_head2,
//        resp_count2, ack, fitem[4], cmd_rr2[C], issued_cmd[C]
//
// fused_run_launch (fused_run_kernel): the persistent event-horizon loop of
// one lane. One launch runs executed steps from the clock `t` until
// `t_stop` or `budget` steps, each step the body of the reference's
// _run_skip_core (src/repro/core/engine.py:326-342) in the port's eager
// order: (1) trace admission and dispatch to a bank queue (thread 0; the
// address decode is addr_decode.cuh's, shared with K4), (2) the FR-FCFS
// row-hit promotion (each bank its own queue), (3) cycle_core(), (4) the
// memory phase on the pre-edge registers (writes, a barrier, reads),
// (5) the t_start / t_complete records and the power counters, (6) the
// skip: WAIT timers down by delta, idle counters up (others reset when
// delta > 0), the skipped cycles' counters, t += 1 + delta. `t_end` is the
// run's horizon (the skip's bound); `t_stop` <= t_end ends a launch at a
// schedule boundary, for a schedule longer than a launch holds (the host
// passes slices of it, kernels/bank_fsm/fused.py). The per-cycle form
// (`cycle_skip` == 0, the reference's `simulate`: one step every clock) is
// a second instantiation with the event bound and step (6) compiled out,
// t += 1; the host picks the form once a launch.
//
// fused_run_batch_launch (fused_run_batch_kernel): the same loop for L
// lanes of one topology, capacities, tiers and form in one launch, CTA i
// running lane i, each from its own FusedRunArgs (its state, trace,
// schedule slice, queue limits, clock, horizon, budget, scratch and
// (t, steps) row), which the CTA copies to shared memory once. Both
// kernels call one body, run_lane(); the single-lane kernel keeps reading
// its arguments from the kernel's parameters. Every lane of a launch has
// the placement and shared-memory size of the lane with the most schedule
// segments, computed once; lanes the card cannot hold at once run in
// waves.
//
// What bounds it on an H100: the dependent latency chain of a step, not
// bytes. At Table-1 size (B = 32) the lane is one warp, so every reduction
// is a shuffle and every barrier a __syncwarp, and thread 0 loads the
// trace a step ahead. The bank registers and the rank timing copies stay
// in registers for the whole launch; the rest of the machine goes to
// dynamic shared memory: the reduction scratch, the schedule (parameter
// rows, segment bounds; at most 64 KB a launch), the counters, the
// bank-queue heads and counts, the req/resp rings and the bank-queue rings
// (64 KB at B = 32, Q = 128). Where that exceeds the 227 KB a block may
// opt in to, the launch keeps, in this order, the bank-queue rings, the
// response ring, the request ring and the bank-queue heads and counts in
// place in device memory instead (`dev`), until the rest fits; the rest
// (the schedule and about 4 KB) always does, so every queue size runs.
// `mem`, `rdata`, the trace and the records are read and written in place
// in device memory (the L2 holds the 256 KB store). The host reads
// (t, steps) once per launch.
#include <cuda_runtime.h>

#include "addr_decode.cuh"
#include "bank_fsm.cuh"

#include <climits>
#include <cstring>

#define LANE_THREADS 1024  // threads of a lane's CTA at most
// scratch bytes a bank of a lane above LANE_THREADS banks needs at least
// (the K = 0 form's slot arrays take 312 of them in fused_run_kernel)
#define K3_SCRATCH_PER_BANK 512

// The k slots of one per-bank array of a thread. The form K = 1 (lanes of
// up to 1024 banks) holds its one slot in a register. The form K = 0 takes
// any k = B / 1024 at run time and keeps the slots in the lane's scratch
// in device memory: slot j of thread tid at v[j * NT + tid], so a warp's
// accesses to one slot are contiguous. Each thread touches only its own
// slots, so the scratch needs no barrier.
template <int K, typename T>
struct Slots {
  T v[K];
  __device__ __forceinline__ T& operator[](int j) { return v[j]; }
  __device__ __forceinline__ const T& operator[](int j) const {
    return v[j];
  }
};
template <typename T>
struct Slots<0, T> {
  T* v;
  int stride;
  __device__ __forceinline__ T& operator[](int j) const {
    return v[j * stride];
  }
};

// A bump allocator over one lane's scratch: each array of the K = 0 form
// takes nk * nt elements, 16-byte aligned; a lane whose arrays overrun the
// scratch the host gave it traps.
struct SlotArena {
  char *next, *end;
  int nk, nt, tid;
  template <typename T>
  __device__ __forceinline__ Slots<0, T> take() {
    const Slots<0, T> s{reinterpret_cast<T*>(next) + tid, nt};
    next += ((size_t)nk * nt * sizeof(T) + 15) & ~(size_t)15;
    if (next > end) __trap();
    return s;
  }
};

// a slot array of the form K (K = 0: from the arena)
template <int K, typename T>
__device__ __forceinline__ Slots<K, T> slots(SlotArena& ar) {
  if constexpr (K == 0)
    return ar.template take<T>();
  else
    return Slots<K, T>{};
}

// Min of v over aligned groups of g consecutive threads of the block; every
// thread of the block must call it (it may synchronise the block).
__device__ int group_min(int v, int g, int* sh) {
  const int tid = threadIdx.x;
  if (g <= 32 && (g & (g - 1)) == 0) {
    const int warp_base = tid & ~31;
    const int n = min(32, (int)blockDim.x - warp_base);
    const unsigned mask = n == 32 ? 0xffffffffu : ((1u << n) - 1u);
    for (int off = g >> 1; off > 0; off >>= 1)
      v = min(v, __shfl_xor_sync(mask, v, off, g));
    return v;
  }
  __syncthreads();  // earlier readers of sh are done
  sh[tid] = v;
  __syncthreads();
  const int base = (tid / g) * g;
  const int i = tid - base;
  int p2 = 1;
  while (p2 < g) p2 <<= 1;
  for (int s = p2 >> 1; s > 0; s >>= 1) {
    if (i < s && i + s < g) sh[tid] = min(sh[tid], sh[tid + s]);
    __syncthreads();
  }
  return sh[base];
}

// v of thread src (a thread of the caller's aligned group of g threads) in
// every thread of the group; every thread of the block must call it.
__device__ int group_bcast(int v, int src, int g, int* sh) {
  const int tid = threadIdx.x;
  if (g <= 32 && (g & (g - 1)) == 0) {
    const int warp_base = tid & ~31;
    const int n = min(32, (int)blockDim.x - warp_base);
    const unsigned mask = n == 32 ? 0xffffffffu : ((1u << n) - 1u);
    return __shfl_sync(mask, v, src & 31);
  }
  __syncthreads();  // earlier readers of sh are done
  if (tid == src) sh[tid] = v;
  __syncthreads();
  return sh[src];
}

__device__ __forceinline__ unsigned lane_mask() {
  const int n = blockDim.x;
  return n >= 32 ? 0xffffffffu : ((1u << n) - 1u);
}

// whether p holds in every thread of the block (every thread calls it)
__device__ __forceinline__ bool lane_all(bool p) {
  if (blockDim.x <= 32) return __all_sync(lane_mask(), p);
  return __syncthreads_and(p);
}

// v[j] becomes the min over the aligned group of g banks (g a power of two)
// that slot j's bank belongs to, of a thread holding nk banks: a pass over
// the thread's own slots, then group_min over the g / nk threads of a
// group wider than nk. Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void group_min_k(Slots<K, int>& v, int nk, int g,
                                            int* sh) {
  if constexpr (K == 1) {
    v[0] = group_min(v[0], g, sh);
  } else {
    // running min within each group's slots, then its last slot's value
#pragma unroll
    for (int j = 1; j < nk; ++j)
      if (j & (g - 1)) v[j] = min(v[j], v[j - 1]);
#pragma unroll
    for (int j = nk - 2; j >= 0; --j)
      if ((j + 1) & (g - 1)) v[j] = v[j + 1];
    if (g > nk) {
      const int r = group_min(v[0], g / nk, sh);
#pragma unroll
      for (int j = 0; j < nk; ++j) v[j] = r;
    }
  }
}

// static shape of one lane
struct LaneGeom {
  int B, Qr, S, T, tier_split, per, banks_per_rank, q_cap, row_shift;
};

// the lane's scalar operands of one cycle (K3's scal row)
struct CycleScal {
  int cycle, arrival_rel, horizon, req_count, resp_head, resp_count,
      resp_limit, resp_rr;
};

// one bank's operands: registers, queue head/count, its rank's timing
// registers, the head item of its queue (garbage where empty)
struct BankIn {
  BankRegs s;
  int qhead, qcount;
  int la, aw0, aw1, aw2, aw3, lr, lw;
  int pop_addr, pop_write, pop_data, pop_id;
};

struct BankOut {
  BankRegs o;
  bool want_pop, rw_done, completed;
  int qhead2, qcount2;
  int la, aw0, aw1, aw2, aw3, lr, lw;
  int cmd_ptr, cmd_issued;  // the bank's channel: new pointer, issued cmd
};

// lane-uniform results, the same in every thread
struct CycleOut {
  int delta, resp_rr, resp_head, resp_count, widx;
  bool ack, any_resp;
  int item[4];  // the accepted response (0 when none)
};

// Phases 3-7 and the event bound of one executed cycle for banks b0 ..
// b0 + nk - 1 of a lane: rp [T*S, NP] and bnd [S] are the lane's schedule,
// cmd_ptr[j] the arbiter pointer of slot j's channel; its own slot arrays
// come from `ar` (a copy: they live for one call). Every thread of the
// block calls it. kSkip == false is the per-cycle form: the event bound is
// compiled out and delta is 0 (what horizon = cycle + 1 gives).
template <int K, bool kSkip>
__device__ __forceinline__ void cycle_core(
    const LaneGeom& g, const int* rp, const int* bnd, int b0, int nk,
    const Slots<K, int>& cmd_ptr, const CycleScal& sc,
    const Slots<K, BankIn>& in, int* sh, Slots<K, BankOut>& out,
    CycleOut& co, SlotArena ar) {
  if (K) nk = K;
  const int cycle = sc.cycle;
  const int nxt = wadd(cycle, 1);
  const int per = g.per;
  auto p = slots<K, Rp>(ar), p2 = slots<K, Rp>(ar);
  auto cmd = slots<K, int>(ar), rot = slots<K, int>(ar);
  auto m = slots<K, int>(ar), rank_in = slots<K, int>(ar);
  auto ch = slots<K, int>(ar);
  auto eligible = slots<K, bool>(ar);

  // ---- phase 3: bids, legality, per-channel RR grant, record_issue -------
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const int b = b0 + j;
    const int tier = (g.T > 1 && b >= g.tier_split) ? 1 : 0;
    p[j] = resolve_rp(rp, bnd, g.S, tier, cycle);
    if constexpr (kSkip) p2[j] = resolve_rp(rp, bnd, g.S, tier, nxt);
    const BankIn& x = in[j];
    cmd[j] = compute_cmd(x.s.st, x.s.cur_write);
    eligible[j] = cmd[j] != CMD_NOP &&
                  cycle >= legal_at(p[j], cmd[j], x.la, x.aw0, x.aw1, x.aw2,
                                    x.aw3, x.lr, x.lw);
    ch[j] = b / per;
    const int wi = b - ch[j] * per;
    rot[j] = fmod_floor(wsub(wi, cmd_ptr[j]), per);
    m[j] = eligible[j] ? rot[j] : per;
    rank_in[j] = wi / g.banks_per_rank;
  }
  group_min_k<K>(m, nk, per, sh);
  // the one granted bank (rot == m) sends its command and rank
  auto won = slots<K, int>(ar);
  if constexpr (K == 1) {
    won[0] = group_bcast(rank_in[0] << 3 | cmd[0],
                         ch[0] * per + fmod_floor(wadd(cmd_ptr[0], m[0]), per),
                         per, sh);
  } else {
#pragma unroll
    for (int j = 0; j < nk; ++j)
      won[j] = eligible[j] && rot[j] == m[j] ? rank_in[j] << 3 | cmd[j]
                                             : INT_MAX;
    group_min_k<K>(won, nk, per, sh);
  }
  auto grant = slots<K, bool>(ar);
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const BankIn& x = in[j];
    BankOut& o = out[j];
    const bool any_g = m[j] < per;
    grant[j] = eligible[j] && rot[j] == m[j];
    const int cmd_w = any_g ? won[j] & 7 : CMD_NOP;
    const int rank_w = any_g ? won[j] >> 3 : 0;
    const bool upd = rank_in[j] == rank_w;
    const bool is_act = any_g && cmd_w == CMD_ACT && upd;
    const bool is_rd = any_g && cmd_w == CMD_RD && upd;
    const bool is_wr = any_g && cmd_w == CMD_WR && upd;
    // tFAW window: replace the FIRST minimum slot (argmin tie order)
    const int awm = min(min(x.aw0, x.aw1), min(x.aw2, x.aw3));
    const bool s0 = x.aw0 == awm;
    const bool s1 = x.aw1 == awm && !s0;
    const bool s2 = x.aw2 == awm && !s0 && !s1;
    const bool s3 = !s0 && !s1 && !s2;
    o.la = is_act ? cycle : x.la;
    o.aw0 = (is_act && s0) ? cycle : x.aw0;
    o.aw1 = (is_act && s1) ? cycle : x.aw1;
    o.aw2 = (is_act && s2) ? cycle : x.aw2;
    o.aw3 = (is_act && s3) ? cycle : x.aw3;
    o.lr = is_rd ? cycle : x.lr;
    o.lw = is_wr ? cycle : x.lw;
    o.cmd_ptr = any_g ? fmod_floor(wadd(wadd(cmd_ptr[j], m[j]), 1), per)
                      : cmd_ptr[j];
    o.cmd_issued = cmd_w;
  }

  // ---- phase 4: response arbitration + respQueue push --------------------
  const bool resp_full = sc.resp_count >= sc.resp_limit;
  auto m_r = slots<K, int>(ar);
  auto accept = slots<K, bool>(ar);
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const bool bid_r = in[j].s.st == S_RESP_PEND && !resp_full;
    const int rot_r = fmod_floor(wsub(b0 + j, sc.resp_rr), g.B);
    m_r[j] = bid_r ? rot_r : g.B;
    accept[j] = bid_r;  // and rot_r == m_r, below
  }
  auto key_r = slots<K, int>(ar);
#pragma unroll
  for (int j = 0; j < nk; ++j) key_r[j] = m_r[j];
  group_min_k<K>(m_r, nk, g.B, sh);
  const int mr = m_r[0];
  const bool any_resp = mr < g.B;
#pragma unroll
  for (int j = 0; j < nk; ++j) accept[j] = accept[j] && key_r[j] == mr;
  // the accepted bank (rot_r == m_r) sends its request
  const int acc = fmod_floor(wadd(sc.resp_rr, mr), g.B);
  int f[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < nk; ++j)
    if (nk == 1 || b0 + j == acc) {
      f[0] = in[j].s.cur_addr;
      f[1] = in[j].s.cur_write;
      f[2] = in[j].s.cur_data;
      f[3] = in[j].s.cur_id;
    }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    co.item[q] = group_bcast(f[q], acc / nk, g.B / nk, sh);
  if (!any_resp) co.item[0] = co.item[1] = co.item[2] = co.item[3] = 0;
  co.any_resp = any_resp;
  co.widx = fmod_floor(wadd(sc.resp_head, sc.resp_count), g.Qr);
  const int resp_count1 = wadd(sc.resp_count, any_resp);

  // ---- phase 5: FSM clock edge + bank-queue pop bookkeeping --------------
  // ---- and the event-horizon bound at nxt on the post-edge state ---------
  bool inert_all = true;
  auto pb = slots<K, int>(ar);
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const BankIn& x = in[j];
    BankOut& ob = out[j];
    fsm_edge(p[j], cycle, g.row_shift, x.s, grant[j], accept[j],
             x.qcount > 0, x.pop_addr, x.pop_write, x.pop_data, x.pop_id,
             ob.o, ob.want_pop, ob.rw_done, ob.completed);
    ob.qhead2 = fmod_floor(wadd(x.qhead, ob.want_pop), g.q_cap);
    ob.qcount2 = wsub(x.qcount, ob.want_pop);
    if constexpr (kSkip) {
      const BankRegs& o = ob.o;
      const int local = event_bound(p2[j], nxt, o.st, o.timer, o.idle_ctr,
                                    o.refresh_due);
      const int cmd_n = compute_cmd(o.st, o.cur_write);
      const int legal_n = legal_at(p2[j], cmd_n, ob.la, ob.aw0, ob.aw1,
                                   ob.aw2, ob.aw3, ob.lr, ob.lw);
      const bool blocked_n = cmd_n != CMD_NOP && !(nxt >= legal_n);
      const bool inert =
          in_wait_state(o.st) || blocked_n ||
          ((o.st == S_IDLE || o.st == S_SREF) && !(ob.qcount2 > 0));
      inert_all = inert_all && inert;
      pb[j] = blocked_n ? wsub(legal_n, nxt) : local;
    }
  }

  // ---- phase 7: flow-through respQueue ack (pop of the post-push queue) --
  co.ack = resp_count1 > 0;
  const int resp_count2 = wsub(resp_count1, co.ack);
  co.delta = 0;
  if constexpr (kSkip) {
    const bool gate = lane_all(inert_all);
    group_min_k<K>(pb, nk, g.B, sh);
    const int per_bank = pb[0];
    // the next schedule boundary is an event (ParamSchedule.next_boundary)
    int nb = SCHEDULE_INF;
    for (int q = 0; q < g.S; ++q)
      if (bnd[q] > nxt) nb = min(nb, bnd[q]);
    int b_val = min(min(per_bank, sc.arrival_rel), wsub(sc.horizon, nxt));
    b_val = min(b_val, wsub(nb, nxt));
    const bool maybe = sc.req_count == 0 && resp_count2 == 0;
    co.delta = (maybe && gate) ? max(b_val, 0) : 0;
  }
  co.resp_rr = any_resp ? fmod_floor(wadd(wadd(sc.resp_rr, mr), 1), g.B)
                        : sc.resp_rr;
  co.resp_head = fmod_floor(wadd(sc.resp_head, co.ack), g.Qr);
  co.resp_count = resp_count2;
}

template <int kThreads, int K>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const int* __restrict__ bank_in, const int* __restrict__ resp_in,
    const int* __restrict__ rp, const int* __restrict__ bounds,
    const int* __restrict__ scal, int* __restrict__ bank_out,
    int* __restrict__ resp_out, int* __restrict__ scal_out,
    char* __restrict__ scratch, int scratch_per_bank, int B, int Qr, int S,
    int T, int tier_split, int C, int per, int banks_per_rank, int q_cap,
    int row_shift) {
  __shared__ int sh[LANE_THREADS];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nk = K ? K : B / blockDim.x;  // banks a thread
  const size_t lane_bytes = (size_t)B * scratch_per_bank;
  char* const lane_scratch = scratch + lane * lane_bytes;
  SlotArena ar{lane_scratch, lane_scratch + lane_bytes, nk, (int)blockDim.x,
               tid};
  const int b0 = tid * nk;                // the thread's first bank
  const int total = gridDim.x * B;
  const int* sc = scal + lane * (8 + C);
  int* so = scal_out + lane * (9 + 2 * C);
  const LaneGeom g{B, Qr, S, T, tier_split, per, banks_per_rank, q_cap,
                   row_shift};

  auto in = slots<K, BankIn>(ar);
  auto cmd_ptr = slots<K, int>(ar);
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const int pos = lane * B + b0 + j;
    BankIn& x = in[j];
    x.s = load_regs(bank_in, total, pos);
    x.qhead = bank_in[10 * total + pos];
    x.qcount = bank_in[11 * total + pos];
    x.la = bank_in[12 * total + pos];
    x.aw0 = bank_in[13 * total + pos];
    x.aw1 = bank_in[14 * total + pos];
    x.aw2 = bank_in[15 * total + pos];
    x.aw3 = bank_in[16 * total + pos];
    x.lr = bank_in[17 * total + pos];
    x.lw = bank_in[18 * total + pos];
    x.pop_addr = bank_in[19 * total + pos];
    x.pop_write = bank_in[20 * total + pos];
    x.pop_data = bank_in[21 * total + pos];
    x.pop_id = bank_in[22 * total + pos];
    cmd_ptr[j] = sc[8 + (b0 + j) / per];
  }
  const CycleScal cs{scal[0], sc[1], scal[2], sc[3],
                     sc[4],   sc[5], sc[6],   sc[7]};

  auto out = slots<K, BankOut>(ar);
  CycleOut co;
  cycle_core<K, true>(g, rp + lane * T * S * NUM_RUNTIME_PARAMS,
                      bounds + lane * S, b0, nk, cmd_ptr, cs, in, sh, out,
                      co, ar);

#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const int pos = lane * B + b0 + j;
    const BankOut& o = out[j];
    store_regs(bank_out, total, pos, o.o);
    bank_out[10 * total + pos] = o.want_pop;
    bank_out[11 * total + pos] = o.rw_done;
    bank_out[12 * total + pos] = o.completed;
    bank_out[13 * total + pos] = o.qhead2;
    bank_out[14 * total + pos] = o.qcount2;
    bank_out[15 * total + pos] = o.la;
    bank_out[16 * total + pos] = o.aw0;
    bank_out[17 * total + pos] = o.aw1;
    bank_out[18 * total + pos] = o.aw2;
    bank_out[19 * total + pos] = o.aw3;
    bank_out[20 * total + pos] = o.lr;
    bank_out[21 * total + pos] = o.lw;
    const int ch = (b0 + j) / per;
    if (b0 + j - ch * per == 0) {
      so[9 + ch] = o.cmd_ptr;
      so[9 + C + ch] = o.cmd_issued;
    }
  }
  const int* old = resp_in + lane * Qr * 4;
  int* rout = resp_out + lane * Qr * 4;
  for (int k = tid; k < Qr * 4; k += B / nk)  // B / nk threads
    rout[k] = (co.any_resp && k / 4 == co.widx) ? co.item[k % 4] : old[k];
  if (tid == 0) {
    const int resp_head = sc[4];
    const bool head_ok = resp_head >= 0 && resp_head < Qr;
    const bool head_is_new = co.any_resp && co.widx == resp_head;
    for (int f = 0; f < 4; ++f)
      so[5 + f] = head_is_new ? co.item[f]
                              : (head_ok ? old[resp_head * 4 + f] : 0);
    so[0] = co.delta;
    so[1] = co.resp_rr;
    so[2] = co.resp_head;
    so[3] = co.resp_count;
    so[4] = co.ack;
  }
}

// the banks a thread of a lane owns: 1 up to LANE_THREADS banks, else
// B / LANE_THREADS (B a power of two); 0 when no form takes the lane
static int banks_per_thread(int B) {
  if (B < 1) return 0;
  if (B <= LANE_THREADS) return 1;
  if ((B & (B - 1)) != 0) return 0;
  return B / LANE_THREADS;
}

// scratch: the slot arrays of lanes above LANE_THREADS banks,
// scratch_per_bank bytes a bank of each lane (null below).
extern "C" int fused_step_launch(const void* bank_in, const void* resp_in,
                                 const void* rp, const void* bounds,
                                 const void* scal, void* bank_out,
                                 void* resp_out, void* scal_out,
                                 void* scratch, int scratch_per_bank, int L,
                                 int B, int Qr, int S, int T, int tier_split,
                                 int C, int per, int banks_per_rank,
                                 int q_cap, int row_shift, void* stream) {
  const int k = banks_per_thread(B);
  if (k == 0 || (k > 1 && (scratch == nullptr ||
                           scratch_per_bank < K3_SCRATCH_PER_BANK)))
    return (int)cudaErrorInvalidValue;
  const auto kern = B <= 32 ? fused_step_kernel<32, 1>
                    : k == 1 ? fused_step_kernel<LANE_THREADS, 1>
                             : fused_step_kernel<LANE_THREADS, 0>;
  kern<<<L, B / k, 0, (cudaStream_t)stream>>>(
      (const int*)bank_in, (const int*)resp_in, (const int*)rp,
      (const int*)bounds, (const int*)scal, (int*)bank_out, (int*)resp_out,
      (int*)scal_out, (char*)scratch, scratch_per_bank, B, Qr, S, T,
      tier_split, C, per, banks_per_rank, q_cap, row_shift);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the persistent event-horizon kernel

// Every pointer is a live SimState / Trace tensor (int32, contiguous), read
// at entry and written back at exit; the host struct is mirrored field for
// field by repro_torch.kernels.bank_fsm.fused._RunArgs.
struct FusedRunArgs {
  const int *tr_t, *tr_addr, *tr_write, *tr_data;  // trace [N]
  const int *rp, *bounds;                          // [T*S, NP], [S]
  int* next_arrival;
  int *req_buf, *req_head, *req_count, *req_limit;  // [Qc, 4], 0-d x 3
  int *bq_buf, *bq_head, *bq_count, *bq_limit;      // [B, Q, 4], [B] x 2, 0-d
  int* regs[10];                                    // BankState leaves [B]
  int *last_act, *act_win, *last_rd, *last_wr;      // [R], [R, 4], [R], [R]
  int *cmd_rr, *resp_rr;                            // [C], 0-d
  int *resp_buf, *resp_head, *resp_count, *resp_limit;  // [Qr, 4], 0-d x 3
  int* mem;                                         // [mem_words + 1]
  int *t_admit, *t_dispatch, *t_start, *t_complete, *rdata;  // [N + 1]
  int *cmd_counts, *sref_cycles, *active_cycles, *idle_cycles;  // [8], 0-d
  int *seg_cycles, *tier_active, *tier_idle, *tier_sref;  // [S], [T] x 3
  int *blocked_arrival, *blocked_dispatch;
  int* out;  // [2]: the clock and the executed steps at exit
  char* scratch;  // [B * scratch_per_bank] slot arrays above LANE_THREADS
                  // banks (null below)
  AddrGeometry geo;
  int n, q_cap, req_cap, resp_cap, S, T, tier_split, mem_words;
  int t, t_end, t_stop, budget, scratch_per_bank;
  int cycle_skip;  // 0: the per-cycle form (every clock a step, no skip)
};

struct TraceEntry {
  int t, addr, write, data;
};

// trace entry min(i, n - 1)
__device__ __forceinline__ TraceEntry load_entry(const FusedRunArgs& a,
                                                 int i) {
  i = min(i, a.n - 1);
  return TraceEntry{a.tr_t[i], a.tr_addr[i], a.tr_write[i], a.tr_data[i]};
}

// counters in shared memory: cmd_counts [8] | sref, active, idle |
// seg_cycles [S] | tier_active, tier_idle, tier_sref [T] each
#define CNT_SREF 8
#define CNT_ACTIVE 9
#define CNT_IDLE 10
#define CNT_SEG 11

// a barrier (with memory ordering) over the lane's threads: one warp at
// B <= 32, the block above
__device__ __forceinline__ void lane_sync() {
  if (blockDim.x <= 32)
    __syncwarp(lane_mask());
  else
    __syncthreads();
}

// the number of the lane's banks whose p holds (every thread calls it;
// k > 1: a warp sum, then the warps' sums through sh)
template <int K>
__device__ __forceinline__ int lane_count(const Slots<K, bool>& p, int nk,
                                          int* sh) {
  if constexpr (K == 1) {
    if (blockDim.x <= 32) return __popc(__ballot_sync(lane_mask(), p[0]));
    return __syncthreads_count(p[0]);
  } else {
    int c = 0;
#pragma unroll
    for (int j = 0; j < nk; ++j) c += p[j];
    c = __reduce_add_sync(0xffffffffu, c);
    __syncthreads();  // earlier readers of sh are done
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = c;
    __syncthreads();
    int n = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) n += sh[w];
    return n;
  }
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// FR-FCFS (queues.BankedFifo.promote_rowhit) on one bank's ring q [Q, 4]:
// swap the oldest entry whose row is the open row into the head slot,
// unless an older entry has the same address.
__device__ __forceinline__ void promote_rowhit(int* q, int Q, int head,
                                               int count, int open_row,
                                               int row_shift) {
  if (open_row < 0) return;
  int first = -1;
  for (int k = 0; k < count; ++k)
    if ((q[fmod_floor(head + k, Q) * 4] >> row_shift) == open_row) {
      first = k;
      break;
    }
  if (first <= 0) return;  // no hit, or the head itself
  const int pos = fmod_floor(head + first, Q);
  const int a_sel = q[pos * 4];
  for (int k = 0; k < first; ++k)
    if (q[fmod_floor(head + k, Q) * 4] == a_sel) return;
  for (int f = 0; f < 4; ++f) {
    const int x = q[head * 4 + f];
    q[head * 4 + f] = q[pos * 4 + f];
    q[pos * 4 + f] = x;
  }
}

// the counters' per-tier buckets of one cycle's bank states
__device__ __forceinline__ void add_tier_counts(int* cnt, int S, int T,
                                                int tier_split, int B, int k,
                                                int sref, int idle, int sref1,
                                                int idle1) {
  int* act = cnt + CNT_SEG + S;
  int* idl = act + T;
  int* srf = idl + T;
  if (T == 1) {
    srf[0] = wadd(srf[0], wmul(k, sref));
    idl[0] = wadd(idl[0], wmul(k, idle));
    act[0] = wadd(act[0], wmul(k, B - sref - idle));
    return;
  }
  const int s0 = sref - sref1, i0 = idle - idle1;
  srf[0] = wadd(srf[0], wmul(k, s0));
  idl[0] = wadd(idl[0], wmul(k, i0));
  act[0] = wadd(act[0], wmul(k, tier_split - s0 - i0));
  srf[1] = wadd(srf[1], wmul(k, sref1));
  idl[1] = wadd(idl[1], wmul(k, idle1));
  act[1] = wadd(act[1], wmul(k, B - tier_split - sref1 - idle1));
}

// where a launch keeps what does not fit shared memory: bits of `dev`,
// set in this order until the rest fits (in place in device memory)
#define DEV_BANK_RINGS 1
#define DEV_RESP_RING 2
#define DEV_REQ_RING 4
#define DEV_QMETA 8

// The persistent loop of one lane, the CTA's threads: the body of both
// fused_run_kernel (one lane, `a` in the kernel's parameters) and
// fused_run_batch_kernel (lane blockIdx.x, `a` copied to shared memory).
template <int kThreads, int K, bool kSkip>
__device__ __forceinline__ void run_lane(const FusedRunArgs& a, int dev) {
  extern __shared__ int smem[];
  const AddrGeometry& geo = a.geo;
  const int B = geo.num_banks;
  const int tid = threadIdx.x;
  const int NT = blockDim.x;          // B / nk
  const int nk = K ? K : B / NT;      // banks a thread
  SlotArena ar{a.scratch, a.scratch + (size_t)B * a.scratch_per_bank, nk,
               NT, tid};
  const int b0 = tid * nk;            // the thread's first bank
  const int C = geo.channels;
  const int per = B / C;
  const int bpr = geo.bankgroups * geo.banks_per_group;
  const int S = a.S, T = a.T, n = a.n;
  const int Q = a.q_cap, Qc = a.req_cap, Qr = a.resp_cap;
  const LaneGeom g{B, Qr, S, T, T > 1 ? a.tier_split : B, per, bpr, Q,
                   geo.row_shift};
  const int n_cnt = CNT_SEG + S + 3 * T;

  int* next_smem = smem;
  const auto take = [&](int ints) {
    int* p = next_smem;
    next_smem += ints;
    return p;
  };
  int* sh = take(NT);                                 // reduction scratch
  int* rp_s = take(T * S * NUM_RUNTIME_PARAMS);       // [T*S, NP]
  int* bnd_s = take(S);                               // [S]
  int* cnt_s = take(n_cnt);                           // counters
  int* fe_s = take(2);                                // req_count, arrival
  int* qhead_s = dev & DEV_QMETA ? a.bq_head : take(B);    // [B]
  int* qcount_s = dev & DEV_QMETA ? a.bq_count : take(B);  // [B]
  int* req_s = dev & DEV_REQ_RING ? a.req_buf : take(Qc * 4);     // [Qc, 4]
  int* resp_s = dev & DEV_RESP_RING ? a.resp_buf : take(Qr * 4);  // [Qr, 4]
  int* ring = dev & DEV_BANK_RINGS ? a.bq_buf : take(B * Q * 4);  // [B, Q, 4]

  // ---- load the machine -------------------------------------------------
  if (!(dev & DEV_QMETA))
    for (int i = tid; i < B; i += NT) {
      qhead_s[i] = a.bq_head[i];
      qcount_s[i] = a.bq_count[i];
    }
  for (int i = tid; i < T * S * NUM_RUNTIME_PARAMS; i += NT) rp_s[i] = a.rp[i];
  for (int i = tid; i < S; i += NT) bnd_s[i] = a.bounds[i];
  if (!(dev & DEV_REQ_RING))
    for (int i = tid; i < Qc * 4; i += NT) req_s[i] = a.req_buf[i];
  if (!(dev & DEV_RESP_RING))
    for (int i = tid; i < Qr * 4; i += NT) resp_s[i] = a.resp_buf[i];
  for (int i = tid; i < n_cnt; i += NT) {
    const int* src;
    int j = i;
    if (j < 8) src = a.cmd_counts + j;
    else if (j == CNT_SREF) src = a.sref_cycles;
    else if (j == CNT_ACTIVE) src = a.active_cycles;
    else if (j == CNT_IDLE) src = a.idle_cycles;
    else if ((j -= CNT_SEG) < S) src = a.seg_cycles + j;
    else if ((j -= S) < T) src = a.tier_active + j;
    else if ((j -= T) < T) src = a.tier_idle + j;
    else src = a.tier_sref + (j - T);
    cnt_s[i] = *src;
  }
  if (!(dev & DEV_BANK_RINGS))
    for (int i = tid; i < B * Q * 4; i += NT) ring[i] = a.bq_buf[i];
  // each slot's bank: registers, its copy of its rank's timing registers,
  // its channel's arbiter pointer
  auto s = slots<K, BankRegs>(ar);
  auto la = slots<K, int>(ar), aw0 = slots<K, int>(ar);
  auto aw1 = slots<K, int>(ar), aw2 = slots<K, int>(ar);
  auto aw3 = slots<K, int>(ar), lr = slots<K, int>(ar);
  auto lw = slots<K, int>(ar), cmd_ptr = slots<K, int>(ar);
  auto tier1 = slots<K, bool>(ar);
  // the arrays of one step: the same scratch every step
  const SlotArena step_ar = ar;
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const int b = b0 + j;
    s[j].st = a.regs[0][b];
    s[j].timer = a.regs[1][b];
    s[j].idle_ctr = a.regs[2][b];
    s[j].refresh_due = a.regs[3][b];
    s[j].cur_addr = a.regs[4][b];
    s[j].cur_write = a.regs[5][b];
    s[j].cur_data = a.regs[6][b];
    s[j].cur_id = a.regs[7][b];
    s[j].open_row = a.regs[8][b];
    s[j].pending = a.regs[9][b];
    const int rank = b / bpr;
    la[j] = a.last_act[rank];
    lr[j] = a.last_rd[rank];
    lw[j] = a.last_wr[rank];
    aw0[j] = a.act_win[rank * 4];
    aw1[j] = a.act_win[rank * 4 + 1];
    aw2[j] = a.act_win[rank * 4 + 2];
    aw3[j] = a.act_win[rank * 4 + 3];
    cmd_ptr[j] = a.cmd_rr[b / per];
    tier1[j] = T > 1 && b >= a.tier_split;
  }
  int resp_rr = *a.resp_rr, resp_head = *a.resp_head;
  int resp_count = *a.resp_count;
  const int resp_limit = *a.resp_limit, bq_limit = *a.bq_limit;
  // the front end's registers, advanced by thread 0 only
  int next_arrival = *a.next_arrival, req_head = *a.req_head;
  int req_count = *a.req_count;
  const int req_limit = *a.req_limit;
  int blocked_arrival = *a.blocked_arrival;
  int blocked_dispatch = *a.blocked_dispatch;
  // thread 0 holds the trace entries at next_arrival and next_arrival + 1
  // (clamped) a step ahead of their use, off the step's latency chain
  TraceEntry e0{}, e1{};
  if (tid == 0) {
    e0 = load_entry(a, next_arrival);
    e1 = load_entry(a, wadd(next_arrival, 1));
  }
  int t = a.t, steps = 0;
  lane_sync();

  while (t < a.t_stop && steps < a.budget) {
    const int nxt = wadd(t, 1);
    const int seg = active_segment(bnd_s, S, t);
    // tier 0's row: the tier-uniform fields the glue reads
    const Rp p0 = resolve_rp(rp_s, bnd_s, S, 0, t);

    // ---- 1: trace admission and dispatch (thread 0) ---------------------
    if (tid == 0) {
      const int idx = min(next_arrival, n - 1);
      const bool due = next_arrival < n && e0.t <= t;
      const bool admit = due && !(req_count >= req_limit);
      if (admit) {
        int* slot = req_s + fmod_floor(wadd(req_head, req_count), Qc) * 4;
        slot[0] = e0.addr;
        slot[1] = e0.write;
        slot[2] = e0.data;
        slot[3] = idx;
        req_count = wadd(req_count, 1);
        a.t_admit[idx] = t;
        e0 = e1;
        e1 = load_entry(a, wadd(next_arrival, 2));
      }
      next_arrival = wadd(next_arrival, admit);
      blocked_arrival = wadd(blocked_arrival, due && !admit);
      const int* head = req_s + req_head * 4;
      int rnk;
      const int frac = T > 1 ? (1 << p0(RP_tier_cxl_frac_log2)) - 1 : 0;
      const int tgt = decode_bank(geo, head[0], T > 1,
                                  p0(RP_tier_interleave_log2), frac, &rnk);
      const bool have = req_count != 0;
      const bool tgt_full = qcount_s[tgt] >= bq_limit;
      if (have && !tgt_full) {
        int* slot = ring + (tgt * Q + fmod_floor(wadd(qhead_s[tgt],
                                                      qcount_s[tgt]), Q)) * 4;
        for (int f = 0; f < 4; ++f) slot[f] = head[f];
        qcount_s[tgt] = wadd(qcount_s[tgt], 1);
        const int id = head[3];
        if (id >= 0 && id < n) a.t_dispatch[id] = t;
        req_head = fmod_floor(wadd(req_head, 1), Qc);
        req_count = wsub(req_count, 1);
      }
      blocked_dispatch = wadd(blocked_dispatch, have && tgt_full);
      // next-arrival distance from nxt, post-admission
      fe_s[0] = req_count;
      fe_s[1] = next_arrival < n ? wsub(e0.t, nxt) : EVENT_INF;
    }
    lane_sync();

    // ---- 2: FR-FCFS promotion on each bank's own queue ------------------
    SlotArena sa = step_ar;
    auto in = slots<K, BankIn>(sa);
#pragma unroll
    for (int j = 0; j < nk; ++j) {
      const int b = b0 + j;
      const int qhead = qhead_s[b], qcount = qcount_s[b];
      int* myq = ring + b * Q * 4;
      if (p0(RP_sched_policy) == SCHED_FRFCFS)
        promote_rowhit(myq, Q, qhead, qcount, s[j].open_row, geo.row_shift);
      const int* pop = myq + qhead * 4;
      in[j] = BankIn{s[j],     qhead,   qcount,  la[j],  aw0[j],
                     aw1[j],   aw2[j],  aw3[j],  lr[j],  lw[j],
                     pop[0],   pop[1],  pop[2],  pop[3]};
    }

    // ---- 3: the cycle body ------------------------------------------------
    const CycleScal cs{t,         fe_s[1],    a.t_end,    fe_s[0],
                       resp_head, resp_count, resp_limit, resp_rr};
    auto out = slots<K, BankOut>(sa);
    CycleOut co;
    auto q_sref = slots<K, bool>(sa), q_idle = slots<K, bool>(sa);
    auto q_sref1 = slots<K, bool>(sa), q_idle1 = slots<K, bool>(sa);
    cycle_core<K, kSkip>(g, rp_s, bnd_s, b0, nk, cmd_ptr, cs, in, sh, out,
                         co, sa);

    // ---- 4: memory phase on the pre-edge registers ------------------------
#pragma unroll
    for (int j = 0; j < nk; ++j)
      if (out[j].rw_done && s[j].cur_write == 1)
        a.mem[s[j].cur_addr & (a.mem_words - 1)] = s[j].cur_data;
    lane_sync();
#pragma unroll
    for (int j = 0; j < nk; ++j)
      if (out[j].rw_done && s[j].cur_write != 1 && s[j].cur_id >= 0 &&
          s[j].cur_id < n)
        a.rdata[s[j].cur_id] = a.mem[s[j].cur_addr & (a.mem_words - 1)];

    // ---- 5: records and counters -------------------------------------------
#pragma unroll
    for (int j = 0; j < nk; ++j) {
      // a popping bank latched the popped item: the new cur_id is its id
      const int id = out[j].o.cur_id;
      if (out[j].want_pop && id >= 0 && id < n) a.t_start[id] = t;
      q_sref[j] = s[j].st == S_SREF;
      q_idle[j] = s[j].st == S_IDLE;
      q_sref1[j] = tier1[j] && q_sref[j];
      q_idle1[j] = tier1[j] && q_idle[j];
    }
    const int sref = lane_count<K>(q_sref, nk, sh);
    const int idle = lane_count<K>(q_idle, nk, sh);
    const int sref1 = T > 1 ? lane_count<K>(q_sref1, nk, sh) : 0;
    const int idle1 = T > 1 ? lane_count<K>(q_idle1, nk, sh) : 0;
#pragma unroll
    for (int j = 0; j < nk; ++j)
      if ((b0 + j) % per == 0) atomicAdd(cnt_s + out[j].cmd_issued, 1);
    if (tid == 0) {
      if (co.any_resp)
        for (int f = 0; f < 4; ++f) resp_s[co.widx * 4 + f] = co.item[f];
      if (co.ack) {  // the head after the push is the acked item
        const int id = resp_s[resp_head * 4 + 3];
        if (id >= 0 && id < n) a.t_complete[id] = t;
      }
      cnt_s[CNT_SREF] = wadd(cnt_s[CNT_SREF], sref);
      cnt_s[CNT_IDLE] = wadd(cnt_s[CNT_IDLE], idle);
      cnt_s[CNT_ACTIVE] = wadd(cnt_s[CNT_ACTIVE], B - sref - idle);
      if (seg >= 0) cnt_s[CNT_SEG + seg] = wadd(cnt_s[CNT_SEG + seg], 1);
      add_tier_counts(cnt_s, S, T, a.tier_split, B, 1, sref, idle, sref1,
                      idle1);
    }

    // ---- 6: the skip over delta inert cycles (0 in the per-cycle form) -----
    const int delta = co.delta;
    if (delta < 0) __trap();
#pragma unroll
    for (int j = 0; j < nk; ++j) s[j] = out[j].o;
    if (kSkip && delta > 0) {
#pragma unroll
      for (int j = 0; j < nk; ++j) {
        if (in_wait_state(s[j].st)) s[j].timer = wsub(s[j].timer, delta);
        s[j].idle_ctr = s[j].st == S_IDLE ? wadd(s[j].idle_ctr, delta) : 0;
        q_sref[j] = s[j].st == S_SREF;
        q_idle[j] = s[j].st == S_IDLE;
        q_sref1[j] = tier1[j] && q_sref[j];
        q_idle1[j] = tier1[j] && q_idle[j];
      }
      const int sref_n = lane_count<K>(q_sref, nk, sh);
      const int idle_n = lane_count<K>(q_idle, nk, sh);
      const int sref1_n = T > 1 ? lane_count<K>(q_sref1, nk, sh) : 0;
      const int idle1_n = T > 1 ? lane_count<K>(q_idle1, nk, sh) : 0;
      if (tid == 0) {
        // every skipped cycle lies in the segment of nxt
        const int seg_n = active_segment(bnd_s, S, nxt);
        atomicAdd(cnt_s + CMD_NOP, wmul(delta, C));
        cnt_s[CNT_SREF] = wadd(cnt_s[CNT_SREF], wmul(delta, sref_n));
        cnt_s[CNT_IDLE] = wadd(cnt_s[CNT_IDLE], wmul(delta, idle_n));
        cnt_s[CNT_ACTIVE] =
            wadd(cnt_s[CNT_ACTIVE], wmul(delta, B - sref_n - idle_n));
        if (seg_n >= 0)
          cnt_s[CNT_SEG + seg_n] = wadd(cnt_s[CNT_SEG + seg_n], delta);
        add_tier_counts(cnt_s, S, T, a.tier_split, B, delta, sref_n, idle_n,
                        sref1_n, idle1_n);
      }
    }
#pragma unroll
    for (int j = 0; j < nk; ++j) {
      la[j] = out[j].la;
      aw0[j] = out[j].aw0;
      aw1[j] = out[j].aw1;
      aw2[j] = out[j].aw2;
      aw3[j] = out[j].aw3;
      lr[j] = out[j].lr;
      lw[j] = out[j].lw;
      cmd_ptr[j] = out[j].cmd_ptr;
      qhead_s[b0 + j] = out[j].qhead2;
      qcount_s[b0 + j] = out[j].qcount2;
    }
    resp_rr = co.resp_rr;
    resp_head = co.resp_head;
    resp_count = co.resp_count;
    const int t_next = wadd(wadd(t, 1), delta);
    // no valid run reaches a clock that fails to advance or overshoots
    if (t_next <= t || t_next > a.t_end) __trap();
    t = t_next;
    ++steps;
    lane_sync();
  }

  // ---- write the machine back ---------------------------------------------
#pragma unroll
  for (int j = 0; j < nk; ++j) {
    const int b = b0 + j;
    a.regs[0][b] = s[j].st;
    a.regs[1][b] = s[j].timer;
    a.regs[2][b] = s[j].idle_ctr;
    a.regs[3][b] = s[j].refresh_due;
    a.regs[4][b] = s[j].cur_addr;
    a.regs[5][b] = s[j].cur_write;
    a.regs[6][b] = s[j].cur_data;
    a.regs[7][b] = s[j].cur_id;
    a.regs[8][b] = s[j].open_row;
    a.regs[9][b] = s[j].pending;
    if (b % bpr == 0) {  // the rank's copies agree: its first bank writes
      const int rank = b / bpr;
      a.last_act[rank] = la[j];
      a.act_win[rank * 4] = aw0[j];
      a.act_win[rank * 4 + 1] = aw1[j];
      a.act_win[rank * 4 + 2] = aw2[j];
      a.act_win[rank * 4 + 3] = aw3[j];
      a.last_rd[rank] = lr[j];
      a.last_wr[rank] = lw[j];
    }
    if (b % per == 0) a.cmd_rr[b / per] = cmd_ptr[j];
  }
  lane_sync();
  if (!(dev & DEV_QMETA))
    for (int i = tid; i < B; i += NT) {
      a.bq_head[i] = qhead_s[i];
      a.bq_count[i] = qcount_s[i];
    }
  if (!(dev & DEV_BANK_RINGS))
    for (int i = tid; i < B * Q * 4; i += NT) a.bq_buf[i] = ring[i];
  if (!(dev & DEV_REQ_RING))
    for (int i = tid; i < Qc * 4; i += NT) a.req_buf[i] = req_s[i];
  if (!(dev & DEV_RESP_RING))
    for (int i = tid; i < Qr * 4; i += NT) a.resp_buf[i] = resp_s[i];
  for (int i = tid; i < n_cnt; i += NT) {
    int* dst;
    int j = i;
    if (j < 8) dst = a.cmd_counts + j;
    else if (j == CNT_SREF) dst = a.sref_cycles;
    else if (j == CNT_ACTIVE) dst = a.active_cycles;
    else if (j == CNT_IDLE) dst = a.idle_cycles;
    else if ((j -= CNT_SEG) < S) dst = a.seg_cycles + j;
    else if ((j -= S) < T) dst = a.tier_active + j;
    else if ((j -= T) < T) dst = a.tier_idle + j;
    else dst = a.tier_sref + (j - T);
    *dst = cnt_s[i];
  }
  if (tid == 0) {
    *a.next_arrival = next_arrival;
    *a.req_head = req_head;
    *a.req_count = req_count;
    *a.blocked_arrival = blocked_arrival;
    *a.blocked_dispatch = blocked_dispatch;
    *a.resp_rr = resp_rr;
    *a.resp_head = resp_head;
    *a.resp_count = resp_count;
    a.out[0] = t;
    a.out[1] = steps;
  }
}

template <int kThreads, int K, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    fused_run_kernel(const FusedRunArgs a, int dev) {
  run_lane<kThreads, K, kSkip>(a, dev);
}

// L lanes of one topology, capacities and form, one CTA a lane. A lane's
// arguments are copied to shared memory once, so its step loop reads them
// there instead of from device memory.
template <int kThreads, int K, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    fused_run_batch_kernel(const FusedRunArgs* __restrict__ lanes, int dev) {
  __shared__ FusedRunArgs lane;
  const int* src = reinterpret_cast<const int*>(lanes + blockIdx.x);
  int* dst = reinterpret_cast<int*>(&lane);
  for (int i = threadIdx.x; i < (int)(sizeof(FusedRunArgs) / sizeof(int));
       i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  run_lane<kThreads, K, kSkip>(lane, dev);
}

// Shared bytes of a launch of `threads` threads that keeps the parts named
// by `dev` in device memory.
static size_t run_smem(const FusedRunArgs& a, int threads, int dev) {
  const size_t B = a.geo.num_banks;
  size_t ints = threads + (size_t)a.T * a.S * NUM_RUNTIME_PARAMS + a.S +
                CNT_SEG + a.S + 3 * (size_t)a.T + 2;
  if (!(dev & DEV_QMETA)) ints += 2 * B;
  if (!(dev & DEV_REQ_RING)) ints += 4 * (size_t)a.req_cap;
  if (!(dev & DEV_RESP_RING)) ints += 4 * (size_t)a.resp_cap;
  if (!(dev & DEV_BANK_RINGS)) ints += B * a.q_cap * 4;
  return ints * sizeof(int);
}

// The launches of the form <kThreads, K, kSkip>: `run` one lane (its
// arguments in the kernel's parameters), `batch` L lanes, CTA i running
// lanes_dev[i], or, with per_sm, the CTAs of it an SM holds at once.
template <int kThreads, int K, bool kSkip>
struct Form {
  static int run(const FusedRunArgs& a, int threads, size_t bytes, int dev,
                 cudaStream_t st) {
    const auto kern = fused_run_kernel<kThreads, K, kSkip>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<1, threads, bytes, st>>>(a, dev);
    return (int)cudaGetLastError();
  }
  static int batch(const FusedRunArgs* lanes_dev, int L, int threads,
                   size_t bytes, int dev, cudaStream_t st, int* per_sm) {
    const auto kern = fused_run_batch_kernel<kThreads, K, kSkip>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, kern, threads, bytes);
    kern<<<L, threads, bytes, st>>>(lanes_dev, dev);
    return (int)cudaGetLastError();
  }
  // loads the batched kernel of this form into the context
  static int load_batch() {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(
        &attr, fused_run_batch_kernel<kThreads, K, kSkip>);
  }
};

// f(Form<..>{}) of a lane of B banks, k a thread: 32 threads up to 32
// banks, one bank a thread up to LANE_THREADS, k slots a thread above;
// the per-cycle form when !skip. The form is chosen once a launch: no
// run-time branch in the step loop.
template <typename F>
static int with_form(int B, int k, bool skip, F&& f) {
  if (skip) {
    if (B <= 32) return f(Form<32, 1, true>{});
    if (k == 1) return f(Form<LANE_THREADS, 1, true>{});
    return f(Form<LANE_THREADS, 0, true>{});
  }
  if (B <= 32) return f(Form<32, 1, false>{});
  if (k == 1) return f(Form<LANE_THREADS, 1, false>{});
  return f(Form<LANE_THREADS, 0, false>{});
}

// The parts a launch keeps in place in device memory (DEV_* bits): none
// while everything fits the block's opt-in shared memory (less `reserve`
// bytes of static shared memory), else the bank-queue rings, then the
// response ring, the request ring and the bank-queue heads and counts,
// until the rest (the schedule a launch holds, at most 64 KB, and about
// 4 KB besides) does.
static int run_placement(const FusedRunArgs& a, int threads, size_t* bytes,
                         size_t reserve = 0) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t room = (size_t)optin - reserve;
  static const int kOrder[] = {DEV_BANK_RINGS, DEV_RESP_RING, DEV_REQ_RING,
                               DEV_QMETA};
  int where = 0;
  *bytes = run_smem(a, threads, where);
  for (const int part : kOrder)
    if (*bytes > room) *bytes = run_smem(a, threads, where |= part);
  return where;
}

// The DEV_* bits a launch with these arguments would set (phase 2 of
// chip_smoke.py holds each case to the placement it is built to reach);
// -1 for a lane no form takes.
extern "C" int fused_run_placement_query(const void* args) {
  const FusedRunArgs& a = *static_cast<const FusedRunArgs*>(args);
  const int k = banks_per_thread(a.geo.num_banks);
  size_t bytes;
  return k == 0 ? -1 : run_placement(a, a.geo.num_banks / k, &bytes);
}

// The host's FusedRunArgs size, which the Python mirror of the struct must
// equal (a batch is an array of them).
extern "C" int fused_run_args_bytes() { return (int)sizeof(FusedRunArgs); }

// Checks that the L lanes of a batch (host copies) can share one launch:
// one topology, capacities, tiers, form and scratch layout, each lane with
// a trace, a budget and, above LANE_THREADS banks, its scratch. Returns the
// lane with the most schedule segments (which sizes the shared memory of
// every lane), or -1.
static int batch_lead(const FusedRunArgs* h, int L) {
  if (L < 1) return -1;
  const FusedRunArgs& a0 = h[0];
  const int k = banks_per_thread(a0.geo.num_banks);
  if (k == 0) return -1;
  int lead = 0;
  for (int i = 0; i < L; ++i) {
    const FusedRunArgs& a = h[i];
    if (memcmp(&a.geo, &a0.geo, sizeof(AddrGeometry)) != 0 ||
        a.q_cap != a0.q_cap || a.req_cap != a0.req_cap ||
        a.resp_cap != a0.resp_cap || a.T != a0.T ||
        a.tier_split != a0.tier_split || a.mem_words != a0.mem_words ||
        a.cycle_skip != a0.cycle_skip ||
        a.scratch_per_bank != a0.scratch_per_bank || a.n < 1 ||
        a.budget < 1 || a.S < 1)
      return -1;
    if (k > 1 &&
        (a.scratch == nullptr || a.scratch_per_bank < K3_SCRATCH_PER_BANK))
      return -1;
    if (a.S > h[lead].S) lead = i;
  }
  return lead;
}

// the batched launch (or, with per_sm, its occupancy) of the lanes that
// `lead` sizes
static int batch_form(const FusedRunArgs& lead, const FusedRunArgs* lanes_dev,
                      int L, int* per_sm, cudaStream_t st) {
  const int B = lead.geo.num_banks;
  const int k = banks_per_thread(B);
  const int threads = B / k;
  size_t bytes;
  const int where =
      run_placement(lead, threads, &bytes, sizeof(FusedRunArgs));
  return with_form(B, k, lead.cycle_skip, [&](auto form) {
    return decltype(form)::batch(lanes_dev, L, threads, bytes, where, st,
                                 per_sm);
  });
}

// The DEV_* bits of a batched launch of these L lanes (host copies); -1
// for lanes that cannot share one.
extern "C" int fused_run_batch_placement_query(const void* lanes_host,
                                               int L) {
  const FusedRunArgs* h = static_cast<const FusedRunArgs*>(lanes_host);
  const int lead = batch_lead(h, L);
  if (lead < 0) return -1;
  const int B = h[lead].geo.num_banks;
  size_t bytes;
  return run_placement(h[lead], B / banks_per_thread(B), &bytes,
                       sizeof(FusedRunArgs));
}

// The CTAs (lanes) of a batched launch of these lanes that one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's
// threads and shared memory); a negative cudaError_t on failure.
extern "C" int fused_run_batch_occupancy(const void* lanes_host, int L) {
  const FusedRunArgs* h = static_cast<const FusedRunArgs*>(lanes_host);
  const int lead = batch_lead(h, L);
  if (lead < 0) return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  const int err = batch_form(h[lead], nullptr, L, &per_sm, nullptr);
  return err != 0 ? -err : per_sm;
}

// L lanes in one launch, CTA i running lanes_dev[i] (a device copy of the
// host array lanes_host, which sizes and checks the launch). Returns a
// cudaError_t.
extern "C" int fused_run_batch_launch(const void* lanes_host,
                                      const void* lanes_dev, int L,
                                      void* stream) {
  const FusedRunArgs* h = static_cast<const FusedRunArgs*>(lanes_host);
  const int lead = batch_lead(h, L);
  if (lead < 0 || lanes_dev == nullptr) return (int)cudaErrorInvalidValue;
  return batch_form(h[lead], static_cast<const FusedRunArgs*>(lanes_dev), L,
                    nullptr, static_cast<cudaStream_t>(stream));
}

// Loads every form of the batched kernel into the context. The runtime
// loads a kernel lazily, at its first use, and a load may wait until the
// card is idle: a form first launched while other launches run (the
// topologies of a sweep, each on its own stream) would start only after
// they end. Returns a cudaError_t.
extern "C" int fused_run_batch_preload() {
  for (const bool skip : {true, false})
    for (const int B : {32, 2 * 32, 2 * LANE_THREADS}) {
      const int err =
          with_form(B, banks_per_thread(B), skip, [](auto form) {
            return decltype(form)::load_batch();
          });
      if (err != 0) return err;
    }
  return 0;
}

// Returns a cudaError_t.
extern "C" int fused_run_launch(const void* args, void* stream) {
  const FusedRunArgs& a = *static_cast<const FusedRunArgs*>(args);
  const int B = a.geo.num_banks;
  const int k = banks_per_thread(B);
  if (k == 0 || a.n < 1 || a.budget < 1) return (int)cudaErrorInvalidValue;
  if (k > 1 &&
      (a.scratch == nullptr || a.scratch_per_bank < K3_SCRATCH_PER_BANK))
    return (int)cudaErrorInvalidValue;
  const int threads = B / k;
  size_t bytes;
  const int where = run_placement(a, threads, &bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_form(B, k, a.cycle_skip, [&](auto form) {
    return decltype(form)::run(a, threads, bytes, where, st);
  });
}
