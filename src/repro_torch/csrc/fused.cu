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
// gives the skip `delta`. One thread per bank of the lane (so at most 1024
// banks a lane), every cross-bank step a reduction inside the CTA:
//   * the command arbiter is a min-reduction of the rotated priority key
//     over the channel's banks_per_channel threads (warp shuffles when the
//     group fits a warp, shared memory above); the minimum names the one
//     winner, which broadcasts its command and rank;
//   * record_issue is rank-uniform: every bank updates its copy of its
//     rank's timing registers when the winner's rank is its own;
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
// one lane. One launch runs executed steps from the clock `t` until the
// horizon `t_end` or `budget` steps, each step the body of the reference's
// _run_skip_core (src/repro/core/engine.py:326-342) in the port's eager
// order: (1) trace admission and dispatch to a bank queue (thread 0; the
// address decode is addr_decode.cuh's, shared with K4), (2) the FR-FCFS
// row-hit promotion (each bank its own queue), (3) cycle_core(), (4) the
// memory phase on the pre-edge registers (writes, a barrier, reads),
// (5) the t_start / t_complete records and the power counters, (6) the
// skip: WAIT timers down by delta, idle counters up (others reset when
// delta > 0), the skipped cycles' counters, t += 1 + delta.
//
// What bounds it on an H100: the dependent latency chain of a step, not
// bytes. At Table-1 size (B = 32) the lane is one warp, so every reduction
// is a shuffle and every barrier a __syncwarp, and thread 0 loads the
// trace a step ahead; the machine's registers and
// queues stay in registers and shared memory for the whole launch: the bank
// registers and the rank timing copies in registers, the req/resp rings,
// the bank-queue rings (64 KB at B = 32, Q = 128; addressed in place in
// device memory when they do not fit the 227 KB), parameter rows and
// counters in dynamic shared memory. `mem`, `rdata`, the trace and the
// records are read and written in place in device memory (the L2 holds the
// 256 KB store). The host reads (t, steps) once per launch.
#include <cuda_runtime.h>

#include "addr_decode.cuh"
#include "bank_fsm.cuh"

#define MAX_LANE_BANKS 1024

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

// Phases 3-7 and the event bound of one executed cycle for bank b of a
// lane: rp [T*S, NP] and bnd [S] are the lane's schedule, cmd_ptr the
// arbiter pointer of b's channel. Every thread of the block calls it.
__device__ __forceinline__ void cycle_core(const LaneGeom& g, const int* rp,
                                           const int* bnd, int b, int cmd_ptr,
                                           const CycleScal& sc,
                                           const BankIn& in, int* sh,
                                           BankOut& out, CycleOut& co) {
  const int cycle = sc.cycle;
  const int nxt = wadd(cycle, 1);
  const int tier = (g.T > 1 && b >= g.tier_split) ? 1 : 0;
  const Rp p = resolve_rp(rp, bnd, g.S, tier, cycle);
  const Rp p2 = resolve_rp(rp, bnd, g.S, tier, nxt);
  const BankRegs& s = in.s;

  // ---- phase 3: bids, legality, per-channel RR grant, record_issue -------
  const int per = g.per;
  const int cmd = compute_cmd(s.st, s.cur_write);
  const bool eligible =
      cmd != CMD_NOP && cycle >= legal_at(p, cmd, in.la, in.aw0, in.aw1,
                                          in.aw2, in.aw3, in.lr, in.lw);
  const int ch = b / per;
  const int wi = b - ch * per;
  const int rot = fmod_floor(wsub(wi, cmd_ptr), per);
  const int m = group_min(eligible ? rot : per, per, sh);
  const bool any_g = m < per;
  const bool grant = eligible && rot == m;
  const int rank_in = wi / g.banks_per_rank;
  // the one granted bank (rot == m) sends its command and rank
  const int won = group_bcast(cmd << 16 | rank_in,
                              ch * per + fmod_floor(wadd(cmd_ptr, m), per),
                              per, sh);
  const int cmd_w = any_g ? won >> 16 : CMD_NOP;
  const int rank_w = any_g ? won & 0xffff : 0;
  const bool upd = rank_in == rank_w;
  const bool is_act = any_g && cmd_w == CMD_ACT && upd;
  const bool is_rd = any_g && cmd_w == CMD_RD && upd;
  const bool is_wr = any_g && cmd_w == CMD_WR && upd;
  // tFAW window: replace the FIRST minimum slot (argmin tie order)
  const int awm = min(min(in.aw0, in.aw1), min(in.aw2, in.aw3));
  const bool s0 = in.aw0 == awm;
  const bool s1 = in.aw1 == awm && !s0;
  const bool s2 = in.aw2 == awm && !s0 && !s1;
  const bool s3 = !s0 && !s1 && !s2;
  out.la = is_act ? cycle : in.la;
  out.aw0 = (is_act && s0) ? cycle : in.aw0;
  out.aw1 = (is_act && s1) ? cycle : in.aw1;
  out.aw2 = (is_act && s2) ? cycle : in.aw2;
  out.aw3 = (is_act && s3) ? cycle : in.aw3;
  out.lr = is_rd ? cycle : in.lr;
  out.lw = is_wr ? cycle : in.lw;
  out.cmd_ptr = any_g ? fmod_floor(wadd(wadd(cmd_ptr, m), 1), per) : cmd_ptr;
  out.cmd_issued = cmd_w;

  // ---- phase 4: response arbitration + respQueue push --------------------
  const bool bid_r = s.st == S_RESP_PEND && !(sc.resp_count >= sc.resp_limit);
  const int rot_r = fmod_floor(wsub(b, sc.resp_rr), g.B);
  const int m_r = group_min(bid_r ? rot_r : g.B, g.B, sh);
  const bool any_resp = m_r < g.B;
  const bool accept = bid_r && rot_r == m_r;
  // the accepted bank (rot_r == m_r) sends its request
  const int acc = fmod_floor(wadd(sc.resp_rr, m_r), g.B);
  co.item[0] = group_bcast(s.cur_addr, acc, g.B, sh);
  co.item[1] = group_bcast(s.cur_write, acc, g.B, sh);
  co.item[2] = group_bcast(s.cur_data, acc, g.B, sh);
  co.item[3] = group_bcast(s.cur_id, acc, g.B, sh);
  if (!any_resp) co.item[0] = co.item[1] = co.item[2] = co.item[3] = 0;
  co.any_resp = any_resp;
  co.widx = fmod_floor(wadd(sc.resp_head, sc.resp_count), g.Qr);
  const int resp_count1 = wadd(sc.resp_count, any_resp);

  // ---- phase 5: FSM clock edge + bank-queue pop bookkeeping --------------
  fsm_edge(p, cycle, g.row_shift, s, grant, accept, in.qcount > 0,
           in.pop_addr, in.pop_write, in.pop_data, in.pop_id, out.o,
           out.want_pop, out.rw_done, out.completed);
  out.qhead2 = fmod_floor(wadd(in.qhead, out.want_pop), g.q_cap);
  out.qcount2 = wsub(in.qcount, out.want_pop);

  // ---- event-horizon bound at nxt on the post-edge state -----------------
  const BankRegs& o = out.o;
  const int local = event_bound(p2, nxt, o.st, o.timer, o.idle_ctr,
                                o.refresh_due);
  const int cmd_n = compute_cmd(o.st, o.cur_write);
  const int legal_n = legal_at(p2, cmd_n, out.la, out.aw0, out.aw1, out.aw2,
                               out.aw3, out.lr, out.lw);
  const bool blocked_n = cmd_n != CMD_NOP && !(nxt >= legal_n);
  const bool inert = in_wait_state(o.st) || blocked_n ||
                     ((o.st == S_IDLE || o.st == S_SREF) && !(out.qcount2 > 0));
  const bool gate = lane_all(inert);
  const int per_bank =
      group_min(blocked_n ? wsub(legal_n, nxt) : local, g.B, sh);

  // ---- phase 7: flow-through respQueue ack (pop of the post-push queue) --
  co.ack = resp_count1 > 0;
  const int resp_count2 = wsub(resp_count1, co.ack);
  // the next schedule boundary is an event (ParamSchedule.next_boundary)
  int nb = SCHEDULE_INF;
  for (int q = 0; q < g.S; ++q)
    if (bnd[q] > nxt) nb = min(nb, bnd[q]);
  int b_val = min(min(per_bank, sc.arrival_rel), wsub(sc.horizon, nxt));
  b_val = min(b_val, wsub(nb, nxt));
  const bool maybe = sc.req_count == 0 && resp_count2 == 0;
  co.delta = (maybe && gate) ? max(b_val, 0) : 0;
  co.resp_rr = any_resp ? fmod_floor(wadd(wadd(sc.resp_rr, m_r), 1), g.B)
                        : sc.resp_rr;
  co.resp_head = fmod_floor(wadd(sc.resp_head, co.ack), g.Qr);
  co.resp_count = resp_count2;
}

__global__ void fused_step_kernel(
    const int* __restrict__ bank_in, const int* __restrict__ resp_in,
    const int* __restrict__ rp, const int* __restrict__ bounds,
    const int* __restrict__ scal, int* __restrict__ bank_out,
    int* __restrict__ resp_out, int* __restrict__ scal_out, int B, int Qr,
    int S, int T, int tier_split, int C, int per, int banks_per_rank,
    int q_cap, int row_shift) {
  __shared__ int sh[MAX_LANE_BANKS];
  const int lane = blockIdx.x;
  const int b = threadIdx.x;
  const int total = gridDim.x * B;
  const int pos = lane * B + b;
  const int* sc = scal + lane * (8 + C);
  int* so = scal_out + lane * (9 + 2 * C);
  const LaneGeom g{B, Qr, S, T, tier_split, per, banks_per_rank, q_cap,
                   row_shift};

  BankIn in;
  in.s = load_regs(bank_in, total, pos);
  in.qhead = bank_in[10 * total + pos];
  in.qcount = bank_in[11 * total + pos];
  in.la = bank_in[12 * total + pos];
  in.aw0 = bank_in[13 * total + pos];
  in.aw1 = bank_in[14 * total + pos];
  in.aw2 = bank_in[15 * total + pos];
  in.aw3 = bank_in[16 * total + pos];
  in.lr = bank_in[17 * total + pos];
  in.lw = bank_in[18 * total + pos];
  in.pop_addr = bank_in[19 * total + pos];
  in.pop_write = bank_in[20 * total + pos];
  in.pop_data = bank_in[21 * total + pos];
  in.pop_id = bank_in[22 * total + pos];
  const CycleScal cs{scal[0], sc[1], scal[2], sc[3],
                     sc[4],   sc[5], sc[6],   sc[7]};
  const int ch = b / per;

  BankOut out;
  CycleOut co;
  cycle_core(g, rp + lane * T * S * NUM_RUNTIME_PARAMS, bounds + lane * S, b,
             sc[8 + ch], cs, in, sh, out, co);

  store_regs(bank_out, total, pos, out.o);
  bank_out[10 * total + pos] = out.want_pop;
  bank_out[11 * total + pos] = out.rw_done;
  bank_out[12 * total + pos] = out.completed;
  bank_out[13 * total + pos] = out.qhead2;
  bank_out[14 * total + pos] = out.qcount2;
  bank_out[15 * total + pos] = out.la;
  bank_out[16 * total + pos] = out.aw0;
  bank_out[17 * total + pos] = out.aw1;
  bank_out[18 * total + pos] = out.aw2;
  bank_out[19 * total + pos] = out.aw3;
  bank_out[20 * total + pos] = out.lr;
  bank_out[21 * total + pos] = out.lw;
  if (b - ch * per == 0) {
    so[9 + ch] = out.cmd_ptr;
    so[9 + C + ch] = out.cmd_issued;
  }
  const int* old = resp_in + lane * Qr * 4;
  int* rout = resp_out + lane * Qr * 4;
  for (int k = b; k < Qr * 4; k += B)
    rout[k] = (co.any_resp && k / 4 == co.widx) ? co.item[k % 4] : old[k];
  if (b == 0) {
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

extern "C" int fused_step_launch(const void* bank_in, const void* resp_in,
                                 const void* rp, const void* bounds,
                                 const void* scal, void* bank_out,
                                 void* resp_out, void* scal_out, int L, int B,
                                 int Qr, int S, int T, int tier_split, int C,
                                 int per, int banks_per_rank, int q_cap,
                                 int row_shift, void* stream) {
  fused_step_kernel<<<L, B, 0, (cudaStream_t)stream>>>(
      (const int*)bank_in, (const int*)resp_in, (const int*)rp,
      (const int*)bounds, (const int*)scal, (int*)bank_out, (int*)resp_out,
      (int*)scal_out, B, Qr, S, T, tier_split, C, per, banks_per_rank, q_cap,
      row_shift);
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
  AddrGeometry geo;
  int n, q_cap, req_cap, resp_cap, S, T, tier_split, mem_words;
  int t, t_end, budget;
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

// the number of the lane's threads whose p holds (every thread calls it)
__device__ __forceinline__ int lane_count(bool p) {
  if (blockDim.x <= 32) return __popc(__ballot_sync(lane_mask(), p));
  return __syncthreads_count(p);
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

template <int kMaxBanks>
__global__ void __launch_bounds__(kMaxBanks)
    fused_run_kernel(const FusedRunArgs a, int ring_in_smem) {
  extern __shared__ int smem[];
  const AddrGeometry& geo = a.geo;
  const int B = geo.num_banks;
  const int b = threadIdx.x;
  const int C = geo.channels;
  const int per = B / C;
  const int bpr = geo.bankgroups * geo.banks_per_group;
  const int S = a.S, T = a.T, n = a.n;
  const int Q = a.q_cap, Qc = a.req_cap, Qr = a.resp_cap;
  const LaneGeom g{B, Qr, S, T, T > 1 ? a.tier_split : B, per, bpr, Q,
                   geo.row_shift};
  const int n_cnt = CNT_SEG + S + 3 * T;

  int* sh = smem;                          // [B] group_min scratch
  int* qhead_s = sh + B;                   // [B]
  int* qcount_s = qhead_s + B;             // [B]
  int* rp_s = qcount_s + B;                // [T*S, NP]
  int* bnd_s = rp_s + T * S * NUM_RUNTIME_PARAMS;  // [S]
  int* req_s = bnd_s + S;                  // [Qc, 4]
  int* resp_s = req_s + Qc * 4;            // [Qr, 4]
  int* cnt_s = resp_s + Qr * 4;            // counters
  int* fe_s = cnt_s + n_cnt;               // req_count, arrival_rel
  int* ring = ring_in_smem ? fe_s + 2 : a.bq_buf;  // [B, Q, 4]

  // ---- load the machine -------------------------------------------------
  qhead_s[b] = a.bq_head[b];
  qcount_s[b] = a.bq_count[b];
  for (int i = b; i < T * S * NUM_RUNTIME_PARAMS; i += B) rp_s[i] = a.rp[i];
  for (int i = b; i < S; i += B) bnd_s[i] = a.bounds[i];
  for (int i = b; i < Qc * 4; i += B) req_s[i] = a.req_buf[i];
  for (int i = b; i < Qr * 4; i += B) resp_s[i] = a.resp_buf[i];
  for (int i = b; i < n_cnt; i += B) {
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
  if (ring_in_smem)
    for (int i = b; i < B * Q * 4; i += B) ring[i] = a.bq_buf[i];
  BankRegs s;
  s.st = a.regs[0][b];
  s.timer = a.regs[1][b];
  s.idle_ctr = a.regs[2][b];
  s.refresh_due = a.regs[3][b];
  s.cur_addr = a.regs[4][b];
  s.cur_write = a.regs[5][b];
  s.cur_data = a.regs[6][b];
  s.cur_id = a.regs[7][b];
  s.open_row = a.regs[8][b];
  s.pending = a.regs[9][b];
  const int rank = b / bpr;
  int la = a.last_act[rank], lr = a.last_rd[rank], lw = a.last_wr[rank];
  int aw0 = a.act_win[rank * 4], aw1 = a.act_win[rank * 4 + 1];
  int aw2 = a.act_win[rank * 4 + 2], aw3 = a.act_win[rank * 4 + 3];
  int cmd_ptr = a.cmd_rr[b / per];
  int resp_rr = *a.resp_rr, resp_head = *a.resp_head;
  int resp_count = *a.resp_count;
  const int resp_limit = *a.resp_limit, bq_limit = *a.bq_limit;
  // the front end's registers, advanced by thread 0 only
  int next_arrival = *a.next_arrival, req_head = *a.req_head;
  int req_count = *a.req_count;
  const int req_limit = *a.req_limit;
  int blocked_arrival = *a.blocked_arrival;
  int blocked_dispatch = *a.blocked_dispatch;
  const bool tier1 = T > 1 && b >= a.tier_split;
  // thread 0 holds the trace entries at next_arrival and next_arrival + 1
  // (clamped) a step ahead of their use, off the step's latency chain
  TraceEntry e0{}, e1{};
  if (b == 0) {
    e0 = load_entry(a, next_arrival);
    e1 = load_entry(a, wadd(next_arrival, 1));
  }
  int t = a.t, steps = 0;
  lane_sync();

  while (t < a.t_end && steps < a.budget) {
    const int nxt = wadd(t, 1);
    const int seg = active_segment(bnd_s, S, t);
    // tier 0's row: the tier-uniform fields the glue reads
    const Rp p0 = resolve_rp(rp_s, bnd_s, S, 0, t);

    // ---- 1: trace admission and dispatch (thread 0) ---------------------
    if (b == 0) {
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

    // ---- 2: FR-FCFS promotion on the bank's own queue -------------------
    const int qhead = qhead_s[b], qcount = qcount_s[b];
    int* myq = ring + b * Q * 4;
    if (p0(RP_sched_policy) == SCHED_FRFCFS)
      promote_rowhit(myq, Q, qhead, qcount, s.open_row, geo.row_shift);

    // ---- 3: the cycle body ------------------------------------------------
    const int* pop = myq + qhead * 4;
    const BankIn in{s,   qhead, qcount, la,     aw0,    aw1,    aw2,
                    aw3, lr,    lw,     pop[0], pop[1], pop[2], pop[3]};
    const CycleScal cs{t,         fe_s[1],    a.t_end,    fe_s[0],
                       resp_head, resp_count, resp_limit, resp_rr};
    BankOut out;
    CycleOut co;
    cycle_core(g, rp_s, bnd_s, b, cmd_ptr, cs, in, sh, out, co);

    // ---- 4: memory phase on the pre-edge registers ------------------------
    const int maddr = s.cur_addr & (a.mem_words - 1);
    const bool is_wr = s.cur_write == 1;
    if (out.rw_done && is_wr) a.mem[maddr] = s.cur_data;
    lane_sync();
    if (out.rw_done && !is_wr && s.cur_id >= 0 && s.cur_id < n)
      a.rdata[s.cur_id] = a.mem[maddr];

    // ---- 5: records and counters -------------------------------------------
    // a popping bank latched the popped item: the new cur_id is its id
    if (out.want_pop && out.o.cur_id >= 0 && out.o.cur_id < n)
      a.t_start[out.o.cur_id] = t;
    const int sref = lane_count(s.st == S_SREF);
    const int idle = lane_count(s.st == S_IDLE);
    const int sref1 = T > 1 ? lane_count(tier1 && s.st == S_SREF) : 0;
    const int idle1 = T > 1 ? lane_count(tier1 && s.st == S_IDLE) : 0;
    if (b % per == 0) atomicAdd(cnt_s + out.cmd_issued, 1);
    if (b == 0) {
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

    // ---- 6: the skip over delta inert cycles -------------------------------
    const int delta = co.delta;
    if (delta < 0) __trap();
    s = out.o;
    if (delta > 0) {
      if (in_wait_state(s.st)) s.timer = wsub(s.timer, delta);
      s.idle_ctr = s.st == S_IDLE ? wadd(s.idle_ctr, delta) : 0;
      const int sref_n = lane_count(s.st == S_SREF);
      const int idle_n = lane_count(s.st == S_IDLE);
      const int sref1_n = T > 1 ? lane_count(tier1 && s.st == S_SREF) : 0;
      const int idle1_n = T > 1 ? lane_count(tier1 && s.st == S_IDLE) : 0;
      if (b == 0) {
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
    la = out.la;
    aw0 = out.aw0;
    aw1 = out.aw1;
    aw2 = out.aw2;
    aw3 = out.aw3;
    lr = out.lr;
    lw = out.lw;
    cmd_ptr = out.cmd_ptr;
    resp_rr = co.resp_rr;
    resp_head = co.resp_head;
    resp_count = co.resp_count;
    qhead_s[b] = out.qhead2;
    qcount_s[b] = out.qcount2;
    const int t_next = wadd(wadd(t, 1), delta);
    // no valid run reaches a clock that fails to advance or overshoots
    if (t_next <= t || t_next > a.t_end) __trap();
    t = t_next;
    ++steps;
    lane_sync();
  }

  // ---- write the machine back ---------------------------------------------
  a.regs[0][b] = s.st;
  a.regs[1][b] = s.timer;
  a.regs[2][b] = s.idle_ctr;
  a.regs[3][b] = s.refresh_due;
  a.regs[4][b] = s.cur_addr;
  a.regs[5][b] = s.cur_write;
  a.regs[6][b] = s.cur_data;
  a.regs[7][b] = s.cur_id;
  a.regs[8][b] = s.open_row;
  a.regs[9][b] = s.pending;
  if (b % bpr == 0) {  // the rank's copies agree: its first bank writes
    a.last_act[rank] = la;
    a.act_win[rank * 4] = aw0;
    a.act_win[rank * 4 + 1] = aw1;
    a.act_win[rank * 4 + 2] = aw2;
    a.act_win[rank * 4 + 3] = aw3;
    a.last_rd[rank] = lr;
    a.last_wr[rank] = lw;
  }
  if (b % per == 0) a.cmd_rr[b / per] = cmd_ptr;
  lane_sync();
  a.bq_head[b] = qhead_s[b];
  a.bq_count[b] = qcount_s[b];
  if (ring_in_smem)
    for (int i = b; i < B * Q * 4; i += B) a.bq_buf[i] = ring[i];
  for (int i = b; i < Qc * 4; i += B) a.req_buf[i] = req_s[i];
  for (int i = b; i < Qr * 4; i += B) a.resp_buf[i] = resp_s[i];
  for (int i = b; i < n_cnt; i += B) {
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
  if (b == 0) {
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

// Shared bytes of the launch without / with the bank-queue rings.
static size_t run_smem(const FusedRunArgs& a, bool ring) {
  const int B = a.geo.num_banks;
  size_t ints = 3 * (size_t)B + (size_t)a.T * a.S * NUM_RUNTIME_PARAMS +
                a.S + 4 * (size_t)a.req_cap + 4 * (size_t)a.resp_cap +
                CNT_SEG + a.S + 3 * (size_t)a.T + 2;
  if (ring) ints += (size_t)B * a.q_cap * 4;
  return ints * sizeof(int);
}

// Returns a cudaError_t. The bank-queue rings go to shared memory when
// they fit the block's opt-in limit beside the rest, else they stay in
// place in device memory.
extern "C" int fused_run_launch(const void* args, void* stream) {
  const FusedRunArgs& a = *static_cast<const FusedRunArgs*>(args);
  const int B = a.geo.num_banks;
  if (B < 1 || B > MAX_LANE_BANKS || a.n < 1 || a.budget < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool ring = run_smem(a, true) <= (size_t)optin;
  const size_t bytes = run_smem(a, ring);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B <= 32) {
    err = cudaFuncSetAttribute(fused_run_kernel<32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_run_kernel<32><<<1, B, bytes, st>>>(a, ring);
  } else {
    err = cudaFuncSetAttribute(fused_run_kernel<MAX_LANE_BANKS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_run_kernel<MAX_LANE_BANKS><<<1, B, bytes, st>>>(a, ring);
  }
  return (int)cudaGetLastError();
}
