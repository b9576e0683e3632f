// K3: the fused hot-loop kernel, one launch per executed cycle.
//
// Replaces (TPU, Pallas): src/repro/kernels/bank_fsm/fused.py:397
// fused_step_pallas (body _fused_kernel, _resolve_rp_lanes, _compute_cmds,
// _legal_at; it calls the shared _fsm_combinational and
// _event_bound_combinational, here fsm_edge() and event_bound() of
// bank_fsm.cuh, the same functions K1 and K2 call).
//
// One launch does phases 3-7 of a cycle for L independent lanes: command
// bids and timing legality, the rotating-priority command arbiter per
// (lane, channel), the rank timing-window update, the response arbiter and
// respQueue push, the FSM edge, the bank-queue pop bookkeeping, the
// flow-through response ack, and the event-horizon bound at cycle + 1 that
// gives the skip `delta` per lane.
//
// What bounds it on an H100: launch latency and the host loop around it.
// At Table-1 size (L = 1, B = 32, Qr = 64) one launch moves ~6 KB and does
// a few thousand integer operations: nanoseconds of device time against a
// launch cost of microseconds. Design: one CTA per lane and one thread per
// bank of the lane (so at most 1024 banks a lane), every cross-bank step a
// reduction inside the CTA, nothing through device memory between phases:
//   * the command arbiter is a min-reduction of the rotated priority key
//     over the channel's banks_per_channel threads (warp shuffles when the
//     group fits a warp, shared memory above); the winner's command and rank
//     come out of the same reduction over (grant ? value : INT_MAX);
//   * record_issue is rank-uniform: every bank updates its copy of its
//     rank's timing registers when the winner's rank is its own;
//   * the response arbiter and the event bound reduce over the lane;
//   * thread 0 writes the lane's scalar row, the first thread of each
//     channel its arbiter pointer and issued command.
// `%` of possibly negative values is a floor-mod and sums wrap (see
// bank_fsm.cuh), matching the reference's int32 jnp semantics.
//
// ABI (int32; L lanes, B banks a lane, lane-major bank axis pos = l*B + b):
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
#include <climits>

#include <cuda_runtime.h>

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

  const int cycle = scal[0];
  const int horizon = scal[2];
  const int nxt = wadd(cycle, 1);
  const int arrival_rel = sc[1];
  const int req_count = sc[3];
  const int resp_head = sc[4];
  const int resp_count = sc[5];
  const int resp_limit = sc[6];
  const int resp_rr = sc[7];

  const int tier = (T > 1 && b >= tier_split) ? 1 : 0;
  const int* lane_rp = rp + lane * T * S * NUM_RUNTIME_PARAMS;
  const int* lane_bnd = bounds + lane * S;
  const Rp p = resolve_rp(lane_rp, lane_bnd, S, tier, cycle);
  const Rp p2 = resolve_rp(lane_rp, lane_bnd, S, tier, nxt);

  const BankRegs s = load_regs(bank_in, total, pos);
  const int qhead = bank_in[10 * total + pos];
  const int qcount = bank_in[11 * total + pos];
  const int la = bank_in[12 * total + pos];
  const int aw0 = bank_in[13 * total + pos];
  const int aw1 = bank_in[14 * total + pos];
  const int aw2 = bank_in[15 * total + pos];
  const int aw3 = bank_in[16 * total + pos];
  const int lr = bank_in[17 * total + pos];
  const int lw = bank_in[18 * total + pos];
  const int pop_addr = bank_in[19 * total + pos];
  const int pop_write = bank_in[20 * total + pos];
  const int pop_data = bank_in[21 * total + pos];
  const int pop_id = bank_in[22 * total + pos];

  // ---- phase 3: bids, legality, per-channel RR grant, record_issue -------
  const int cmd = compute_cmd(s.st, s.cur_write);
  const bool eligible =
      cmd != CMD_NOP && cycle >= legal_at(p, cmd, la, aw0, aw1, aw2, aw3, lr, lw);
  const int ch = b / per;
  const int wi = b - ch * per;
  const int ptr = sc[8 + ch];
  const int rot = fmod_floor(wsub(wi, ptr), per);
  const int m = group_min(eligible ? rot : per, per, sh);
  const bool any_g = m < per;
  const bool grant = eligible && rot == m;
  const int rank_in = wi / banks_per_rank;
  const int cmd_min = group_min(grant ? cmd : INT_MAX, per, sh);
  const int rank_min = group_min(grant ? rank_in : INT_MAX, per, sh);
  const int cmd_w = any_g ? cmd_min : CMD_NOP;
  const int rank_w = any_g ? rank_min : 0;
  const bool upd = rank_in == rank_w;
  const bool is_act = any_g && cmd_w == CMD_ACT && upd;
  const bool is_rd = any_g && cmd_w == CMD_RD && upd;
  const bool is_wr = any_g && cmd_w == CMD_WR && upd;
  // tFAW window: replace the FIRST minimum slot (argmin tie order)
  const int awm = min(min(aw0, aw1), min(aw2, aw3));
  const bool s0 = aw0 == awm;
  const bool s1 = aw1 == awm && !s0;
  const bool s2 = aw2 == awm && !s0 && !s1;
  const bool s3 = !s0 && !s1 && !s2;
  const int la2 = is_act ? cycle : la;
  const int aw0_2 = (is_act && s0) ? cycle : aw0;
  const int aw1_2 = (is_act && s1) ? cycle : aw1;
  const int aw2_2 = (is_act && s2) ? cycle : aw2;
  const int aw3_2 = (is_act && s3) ? cycle : aw3;
  const int lr2 = is_rd ? cycle : lr;
  const int lw2 = is_wr ? cycle : lw;
  if (wi == 0) {
    so[9 + ch] = any_g ? fmod_floor(wadd(wadd(ptr, m), 1), per) : ptr;
    so[9 + C + ch] = cmd_w;
  }

  // ---- phase 4: response arbitration + respQueue push --------------------
  const bool bid_r = s.st == S_RESP_PEND && !(resp_count >= resp_limit);
  const int rot_r = fmod_floor(wsub(b, resp_rr), B);
  const int m_r = group_min(bid_r ? rot_r : B, B, sh);
  const bool any_resp = m_r < B;
  const bool accept = bid_r && rot_r == m_r;
  int item[4];
  item[0] = group_min(accept ? s.cur_addr : INT_MAX, B, sh);
  item[1] = group_min(accept ? s.cur_write : INT_MAX, B, sh);
  item[2] = group_min(accept ? s.cur_data : INT_MAX, B, sh);
  item[3] = group_min(accept ? s.cur_id : INT_MAX, B, sh);
  if (!any_resp) item[0] = item[1] = item[2] = item[3] = 0;
  const int widx = fmod_floor(wadd(resp_head, resp_count), Qr);
  const int* old = resp_in + lane * Qr * 4;
  int* rout = resp_out + lane * Qr * 4;
  for (int k = b; k < Qr * 4; k += B)
    rout[k] = (any_resp && k / 4 == widx) ? item[k % 4] : old[k];
  const int resp_count1 = wadd(resp_count, any_resp);

  // ---- phase 5: FSM clock edge + bank-queue pop bookkeeping --------------
  BankRegs o;
  bool want_pop, rw_done, completed;
  fsm_edge(p, cycle, row_shift, s, grant, accept, qcount > 0, pop_addr,
           pop_write, pop_data, pop_id, o, want_pop, rw_done, completed);
  const int qhead2 = fmod_floor(wadd(qhead, want_pop), q_cap);
  const int qcount2 = wsub(qcount, want_pop);

  // ---- event-horizon bound at nxt on the post-edge state -----------------
  const int local = event_bound(p2, nxt, o.st, o.timer, o.idle_ctr,
                                o.refresh_due);
  const int cmd_n = compute_cmd(o.st, o.cur_write);
  const int legal_n =
      legal_at(p2, cmd_n, la2, aw0_2, aw1_2, aw2_2, aw3_2, lr2, lw2);
  const bool blocked_n = cmd_n != CMD_NOP && !(nxt >= legal_n);
  const bool inert = in_wait_state(o.st) || blocked_n ||
                     ((o.st == S_IDLE || o.st == S_SREF) && !(qcount2 > 0));
  const bool gate = group_min(inert ? 1 : 0, B, sh) == 1;
  const int per_bank =
      group_min(blocked_n ? wsub(legal_n, nxt) : local, B, sh);

  // ---- stores -----------------------------------------------------------
  store_regs(bank_out, total, pos, o);
  bank_out[10 * total + pos] = want_pop;
  bank_out[11 * total + pos] = rw_done;
  bank_out[12 * total + pos] = completed;
  bank_out[13 * total + pos] = qhead2;
  bank_out[14 * total + pos] = qcount2;
  bank_out[15 * total + pos] = la2;
  bank_out[16 * total + pos] = aw0_2;
  bank_out[17 * total + pos] = aw1_2;
  bank_out[18 * total + pos] = aw2_2;
  bank_out[19 * total + pos] = aw3_2;
  bank_out[20 * total + pos] = lr2;
  bank_out[21 * total + pos] = lw2;

  if (b == 0) {
    // phase 7: flow-through respQueue ack (pop of the post-push queue)
    const bool ack = resp_count1 > 0;
    const bool head_ok = resp_head >= 0 && resp_head < Qr;
    const bool head_is_new = any_resp && widx == resp_head;
    for (int f = 0; f < 4; ++f)
      so[5 + f] = head_is_new ? item[f]
                              : (head_ok ? old[resp_head * 4 + f] : 0);
    const int resp_count2 = wsub(resp_count1, ack);
    // next schedule boundary is an event (ParamSchedule.next_boundary)
    int nb = SCHEDULE_INF;
    for (int q = 0; q < S; ++q)
      if (lane_bnd[q] > nxt) nb = min(nb, lane_bnd[q]);
    int b_val = min(min(per_bank, arrival_rel), wsub(horizon, nxt));
    b_val = min(b_val, wsub(nb, nxt));
    const bool maybe = req_count == 0 && resp_count2 == 0;
    so[0] = (maybe && gate) ? max(b_val, 0) : 0;
    so[1] = any_resp ? fmod_floor(wadd(wadd(resp_rr, m_r), 1), B) : resp_rr;
    so[2] = fmod_floor(wadd(resp_head, ack), Qr);
    so[3] = resp_count2;
    so[4] = ack;
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
