// Per-bank combinational networks shared by the bank-FSM kernels.
//
// fsm_edge() is one clock edge of one bank scheduler FSM and event_bound()
// its cycles-until-actionable bound. K1 (bank_fsm.cu), K2 (bank_fsm.cu) and
// K3 (fused.cu) all call these same functions, as the reference's split and
// fused Pallas kernels share _fsm_combinational and
// _event_bound_combinational, so the backends cannot drift apart.
//
// Integer semantics follow jnp/torch int32: sums and differences of data
// values wrap (wadd/wsub do them in uint32_t, since signed overflow is
// undefined in C++), and `%` of a possibly negative value is a floor-mod
// (fmod_floor), not C++'s truncating remainder.
#pragma once

#include "rp_index.h"

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// a mod n rounded toward negative infinity, for n > 0 (jnp/torch `%`).
// The divisors are runtime values, mostly powers of two (bank and channel
// counts, Table-1 queue sizes) and the dividends mostly in [0, 2n) (a ring
// index plus a count): both take a few instructions instead of a division
// (on an H100 they take the persistent K3 from ~3.7 to ~3.3 us a step).
__device__ __forceinline__ int fmod_floor(int a, int n) {
  if ((n & (n - 1)) == 0) return a & (n - 1);  // two's complement floor-mod
  if ((unsigned)a < 2u * (unsigned)n) return a >= n ? a - n : a;
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// The parameter row governing one bank: a row of the packed [T*S, NP]
// matrix, or all zeros when no segment is active yet (cycle below the first
// boundary), which is what the reference's one-hot row select yields.
struct Rp {
  const int* row;
  __device__ __forceinline__ int operator()(int j) const {
    return row ? row[j] : 0;
  }
};

// Active ParamSchedule segment: the count of boundaries <= cycle, minus 1.
// S == 1 (a constant run) reads row 0 without looking at the boundary.
__device__ __forceinline__ int active_segment(const int* bounds, int S,
                                              int cycle) {
  if (S == 1) return 0;
  int n = 0;
  for (int s = 0; s < S; ++s) n += bounds[s] <= cycle;
  return n - 1;
}

// rp: one tier-major [T*S, NP] block (row t*S + s is tier t, segment s).
__device__ __forceinline__ Rp resolve_rp(const int* rp, const int* bounds,
                                         int S, int tier, int cycle) {
  const int seg = active_segment(bounds, S, cycle);
  Rp r;
  r.row = seg < 0 ? nullptr : rp + (tier * S + seg) * NUM_RUNTIME_PARAMS;
  return r;
}

struct BankRegs {
  int st, timer, idle_ctr, refresh_due, cur_addr, cur_write, cur_data, cur_id,
      open_row, pending;
};

// packed state rows 0-9 of a [rows, stride] operand, column `col`
__device__ __forceinline__ BankRegs load_regs(const int* p, int stride,
                                              int col) {
  BankRegs s;
  s.st = p[0 * stride + col];
  s.timer = p[1 * stride + col];
  s.idle_ctr = p[2 * stride + col];
  s.refresh_due = p[3 * stride + col];
  s.cur_addr = p[4 * stride + col];
  s.cur_write = p[5 * stride + col];
  s.cur_data = p[6 * stride + col];
  s.cur_id = p[7 * stride + col];
  s.open_row = p[8 * stride + col];
  s.pending = p[9 * stride + col];
  return s;
}

__device__ __forceinline__ void store_regs(int* p, int stride, int col,
                                           const BankRegs& s) {
  p[0 * stride + col] = s.st;
  p[1 * stride + col] = s.timer;
  p[2 * stride + col] = s.idle_ctr;
  p[3 * stride + col] = s.refresh_due;
  p[4 * stride + col] = s.cur_addr;
  p[5 * stride + col] = s.cur_write;
  p[6 * stride + col] = s.cur_data;
  p[7 * stride + col] = s.cur_id;
  p[8 * stride + col] = s.open_row;
  p[9 * stride + col] = s.pending;
}

__device__ __forceinline__ bool in_wait_state(int st) {
  return st == S_ACT_WAIT || st == S_RW_WAIT || st == S_PRE_WAIT ||
         st == S_REF_WAIT || st == S_SREF_EXIT_WAIT;
}

// compute_bids: the command a bank bids on the bus (CMD_NOP: no bid)
__device__ __forceinline__ int compute_cmd(int st, int cur_write) {
  int cmd = CMD_NOP;
  if (st == S_ACT_ISSUE) cmd = CMD_ACT;
  if (st == S_RW_ISSUE) cmd = cur_write == 1 ? CMD_WR : CMD_RD;
  if (st == S_PRE_ISSUE) cmd = CMD_PRE;
  if (st == S_REF_ISSUE) cmd = CMD_REF;
  if (st == S_SREF_ISSUE) cmd = CMD_SREF_ENTER;
  if (st == S_SREF_EXIT_ISSUE) cmd = CMD_SREF_EXIT;
  return cmd;
}

// legal_issue_cycle on the bank's copy of its rank's timing registers
__device__ __forceinline__ int legal_at(const Rp& rp, int cmd, int la, int aw0,
                                        int aw1, int aw2, int aw3, int lr,
                                        int lw) {
  const int oldest = min(min(aw0, aw1), min(aw2, aw3));
  if (cmd == CMD_ACT)
    return max(wadd(la, rp(RP_tRRDL)), wadd(oldest, rp(RP_tFAW)));
  if (cmd == CMD_RD)
    return max(wadd(lr, rp(RP_tCCDL)), wadd(lw, rp(RP_tWTR)));
  if (cmd == CMD_WR)
    return max(wadd(lw, rp(RP_tCCDL)), wadd(lr, rp(RP_tRTW)));
  return NEG_TIME;
}

// One synchronous clock edge of one bank FSM: the where-chain of
// repro_torch.core.bank_fsm.fsm_update, in the same order (a later
// assignment overrides an earlier one, as a later jnp.where does).
__device__ __forceinline__ void fsm_edge(
    const Rp& rp, int cycle, int row_shift, const BankRegs& s, bool grant,
    bool resp_accept, bool queue_nonempty, int pop_addr, int pop_write,
    int pop_data, int pop_id, BankRegs& o, bool& want_pop, bool& rw_done,
    bool& completed) {
  const bool is_open = rp(RP_page_policy) == PAGE_OPEN;
  const int st = s.st;
  int open_row = s.open_row;
  int pending = s.pending;
  const bool refresh_needed = cycle >= wsub(s.refresh_due, rp(RP_tRFC));

  // WAIT states: tick timers, transition on expiry
  const bool in_wait = in_wait_state(st);
  int timer2 = in_wait ? max(wsub(s.timer, 1), 0) : s.timer;
  const bool expired = in_wait && timer2 == 0;
  int nxt = st;
  if (expired && st == S_ACT_WAIT) {
    nxt = S_RW_ISSUE;
    open_row = s.cur_addr >> row_shift;
  }
  if (expired && st == S_RW_WAIT) nxt = is_open ? S_RESP_PEND : S_PRE_ISSUE;
  const bool pre_done = expired && st == S_PRE_WAIT;
  if (pre_done && !is_open) nxt = S_RESP_PEND;
  if (pre_done && is_open && pending == P_RW) nxt = S_ACT_ISSUE;
  if (pre_done && is_open && pending == P_REF) nxt = S_REF_ISSUE;
  if (pre_done && is_open && pending == P_SREF) nxt = S_SREF_ISSUE;
  if (pre_done) {
    open_row = -1;
    pending = P_NONE;
  }
  if (expired && st == S_REF_WAIT) nxt = S_IDLE;
  if (expired && st == S_SREF_EXIT_WAIT) nxt = S_IDLE;
  rw_done = expired && st == S_RW_WAIT;
  const bool ref_done = expired && st == S_REF_WAIT;

  // ISSUE states: on (timing-checked, arbitrated) grant, enter WAIT
  const int act_dur = s.cur_write == 1 ? rp(RP_tRCDWR) : rp(RP_tRCDRD);
  if (grant && st == S_ACT_ISSUE) { nxt = S_ACT_WAIT; timer2 = act_dur; }
  if (grant && st == S_RW_ISSUE) { nxt = S_RW_WAIT; timer2 = rp(RP_tCL); }
  if (grant && st == S_PRE_ISSUE) { nxt = S_PRE_WAIT; timer2 = rp(RP_tRP); }
  if (grant && st == S_REF_ISSUE) { nxt = S_REF_WAIT; timer2 = rp(RP_tRFC); }
  if (grant && st == S_SREF_ISSUE) nxt = S_SREF;
  if (grant && st == S_SREF_EXIT_ISSUE) {
    nxt = S_SREF_EXIT_WAIT;
    timer2 = rp(RP_tXS);
  }

  // RESP_PEND drained by the response arbiter
  completed = resp_accept && st == S_RESP_PEND;
  if (completed) nxt = S_IDLE;

  // IDLE: refresh > pop > self-refresh countdown
  const bool idle = st == S_IDLE;
  const bool row_open = open_row >= 0;
  const bool go_ref = idle && refresh_needed;
  const bool ref_pre = is_open && row_open;
  if (go_ref) nxt = ref_pre ? S_PRE_ISSUE : S_REF_ISSUE;
  if (go_ref && ref_pre) pending = P_REF;

  want_pop = idle && !refresh_needed && queue_nonempty;
  const int pop_row = pop_addr >> row_shift;
  const bool hit = is_open && want_pop && row_open && open_row == pop_row;
  const bool conflict = is_open && want_pop && row_open && open_row != pop_row;
  if (want_pop) nxt = S_ACT_ISSUE;
  if (hit) nxt = S_RW_ISSUE;
  if (conflict) { nxt = S_PRE_ISSUE; pending = P_RW; }

  const bool truly_idle = idle && !refresh_needed && !queue_nonempty;
  const int idle_ctr2 = truly_idle ? wadd(s.idle_ctr, 1) : 0;
  const bool go_sref = truly_idle && idle_ctr2 >= rp(RP_sref_idle_cycles);
  const bool sref_pre = is_open && row_open;
  if (go_sref) nxt = sref_pre ? S_PRE_ISSUE : S_SREF_ISSUE;
  if (go_sref && sref_pre) pending = P_SREF;

  // SREF wake on pending work
  if (st == S_SREF && queue_nonempty) nxt = S_SREF_EXIT_ISSUE;

  // refresh bookkeeping
  int refresh_due2 = ref_done ? wadd(s.refresh_due, rp(RP_tREFI))
                              : s.refresh_due;
  if (expired && st == S_SREF_EXIT_WAIT)
    refresh_due2 = wadd(cycle, rp(RP_tREFI));

  o.st = nxt;
  o.timer = timer2;
  o.idle_ctr = idle_ctr2;
  o.refresh_due = refresh_due2;
  o.cur_addr = want_pop ? pop_addr : s.cur_addr;
  o.cur_write = want_pop ? pop_write : s.cur_write;
  o.cur_data = want_pop ? pop_data : s.cur_data;
  o.cur_id = want_pop ? pop_id : s.cur_id;
  o.open_row = open_row;
  o.pending = pending;
}

// cycles_until_actionable: WAIT timer-1; IDLE min(refresh window, SREF
// threshold); SREF EVENT_INF; ISSUE / RESP_PEND 0.
__device__ __forceinline__ int event_bound(const Rp& rp, int cycle, int st,
                                           int timer, int idle_ctr,
                                           int refresh_due) {
  int bound = 0;
  if (in_wait_state(st)) bound = wsub(timer, 1);
  if (st == S_IDLE)
    bound = min(wsub(wsub(refresh_due, rp(RP_tRFC)), cycle),
                wsub(wsub(rp(RP_sref_idle_cycles), 1), idle_ctr));
  if (st == S_SREF) bound = EVENT_INF;
  return bound;
}
