"""The fused hot-loop kernel K3: one launch per executed cycle
(``fused_step``), or one persistent launch per run (``fused_run``).

It does phases 3-7 of ``repro_torch.core.simulator.cycle_step`` plus the
event-horizon bound of ``repro_torch.core.engine._next_event``:

  * command bids + rank timing legality,
  * the per-(lane, channel) rotating-priority command arbiter,
  * the rank timing-window update (``record_issue``, rank-uniform),
  * response arbitration + respQueue push with ready&valid gating,
  * the FSM clock edge (the same network as K1) and the bank-queue pop
    bookkeeping (the head peek stays in the glue and arrives as pop rows),
  * the flow-through respQueue ack,
  * the event bound at ``cycle + 1`` on the post-edge state, giving the
    skip ``delta`` per lane.

The kernel takes ``lanes`` independent lanes (lane-major bank axis,
position = lane * B + bank); the single-lane engines call it with
``lanes=1``.

ABI (all int32; L lanes, B banks a lane, Qr respQueue capacity, F = 4
request fields, T tiers, S schedule segments, C channels, NP = 17):

  inputs   bank rows [23, L*B]: state 0-9 | qmeta 10-11 (head, count) |
           timing 12-18 (last_act, act_win0..3, last_rd, last_wr of the
           bank's rank) | pop 19-22 (head items; garbage where empty)
           resp_buf [L*Qr, F] | rp_mat [L*T*S, NP] (each lane's block is
           its own tier-major ``ParamSchedule.pack``) | bounds [L*S, 1] |
           scal [L, 8+C] = (cycle, arrival_rel, horizon, req_count,
           resp_head, resp_count, resp_limit, resp_rr, cmd_rr[C]); cycle
           and horizon are read from lane 0 (the shared batch clock)
  outputs  bank rows [22, L*B]: new_state 0-9 | flags 10-12 (want_pop,
           rw_done, completed) | qmeta2 13-14 | timing2 15-21
           (rank-uniform) | resp_buf2 [L*Qr, F] | scal2 [L, 9+2C] =
           (delta, resp_rr2, resp_head2, resp_count2, ack_valid,
           fitem[F], cmd_rr2[C], issued_cmd[C])

``fused_step`` launches the CUDA kernel (``csrc/fused.cu``) for CUDA
tensors and runs ``fused_step_plain`` — the same function written with
PyTorch ops — for CPU tensors.

``fused_run`` is the persistent form of K3 that the engines run: ONE
launch executes whole steps of ``simulate_fast``'s loop (the front end, the
FR-FCFS promotion, the cycle above, the memory phase, the records and
counters, and the skip) from the clock ``t`` to the horizon ``t_end``, or
until ``budget`` steps are spent, on the live ``SimState`` tensors in
place, and returns ``(t, steps)``: one host read per launch. With
``cycle_skip=False`` it is the per-cycle form that ``simulate`` runs: a
step every clock, no event bound, no skip. ``fused_run_cuda`` launches it;
the engine owns its plain version and the choice between the two
(``core.engine.fused_run``).

``fused_run_batch_cuda`` runs L such lanes (one topology and capacities,
each lane its own state, trace, schedule, depths and clock) in launches of
the lane-batched form, one CTA a lane, and reads every lane's ``(t,
steps)`` in one copy a launch; ``core.engine.fused_run_batch`` chooses it
or its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.bank_fsm import (
    BankState,
    compute_bids,
    cycles_until_actionable,
    fsm_update,
    wait_mask,
)
from repro_torch.core.params import (
    CMD_ACT,
    CMD_NOP,
    CMD_RD,
    CMD_WR,
    I32,
    NUM_RUNTIME_PARAMS,
    RuntimeParams,
    S_IDLE,
    S_RESP_PEND,
    S_SREF,
    SCHEDULE_INF,
    Topology,
)
from repro_torch.kernels import build

_NEG = -(1 << 20)  # dram_model's "legal since long ago"

NUM_BANK_ROWS_IN = 23    # state 10 + qmeta 2 + timing 7 + pop 4
NUM_BANK_ROWS_OUT = 22   # state 10 + flags 3 + qmeta 2 + timing 7
NUM_SCAL_IN = 8          # + channels
NUM_SCAL_OUT = 9         # + 2 * channels
#: a lane is one CTA of at most 1024 threads: one bank a thread up to 1024
#: banks, B / 1024 banks a thread above, their per-bank arrays in a scratch
#: of SCRATCH_PER_BANK bytes a bank (csrc/fused.cu K3_SCRATCH_PER_BANK)
LANE_THREADS = 1024
SCRATCH_PER_BANK = 512


def _scratch(b: int, lanes: int, device) -> Optional[torch.Tensor]:
    """The slot-array scratch of ``lanes`` lanes of ``b`` banks: none up to
    LANE_THREADS banks."""
    if b <= LANE_THREADS:
        return None
    return torch.empty((lanes * b * SCRATCH_PER_BANK,), dtype=torch.uint8,
                       device=device)


def _check_abi(topo, bank_rows, resp_buf, rp_mat, bounds, scal, lanes):
    b = topo.num_banks
    total = lanes * b
    c = topo.channels
    if bank_rows.shape != (NUM_BANK_ROWS_IN, total):
        raise ValueError(
            f"fused_step: bank rows must be [{NUM_BANK_ROWS_IN}, "
            f"{lanes}*{b}], got {tuple(bank_rows.shape)}")
    if resp_buf.dim() != 2 or resp_buf.shape[1] != 4 \
            or resp_buf.shape[0] % lanes or resp_buf.shape[0] == 0:
        raise ValueError(f"fused_step: resp_buf must be [L*Qr, 4], got "
                         f"{tuple(resp_buf.shape)}")
    s = bounds.shape[0] // lanes
    if bounds.shape != (lanes * s, 1) or s < 1:
        raise ValueError(f"fused_step: bounds must be [L*S, 1], got "
                         f"{tuple(bounds.shape)}")
    if rp_mat.shape != (lanes * topo.tiers * s, NUM_RUNTIME_PARAMS):
        raise ValueError(
            f"fused_step: rp must be [L*T*S, {NUM_RUNTIME_PARAMS}] = "
            f"[{lanes}*{topo.tiers}*{s}, {NUM_RUNTIME_PARAMS}], got "
            f"{tuple(rp_mat.shape)}")
    if scal.shape != (lanes, NUM_SCAL_IN + c):
        raise ValueError(f"fused_step: scal must be [{lanes}, "
                         f"{NUM_SCAL_IN + c}], got {tuple(scal.shape)}")
    return s


def fused_step_cuda(topo: Topology, bank_rows: torch.Tensor,
                    resp_buf: torch.Tensor, rp_mat: torch.Tensor,
                    bounds: torch.Tensor, scal: torch.Tensor,
                    lanes: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3 (CUDA tensors only). Returns (bank_rows2 [22, L*B],
    resp_buf2 [L*Qr, 4], scal2 [L, 9+2C])."""
    build.require_cuda("fused_step", bank_rows=bank_rows, resp_buf=resp_buf,
                       rp=rp_mat, bounds=bounds, scal=scal)
    s = _check_abi(topo, bank_rows, resp_buf, rp_mat, bounds, scal, lanes)
    b = topo.num_banks
    lib = build.load()["fused"]
    dev = bank_rows.device
    scratch = _scratch(b, lanes, dev)
    bank2 = torch.empty((NUM_BANK_ROWS_OUT, lanes * b), dtype=I32,
                        device=dev)
    resp2 = torch.empty_like(resp_buf)
    scal2 = torch.empty((lanes, NUM_SCAL_OUT + 2 * topo.channels),
                        dtype=I32, device=dev)
    err = lib.fused_step_launch(
        bank_rows.data_ptr(), resp_buf.data_ptr(), rp_mat.data_ptr(),
        bounds.data_ptr(), scal.data_ptr(), bank2.data_ptr(),
        resp2.data_ptr(), scal2.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), SCRATCH_PER_BANK,
        lanes, b,
        resp_buf.shape[0] // lanes, s, topo.tiers,
        topo.tier_split_bank if topo.tiers > 1 else b, topo.channels,
        topo.banks_per_channel, topo.banks_per_rank, topo.queue_size,
        topo.row_shift, build.stream_of(bank_rows))
    build.check(err, "fused_step")
    build.LAUNCHES["k3"] += 1
    return bank2, resp2, scal2


def _resolve_rp_lanes(rp_mat, bounds, cycle, lanes: int, width: int,
                      tiers: int, tier_split: int) -> RuntimeParams:
    """Each lane's parameter row of the segment governing ``cycle``,
    broadcast per position to int32[L*width] leaves (per tier at the
    static ``tier_split`` within each lane's bank block)."""
    s = rp_mat.shape[0] // (lanes * tiers)
    dev = rp_mat.device
    if s == 1 and lanes == 1 and tiers == 1:
        # one row for every position: 0-d leaves broadcast the same way
        return RuntimeParams(*rp_mat[0].unbind())
    if s == 1:
        rows = rp_mat.reshape(lanes, tiers, -1)                  # [L, T, NP]
    else:
        bnd = bounds.reshape(lanes, s)
        segs = (bnd <= cycle).to(I32).sum(dim=1) - 1
        onehot = (torch.arange(s, device=dev)[None, :]
                  == segs[:, None]).to(I32)
        rows = (rp_mat.reshape(lanes, tiers, s, -1)
                * onehot[:, None, :, None]).sum(dim=2).to(I32)
    bi = torch.arange(width, device=dev)[None, :]
    leaves = []
    for j in range(NUM_RUNTIME_PARAMS):
        col = rows[:, :, j]                                      # [L, T]
        val = col[:, 0:1].expand(lanes, width)
        for t in range(1, tiers):
            val = torch.where(bi >= tier_split, col[:, t:t + 1], val)
        leaves.append(val.reshape(lanes * width))
    return RuntimeParams(*leaves)


def _legal_at(rp, cmd, la, aw0, aw1, aw2, aw3, lr, lw):
    """Lanewise legal_issue_cycle on the per-bank timing rows."""
    oldest = torch.minimum(torch.minimum(aw0, aw1), torch.minimum(aw2, aw3))
    act_at = torch.maximum(la + rp.tRRDL, oldest + rp.tFAW)
    rd_at = torch.maximum(lr + rp.tCCDL, lw + rp.tWTR)
    wr_at = torch.maximum(lw + rp.tCCDL, lr + rp.tRTW)
    at = torch.full_like(cmd, _NEG)
    at = torch.where(cmd == CMD_ACT, act_at, at)
    at = torch.where(cmd == CMD_RD, rd_at, at)
    at = torch.where(cmd == CMD_WR, wr_at, at)
    return at.to(I32)


def fused_step_plain(topo: Topology, bank_rows: torch.Tensor,
                     resp_buf: torch.Tensor, rp_mat: torch.Tensor,
                     bounds: torch.Tensor, scal: torch.Tensor,
                     lanes: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 written with PyTorch ops: same ABI, same integer results."""
    _check_abi(topo, bank_rows, resp_buf, rp_mat, bounds, scal, lanes)
    dev = bank_rows.device
    b = topo.num_banks
    total = lanes * b
    nf = resp_buf.shape[1]
    qr = resp_buf.shape[0] // lanes
    per = topo.banks_per_channel
    channels = topo.channels
    seg_rows = lanes * channels
    split = topo.tier_split_bank if topo.tiers > 1 else 0

    def r(i):
        return bank_rows[i]

    cycle = scal[0, 0]
    horizon = scal[0, 2]
    arrival_rel = scal[:, 1]
    req_count = scal[:, 3]
    resp_head = scal[:, 4]
    resp_count = scal[:, 5]
    resp_limit = scal[:, 6]
    resp_rr = scal[:, 7]
    cmd_rr = scal[:, NUM_SCAL_IN:NUM_SCAL_IN + channels]          # [L, C]
    nxt = cycle + 1
    rp = _resolve_rp_lanes(rp_mat, bounds, cycle, lanes, b, topo.tiers,
                           split)
    rp2 = _resolve_rp_lanes(rp_mat, bounds, nxt, lanes, b, topo.tiers, split)

    bank = BankState(*[r(i) for i in range(10)])
    qhead, qcount = r(10), r(11)
    la, aw0, aw1, aw2, aw3, lr, lw = (r(i) for i in range(12, 19))
    pop_item = bank_rows[19:23].T                                 # [L*B, 4]
    queue_nonempty = qcount > 0

    # ---- phase 3: bids, legality, per-channel RR grant, record_issue -------
    _, cmds = compute_bids(bank.st, bank.cur_write)
    bids = cmds != CMD_NOP
    eligible = bids & (cycle >= _legal_at(rp, cmds, la, aw0, aw1, aw2, aw3,
                                          lr, lw))
    elig_m = eligible.reshape(seg_rows, per)
    wi = torch.arange(per, dtype=I32, device=dev)[None, :]
    ptr = cmd_rr.reshape(seg_rows, 1)
    rot = (wi - ptr) % per
    key = torch.where(elig_m, rot, per)
    m = key.min(dim=1, keepdim=True).values                       # [L*C, 1]
    any_g = m < per
    g_m = elig_m & (rot == m)
    grant = g_m.reshape(total)
    cmd_rr2 = torch.where(any_g, (ptr + m + 1) % per, ptr).reshape(
        lanes, channels)
    g_i = g_m.to(I32)
    cmd_w = (g_i * cmds.reshape(seg_rows, per)).sum(
        dim=1, keepdim=True).to(I32)                  # CMD_NOP when no grant
    issued = cmd_w.reshape(lanes, channels)
    rank_in = wi // topo.banks_per_rank
    rank_w = (g_i * rank_in).sum(dim=1, keepdim=True).to(I32)
    upd = rank_in == rank_w
    hit_act = any_g & (cmd_w == CMD_ACT) & upd
    is_rd = any_g & (cmd_w == CMD_RD) & upd
    is_wr = any_g & (cmd_w == CMD_WR) & upd

    def m2(x):
        return x.reshape(seg_rows, per)

    # tFAW window: replace the first-minimum slot (argmin tie order)
    awm = torch.minimum(torch.minimum(m2(aw0), m2(aw1)),
                        torch.minimum(m2(aw2), m2(aw3)))
    s0 = m2(aw0) == awm
    s1 = (m2(aw1) == awm) & ~s0
    s2 = (m2(aw2) == awm) & ~s0 & ~s1
    s3 = ~s0 & ~s1 & ~s2
    la2 = torch.where(hit_act, cycle, m2(la)).reshape(total)
    aw0_2 = torch.where(hit_act & s0, cycle, m2(aw0)).reshape(total)
    aw1_2 = torch.where(hit_act & s1, cycle, m2(aw1)).reshape(total)
    aw2_2 = torch.where(hit_act & s2, cycle, m2(aw2)).reshape(total)
    aw3_2 = torch.where(hit_act & s3, cycle, m2(aw3)).reshape(total)
    lr2 = torch.where(is_rd, cycle, m2(lr)).reshape(total)
    lw2 = torch.where(is_wr, cycle, m2(lw)).reshape(total)

    # ---- phase 4: response arbitration + respQueue push --------------------
    resp_full = resp_count >= resp_limit                          # [L]
    bids_r = (bank.st == S_RESP_PEND).reshape(lanes, b) & ~resp_full[:, None]
    bi = torch.arange(b, dtype=I32, device=dev)[None, :]
    rot_r = (bi - resp_rr[:, None]) % b
    key_r = torch.where(bids_r, rot_r, b)
    m_r = key_r.min(dim=1).values                                 # [L]
    any_resp = m_r < b
    accept_m = bids_r & (rot_r == m_r[:, None])
    accept = accept_m.reshape(total)
    resp_rr2 = torch.where(any_resp, (resp_rr + m_r + 1) % b, resp_rr)
    a_i = accept_m.to(I32)
    item = torch.stack([
        (a_i * bank.cur_addr.reshape(lanes, b)).sum(dim=1),
        (a_i * bank.cur_write.reshape(lanes, b)).sum(dim=1),
        (a_i * bank.cur_data.reshape(lanes, b)).sum(dim=1),
        (a_i * bank.cur_id.reshape(lanes, b)).sum(dim=1),
    ], dim=1).to(I32)                                             # [L, F]
    old = resp_buf.reshape(lanes, qr, nf)
    widx = (resp_head + resp_count) % qr                          # [L]
    qi = torch.arange(qr, dtype=I32, device=dev)[None, :]
    at_w = (qi == widx[:, None]) & any_resp[:, None]
    resp_buf2 = torch.where(at_w[:, :, None], item[:, None, :], old).reshape(
        lanes * qr, nf)
    resp_count1 = resp_count + any_resp.to(I32)

    # ---- phase 5: FSM clock edge + bank-queue pop bookkeeping --------------
    new_bank, outs = fsm_update(topo, rp, bank, grant, accept,
                                queue_nonempty, pop_item, cycle)
    wp = outs.want_pop.to(I32)
    qhead2 = (qhead + wp) % topo.queue_size
    qcount2 = qcount - wp

    # ---- phase 7: flow-through respQueue ack (Fifo.pop post-push) ----------
    ack = resp_count1 > 0                                         # [L]
    head_oh = (qi == resp_head[:, None]).to(I32)
    head_row = (old * head_oh[:, :, None]).sum(dim=1).to(I32)     # [L, F]
    fitem = torch.where((any_resp & (widx == resp_head))[:, None], item,
                        head_row)
    resp_head2 = (resp_head + ack.to(I32)) % qr
    resp_count2 = resp_count1 - ack.to(I32)

    # ---- event-horizon bound at nxt on the post-edge state -----------------
    st2 = new_bank.st
    local = cycles_until_actionable(rp2, new_bank, nxt)
    _, cmds_n = compute_bids(st2, new_bank.cur_write)
    bids_n = cmds_n != CMD_NOP
    legal_n = _legal_at(rp2, cmds_n, la2, aw0_2, aw1_2, aw2_2, aw3_2, lr2,
                        lw2)
    blocked_n = bids_n & ~(nxt >= legal_n)
    inert = (wait_mask(st2) | blocked_n
             | (((st2 == S_IDLE) | (st2 == S_SREF)) & ~(qcount2 > 0)))
    gate = inert.to(I32).reshape(lanes, b).min(dim=1).values == 1
    per_bank = torch.where(blocked_n, legal_n - nxt, local).reshape(
        lanes, b).min(dim=1).values
    bnd = bounds.reshape(lanes, -1)
    nb = torch.where(bnd > nxt, bnd, SCHEDULE_INF).min(dim=1).values
    b_val = torch.minimum(torch.minimum(per_bank, arrival_rel),
                          horizon - nxt)
    b_val = torch.minimum(b_val, nb - nxt)
    maybe = (req_count == 0) & (resp_count2 == 0)
    delta = torch.where(maybe & gate, b_val.clamp(min=0), 0)      # [L]

    bank_rows2 = torch.stack(
        list(new_bank)
        + [outs.want_pop.to(I32), outs.rw_done.to(I32),
           outs.completed.to(I32), qhead2, qcount2,
           la2, aw0_2, aw1_2, aw2_2, aw3_2, lr2, lw2]).to(I32)
    scal2 = torch.cat([
        torch.stack([delta, resp_rr2, resp_head2, resp_count2,
                     ack.to(I32)], dim=1).to(I32),
        fitem, cmd_rr2, issued,
    ], dim=1).to(I32)
    return bank_rows2, resp_buf2, scal2


def fused_step(topo: Topology, bank_rows: torch.Tensor,
               resp_buf: torch.Tensor, rp_mat: torch.Tensor,
               bounds: torch.Tensor, scal: torch.Tensor, lanes: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if bank_rows.is_cuda:
        return fused_step_cuda(topo, bank_rows, resp_buf, rp_mat, bounds,
                               scal, lanes)
    return fused_step_plain(topo, bank_rows, resp_buf, rp_mat, bounds, scal,
                            lanes)


# ---------------------------------------------------------------------------
# the persistent event-horizon kernel

#: steps one ``fused_run`` launch may take when the caller gives no budget
#: (a 100k-cycle run executes at most 100k steps: one launch)
DEFAULT_RUN_BUDGET = 1 << 20

_PTR_FIELDS = (
    "tr_t", "tr_addr", "tr_write", "tr_data", "rp", "bounds",
    "next_arrival", "req_buf", "req_head", "req_count", "req_limit",
    "bq_buf", "bq_head", "bq_count", "bq_limit",
    *[f"reg{i}" for i in range(10)],
    "last_act", "act_win", "last_rd", "last_wr", "cmd_rr", "resp_rr",
    "resp_buf", "resp_head", "resp_count", "resp_limit", "mem",
    "t_admit", "t_dispatch", "t_start", "t_complete", "rdata",
    "cmd_counts", "sref_cycles", "active_cycles", "idle_cycles",
    "seg_cycles", "tier_active_cycles", "tier_idle_cycles",
    "tier_sref_cycles", "blocked_arrival", "blocked_dispatch", "out",
    "scratch")
_INT_FIELDS = (
    # AddrGeometry (csrc/addr_decode.cuh)
    "banks_per_group", "bankgroups", "ranks", "channels", "bank_bits",
    "bankgroup_bits", "rank_bits", "row_shift", "dram_channels",
    "cxl_channels", "num_banks",
    "n", "q_cap", "req_cap", "resp_cap", "S", "T", "tier_split",
    "mem_words", "t", "t_end", "t_stop", "budget", "scratch_per_bank",
    "cycle_skip")


class _RunArgs(ctypes.Structure):
    """``FusedRunArgs`` of ``csrc/fused.cu``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


#: bytes of the parameter schedule (rows, bounds, segment counters) a
#: persistent launch holds in shared memory at most: a longer schedule runs
#: in launches over slices of it, each ending at a boundary
SCHEDULE_SLICE_BYTES = 64 * 1024


def _schedule_slice(topo: Topology, view, state, t: int):
    """``(bounds, rp rows, seg_cycles, stop)`` of a launch from clock ``t``:
    the whole schedule and no stop, or, for one of more than
    SCHEDULE_SLICE_BYTES, its segments from the one of ``t``, ``stop`` the
    boundary of the last but one. Every step of the launch (t < stop), the
    cycle after it and the boundary after that then resolve in the slice."""
    bounds, rp_mat = view.packed
    seg = state.counters["seg_cycles"]
    s = view.num_segments
    per_seg = (topo.tiers * NUM_RUNTIME_PARAMS + 2) * 4
    if s * per_seg <= SCHEDULE_SLICE_BYTES:
        return bounds, rp_mat, seg, None
    w = SCHEDULE_SLICE_BYTES // per_seg - 2   # segments a launch runs in
    s0 = view.segment_at(t)
    hi = min(s, s0 + w + 2)
    rows = rp_mat.reshape(topo.tiers, s, NUM_RUNTIME_PARAMS)[:, s0:hi]
    stop = view.bounds[s0 + w] if s0 + w < s else None
    return (bounds[s0:hi], rows.reshape(-1, NUM_RUNTIME_PARAMS).contiguous(),
            seg[s0:], stop)


def _run_tensors(topo: Topology, view, trace, state, out, t: int):
    """The tensors of ``_PTR_FIELDS`` but the scratch, by name (the
    schedule's slice of a launch from clock ``t``), and its stop."""
    bounds, rp_mat, seg, stop = _schedule_slice(topo, view, state, t)
    c = state.counters
    ten = {"tr_t": trace.t, "tr_addr": trace.addr, "tr_write": trace.is_write,
         "tr_data": trace.wdata, "rp": rp_mat, "bounds": bounds,
         "next_arrival": state.next_arrival,
         "req_buf": state.req_q.buf, "req_head": state.req_q.head,
         "req_count": state.req_q.count, "req_limit": state.req_q.limit,
         "bq_buf": state.bank_q.buf, "bq_head": state.bank_q.head,
         "bq_count": state.bank_q.count, "bq_limit": state.bank_q.limit,
         "last_act": state.timing.last_act, "act_win": state.timing.act_win,
         "last_rd": state.timing.last_rd, "last_wr": state.timing.last_wr,
         "cmd_rr": state.cmd_rr, "resp_rr": state.resp_rr,
         "resp_buf": state.resp_q.buf, "resp_head": state.resp_q.head,
         "resp_count": state.resp_q.count, "resp_limit": state.resp_q.limit,
         "mem": state.mem, "t_admit": state.t_admit,
         "t_dispatch": state.t_dispatch, "t_start": state.t_start,
         "t_complete": state.t_complete, "rdata": state.rdata,
         "blocked_arrival": state.blocked_arrival,
         "blocked_dispatch": state.blocked_dispatch, "out": out}
    ten.update({f"reg{i}": x for i, x in enumerate(state.bank)})
    ten.update({k: c[k] for k in ("cmd_counts", "sref_cycles", "active_cycles",
                                "idle_cycles", "tier_active_cycles",
                                "tier_idle_cycles", "tier_sref_cycles")})
    ten["seg_cycles"] = seg
    return ten, stop


def _run_args(topo: Topology, trace, state, tensors, t: int, t_end: int,
              t_stop: int, budget: int, scratch=None,
              cycle_skip: bool = True) -> _RunArgs:
    geo = dict(banks_per_group=topo.banks_per_group,
               bankgroups=topo.bankgroups, ranks=topo.ranks,
               channels=topo.channels, bank_bits=topo.bank_bits,
               bankgroup_bits=topo.bankgroup_bits, rank_bits=topo.rank_bits,
               row_shift=topo.row_shift, dram_channels=topo.dram_channels,
               cxl_channels=topo.cxl_channels, num_banks=topo.num_banks)
    return _RunArgs(
        **{k: v.data_ptr() for k, v in tensors.items()}, **geo,
        scratch=0 if scratch is None else scratch.data_ptr(),
        scratch_per_bank=SCRATCH_PER_BANK,
        n=trace.num_requests, q_cap=state.bank_q.capacity,
        req_cap=state.req_q.capacity, resp_cap=state.resp_q.capacity,
        S=tensors["bounds"].shape[0], T=topo.tiers,
        tier_split=topo.tier_split_bank, mem_words=topo.mem_words,
        t=int(t), t_end=int(t_end), t_stop=int(t_stop), budget=budget,
        cycle_skip=int(cycle_skip))


#: what a persistent launch may keep in place in device memory, in the order
#: it gives up shared memory (csrc/fused.cu DEV_*)
RUN_PLACEMENT = ("bank-queue rings", "response ring", "request ring",
                 "bank-queue heads and counts")


def fused_run_placement(topo: Topology, view, trace, state) -> Tuple[str, ...]:
    """The parts of a ``SimState`` that a ``fused_run_cuda`` launch keeps
    in device memory (the rest goes to the block's shared memory)."""
    out = torch.empty((2,), dtype=I32, device=state.mem.device)
    tensors, _ = _run_tensors(topo, view, trace, state, out, 0)
    build.require_cuda("fused_run", **tensors)
    args = _run_args(topo, trace, state, tensors, 0, 1, 1, 1)
    bits = build.load()["fused"].fused_run_placement_query(
        ctypes.byref(args))
    return tuple(p for i, p in enumerate(RUN_PLACEMENT) if bits >> i & 1)


def fused_run_cuda(topo: Topology, view, trace, state, t: int, t_end: int,
                   budget: Optional[int] = None, cycle_skip: bool = True
                   ) -> Tuple[int, int]:
    """Launch the persistent K3 on a ``SimState`` on the card: executed
    steps from clock ``t`` until ``t_end`` (the horizon) or ``budget``
    steps, in place (a schedule longer than a launch holds also ends the
    launch at the end of its slice). ``cycle_skip=False`` launches the
    per-cycle form: one step every clock, counted under ``"k3cyc"``.
    Returns ``(t, steps)`` (one host read)."""
    budget = DEFAULT_RUN_BUDGET if budget is None else int(budget)
    if budget < 1:
        raise ValueError(f"fused_run: budget={budget} must be >= 1")
    if trace.num_requests < 1:
        # what the reference does: its first read of the trace is out of
        # bounds
        raise IndexError("fused_run: index is out of bounds for the trace, "
                         "which holds no request")
    out = torch.empty((2,), dtype=I32, device=state.mem.device)
    tensors, stop = _run_tensors(topo, view, trace, state, out, t)
    build.require_cuda("fused_run", **tensors)
    if t >= t_end:
        return t, 0
    scratch = _scratch(topo.num_banks, 1, out.device)
    t_stop = t_end if stop is None else min(t_end, stop)
    args = _run_args(topo, trace, state, tensors, t, t_end, t_stop, budget,
                     scratch, cycle_skip)
    lib = build.load()["fused"]
    err = lib.fused_run_launch(ctypes.byref(args), build.stream_of(out))
    build.check(err, "fused_run")
    build.LAUNCHES["k3run" if cycle_skip else "k3cyc"] += 1
    t2, steps = out.tolist()  # the one host read of the launch
    return t2, steps


# ---------------------------------------------------------------------------
# the lane-batched persistent kernel: one CTA a lane

def _batch_lib():
    """The fused library, its ``FusedRunArgs`` checked against ``_RunArgs``
    (a batch passes an array of them)."""
    lib = build.load()["fused"]
    c_bytes = lib.fused_run_args_bytes()
    if c_bytes != ctypes.sizeof(_RunArgs):
        raise RuntimeError(
            f"fused_run_batch: FusedRunArgs is {c_bytes} bytes in "
            f"csrc/fused.cu, {ctypes.sizeof(_RunArgs)} in _RunArgs")
    return lib


def _batch_args(topo: Topology, views, traces, states, lanes, ts,
                t_end: int, budget: int, scratch, outs, cycle_skip: bool):
    """The host array of the ``_RunArgs`` of ``lanes`` (lane ``lanes[j]``
    writes its ``(t, steps)`` to ``outs[j]``) and the tensors it points
    to, which must live until the launch has ended."""
    args, keep = [], []
    for j, i in enumerate(lanes):
        tensors, stop = _run_tensors(topo, views[i], traces[i], states[i],
                                     outs[j], ts[i])
        build.require_cuda("fused_run_batch", **tensors)
        t_stop = t_end if stop is None else min(t_end, stop)
        args.append(_run_args(topo, traces[i], states[i], tensors, ts[i],
                              t_end, t_stop, budget, scratch[i], cycle_skip))
        keep.append(tensors)
    return (_RunArgs * len(args))(*args), keep


def _batch_scratch(topo: Topology, n: int, device):
    return [_scratch(topo.num_banks, 1, device) for _ in range(n)]


def _batch_query(entry: str, topo: Topology, views, traces, states,
                 cycle_skip: bool) -> int:
    """``entry`` of the fused library on the host array of a launch of
    these lanes from reset."""
    n = len(states)
    dev = states[0].mem.device
    outs = torch.empty((n, 2), dtype=I32, device=dev)
    host, _ = _batch_args(topo, views, traces, states, range(n), [0] * n, 1,
                          1, _batch_scratch(topo, n, dev), outs, cycle_skip)
    return getattr(_batch_lib(), entry)(ctypes.byref(host), n)


def fused_run_batch_placement(topo: Topology, views, traces, states
                              ) -> Tuple[str, ...]:
    """The parts of each lane's ``SimState`` that a ``fused_run_batch_cuda``
    launch of these lanes keeps in device memory (every lane of a launch
    keeps the same parts)."""
    bits = _batch_query("fused_run_batch_placement_query", topo, views,
                        traces, states, True)
    if bits < 0:
        raise ValueError("fused_run_batch: the lanes cannot share a launch")
    return tuple(p for i, p in enumerate(RUN_PLACEMENT) if bits >> i & 1)


def fused_run_batch_occupancy(topo: Topology, views, traces, states,
                              cycle_skip: bool = True) -> int:
    """The lanes (CTAs) of a ``fused_run_batch_cuda`` launch of these lanes
    that one SM runs at once, at the launch's threads and shared memory."""
    per_sm = _batch_query("fused_run_batch_occupancy", topo, views, traces,
                          states, cycle_skip)
    build.check(min(per_sm, 0), "fused_run_batch occupancy")
    return per_sm


def preload_batch_forms() -> None:
    """Load every form of the lane-batched K3 into the current card's context
    before launches that run concurrently: the runtime loads a kernel at
    its first use, and a load may wait until the card is idle, so a form
    first launched while other launches run would start after they end."""
    build.check(_batch_lib().fused_run_batch_preload(),
                "fused_run_batch preload")


class FusedRunBatch:
    """The launch protocol of the lane-batched persistent K3 on the card
    (:func:`fused_run_batch_cuda`), one launch at a time: L lanes of one
    topology and capacities, each from its clock (``t[i]``, default 0) to
    the horizon ``t_end``, in place. ``launch`` enqueues a launch of every
    lane that has not reached the horizon on the current stream and
    returns at once (the launch's arguments, scratch and ``(t, steps)``
    rows are kept until it is read); ``read`` waits for it, with the one
    host read of the launch, and advances each lane's clock and steps;
    ``finish`` reads a pending launch and relaunches the lanes left,
    compacted, until every lane has reached the horizon or
    ``max_launches`` have run. A launch runs a lane for at most ``budget``
    steps and to the end of its schedule slice."""

    def __init__(self, topo: Topology, views, traces, states, t_end: int,
                 budget: Optional[int] = None, cycle_skip: bool = True,
                 t=None, max_launches: Optional[int] = None):
        budget = DEFAULT_RUN_BUDGET if budget is None else int(budget)
        if budget < 1:
            raise ValueError(f"fused_run_batch: budget={budget} must be >= 1")
        n = len(states)
        if len(views) != n or len(traces) != n:
            raise ValueError(
                "fused_run_batch: one view and one trace per state")
        if any(tr.num_requests < 1 for tr in traces):
            raise IndexError("fused_run: index is out of bounds for the "
                             "trace, which holds no request")
        self.lanes = (topo, views, traces, states)
        self.t_end, self.budget, self.cycle_skip = t_end, budget, cycle_skip
        self.max_launches = max_launches
        self.ts = [0] * n if t is None else [int(x) for x in t]
        self.steps = [0] * n
        self.launches = 0
        self.active = [i for i in range(n) if self.ts[i] < t_end]
        self.scratch = (_batch_scratch(topo, n, states[0].mem.device)
                        if n else [])
        self._pending = None

    def launch(self) -> None:
        topo, views, traces, states = self.lanes
        dev = states[0].mem.device
        outs = torch.empty((len(self.active), 2), dtype=I32, device=dev)
        host, keep = _batch_args(topo, views, traces, states, self.active,
                                 self.ts, self.t_end, self.budget,
                                 self.scratch, outs, self.cycle_skip)
        lib = _batch_lib()  # built once every tensor is checked
        lanes_dev = torch.frombuffer(bytearray(host),
                                     dtype=torch.uint8).to(dev)
        err = lib.fused_run_batch_launch(ctypes.byref(host),
                                         lanes_dev.data_ptr(),
                                         len(self.active),
                                         build.stream_of(outs))
        build.check(err, "fused_run_batch")
        build.LAUNCHES["k3batch"] += 1
        self.launches += 1
        self._pending = (outs, keep, lanes_dev)

    def read(self) -> None:
        outs = self._pending[0]
        # the one host read of the launch: every lane's (t, steps)
        for i, (t2, k) in zip(self.active, outs.tolist()):
            self.ts[i] = t2
            self.steps[i] += k
        self._pending = None
        self.active = [i for i in self.active if self.ts[i] < self.t_end]

    def finish(self) -> Tuple[list, list, int]:
        """Returns (the clock of each lane, its executed steps, launches)."""
        if self._pending is not None:
            self.read()
        while self.active and self.launches != self.max_launches:
            self.launch()
            self.read()
        return self.ts, self.steps, self.launches


def fused_run_batch_cuda(topo: Topology, views, traces, states, t_end: int,
                         budget: Optional[int] = None,
                         cycle_skip: bool = True, t=None,
                         max_launches: Optional[int] = None
                         ) -> Tuple[list, list, int]:
    """Run L lanes of one topology and capacities on the card, each from
    its clock (``t[i]``, default 0) to the horizon ``t_end``, in place, by
    launches of the lane-batched persistent K3 (:class:`FusedRunBatch`):
    one CTA a lane, each lane with its own ``ScheduleView``, trace,
    ``SimState``, scratch and ``(t, steps)`` row. A launch runs every lane
    that has not reached the horizon for at most ``budget`` steps (and to
    the end of its schedule slice); the host reads every lane's
    ``(t, steps)`` in one copy and relaunches the lanes left, compacted.
    ``cycle_skip=False`` is the per-cycle form; ``max_launches`` stops the
    protocol after that many launches. Launches count under
    ``"k3batch"``. Returns (the clock of each lane, its executed steps,
    launches)."""
    return FusedRunBatch(topo, views, traces, states, t_end, budget,
                         cycle_skip, t, max_launches).finish()
