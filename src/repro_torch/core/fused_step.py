"""Glue around the fused hot-loop kernel K3: ONE kernel per executed cycle.

``fused_cycle_step`` is the ``fsm_backend == "fused"`` twin of
``repro_torch.core.simulator.cycle_step`` plus the event-horizon bound of
``repro_torch.core.engine._next_event``. The front-end phases (trace
admission and dispatch), the FR-FCFS promotion and the per-request
record and memory scatters stay in PyTorch around the kernel; they are the
same helpers ``cycle_step`` uses. ``engine.fused_run_plain``, the plain
version of K3's persistent form, runs it with ``fused_step_plain``, for
``simulate_fast`` and (with ``horizon = cycle + 1``) for the per-cycle
``simulate``; on the card both engines do all of this inside that
persistent kernel, and ``cycle_step`` on a fused topology still runs it
with the per-step K3.

It returns ``(new_state, delta)``, ``delta`` a 0-d device tensor: the
exact skip the unfused engine would compute, 0 unless the whole machine is
provably inert through ``cycle + 1 + delta``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import power as power_lib
from repro_torch.core.dram_model import TimingState
from repro_torch.core.indexing import fill_at_, take
from repro_torch.core.params import I32, Topology
from repro_torch.core.queues import BankedFifo, Fifo
from repro_torch.core.simulator import (
    ScheduleView,
    SimState,
    Trace,
    _frontend_phases,
    _memory_phase,
    _promote_frfcfs,
)
from repro_torch.kernels.bank_fsm.fused import NUM_SCAL_OUT, fused_step
from repro_torch.kernels.bank_fsm.ref import pack_state, unpack_state

_INF = 0x3FFFFFFF


def _scalar(x, device) -> torch.Tensor:
    """A host int or 0-d tensor as a 0-d int32 device tensor."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(I32)
    return torch.full((), int(x), dtype=I32, device=device)


def _pre(topo: Topology, view: ScheduleView, trace: Trace, state: SimState,
         cycle, horizon, seg: int):
    """Front-end glue + kernel operand packing (single lane)."""
    rp = view.host[seg]
    n = trace.num_requests
    dev = state.mem.device
    nxt = cycle + 1

    (req_q, bank_q, t_admit, t_dispatch, next_arrival, blocked_arrival,
     blocked_dispatch) = _frontend_phases(topo, trace, state, cycle, rp)
    bank_q = _promote_frfcfs(topo, rp, bank_q, state.bank.open_row)

    rob = view.rank_of_bank.long()
    tm = state.timing
    # head PEEK in glue; the pop bookkeeping runs in-kernel on qmeta rows
    pop_items, _ = bank_q.peek_valid()
    bank_rows = torch.cat([
        pack_state(state.bank),
        torch.stack([bank_q.head, bank_q.count, tm.last_act[rob]]),
        tm.act_win[rob].T,
        torch.stack([tm.last_rd[rob], tm.last_wr[rob]]),
        pop_items.T,
    ]).contiguous()
    bounds, rp_mat = view.packed
    # next-arrival distance from nxt, post-admission
    idx = next_arrival.clamp(max=n - 1)
    arrival_rel = torch.where(next_arrival < n, take(trace.t, idx) - nxt,
                              _INF)
    scal = torch.cat([
        torch.stack([
            _scalar(cycle, dev), arrival_rel, _scalar(horizon, dev),
            req_q.count, state.resp_q.head, state.resp_q.count,
            state.resp_q.limit, state.resp_rr,
        ]),
        state.cmd_rr,
    ]).reshape(1, -1)

    ops = (bank_rows, state.resp_q.buf, rp_mat, bounds, scal)
    ctx = (req_q, bank_q, t_admit, t_dispatch, next_arrival, blocked_arrival,
           blocked_dispatch, seg)
    return ops, ctx


def _post(topo: Topology, view: ScheduleView, n: int, state: SimState,
          cycle: int, ctx, outs) -> Tuple[SimState, torch.Tensor]:
    """Unpack the kernel outputs + the remaining glue (record and memory
    scatters, counters). ``outs`` has the scalar block as a flat row."""
    (req_q, bank_q, t_admit, t_dispatch, next_arrival, blocked_arrival,
     blocked_dispatch, seg) = ctx
    bank2, resp_buf2, scal_row = outs
    new_bank = unpack_state(bank2[:10])
    want_pop = bank2[10] == 1
    rw_done = bank2[11] == 1
    bank_q = BankedFifo(buf=bank_q.buf, head=bank2[13], count=bank2[14],
                        limit=bank_q.limit)
    sel = bank2[15:22, ::topo.banks_per_rank]            # [7, R] rank-uniform
    timing = TimingState(last_act=sel[0], act_win=sel[1:5].T.contiguous(),
                         last_rd=sel[5], last_wr=sel[6])
    delta = scal_row[0]
    resp_q = Fifo(buf=resp_buf2, head=scal_row[2], count=scal_row[3],
                  limit=state.resp_q.limit)
    ack_valid = scal_row[4] == 1
    c = topo.channels
    cmd_rr = scal_row[NUM_SCAL_OUT:NUM_SCAL_OUT + c]
    issued_cmds = scal_row[NUM_SCAL_OUT + c:NUM_SCAL_OUT + 2 * c]

    # where a bank popped, the FSM latched the popped item into its cur_*
    # registers this edge, so the new cur_id IS the popped request id
    fill_at_(state.t_start, torch.where(want_pop, new_bank.cur_id, n), cycle)
    mem, rdata = _memory_phase(topo, n, state.bank, state.mem, state.rdata,
                               rw_done)
    fill_at_(state.t_complete, torch.where(ack_valid, scal_row[8], n), cycle)
    counters = power_lib.update_counters(state.counters, issued_cmds,
                                         state.bank.st, seg,
                                         tier_idx=view.tier_idx)

    new_state = SimState(
        next_arrival=next_arrival, req_q=req_q, bank_q=bank_q,
        bank=new_bank, timing=timing, cmd_rr=cmd_rr, resp_rr=scal_row[1],
        resp_q=resp_q, mem=mem, t_admit=t_admit, t_dispatch=t_dispatch,
        t_start=state.t_start, t_complete=state.t_complete, rdata=rdata,
        counters=counters, blocked_arrival=blocked_arrival,
        blocked_dispatch=blocked_dispatch,
    )
    return new_state, delta


def fused_cycle_step(topo: Topology, view: ScheduleView, trace: Trace,
                     state: SimState, cycle, horizon, seg=None,
                     kernel=fused_step) -> Tuple[SimState, torch.Tensor]:
    """One synchronous clock edge + the event bound at ``cycle + 1`` with
    exactly one kernel launch. ``cycle`` is a host int or a 0-d device
    tensor (then ``seg``, its schedule segment, is required); ``horizon``
    caps the skip — pass ``cycle + 1`` to force ``delta = 0``. ``kernel``
    is K3's entry point (``fused_step_plain`` for the plain version on any
    device)."""
    if seg is None:
        seg = view.segment_at(cycle)
    ops, ctx = _pre(topo, view, trace, state, cycle, horizon, seg)
    bank2, resp_buf2, scal2 = kernel(topo, *ops)
    return _post(topo, view, trace.num_requests, state, cycle, ctx,
                 (bank2, resp_buf2, scal2[0]))
