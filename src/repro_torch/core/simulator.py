"""MemorySim top level (paper §5.1): trace front-end -> controller -> banks.

PyTorch counterpart of ``repro.core.simulator``. ``cycle_step`` is the
combinational logic of one clock edge, :class:`SimState` the register file,
and a Python loop over cycles the clock. Request life-cycle:

  1. trace lists R = {addr, t}
  2. at cycle t, R is pushed into the global reqQueue (stall = backpressure)
  3. the controller forwards it to its bank scheduler's local queue
  4. the bank FSM drives ACTIVATE -> READ/WRITE -> PRECHARGE against the
     DRAM timing model (closed- or open-page policy, refresh deadlines)
  5. the completion token is round-robin collected into respQueue and acked
     to the front-end; latency = ack_cycle - t.

Differences from the JAX reference, none of them visible in results:

* The loop's clock is a host ``int``; the step never waits for the device
  (the event-horizon engine reads one value per executed cycle, the skip).
  On the fused backend (the default) both engines run K3's persistent
  form instead, which keeps the clock on the card: ``simulate`` one launch
  of its per-cycle form per run (per 2^20 cycles and per schedule slice).
  Choices that depend only on the cycle's schedule segment (its
  parameters, the FR-FCFS branch) are taken on the host through a
  :class:`ScheduleView`. On the card the split and plain backends replay
  each cycle as a CUDA graph (``repro_torch.core.graphs``); the step then
  reads the cycle from a 0-d device tensor, which every function of the
  step accepts in place of the host int.
* Large buffers are updated in place: the queue buffers, the backing store
  ``mem`` and the per-request records. ``_memory_phase`` keeps the
  reference's write order (scatter the writes, then gather the reads from
  the written image).
* JAX drops out-of-range scatter indices; PyTorch does not. The per-request
  records carry one extra trailing slot and ``mem`` one extra trailing word
  that masked-off writes land in (``SimState`` shapes ``[N + 1]`` and
  ``[mem_words + 1]``); :func:`state_to_result` and ``interop`` strip them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import graphs as graphs_lib
from repro_torch.core import power as power_lib
from repro_torch.core.bank_fsm import (
    BankState,
    FsmOutputs,
    compute_bids,
    fsm_update,
    row_of,
)
from repro_torch.core.dram_model import (
    TimingState,
    decode_address,
    legal_issue_cycle,
    record_issue,
)
from repro_torch.core.indexing import fill_at_, take
from repro_torch.core.params import (
    CMD_NOP,
    I32,
    SCHED_FRFCFS,
    SCHEDULE_INF,
    MemSimConfig,
    ParamSchedule,
    RuntimeParams,
    S_RESP_PEND,
    Topology,
    _np,
    as_schedule,
    tier_of_bank,
)
from repro_torch.core.queues import (
    BankedFifo,
    Fifo,
    rr_arbiter,
    rr_arbiter_grouped,
)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the CUDA card, and
    raises when there is none (the entry points never fall back to the
    CPU on their own: pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "simulator on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Trace(NamedTuple):
    """A standalone memory trace: request i must issue at cycle t[i]."""

    t: torch.Tensor         # [N] int32, sorted non-decreasing
    addr: torch.Tensor      # [N] int32 word address
    is_write: torch.Tensor  # [N] int32 {0, 1}
    wdata: torch.Tensor     # [N] int32 payload for writes

    @property
    def num_requests(self) -> int:
        return self.t.shape[0]

    @staticmethod
    def from_numpy(t, addr, is_write, wdata=None) -> "Trace":
        """A CPU trace from host arrays, stably sorted by arrival."""
        t = np.asarray(t, np.int32)
        if wdata is None:
            wdata = np.zeros_like(t)
        order = np.argsort(t, kind="stable")

        def col(x):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(x, np.int32)[order]))

        return Trace(t=col(t), addr=col(addr), is_write=col(is_write),
                     wdata=col(wdata))

    def to(self, device) -> "Trace":
        return Trace(*[x.to(device) for x in self])


class SimState(NamedTuple):
    next_arrival: torch.Tensor       # 0-d: index of next trace entry to admit
    req_q: Fifo                      # global request queue
    bank_q: BankedFifo               # per-bank scheduler queues
    bank: BankState
    timing: TimingState
    cmd_rr: torch.Tensor             # [C] per-channel command arbiter pointers
    resp_rr: torch.Tensor            # 0-d response arbiter pointer
    resp_q: Fifo
    mem: torch.Tensor                # [mem_words + 1] backing store + sink
    # per-request records, [N + 1] (last slot: write sink); -1 = not yet
    t_admit: torch.Tensor
    t_dispatch: torch.Tensor
    t_start: torch.Tensor
    t_complete: torch.Tensor
    rdata: torch.Tensor
    # aggregate counters
    counters: Dict[str, torch.Tensor]
    blocked_arrival: torch.Tensor    # cycles an arrival stalled on full reqQueue
    blocked_dispatch: torch.Tensor   # cycles dispatch stalled on a full bank queue


@dataclasses.dataclass
class SimResult:
    """Host-side result bundle (numpy)."""

    cfg: MemSimConfig
    num_cycles: int
    t_intended: np.ndarray
    is_write: np.ndarray
    t_admit: np.ndarray
    t_dispatch: np.ndarray
    t_start: np.ndarray
    t_complete: np.ndarray
    rdata: np.ndarray
    counters: Dict[str, np.ndarray]
    blocked_arrival: int
    blocked_dispatch: int

    @property
    def completed(self) -> np.ndarray:
        return self.t_complete >= 0

    @property
    def latency(self) -> np.ndarray:
        """In-system latency (admission -> ack), the paper's accounting."""
        return np.where(self.completed, self.t_complete - self.t_admit, -1)

    @property
    def e2e_latency(self) -> np.ndarray:
        """Intended-issue -> ack (includes pre-admission stall)."""
        return np.where(self.completed, self.t_complete - self.t_intended, -1)


class ScheduleView:
    """A :class:`ParamSchedule` resolved for a loop whose clock is a host
    int: segment boundaries on the host, each segment's parameters both as
    host ints (tier 0; the tier-uniform glue fields) and as device tensors
    resolved per bank (what the PyTorch networks consume), and the packed
    kernel ABI ``(bounds [S, 1], rp [T*S, NP])`` on the device."""

    def __init__(self, topo: Topology, sched, device):
        sched = as_schedule(sched)
        self.sched = sched
        self.device = torch.device(device)
        self.num_segments = s = sched.num_segments
        self.bounds = [int(x) for x in _np(sched.boundaries).reshape(-1)]
        bounds, rp_mat = sched.pack()
        self.packed = (bounds.to(self.device).contiguous(),
                       rp_mat.to(self.device).contiguous())
        vals = _np(rp_mat).astype(np.int64)                      # [T*S, NP]
        t = vals.shape[0] // s
        self.host = [RuntimeParams(*[int(v) for v in vals[i]])
                     for i in range(s)]
        tiers = tier_of_bank(topo)
        self.dev: List[RuntimeParams] = []
        for i in range(s):
            if t == 1:
                leaves = [torch.tensor(int(v), dtype=I32, device=self.device)
                          for v in vals[i]]
            else:
                per_bank = vals[tiers * s + i]                   # [B, NP]
                leaves = [torch.tensor(per_bank[:, j], dtype=I32,
                                       device=self.device)
                          for j in range(per_bank.shape[1])]
            self.dev.append(RuntimeParams(*leaves))
        self.tier_idx = (torch.tensor(tiers, dtype=I32, device=self.device)
                         if topo.tiers > 1 else None)
        self.rank_of_bank = torch.arange(
            topo.num_banks, dtype=I32, device=self.device) // topo.banks_per_rank

    def segment_at(self, cycle: int) -> int:
        if self.num_segments == 1:
            return 0
        return sum(b <= cycle for b in self.bounds) - 1

    def boundary_after(self, seg: int) -> int:
        """First boundary after every cycle of segment ``seg``
        (``SCHEDULE_INF`` for the last): ``ParamSchedule.next_boundary(c)``
        for any cycle ``c`` in the segment."""
        return self.bounds[seg + 1] if seg + 1 < self.num_segments \
            else SCHEDULE_INF


def init_state(topo: Topology, sched, num_requests: int,
               queue_limit=None, resp_queue_limit=None,
               device=None) -> SimState:
    """Initial register file on ``device``. ``sched`` is a
    :class:`ParamSchedule`, a :class:`RuntimeParams` or a
    :class:`ScheduleView`; only its cycle-0 ``tREFI`` is read."""
    sched = sched.sched if isinstance(sched, ScheduleView) else \
        as_schedule(sched)
    rp0 = sched.params_at(0)

    def neg():
        return torch.full((num_requests + 1,), -1, dtype=I32, device=device)

    return SimState(
        next_arrival=torch.zeros((), dtype=I32, device=device),
        req_q=Fifo.make(topo.queue_size, limit=queue_limit, device=device),
        bank_q=BankedFifo.make(topo.num_banks, topo.queue_size,
                               limit=queue_limit, device=device),
        bank=BankState.make(topo, rp0, device=device),
        timing=TimingState.make(topo, device=device),
        cmd_rr=torch.zeros((topo.channels,), dtype=I32, device=device),
        resp_rr=torch.zeros((), dtype=I32, device=device),
        resp_q=Fifo.make(topo.resp_queue_size, limit=resp_queue_limit,
                         device=device),
        mem=torch.zeros((topo.mem_words + 1,), dtype=I32, device=device),
        t_admit=neg(),
        t_dispatch=neg(),
        t_start=neg(),
        t_complete=neg(),
        rdata=torch.zeros((num_requests + 1,), dtype=I32, device=device),
        counters=power_lib.make_counters(topo.num_banks, sched.num_segments,
                                         topo.tiers, device=device),
        blocked_arrival=torch.zeros((), dtype=I32, device=device),
        blocked_dispatch=torch.zeros((), dtype=I32, device=device),
    )


def issue_eligibility(topo: Topology, view: ScheduleView,
                      timing: TimingState, bank: BankState, cycle,
                      seg: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The one issue-eligibility predicate: ``(eligible bool[B], cmds
    int32[B], legal_at int32[B])`` with ``eligible = bidding & (cycle >=
    legal_at)``, judged under the parameters governing ``cycle`` (segment
    ``seg``, resolved from a host ``cycle`` when omitted)."""
    if seg is None:
        seg = view.segment_at(cycle)
    bids, cmds = compute_bids(bank.st, bank.cur_write)
    legal_at = legal_issue_cycle(view.dev[seg], timing, cmds,
                                 view.rank_of_bank)
    eligible = bids & (legal_at <= cycle)
    return eligible, cmds, legal_at


def _frontend_phases(topo: Topology, trace: Trace, state: SimState,
                     cycle, rp: RuntimeParams = None):
    """Phases 1-2: trace admission into the global reqQueue and dispatch of
    its head into the target bank queue (stamps ``t_admit`` /
    ``t_dispatch`` in place). Returns ``(req_q, bank_q, t_admit,
    t_dispatch, next_arrival, blocked_arrival, blocked_dispatch)``."""
    n = trace.num_requests

    # ---- phase 1: front-end arrival into reqQueue (1 request / cycle) -----
    idx = state.next_arrival.clamp(max=n - 1)
    due = (state.next_arrival < n) & (take(trace.t, idx) <= cycle)
    can_admit = due & ~state.req_q.full()
    item = torch.stack([take(trace.addr, idx), take(trace.is_write, idx),
                        take(trace.wdata, idx), idx])
    req_q = state.req_q.push(item, can_admit)
    fill_at_(state.t_admit, torch.where(can_admit, idx, n), cycle)
    next_arrival = state.next_arrival + can_admit.to(I32)
    blocked_arrival = state.blocked_arrival + (due & ~can_admit).to(I32)

    # ---- phase 2: dispatch reqQueue head -> bank scheduler queue -----------
    head = req_q.peek()
    tgt_bank, _, _ = decode_address(topo, head[0], rp)
    have_req = ~req_q.empty()
    tgt_full = take(state.bank_q.full(), tgt_bank)
    do_dispatch = have_req & ~tgt_full
    req_q, ditem = req_q.pop(do_dispatch)
    bank_q = state.bank_q.push_at(tgt_bank, ditem, do_dispatch)
    fill_at_(state.t_dispatch, torch.where(do_dispatch, ditem[3], n), cycle)
    blocked_dispatch = state.blocked_dispatch + (have_req & tgt_full).to(I32)
    return (req_q, bank_q, state.t_admit, state.t_dispatch, next_arrival,
            blocked_arrival, blocked_dispatch)


def _promote_frfcfs(topo: Topology, rp: RuntimeParams, bank_q: BankedFifo,
                    open_row: torch.Tensor) -> BankedFifo:
    """FR-FCFS: promote the oldest row-hit to each bank queue's head. The
    policy flag is a host int of the active segment, so FCFS cycles skip
    the promotion network (the reference's ``lax.cond``)."""
    if int(rp.sched_policy) != SCHED_FRFCFS:
        return bank_q
    q = bank_q.capacity
    offs = (bank_q.head[:, None]
            + torch.arange(q, dtype=I32, device=bank_q.buf.device)[None, :]
            ) % q
    addrs = torch.gather(bank_q.buf[..., 0], 1, offs.long())
    return bank_q.promote_rowhit(open_row, row_of(topo, addrs))


def _memory_phase(topo: Topology, n: int, old_bank: BankState,
                  mem: torch.Tensor, rdata: torch.Tensor,
                  rw_done: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 6: bit-true memory access on column completion, on the
    pre-edge bank registers, in place. Writes land first, then reads gather
    from the written image (banks never alias a word within a cycle)."""
    maddr = old_bank.cur_addr & (topo.mem_words - 1)
    is_wr = old_bank.cur_write == 1
    widx = torch.where(rw_done & is_wr, maddr, topo.mem_words)
    mem.index_put_((widx.long(),), old_bank.cur_data)
    rvals = mem[maddr.long()]
    ridx = torch.where(rw_done & ~is_wr, old_bank.cur_id, n)
    rdata.index_put_((ridx.long(),), rvals)
    return mem, rdata


def cycle_step(topo: Topology, view: ScheduleView, trace: Trace,
               state: SimState, cycle, seg: Optional[int] = None
               ) -> SimState:
    """One synchronous clock edge at ``cycle`` — a host int, or a 0-d
    device tensor (CUDA-graph replay) with its segment ``seg`` given.
    Every parameter consumed is the one governing ``cycle``.

    With ``topo.fsm_backend == "fused"`` the whole edge after the front-end
    runs through the fused kernel K3; the event bound it also computes is
    discarded here."""
    if seg is None:
        seg = view.segment_at(cycle)
    if topo.fsm_backend == "fused":
        from repro_torch.core.fused_step import fused_cycle_step

        new_state, _ = fused_cycle_step(topo, view, trace, state, cycle,
                                        cycle + 1, seg)
        return new_state

    rp = view.host[seg]
    rp_b = view.dev[seg]
    n = trace.num_requests
    b = topo.num_banks
    per = topo.banks_per_channel

    (req_q, bank_q, t_admit, t_dispatch, next_arrival, blocked_arrival,
     blocked_dispatch) = _frontend_phases(topo, trace, state, cycle, rp)

    # ---- phase 3: command bids, timing legality, per-channel RR grant ------
    eligible, cmds, _ = issue_eligibility(topo, view, state.timing,
                                          state.bank, cycle, seg)
    grant_mask, winners, cmd_rr = rr_arbiter_grouped(eligible, state.cmd_rr,
                                                     topo.channels)
    timing = state.timing
    issued = []
    elig_c = eligible.reshape(topo.channels, per)
    for ch in range(topo.channels):  # static unroll; channels is small
        flat_w = winners[ch] + ch * per
        granted = elig_c[ch].any()
        cmd_w = torch.where(granted, take(cmds, flat_w), CMD_NOP)
        timing = record_issue(timing, cycle, cmd_w,
                              take(view.rank_of_bank, flat_w), granted)
        issued.append(cmd_w)
    issued_cmds = torch.stack(issued)

    # ---- phase 4: response arbitration into respQueue ----------------------
    resp_bids = (state.bank.st == S_RESP_PEND) & ~state.resp_q.full()
    resp_w, any_resp, resp_rr = rr_arbiter(resp_bids, state.resp_rr)
    resp_accept = (torch.arange(b, dtype=I32, device=resp_w.device)
                   == resp_w) & any_resp
    bk = state.bank
    resp_item = torch.stack([take(bk.cur_addr, resp_w),
                             take(bk.cur_write, resp_w),
                             take(bk.cur_data, resp_w),
                             take(bk.cur_id, resp_w)])
    resp_q = state.resp_q.push(resp_item, any_resp)

    # ---- phase 5: synchronous FSM update + bank queue pops -----------------
    bank_q = _promote_frfcfs(topo, rp, bank_q, state.bank.open_row)
    pop_items, queue_nonempty = bank_q.peek_valid()
    if topo.fsm_backend == "split":
        from repro_torch.kernels.bank_fsm.ops import bank_fsm_step
        from repro_torch.kernels.bank_fsm.ref import pack_state, unpack_state

        ins = torch.stack([grant_mask, resp_accept, queue_nonempty]).to(I32)
        new_packed, flags = bank_fsm_step(
            topo, pack_state(state.bank), ins, pop_items.T.contiguous(),
            cycle, view.packed)
        new_bank = unpack_state(new_packed)
        outs = FsmOutputs(want_pop=flags[0] == 1, rw_done=flags[1] == 1,
                          completed=flags[2] == 1, started=flags[0] == 1)
    else:
        new_bank, outs = fsm_update(topo, rp_b, state.bank, grant_mask,
                                    resp_accept, queue_nonempty, pop_items,
                                    cycle)
    bank_q, _ = bank_q.pop_mask(outs.want_pop)
    fill_at_(state.t_start, torch.where(outs.want_pop, pop_items[:, 3], n),
             cycle)

    # ---- phase 6: bit-true memory access on column completion --------------
    mem, rdata = _memory_phase(topo, n, state.bank, state.mem, state.rdata,
                               outs.rw_done)

    # ---- phase 7: respQueue -> front-end ack (flow-through) -----------------
    ack_valid = ~resp_q.empty()
    resp_q, fitem = resp_q.pop(ack_valid)
    fill_at_(state.t_complete, torch.where(ack_valid, fitem[3], n), cycle)

    # ---- phase 8: counters ---------------------------------------------------
    counters = power_lib.update_counters(state.counters, issued_cmds,
                                         state.bank.st, seg,
                                         tier_idx=view.tier_idx)

    return SimState(
        next_arrival=next_arrival, req_q=req_q, bank_q=bank_q,
        bank=new_bank, timing=timing, cmd_rr=cmd_rr, resp_rr=resp_rr,
        resp_q=resp_q, mem=mem, t_admit=t_admit, t_dispatch=t_dispatch,
        t_start=state.t_start, t_complete=state.t_complete, rdata=rdata,
        counters=counters, blocked_arrival=blocked_arrival,
        blocked_dispatch=blocked_dispatch,
    )


def state_to_result(cfg: MemSimConfig, trace: Trace, final: SimState,
                    num_cycles: int) -> SimResult:
    """Copy a final state to the host-side result bundle (sink slots
    stripped)."""
    n = trace.num_requests

    def rec(x):
        return x[:n].cpu().numpy()

    return SimResult(
        cfg=cfg,
        num_cycles=num_cycles,
        t_intended=trace.t.cpu().numpy(),
        is_write=trace.is_write.cpu().numpy(),
        t_admit=rec(final.t_admit),
        t_dispatch=rec(final.t_dispatch),
        t_start=rec(final.t_start),
        t_complete=rec(final.t_complete),
        rdata=rec(final.rdata),
        counters={k: v.cpu().numpy() for k, v in final.counters.items()},
        blocked_arrival=int(final.blocked_arrival),
        blocked_dispatch=int(final.blocked_dispatch),
    )


def run_cycles(topo: Topology, view: ScheduleView, trace: Trace,
               state: SimState, start: int, stop: int) -> SimState:
    """Step ``state`` through cycles ``[start, stop)`` one edge each. The
    fused backend runs K3's persistent per-cycle form (its plain version on
    the CPU), updating ``state`` in place; the split and plain backends
    step :func:`cycle_step` eagerly on the CPU and, on the card, replay one
    CUDA graph of it per schedule segment."""
    if topo.fsm_backend == "fused":
        from repro_torch.core.engine import fused_cycles

        fused_cycles(topo, view, trace, state, start, stop, cycle_skip=False)
        return state
    graphs = graphs_lib.graphs_for(state)
    if graphs is None:
        for cycle in range(start, stop):
            state = cycle_step(topo, view, trace, state, cycle)
        return state
    for cycle in range(start, stop):
        seg = view.segment_at(cycle)
        graphs.step(seg, cycle, functools.partial(
            _graph_cycle, topo, view, trace, seg))
    return graphs.state


def _graph_cycle(topo, view, trace, seg, state, cycle):
    return cycle_step(topo, view, trace, state, cycle, seg), None


def simulate(cfg: MemSimConfig, trace: Trace, num_cycles: int = 100_000,
             *, params=None, device=None) -> SimResult:
    """Run MemorySim for ``num_cycles`` over ``trace``; the reference
    per-cycle engine (one ``cycle_step`` per clock; on the fused backend,
    one step of K3's per-cycle persistent form per clock).

    ``params`` may be a :class:`RuntimeParams` point or a
    :class:`ParamSchedule` (re-resolved every cycle); default from ``cfg``.
    ``device=None`` runs on the CUDA card and raises without one."""
    dev = resolve_device(device)
    if params is None:
        sched = ParamSchedule.constant(cfg.runtime())
    else:
        sched = as_schedule(params).validate()
        cfg = sched.apply_to(cfg)  # label the result with the real point
    cfg.validate()
    topo = cfg.topology()
    trace_d = trace.to(dev)
    view = ScheduleView(topo, sched, dev)
    state = init_state(topo, view, trace.num_requests, device=dev)
    final = run_cycles(topo, view, trace_d, state, 0, num_cycles)
    return state_to_result(cfg, trace_d, final, num_cycles)
