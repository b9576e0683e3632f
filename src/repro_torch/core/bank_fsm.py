"""Bank-scheduler FSM (paper §5.2, Fig 2), vectorized over banks.

PyTorch counterpart of ``repro.core.bank_fsm``. Every bank's FSM register
updates exactly once per clock from the cycle-start state; ``fsm_update``
is the combinational network (a where-chain), and the CUDA kernels in
``repro_torch.kernels.bank_fsm`` implement the identical function, held
against this one bit for bit.

``rp`` is the operating point governing this cycle; its leaves are
0-d int32 tensors (or ``[B]`` per-bank tensors on tiered topologies, or
Python ints, which are lifted to tensors on the state's device).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.params import (
    CMD_ACT,
    CMD_NOP,
    CMD_PRE,
    CMD_RD,
    CMD_REF,
    CMD_SREF_ENTER,
    CMD_SREF_EXIT,
    CMD_WR,
    I32,
    P_NONE,
    P_REF,
    P_RW,
    P_SREF,
    PAGE_OPEN,
    RuntimeParams,
    S_ACT_ISSUE,
    S_ACT_WAIT,
    S_IDLE,
    S_PRE_ISSUE,
    S_PRE_WAIT,
    S_REF_ISSUE,
    S_REF_WAIT,
    S_RESP_PEND,
    S_RW_ISSUE,
    S_RW_WAIT,
    S_SREF,
    S_SREF_EXIT_ISSUE,
    S_SREF_EXIT_WAIT,
    S_SREF_ISSUE,
    Topology,
    rp_for_banks,
)

__all__ = ["BankState", "FsmOutputs", "EVENT_INF", "P_NONE", "P_RW",
           "P_REF", "P_SREF", "row_of", "wait_mask",
           "cycles_until_actionable", "compute_bids", "fsm_update",
           "rp_tensors"]


def rp_tensors(rp: RuntimeParams, device) -> RuntimeParams:
    """``rp`` with every Python-int leaf lifted to a 0-d int32 tensor on
    ``device`` (tensor leaves pass through)."""
    return RuntimeParams(*[
        v if isinstance(v, torch.Tensor)
        else torch.tensor(int(v), dtype=I32, device=device) for v in rp])


class BankState(NamedTuple):
    """Per-bank scheduler registers, all [B] int32."""

    st: torch.Tensor           # FSM state
    timer: torch.Tensor        # countdown for WAIT states
    idle_ctr: torch.Tensor     # consecutive idle cycles (self-refresh entry)
    refresh_due: torch.Tensor  # absolute cycle of next refresh deadline
    cur_addr: torch.Tensor     # in-flight request fields
    cur_write: torch.Tensor
    cur_data: torch.Tensor
    cur_id: torch.Tensor
    open_row: torch.Tensor     # open-page: currently open row (-1 = closed)
    pending: torch.Tensor      # open-page: action after PRE_WAIT (P_* codes)

    @staticmethod
    def make(topo: Topology, rp: RuntimeParams, device=None) -> "BankState":
        b = topo.num_banks
        rp = rp_for_banks(topo, rp)
        z = torch.zeros((b,), dtype=I32, device=device)
        trefi = rp.tREFI
        if isinstance(trefi, torch.Tensor):
            refresh_due = trefi.to(device=device, dtype=I32).expand(b).clone()
        else:
            refresh_due = torch.full((b,), int(trefi), dtype=I32,
                                     device=device)
        return BankState(
            st=z, timer=z.clone(), idle_ctr=z.clone(),
            refresh_due=refresh_due,
            cur_addr=z.clone(), cur_write=z.clone(), cur_data=z.clone(),
            cur_id=torch.full((b,), -1, dtype=I32, device=device),
            open_row=torch.full((b,), -1, dtype=I32, device=device),
            pending=z.clone(),
        )


class FsmOutputs(NamedTuple):
    """What the FSM asks the controller to do this cycle."""

    want_pop: torch.Tensor      # bool[B]: pop my local queue head into cur_*
    rw_done: torch.Tensor       # bool[B]: column access completed
    completed: torch.Tensor     # bool[B]: response accepted -> finished
    started: torch.Tensor       # bool[B]: service began


def row_of(topo: Topology, addr: torch.Tensor) -> torch.Tensor:
    return (addr >> (topo.addr_low_bits + topo.column_bits)).to(I32)


#: bit s set iff state s is a timed WAIT state
_WAIT_BITS = sum(1 << s for s in (S_ACT_WAIT, S_RW_WAIT, S_PRE_WAIT,
                                  S_REF_WAIT, S_SREF_EXIT_WAIT))


def wait_mask(st: torch.Tensor) -> torch.Tensor:
    """bool[B]: bank is in a timed WAIT state (ACT/RW/PRE/REF/SREF_EXIT
    WAIT), read as one bit of a constant (PyTorch saturates out-of-range
    shifts, so any other value, negative or large, is not a WAIT state)."""
    return ((_WAIT_BITS >> st) & 1) == 1


#: sentinel bound for banks that only an external event can unblock
EVENT_INF = 0x3FFFFFFF


def cycles_until_actionable(rp: RuntimeParams, bank: BankState,
                            cycle) -> torch.Tensor:
    """Per-bank cycles from ``cycle`` until the FSM would do anything but
    count: WAIT ``timer - 1``; IDLE ``min(refresh_due - tRFC - cycle,
    sref_idle_cycles - 1 - idle_ctr)``; SREF ``EVENT_INF``; ISSUE and
    RESP_PEND 0. ``rp`` is the point of the segment containing ``cycle``."""
    st = bank.st
    rp = rp_tensors(rp, st.device)
    in_wait = wait_mask(st)
    refresh_in = bank.refresh_due - rp.tRFC - cycle
    sref_in = rp.sref_idle_cycles - 1 - bank.idle_ctr
    bound = torch.zeros_like(st)
    bound = torch.where(in_wait, bank.timer - 1, bound)
    bound = torch.where(st == S_IDLE, torch.minimum(refresh_in, sref_in),
                        bound)
    bound = torch.where(st == S_SREF, torch.full_like(bound, EVENT_INF),
                        bound)
    return bound.to(I32)


def compute_bids(st: torch.Tensor, cur_write: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Current-state command bids: (bids bool[B], cmds int32[B]), cmds is
    CMD_NOP where not bidding."""
    cmd = torch.full_like(st, CMD_NOP)
    cmd = torch.where(st == S_ACT_ISSUE, CMD_ACT, cmd)
    rw = torch.where(cur_write == 1, CMD_WR, CMD_RD).to(I32)
    cmd = torch.where(st == S_RW_ISSUE, rw, cmd)
    cmd = torch.where(st == S_PRE_ISSUE, CMD_PRE, cmd)
    cmd = torch.where(st == S_REF_ISSUE, CMD_REF, cmd)
    cmd = torch.where(st == S_SREF_ISSUE, CMD_SREF_ENTER, cmd)
    cmd = torch.where(st == S_SREF_EXIT_ISSUE, CMD_SREF_EXIT, cmd)
    return cmd != CMD_NOP, cmd


def fsm_update(topo: Topology, rp: RuntimeParams, bank: BankState,
               grant: torch.Tensor, resp_accept: torch.Tensor,
               queue_nonempty: torch.Tensor, pop_item: torch.Tensor,
               cycle) -> Tuple[BankState, FsmOutputs]:
    """One synchronous clock edge for all bank FSMs (branchless).

    ``grant``/``resp_accept``/``queue_nonempty`` bool[B]; ``pop_item``
    int32[B, 4] head items; ``cycle`` an int or 0-d tensor. The page policy
    is data: the open-page deviations merge in through masks on
    ``is_open``."""
    st, timer = bank.st, bank.timer
    rp = rp_tensors(rp, st.device)
    is_open = rp.page_policy == PAGE_OPEN
    open_row = bank.open_row
    pending = bank.pending

    refresh_needed = (bank.refresh_due - rp.tRFC) <= cycle

    # ---- WAIT states: tick timers, transition on expiry -------------------
    in_wait = wait_mask(st)
    timer2 = torch.where(in_wait, (timer - 1).clamp(min=0), timer)
    expired = in_wait & (timer2 == 0)

    nxt = st
    nxt = torch.where(expired & (st == S_ACT_WAIT), S_RW_ISSUE, nxt)
    open_row = torch.where(expired & (st == S_ACT_WAIT),
                           row_of(topo, bank.cur_addr), open_row)
    rw_exp = torch.where(is_open, S_RESP_PEND, S_PRE_ISSUE).to(I32)
    nxt = torch.where(expired & (st == S_RW_WAIT), rw_exp, nxt)
    pre_done = expired & (st == S_PRE_WAIT)
    nxt = torch.where(pre_done & ~is_open, S_RESP_PEND, nxt)
    nxt = torch.where(pre_done & is_open & (pending == P_RW), S_ACT_ISSUE,
                      nxt)
    nxt = torch.where(pre_done & is_open & (pending == P_REF), S_REF_ISSUE,
                      nxt)
    nxt = torch.where(pre_done & is_open & (pending == P_SREF),
                      S_SREF_ISSUE, nxt)
    open_row = torch.where(pre_done, -1, open_row)
    pending = torch.where(pre_done, P_NONE, pending)
    nxt = torch.where(expired & (st == S_REF_WAIT), S_IDLE, nxt)
    nxt = torch.where(expired & (st == S_SREF_EXIT_WAIT), S_IDLE, nxt)
    rw_done = expired & (st == S_RW_WAIT)
    ref_done = expired & (st == S_REF_WAIT)

    # ---- ISSUE states: on grant, enter the corresponding WAIT -------------
    is_wr = bank.cur_write == 1
    act_dur = torch.where(is_wr, rp.tRCDWR, rp.tRCDRD).to(I32)
    g = grant & (st == S_ACT_ISSUE)
    nxt = torch.where(g, S_ACT_WAIT, nxt)
    timer2 = torch.where(g, act_dur, timer2)
    g = grant & (st == S_RW_ISSUE)
    nxt = torch.where(g, S_RW_WAIT, nxt)
    timer2 = torch.where(g, rp.tCL, timer2)
    g = grant & (st == S_PRE_ISSUE)
    nxt = torch.where(g, S_PRE_WAIT, nxt)
    timer2 = torch.where(g, rp.tRP, timer2)
    g = grant & (st == S_REF_ISSUE)
    nxt = torch.where(g, S_REF_WAIT, nxt)
    timer2 = torch.where(g, rp.tRFC, timer2)
    nxt = torch.where(grant & (st == S_SREF_ISSUE), S_SREF, nxt)
    g = grant & (st == S_SREF_EXIT_ISSUE)
    nxt = torch.where(g, S_SREF_EXIT_WAIT, nxt)
    timer2 = torch.where(g, rp.tXS, timer2)

    # ---- RESP_PEND: drained by the response arbiter ------------------------
    completed = resp_accept & (st == S_RESP_PEND)
    nxt = torch.where(completed, S_IDLE, nxt)

    # ---- IDLE: refresh > new request > self-refresh countdown --------------
    idle = st == S_IDLE
    row_open = open_row >= 0
    go_ref = idle & refresh_needed
    ref_pre = is_open & row_open
    nxt = torch.where(go_ref, torch.where(ref_pre, S_PRE_ISSUE, S_REF_ISSUE)
                      .to(I32), nxt)
    pending = torch.where(go_ref & ref_pre, P_REF, pending)

    want_pop = idle & ~refresh_needed & queue_nonempty
    pop_row = row_of(topo, pop_item[:, 0])
    hit = is_open & want_pop & row_open & (open_row == pop_row)
    conflict = is_open & want_pop & row_open & (open_row != pop_row)
    nxt = torch.where(want_pop, S_ACT_ISSUE, nxt)
    nxt = torch.where(hit, S_RW_ISSUE, nxt)
    nxt = torch.where(conflict, S_PRE_ISSUE, nxt)
    pending = torch.where(conflict, P_RW, pending)

    truly_idle = idle & ~refresh_needed & ~queue_nonempty
    idle_ctr2 = torch.where(truly_idle, bank.idle_ctr + 1,
                            torch.zeros_like(bank.idle_ctr))
    go_sref = truly_idle & (idle_ctr2 >= rp.sref_idle_cycles)
    sref_pre = is_open & row_open
    nxt = torch.where(go_sref,
                      torch.where(sref_pre, S_PRE_ISSUE, S_SREF_ISSUE)
                      .to(I32), nxt)
    pending = torch.where(go_sref & sref_pre, P_SREF, pending)

    # ---- SREF: wake on pending work ----------------------------------------
    nxt = torch.where((st == S_SREF) & queue_nonempty, S_SREF_EXIT_ISSUE, nxt)

    # ---- refresh bookkeeping ------------------------------------------------
    refresh_due2 = torch.where(ref_done, bank.refresh_due + rp.tREFI,
                               bank.refresh_due)
    exiting = expired & (st == S_SREF_EXIT_WAIT)
    refresh_due2 = torch.where(exiting, rp.tREFI + cycle, refresh_due2)

    # ---- latch popped request -------------------------------------------------
    wp = want_pop
    new = BankState(
        st=nxt.to(I32),
        timer=timer2.to(I32),
        idle_ctr=idle_ctr2.to(I32),
        refresh_due=refresh_due2.to(I32),
        cur_addr=torch.where(wp, pop_item[:, 0], bank.cur_addr),
        cur_write=torch.where(wp, pop_item[:, 1], bank.cur_write),
        cur_data=torch.where(wp, pop_item[:, 2], bank.cur_data),
        cur_id=torch.where(wp, pop_item[:, 3], bank.cur_id),
        open_row=open_row.to(I32),
        pending=pending.to(I32),
    )
    outs = FsmOutputs(want_pop=want_pop, rw_done=rw_done,
                      completed=completed, started=want_pop)
    return new, outs
