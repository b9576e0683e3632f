"""Packed kernel ABI of the bank-FSM kernels and the plain PyTorch versions
of K1 and K2.

Packed layout:

  state  : int32[NS=10, B] rows = (st, timer, idle_ctr, refresh_due,
                                   cur_addr, cur_write, cur_data, cur_id,
                                   open_row, pending)
  inputs : int32[NI=3, B]  rows = (grant, resp_accept, queue_nonempty) 0/1
  pop    : int32[4,  B]    head items (addr, is_write, data, id)
  rp     : int32[T*S, NP]  packed ParamSchedule values (tier-major)
  bounds : int32[S, 1]     segment start cycles (SCHEDULE_INF pads)
  cycle  : int32[1, 1]

  -> new_state int32[10, B], flags int32[NF=3, B] rows = (want_pop,
     rw_done, completed)

The plain versions adapt :func:`repro_torch.core.bank_fsm.fsm_update` and
:func:`cycles_until_actionable` to this ABI. They run on CPU tensors (the
tests, the CPU engines) and serve as the yardstick the CUDA kernels are
held against on the card; the cycle loops never hand them a CUDA tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bank_fsm import (
    BankState,
    cycles_until_actionable,
    fsm_update,
)
from repro_torch.core.params import I32, ParamSchedule, Topology, rp_for_banks

NS = 10  # state rows
NI = 3  # input rows
NF = 3  # flag rows


def pack_state(b: BankState) -> torch.Tensor:
    return torch.stack(
        [b.st, b.timer, b.idle_ctr, b.refresh_due,
         b.cur_addr, b.cur_write, b.cur_data, b.cur_id,
         b.open_row, b.pending])


def unpack_state(s: torch.Tensor) -> BankState:
    return BankState(
        st=s[0], timer=s[1], idle_ctr=s[2], refresh_due=s[3],
        cur_addr=s[4], cur_write=s[5], cur_data=s[6], cur_id=s[7],
        open_row=s[8], pending=s[9],
    )


def bank_event_bound_plain(state: torch.Tensor, rp_mat: torch.Tensor,
                           bounds: torch.Tensor, cycle: torch.Tensor,
                           topo: Topology = None) -> torch.Tensor:
    """Plain K2: per-bank cycles-until-actionable under the segment
    governing ``cycle``. ``topo`` is needed only for a tiered matrix.
    Returns int32[1, B]."""
    sched = ParamSchedule.unpack(bounds, rp_mat)
    rp = sched.params_at(cycle[0, 0])
    if topo is not None:
        rp = rp_for_banks(topo, rp)
    bound = cycles_until_actionable(rp, unpack_state(state), cycle[0, 0])
    return bound[None, :]


def bank_fsm_step_plain(topo: Topology, state: torch.Tensor,
                        inputs: torch.Tensor, pop: torch.Tensor,
                        rp_mat: torch.Tensor, bounds: torch.Tensor,
                        cycle: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: one FSM clock edge on the packed ABI."""
    sched = ParamSchedule.unpack(bounds, rp_mat)
    new_bank, outs = fsm_update(
        topo, rp_for_banks(topo, sched.params_at(cycle[0, 0])),
        unpack_state(state),
        grant=inputs[0] == 1,
        resp_accept=inputs[1] == 1,
        queue_nonempty=inputs[2] == 1,
        pop_item=pop.T,
        cycle=cycle[0, 0],
    )
    flags = torch.stack([outs.want_pop.to(I32), outs.rw_done.to(I32),
                         outs.completed.to(I32)])
    return pack_state(new_bank), flags
