"""Entry points of the split bank-FSM kernels: bank padding and dispatch.

A CUDA tensor launches the CUDA kernel (K1 / K2 in ``bank_fsm.py``) or
raises; a CPU tensor runs the kernel's plain PyTorch version (``ref.py``).
The kernel path pads the bank axis with inert banks (IDLE, refresh
deadline ``0x3FFFFFFF``, no request, no open row) to a multiple of the
reference's block width and slices them off again, so both paths agree
bank for bank.

``params`` is a :class:`RuntimeParams` (constant), a
:class:`ParamSchedule`, or an already packed ``(bounds [S, 1], rp [T*S,
NP])`` pair on the state's device (what the cycle loops pass).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.params import (
    I32,
    ParamSchedule,
    RuntimeParams,
    S_IDLE,
    Topology,
    as_schedule,
)
from repro_torch.kernels.bank_fsm.bank_fsm import (
    bank_event_bound_cuda,
    bank_fsm_step_cuda,
)
from repro_torch.kernels.bank_fsm.ref import (
    bank_event_bound_plain,
    bank_fsm_step_plain,
)

_FAR_FUTURE = 0x3FFFFFFF


def _block_b(b: int) -> int:
    """The reference's bank-axis block width: min(128, B)."""
    return min(128, b)


def _pad_banks(state, inputs, pop, padded_b: int):
    b = state.shape[1]
    if b == padded_b:
        return state, inputs, pop
    extra = padded_b - b
    dev = state.device
    pad_state = torch.zeros((10, extra), dtype=I32, device=dev)
    pad_state[0] = S_IDLE
    pad_state[3] = _FAR_FUTURE  # never refresh
    pad_state[7] = -1
    pad_state[8] = -1           # no open row
    state = torch.cat([state, pad_state], dim=1)
    inputs = torch.cat(
        [inputs, torch.zeros((3, extra), dtype=I32, device=dev)], dim=1)
    pop = torch.cat([pop, torch.zeros((4, extra), dtype=I32, device=dev)],
                    dim=1)
    return state, inputs, pop


def _packed(params, device):
    if isinstance(params, (RuntimeParams, ParamSchedule)):
        bounds, rp_mat = as_schedule(params).pack()
        return bounds.to(device), rp_mat.to(device)
    bounds, rp_mat = params
    return bounds, rp_mat


def _cycle2d(cycle, device) -> torch.Tensor:
    if isinstance(cycle, torch.Tensor):
        return cycle.to(I32).reshape(1, 1)
    return torch.full((1, 1), int(cycle), dtype=I32, device=device)


def _padded(b: int) -> int:
    block = _block_b(b)
    return ((b + block - 1) // block) * block


def bank_event_bound(state: torch.Tensor, cycle, params,
                     topo: Optional[Topology] = None) -> torch.Tensor:
    """Per-bank cycles-until-actionable on the packed ABI: int32[B].
    ``topo`` is needed only for tiered topologies (the DRAM/CXL split)."""
    cycle2d = _cycle2d(cycle, state.device)
    bounds, rp_mat = _packed(params, state.device)
    b = state.shape[1]
    if not state.is_cuda:
        return bank_event_bound_plain(state, rp_mat, bounds, cycle2d,
                                      topo=topo)[0]
    ps = state
    if _padded(b) != b:
        ps, _, _ = _pad_banks(
            state, torch.zeros((3, b), dtype=I32, device=state.device),
            torch.zeros((4, b), dtype=I32, device=state.device), _padded(b))
    tiers = 1 if topo is None else topo.tiers
    split = 0 if tiers == 1 else topo.tier_split_bank
    bound = bank_event_bound_cuda(ps.contiguous(), rp_mat, bounds, cycle2d,
                                  tiers=tiers, tier_split=split)
    return bound[0, :b]


def bank_fsm_step(topo: Topology, state: torch.Tensor, inputs: torch.Tensor,
                  pop: torch.Tensor, cycle, params
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FSM clock edge. Returns (new_state [10, B], flags [3, B])."""
    topo = topo.topology()
    cycle2d = _cycle2d(cycle, state.device)
    bounds, rp_mat = _packed(params, state.device)
    if not state.is_cuda:
        return bank_fsm_step_plain(topo, state, inputs, pop, rp_mat, bounds,
                                   cycle2d)
    b = state.shape[1]
    ps, pi, pp = _pad_banks(state, inputs, pop, _padded(b))
    new_state, flags = bank_fsm_step_cuda(
        topo, ps.contiguous(), pi.contiguous(), pp.contiguous(), rp_mat,
        bounds, cycle2d)
    return new_state[:, :b], flags[:, :b]
