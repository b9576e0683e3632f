"""Wrappers of the split bank-FSM CUDA kernels (``csrc/bank_fsm.cu``).

K1 ``bank_fsm_step_cuda``: one synchronous clock edge of every bank FSM;
K2 ``bank_event_bound_cuda``: per-bank cycles until actionable. Both
resolve the active ParamSchedule segment and each bank's tier row
in-kernel. They take CUDA tensors only (``ops.py`` dispatches CPU tensors
to the plain versions in ``ref.py``), allocate their outputs, launch on
PyTorch's current stream, never synchronise, and raise on a launch error.
The ABI is documented in ``ref.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.params import I32, NUM_RUNTIME_PARAMS, Topology
from repro_torch.kernels import build
from repro_torch.kernels.bank_fsm.ref import NF, NI, NS


def _check_schedule(name, rp_mat, bounds, cycle, tiers):
    s = bounds.shape[0]
    if bounds.shape != (s, 1) or s < 1:
        raise ValueError(f"{name}: bounds must be [S, 1], got "
                         f"{tuple(bounds.shape)}")
    if rp_mat.shape != (tiers * s, NUM_RUNTIME_PARAMS):
        raise ValueError(
            f"{name}: rp must be [T*S, {NUM_RUNTIME_PARAMS}] = "
            f"[{tiers}*{s}, {NUM_RUNTIME_PARAMS}], got {tuple(rp_mat.shape)}")
    if cycle.shape != (1, 1):
        raise ValueError(f"{name}: cycle must be [1, 1], got "
                         f"{tuple(cycle.shape)}")
    return s


def bank_fsm_step_cuda(topo: Topology, state: torch.Tensor,
                       inputs: torch.Tensor, pop: torch.Tensor,
                       rp_mat: torch.Tensor, bounds: torch.Tensor,
                       cycle: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1. Returns (new_state int32[10, B], flags int32[3, B])."""
    build.require_cuda("bank_fsm_step", state=state, inputs=inputs, pop=pop,
                       rp=rp_mat, bounds=bounds, cycle=cycle)
    b = state.shape[1]
    if (state.shape != (NS, b) or inputs.shape != (NI, b)
            or pop.shape != (4, b) or b < 1):
        raise ValueError(
            f"bank_fsm_step: shapes state {tuple(state.shape)}, inputs "
            f"{tuple(inputs.shape)}, pop {tuple(pop.shape)} do not match "
            f"[10, B], [3, B], [4, B]")
    s = _check_schedule("bank_fsm_step", rp_mat, bounds, cycle, topo.tiers)
    lib = build.load()["bank_fsm"]
    new_state = torch.empty((NS, b), dtype=I32, device=state.device)
    flags = torch.empty((NF, b), dtype=I32, device=state.device)
    split = topo.tier_split_bank if topo.tiers > 1 else b
    err = lib.bank_fsm_step_launch(
        state.data_ptr(), inputs.data_ptr(), pop.data_ptr(),
        rp_mat.data_ptr(), bounds.data_ptr(), cycle.data_ptr(),
        new_state.data_ptr(), flags.data_ptr(), b, s, topo.tiers, split,
        topo.row_shift, build.stream_of(state))
    build.check(err, "bank_fsm_step")
    build.LAUNCHES["k1"] += 1
    return new_state, flags


def bank_event_bound_cuda(state: torch.Tensor, rp_mat: torch.Tensor,
                          bounds: torch.Tensor, cycle: torch.Tensor,
                          tiers: int = 1, tier_split: int = 0
                          ) -> torch.Tensor:
    """Launch K2. Returns int32[1, B] cycles-until-actionable."""
    build.require_cuda("bank_event_bound", state=state, rp=rp_mat,
                       bounds=bounds, cycle=cycle)
    b = state.shape[1]
    if state.shape != (NS, b) or b < 1:
        raise ValueError(f"bank_event_bound: state must be [10, B], got "
                         f"{tuple(state.shape)}")
    s = _check_schedule("bank_event_bound", rp_mat, bounds, cycle, tiers)
    lib = build.load()["bank_fsm"]
    out = torch.empty((1, b), dtype=I32, device=state.device)
    err = lib.bank_event_bound_launch(
        state.data_ptr(), rp_mat.data_ptr(), bounds.data_ptr(),
        cycle.data_ptr(), out.data_ptr(), b, s, tiers,
        tier_split if tiers > 1 else b, build.stream_of(state))
    build.check(err, "bank_event_bound")
    build.LAUNCHES["k2"] += 1
    return out
