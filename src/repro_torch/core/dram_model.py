"""DRAM timing model (paper §5.5), PyTorch counterpart of
``repro.core.dram_model``.

Rank-scoped registers (tRRDL, tFAW windows, column-bus turnarounds) live
in :class:`TimingState`, one entry per flattened rank. Bank-level
sequencing (tRP before ACT, tRCD before RW) is structural in the bank FSM.
Every timing value comes from a :class:`RuntimeParams` point whose leaves
are Python ints or int32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.params import (
    CMD_ACT,
    CMD_PRE,
    CMD_RD,
    CMD_REF,
    CMD_SREF_ENTER,
    CMD_SREF_EXIT,
    CMD_WR,
    I32,
    RuntimeParams,
    Topology,
)

_NEG = -(1 << 20)  # "long ago" initializer for last-command times


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """A runtime-parameter leaf as an int32 tensor on ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(int(v), dtype=I32, device=like.device)


class TimingState(NamedTuple):
    """Rank-scoped DRAM timing registers."""

    last_act: torch.Tensor    # [R] cycle of most recent ACTIVATE (tRRDL)
    act_win: torch.Tensor     # [R, 4] cycles of the last four ACTs (tFAW)
    last_rd: torch.Tensor     # [R] most recent READ column command
    last_wr: torch.Tensor     # [R] most recent WRITE column command

    @staticmethod
    def make(topo: Topology, device=None) -> "TimingState":
        r = topo.num_ranks
        return TimingState(
            last_act=torch.full((r,), _NEG, dtype=I32, device=device),
            act_win=torch.full((r, 4), _NEG, dtype=I32, device=device),
            last_rd=torch.full((r,), _NEG, dtype=I32, device=device),
            last_wr=torch.full((r,), _NEG, dtype=I32, device=device),
        )


def bank_to_rank(topo: Topology, bank_idx: torch.Tensor) -> torch.Tensor:
    """Map flattened bank index -> flattened rank index.

    Banks are flattened channel-major:
    ``bank = ((ch * R + rank) * BG + bg) * BA + ba``.
    """
    return bank_idx // topo.banks_per_rank


def legal_issue_cycle(rp: RuntimeParams, timing: TimingState,
                      cmd: torch.Tensor, rank_of_bank: torch.Tensor
                      ) -> torch.Tensor:
    """Earliest cycle at which each bank's bid command satisfies the rank
    constraints (tRRDL/tFAW for ACT, tCCDL/tWTR/tRTW for column commands);
    other commands report ``_NEG``. The one definition of command-bus
    readiness, shared by the stepper and the event-horizon bound."""
    rk = rank_of_bank.long()
    la = timing.last_act[rk]                 # [B]
    aw = timing.act_win[rk]                  # [B, 4]
    lr = timing.last_rd[rk]
    lw = timing.last_wr[rk]

    oldest_act = aw.min(dim=-1).values
    act_at = torch.maximum(la + rp.tRRDL, oldest_act + rp.tFAW)
    rd_at = torch.maximum(lr + rp.tCCDL, lw + rp.tWTR)
    wr_at = torch.maximum(lw + rp.tCCDL, lr + rp.tRTW)

    at = torch.full_like(cmd, _NEG)
    at = torch.where(cmd == CMD_ACT, act_at, at)
    at = torch.where(cmd == CMD_RD, rd_at, at)
    at = torch.where(cmd == CMD_WR, wr_at, at)
    return at.to(I32)


def record_issue(timing: TimingState, cycle, cmd: torch.Tensor,
                 rank: torch.Tensor, granted: torch.Tensor) -> TimingState:
    """Update rank registers after the arbiter grants one command.
    ``cmd``/``rank``/``granted`` are 0-d tensors; ``cycle`` an int or 0-d
    tensor. The tFAW slot replaced is the *first* minimum of the window
    (``argmin`` ties to the first occurrence, as ``jnp.argmin``)."""
    r = timing.last_act.shape[0]
    dev = timing.last_act.device
    at_rank = torch.arange(r, dtype=I32, device=dev) == rank          # [R]
    is_act = at_rank & (granted & (cmd == CMD_ACT))
    is_rd = at_rank & (granted & (cmd == CMD_RD))
    is_wr = at_rank & (granted & (cmd == CMD_WR))
    cyc = cycle if isinstance(cycle, torch.Tensor) else int(cycle)

    last_act = torch.where(is_act, cyc, timing.last_act)
    oldest_slot = timing.act_win.argmin(dim=1)                        # [R]
    slot = torch.arange(4, device=dev)[None, :] == oldest_slot[:, None]
    act_win = torch.where(is_act[:, None] & slot, cyc, timing.act_win)
    last_rd = torch.where(is_rd, cyc, timing.last_rd)
    last_wr = torch.where(is_wr, cyc, timing.last_wr)
    return TimingState(last_act, act_win, last_rd, last_wr)


def wait_duration(rp: RuntimeParams, cmd: torch.Tensor,
                  is_write: torch.Tensor) -> torch.Tensor:
    """Duration of the WAIT state entered after a command is issued."""
    dur = torch.zeros_like(cmd)
    act_dur = torch.where(is_write.bool(), _t(rp.tRCDWR, cmd),
                          _t(rp.tRCDRD, cmd))
    dur = torch.where(cmd == CMD_ACT, act_dur, dur)
    dur = torch.where((cmd == CMD_RD) | (cmd == CMD_WR), _t(rp.tCL, cmd), dur)
    dur = torch.where(cmd == CMD_PRE, _t(rp.tRP, cmd), dur)
    dur = torch.where(cmd == CMD_REF, _t(rp.tRFC, cmd), dur)
    dur = torch.where(cmd == CMD_SREF_ENTER, torch.ones_like(dur), dur)
    dur = torch.where(cmd == CMD_SREF_EXIT, _t(rp.tXS, cmd), dur)
    return dur.to(I32)


def _first(v):
    """First element of a tier-uniform leaf (int or tensor)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1)[0]
    return int(v)


def tier_select(topo: Topology, addr: torch.Tensor,
                rp: RuntimeParams) -> torch.Tensor:
    """Placement decode: which tier owns ``addr`` (bool, True = CXL). The
    CXL expander owns 1 of every ``2^tier_cxl_frac_log2`` blocks of
    ``2^tier_interleave_log2`` words (the all-ones residue)."""
    il = _first(rp.tier_interleave_log2)
    k = _first(rp.tier_cxl_frac_log2)
    frac_mask = (1 << k) - 1
    return ((addr >> il) & frac_mask) == frac_mask


def decode_address(topo: Topology, addr: torch.Tensor,
                   rp: RuntimeParams = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Address -> (flat_bank, flat_rank, row), paper §5.2 fixed mapping
    with the channel above the rank; tiered topologies remap the channel
    through the placement decode (:func:`tier_select`)."""
    ba = addr & (topo.banks_per_group - 1)
    bg = (addr >> topo.bank_bits) & (topo.bankgroups - 1)
    rk = (addr >> (topo.bank_bits + topo.bankgroup_bits)) & (topo.ranks - 1)
    ch = (addr >> (topo.bank_bits + topo.bankgroup_bits + topo.rank_bits)) & (
        topo.channels - 1)
    if topo.tiers > 1 and rp is not None:
        is_cxl = tier_select(topo, addr, rp)
        ch = torch.where(is_cxl,
                         topo.dram_channels + (ch & (topo.cxl_channels - 1)),
                         ch & (topo.dram_channels - 1))
    flat_bank = ((ch * topo.ranks + rk) * topo.bankgroups + bg) \
        * topo.banks_per_group + ba
    flat_rank = ch * topo.ranks + rk
    row = addr >> (topo.addr_low_bits + topo.column_bits)
    return flat_bank.to(I32), flat_rank.to(I32), row.to(I32)
