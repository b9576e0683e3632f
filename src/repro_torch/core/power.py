"""DRAMPower-style energy accounting, PyTorch counterpart of
``repro.core.power``.

Per-command counts and per-state bank-cycle buckets accumulate in int32
counters inside the cycle loop; Joules are derived afterwards on the host
(:func:`energy_report`). ``seg`` (the active schedule segment) and
``delta`` (skipped cycles) are Python ints or 0-d tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.params import CMD_NOP, I32, NUM_CMDS, S_IDLE, S_SREF


@dataclasses.dataclass(frozen=True)
class PowerConfig:
    # per-command energy, nanojoules (DDR4-class defaults)
    e_act_nj: float = 1.7
    e_pre_nj: float = 1.2
    e_rd_nj: float = 4.2
    e_wr_nj: float = 4.6
    e_ref_nj: float = 26.0
    # background power, milliwatts per bank-cycle bucket
    p_act_standby_mw: float = 45.0
    p_pre_standby_mw: float = 35.0
    p_sref_mw: float = 4.0
    clock_ghz: float = 1.2


def make_counters(num_banks: int, num_segments: int = 1,
                  num_tiers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    return {
        "cmd_counts": z(NUM_CMDS),
        "sref_cycles": z(),
        "active_cycles": z(),   # banks not IDLE/SREF
        "idle_cycles": z(),
        # cycles spent under each ParamSchedule segment (operating point)
        "seg_cycles": z(num_segments),
        # per-memory-tier split of the same bank-cycle buckets
        "tier_active_cycles": z(num_tiers),
        "tier_idle_cycles": z(num_tiers),
        "tier_sref_cycles": z(num_tiers),
    }


def _add_at(x: torch.Tensor, i, v) -> torch.Tensor:
    """``x`` with ``v`` added at index ``i`` (int or 0-d tensor)."""
    if not isinstance(i, torch.Tensor):
        i = torch.full((1,), int(i), dtype=torch.long, device=x.device)
    if not isinstance(v, torch.Tensor):
        v = torch.full((1,), int(v), dtype=x.dtype, device=x.device)
    return x.index_add(0, i.reshape(1).long(), v.reshape(1).to(x.dtype))


def _tier_state_counts(counters, st: torch.Tensor,
                       tier_idx: Optional[torch.Tensor]):
    """Per-tier (sref, idle, active) bank counts for the current states.
    ``tier_idx`` is the static int bank->tier map (None for one tier)."""
    t = counters["tier_sref_cycles"].shape[0]
    sref_m = (st == S_SREF).to(I32)
    idle_m = (st == S_IDLE).to(I32)
    if t == 1 or tier_idx is None:
        sref = sref_m.sum().to(I32).reshape(1)
        idle = idle_m.sum().to(I32).reshape(1)
        per_tier = st.shape[0]
    else:
        idx = tier_idx.to(st.device).long()
        zeros = torch.zeros((t,), dtype=I32, device=st.device)
        sref = zeros.index_add(0, idx, sref_m)
        idle = zeros.index_add(0, idx, idle_m)
        per_tier = zeros.index_add(0, idx, torch.ones_like(idle_m))
    return sref, idle, per_tier - sref - idle


def update_counters(counters: Dict[str, torch.Tensor],
                    issued_cmd: torch.Tensor, st: torch.Tensor, seg=0,
                    tier_idx=None) -> Dict[str, torch.Tensor]:
    """One executed cycle: ``issued_cmd`` int32[C] (CMD_NOP where no
    grant), ``st`` int32[B] the cycle-start bank states."""
    cmd_counts = counters["cmd_counts"].index_add(
        0, issued_cmd.long(), torch.ones_like(issued_cmd))
    # CMD_NOP slot accumulates junk; it is ignored at report time
    sref = (st == S_SREF).sum().to(I32)
    idle = (st == S_IDLE).sum().to(I32)
    b = st.shape[0]
    t_sref, t_idle, t_active = _tier_state_counts(counters, st, tier_idx)
    return {
        "cmd_counts": cmd_counts,
        "sref_cycles": counters["sref_cycles"] + sref,
        "idle_cycles": counters["idle_cycles"] + idle,
        "active_cycles": counters["active_cycles"] + (b - sref - idle),
        "seg_cycles": _add_at(counters["seg_cycles"], seg, 1),
        "tier_sref_cycles": counters["tier_sref_cycles"] + t_sref,
        "tier_idle_cycles": counters["tier_idle_cycles"] + t_idle,
        "tier_active_cycles": counters["tier_active_cycles"] + t_active,
    }


def skip_counters(counters: Dict[str, torch.Tensor], st: torch.Tensor,
                  delta, channels: int, seg=0,
                  tier_idx=None) -> Dict[str, torch.Tensor]:
    """Exactly ``delta`` applications of :func:`update_counters` under an
    all-NOP issue slate and frozen bank states (what every skipped inert
    cycle contributes). The engine caps every skip at the next schedule
    boundary, so the whole delta belongs to segment ``seg``."""
    sref = (st == S_SREF).sum().to(I32)
    idle = (st == S_IDLE).sum().to(I32)
    b = st.shape[0]
    t_sref, t_idle, t_active = _tier_state_counts(counters, st, tier_idx)
    return {
        "cmd_counts": _add_at(counters["cmd_counts"], CMD_NOP,
                              delta * channels),
        "sref_cycles": counters["sref_cycles"] + delta * sref,
        "idle_cycles": counters["idle_cycles"] + delta * idle,
        "active_cycles": counters["active_cycles"] + delta * (b - sref - idle),
        "seg_cycles": _add_at(counters["seg_cycles"], seg, delta),
        "tier_sref_cycles": counters["tier_sref_cycles"] + delta * t_sref,
        "tier_idle_cycles": counters["tier_idle_cycles"] + delta * t_idle,
        "tier_active_cycles": counters["tier_active_cycles"]
        + delta * t_active,
    }


def energy_report(counters, pcfg: PowerConfig) -> Dict[str, float]:
    """Derive energy (µJ) and average power (mW) from raw counters
    (tensors on any device, or numpy arrays)."""
    def host(v):
        return v.detach().cpu() if isinstance(v, torch.Tensor) else v

    c = {k: int(v) for k, v in zip(
        ["nop", "act", "rd", "wr", "pre", "ref", "srefe", "srefx"],
        list(host(counters["cmd_counts"])),
    )}
    cmd_nj = (
        c["act"] * pcfg.e_act_nj
        + c["pre"] * pcfg.e_pre_nj
        + c["rd"] * pcfg.e_rd_nj
        + c["wr"] * pcfg.e_wr_nj
        + c["ref"] * pcfg.e_ref_nj
    )
    ns_per_cycle = 1.0 / pcfg.clock_ghz
    act = float(host(counters["active_cycles"]))
    idl = float(host(counters["idle_cycles"]))
    srf = float(host(counters["sref_cycles"]))
    bg_nj = (act * pcfg.p_act_standby_mw + idl * pcfg.p_pre_standby_mw
             + srf * pcfg.p_sref_mw) * 1e-3 * ns_per_cycle
    total_cycles = act + idl + srf
    total_nj = cmd_nj + bg_nj
    avg_mw = 0.0
    if total_cycles > 0:
        avg_mw = total_nj / (total_cycles * ns_per_cycle) * 1e3
    return {
        "command_energy_uj": cmd_nj * 1e-3,
        "background_energy_uj": bg_nj * 1e-3,
        "total_energy_uj": total_nj * 1e-3,
        "avg_power_mw_per_bank": avg_mw,
        "counts": c,
    }
