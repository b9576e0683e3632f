"""Address-decode entry point: dispatch on the address tensor's device.

A CUDA tensor launches K4 (``addr_map.py``) or raises; a CPU tensor runs
the plain version (``ref.py``). Any N: the kernel masks its ragged tail,
so the Pallas wrapper's pad-with-address-0 and its subtraction from
``hist[0]`` are not needed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.params import MemSimConfig, Topology
from repro_torch.kernels.addr_map.addr_map import addr_map_cuda
from repro_torch.kernels.addr_map.ref import addr_map_ref


def addr_map(cfg: Topology, addr, tier_flags=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Decode a batch of addresses -> (bank, rank, row, per-bank
    histogram), all int32 on the addresses' device.

    Tiered configs (``cfg.tiers > 1``) route through the placement decode:
    ``tier_flags`` int32[2] = (tier_interleave_log2, tier_cxl_frac_log2);
    omitted, it lifts from ``cfg`` (which must then be a
    :class:`MemSimConfig`). Single-tier configs ignore it.
    """
    addr = torch.as_tensor(addr, dtype=torch.int32)
    if cfg.tiers > 1 and tier_flags is None:
        if not isinstance(cfg, MemSimConfig):
            raise ValueError(
                "tier_flags required when cfg is a bare tiered Topology")
        tier_flags = [cfg.tier_interleave_log2, cfg.tier_cxl_frac_log2]
    if cfg.tiers == 1:
        tier_flags = None
    if tier_flags is not None:
        tier_flags = torch.as_tensor(tier_flags, dtype=torch.int32).reshape(
            2).to(addr.device)
    if not addr.is_cuda:
        return addr_map_ref(cfg, addr, tier_flags)
    return addr_map_cuda(cfg, addr.contiguous(), tier_flags)
