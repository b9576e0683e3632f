"""Plain PyTorch version of K4: trace address decode + per-bank histogram
(the reference's ``addr_map_ref``), through this package's own
``core.dram_model.decode_address``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.dram_model import decode_address
from repro_torch.core.params import RuntimeParams, Topology


def addr_map_ref(cfg: Topology, addr: torch.Tensor,
                 tier_flags: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """addr int32[N] -> (bank[N], rank[N], row[N], hist int32[num_banks]).

    ``tier_flags`` int32[2] = (tier_interleave_log2, tier_cxl_frac_log2)
    routes a tiered topology through the placement decode; a single-tier
    topology ignores it."""
    rp = None
    if cfg.tiers > 1 and tier_flags is not None:
        rp = RuntimeParams()._replace(tier_interleave_log2=tier_flags[0],
                                      tier_cxl_frac_log2=tier_flags[1])
    bank, rank, row = decode_address(cfg, addr, rp)
    # index_add_, not bincount: bincount reads its maximum on the host
    hist = torch.zeros((cfg.num_banks,), dtype=torch.int32,
                       device=addr.device).index_add_(
        0, bank.long(), torch.ones_like(bank))
    return bank, rank, row, hist
