"""Wrapper of the K4 CUDA kernel (``csrc/addr_map.cu``).

``addr_map_cuda`` takes CUDA tensors only (``ops.py`` sends CPU tensors to
the plain version in ``ref.py``), allocates the outputs (the histogram
zeroed), launches one kernel on PyTorch's current stream, never
synchronises, and raises on a launch error. One call is one K4 launch in
``build.LAUNCHES["k4"]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.params import Topology
from repro_torch.kernels import build

#: the shared-memory histogram holds at most 48 KiB of int32 counts
MAX_BANKS = 48 * 1024 // 4


def addr_map_cuda(cfg: Topology, addr: torch.Tensor,
                  tier_flags: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Launch K4. addr int32[N] on the card; tier_flags int32[2] on the
    same card for a tiered decode, else None. Returns (bank, rank, row
    int32[N], hist int32[num_banks])."""
    build.require_cuda("addr_map", addr=addr)
    if tier_flags is not None:
        build.require_cuda("addr_map", tier_flags=tier_flags)
        if tier_flags.shape != (2,):
            raise ValueError(f"addr_map: tier_flags must be int32[2], got "
                             f"{tuple(tier_flags.shape)}")
    if addr.dim() != 1:
        raise ValueError(f"addr_map: addr must be int32[N], got "
                         f"{tuple(addr.shape)}")
    nb = cfg.num_banks
    if nb > MAX_BANKS:
        raise ValueError(f"addr_map: {nb} banks do not fit the kernel's "
                         f"shared-memory histogram (at most {MAX_BANKS})")
    n = addr.shape[0]
    bank, rank, row = (torch.empty_like(addr) for _ in range(3))
    hist = torch.zeros((nb,), dtype=torch.int32, device=addr.device)
    if n == 0:
        return bank, rank, row, hist
    lib = build.load()["addr_map"]
    err = lib.addr_map_launch(
        addr.data_ptr(), bank.data_ptr(), rank.data_ptr(), row.data_ptr(),
        hist.data_ptr(), 0 if tier_flags is None else tier_flags.data_ptr(),
        n, cfg.banks_per_group, cfg.bankgroups, cfg.ranks, cfg.channels,
        cfg.bank_bits, cfg.bankgroup_bits, cfg.rank_bits, cfg.row_shift,
        cfg.dram_channels, cfg.cxl_channels, nb, build.stream_of(addr))
    build.check(err, "addr_map")
    build.LAUNCHES["k4"] += 1
    return bank, rank, row, hist
