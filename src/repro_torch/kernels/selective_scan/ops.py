"""Selective-scan entry point: dispatch on the tensors' device.

A CUDA tensor launches K7 (``selective_scan.py``) or raises; a CPU tensor
runs the plain version (``ref.py``), whose autograd is the plain version
of K7's backward. On the card, while grad mode is on and an input
requires grad, the call goes through ``SelectiveScan`` (K7's saving form,
then K7's backward kernels); otherwise it is K7's plain launch. Both take
any T and D: the kernels mask a ragged last chunk and channel block, so
the Pallas wrapper's ``chunk_t``/``block_d`` divisibility does not apply.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import (
    SelectiveScan,
    selective_scan_cuda,
)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
                   cc: torch.Tensor, a: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [B, T, D]; bc, cc: [B, T, S]; a: [D, S] float32 ->
    (y [B, T, D] in x's dtype, h_final [B, D, S] float32)."""
    if not x.is_cuda:
        return selective_scan_ref(x, dt, bc, cc, a)
    args = (x.contiguous(), dt.contiguous(), bc.contiguous(),
            cc.contiguous(), a.to(torch.float32).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScan.apply(*args)
    return selective_scan_cuda(*args)
