"""Decode-attention entry point: dispatch on the tensors' device.

A CUDA tensor launches K5 (``decode_attention.py``) or raises; a CPU
tensor runs the plain version (``ref.py``). Both take any cache length:
the kernel masks a ragged last tile, so the Pallas wrapper's rule that S
be a multiple of ``min(512, S)`` does not apply.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_cuda,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Hq, D]; k, v [B, Hkv, S, D]; kv_len int32[B] -> [B, Hq, D]."""
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, kv_len=kv_len)
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                            device=q.device)
    return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), kv_len.to(torch.int32))
