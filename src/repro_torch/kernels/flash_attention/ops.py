"""GQA attention entry point: dispatch on the tensors' device.

A CUDA tensor launches K6 (``flash_attention.py``) or raises; a CPU tensor
runs the plain version (``ref.py``). Both take any sequence length: the
kernel masks a ragged last block, so the Pallas wrapper's rule that S be
a multiple of ``min(128, S)`` does not apply.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q [B, Hq, S, D]; k, v [B, Hkv, S, D] -> [B, Hq, S, D]."""
    if not q.is_cuda:
        return gqa_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)
