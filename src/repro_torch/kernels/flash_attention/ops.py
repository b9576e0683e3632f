"""GQA attention entry point: dispatch on the tensors' device.

A CUDA tensor launches K6 (``flash_attention.py``) or raises; a CPU tensor
runs the plain version (``ref.py``), whose autograd is the plain version
of K6's backward. On the card, while grad mode is on and an input
requires grad, the call goes through ``FlashAttention`` (K6 with its
log-sum-exp, then K6's backward kernels); otherwise it is K6's plain
launch. Both take any sequence length: the kernels mask a ragged last
block, so the Pallas wrapper's rule that S be a multiple of
``min(128, S)`` does not apply. A call that is not one of K6's base forms
(Dqk != Dv, Sk != Sq, or another scale) launches K6's general form, and
under grad its backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    FlashAttention,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, Sq, Dqk]; k [B, Hkv, Sk, Dqk]; v [B, Hkv, Sk, Dv] ->
    [B, Hq, Sq, Dv]; the logits times ``scale`` (1/sqrt(Dqk) by default)."""
    if not q.is_cuda:
        return gqa_attention_ref(q, k, v, causal=causal, scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_cuda(q, k, v, causal, scale=scale)
