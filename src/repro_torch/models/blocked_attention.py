"""Blocked attention (the reference's jnp ``blocked_attention``): GQA
grouping, a query/key width apart from the value width (MLA), the query
and key lengths apart (cross-attention).

This is K6's entry point, ``kernels.flash_attention.ops.attention``: a
CUDA tensor launches K6 (its general form wherever the shapes or the scale
are not a base form's) or raises; a CPU tensor runs K6's plain version,
``gqa_attention_ref``. The reference's ``block_q`` and ``block_k`` bound
the memory of its jnp recurrence; K6 blocks inside the kernel and masks a
ragged last block, so no block size is taken here, and the reference's
rule that Sq and Sk be multiples of their block sizes does not apply.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import attention as k6_attention


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """q [B, Hq, Sq, Dk]; k [B, Hkv, Sk, Dk]; v [B, Hkv, Sk, Dv] ->
    [B, Hq, Sq, Dv] in q's dtype; causal only with Sq == Sk."""
    return k6_attention(q, k, v, causal, scale)
