"""Plain PyTorch version of K6: causal grouped-query attention with the
softmax materialised (the reference's ``gqa_attention_ref``)."""

from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] with Hq % Hkv == 0.
    Returns [B, Hq, S, D] in q's dtype; the arithmetic is float32. Masked
    logits are ``-inf``, as in the reference."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qf = q.to(F32).reshape(b, hkv, g, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(F32)) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(F32))
    return out.reshape(b, hq, s, d).to(q.dtype)
