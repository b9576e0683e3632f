"""Plain PyTorch version of K5: one-token GQA decode attention over a KV
cache (the reference's ``decode_attention_ref``)."""

from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, D] (the new token's queries); k, v: [B, Hkv, S, D] (the
    cache; positions >= kv_len are padding); kv_len: int32[B] valid lengths
    (None = the whole cache). Returns [B, Hq, D] in q's dtype; the
    arithmetic is float32 and padding is masked with ``-1e30``."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qf = q.to(F32).reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bhtd->bhgt", qf, k.to(F32)) * scale
    if kv_len is not None:
        cols = torch.arange(s, device=q.device)
        mask = cols[None, None, None, :] < kv_len.to(q.device)[:, None, None,
                                                               None]
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.to(F32))
    return out.reshape(b, hq, d).to(q.dtype)
