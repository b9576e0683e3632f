"""Plain PyTorch version of K6: grouped-query attention with the softmax
materialised (the reference's ``gqa_attention_ref``), at K6's general
shapes: a query/key width apart from the value width, and the query and
key lengths apart."""

from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, Dqk]; k: [B, Hkv, Sk, Dqk]; v: [B, Hkv, Sk, Dv] with
    Hq % Hkv == 0; the logits times ``scale`` (1/sqrt(Dqk) by default);
    causal only with Sq == Sk. Returns [B, Hq, Sq, Dv] in q's dtype; the
    arithmetic is float32. Masked logits are ``-inf``, as in the
    reference."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs Sq == Sk (got {sq}, {sk})")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qf = q.to(F32).reshape(b, hkv, g, sq, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(F32)) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(F32))
    return out.reshape(b, hq, sq, dv).to(q.dtype)
