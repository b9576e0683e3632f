"""Shared model layers: norms, RoPE, SwiGLU FFN, embeddings.

Plain functions on dicts of tensors, as in the reference package, so that
its parameter trees carry across leaf for leaf (``core.interop``). Weight
matrices keep the reference's ``[d_in, d_out]`` layout (``x @ w``). The
compute dtype is the input's; norms and RoPE angles are taken in float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]
F32 = torch.float32

#: matrices that the reference keeps and uses in float32 (the MoE router,
#: whose routing is computed in float32, and the Mamba ``A_log``, whose
#: ``-exp`` sets the decay rates): they are never cast to the compute
#: dtype, at the host draw or in the parameter bridge
REFERENCE_F32 = frozenset({"router", "A_log"})


def truncated_normal(gen: torch.Generator, shape, std: float = 0.02,
                     device=None, dtype=F32) -> torch.Tensor:
    """A normal sample truncated at +-2, times ``std``, drawn in float32
    from ``gen`` on the generator's device, cast to ``dtype`` there and
    then moved to ``device`` (so a seed gives the same values on any
    device)."""
    t = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype).to(device)


# ---- norms -------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=F32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32)).to(x.dtype)


def init_layernorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=F32, device=device),
            "bias": torch.zeros((d,), dtype=F32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---- rotary embeddings -------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, D] (D even); positions: broadcastable to [..., S]. The
    two halves of D rotate together (split, not interleaved)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # [D/2]
    angles = positions[..., None].to(F32) * freqs                # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---- FFNs --------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d: int, h: int, device=None,
                dtype=F32) -> Params:
    return {
        "w_gate": truncated_normal(gen, (d, h), device=device, dtype=dtype),
        "w_up": truncated_normal(gen, (d, h), device=device, dtype=dtype),
        "w_down": truncated_normal(gen, (h, d), std=0.02 / math.sqrt(2.0),
                                   device=device, dtype=dtype),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


# ---- embeddings --------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, device=None,
                   dtype=F32) -> Params:
    return {"table": truncated_normal(gen, (vocab, d), device=device,
                                      dtype=dtype)}


def embed(p: Params, tokens: torch.Tensor,
          dtype: torch.dtype = F32) -> torch.Tensor:
    """The table is cast to ``dtype`` before the gather, as the reference
    casts it."""
    return p["table"].to(dtype)[tokens.long()]


# ---- loss --------------------------------------------------------------------

def _chunk_xent(xb: torch.Tensor, head: torch.Tensor, lb: torch.Tensor):
    """(summed loss, count of labels >= 0) of one sequence chunk, its
    logits float32."""
    logits = (xb @ head.to(xb.dtype)).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp(lb, min=0).long()[..., None]
                          )[..., 0]
    valid = lb >= 0
    loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return loss.sum(), valid.sum()


def chunked_softmax_xent(x: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512):
    """Cross entropy without materialising [B, S, V]: x [B, S, d] final
    hidden states, head [d, V], labels [B, S] (-100 = ignore). Returns
    (mean loss over the counted labels, float32; the count, int64).

    Chunks run over the sequence (a ragged tail is padded with label
    -100), each chunk's logits [B, c, V] in float32. While grad is on,
    each chunk is checkpointed (``torch.utils.checkpoint``, non-reentrant)
    and its logits recomputed in the backward, as the reference's
    ``jax.checkpoint(nothing_saveable)``: saving them across chunks would
    hold the whole [B, S, V] the chunking avoids."""
    b, s, d = x.shape
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
        s += pad
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    grad = torch.is_grad_enabled()
    for c0 in range(0, s, chunk):
        xb, lb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if grad:
            loss, n = torch.utils.checkpoint.checkpoint(
                _chunk_xent, xb, head, lb, use_reentrant=False)
        else:
            loss, n = _chunk_xent(xb, head, lb)
        tot = tot + loss
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1), cnt
