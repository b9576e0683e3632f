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
