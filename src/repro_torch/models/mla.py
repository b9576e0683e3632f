"""Multi-head Latent Attention (DeepSeek-V3) with a compressed latent KV
cache.

The prefill materialises per-head K and V from the shared latent and runs
``blocked_attention`` (on the card K6's general form at d_qk = nope + rope
against d_v); decode runs the absorbed formulation against the latent
cache {``ckv`` [B, S, kv_lora], ``k_rope`` [B, S, rope]}, as einsums and
matrix products (no kernel), like the reference.

``mla_decode`` writes the new token's latents into the cache IN PLACE and
returns the same dict (a position past the end clamps to the last slot, as
``dynamic_update_slice`` clamps); the reference returns a new cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocked_attention import blocked_attention
from repro_torch.models.layers import (
    F32,
    apply_rope,
    init_rmsnorm,
    rmsnorm,
    truncated_normal,
)

Params = Dict[str, torch.Tensor]


def init_mla(gen: torch.Generator, cfg: ArchConfig, device=None,
             dtype=F32) -> Params:
    """Matrices in ``dtype``; norm scales in float32."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim

    def w(shape, std=0.02):
        return truncated_normal(gen, shape, std, device=device, dtype=dtype)

    return {
        "w_dq": w((d, cfg.mla_q_lora)),
        "q_norm": init_rmsnorm(cfg.mla_q_lora, device),
        "w_uq": w((cfg.mla_q_lora, h * (nope + rope))),
        "w_dkv": w((d, cfg.mla_kv_lora)),
        "kv_norm": init_rmsnorm(cfg.mla_kv_lora, device),
        "w_uk": w((cfg.mla_kv_lora, h * nope)),
        "w_uv": w((cfg.mla_kv_lora, h * vd)),
        "w_kr": w((d, rope)),
        "wo": w((h * vd, d), 0.02 / math.sqrt(2.0)),
    }


def _latents(p: Params, x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """x [B, S, d] -> (q_nope [B, S, H, nope], q_rope [B, S, H, rope],
    c_kv [B, S, kv_lora], k_rope [B, S, rope])."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim
    cq = rmsnorm(p["q_norm"], x @ p["w_dq"].to(x.dtype), cfg.norm_eps)
    q = (cq @ p["w_uq"].to(x.dtype)).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None, :],
                        cfg.rope_theta).transpose(1, 2)
    ckv = rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(x.dtype), cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"].to(x.dtype))[:, None],
                        positions[:, None, :], cfg.rope_theta)[:, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_full(p: Params, x: torch.Tensor, cfg: ArchConfig,
             positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence MLA (prefill). Returns (out [B, S, d], the latent
    cache {"ckv", "k_rope"})."""
    b, s, _ = x.shape
    h, nope, rope, vd = (cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim,
                         cfg.mla_v_dim)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    q_nope, q_rope, ckv, k_rope = _latents(p, x, cfg, positions)
    k_nope = (ckv @ p["w_uk"].to(x.dtype)).reshape(b, s, h, nope)
    v = (ckv @ p["w_uv"].to(x.dtype)).reshape(b, s, h, vd)
    scale = 1.0 / float(nope + rope) ** 0.5
    # per-head q and k with the shared rope part appended to every head
    qh = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)   # [B,H,S,dk]
    kh = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rope)],
                   dim=-1).transpose(1, 2)
    vh = v.transpose(1, 2)                                      # [B,H,S,dv]
    o = blocked_attention(qh, kh, vh, causal=cfg.causal, scale=scale)
    o = o.transpose(1, 2).reshape(b, s, h * vd)
    return o @ p["wo"].to(x.dtype), {"ckv": ckv, "k_rope": k_rope}


def _write_latent(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b, 0] in place, the index clamped to the
    cache, as ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.to(device=cache.device, dtype=torch.long).clamp(
        0, cache.shape[1] - 1)
    cache[rows, idx] = new[:, 0]


def mla_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ArchConfig, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed one-token decode against the latent cache. x [B, 1, d];
    cache {ckv [B, S, kv_lora], k_rope [B, S, rope]}; pos int32[B]. Returns
    (out [B, 1, d], the cache, updated in place)."""
    b = x.shape[0]
    h, nope, vd = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_v_dim
    q_nope, q_rope, ckv_new, kr_new = _latents(p, x, cfg, pos[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]                 # [B, H, *]
    _write_latent(cache["ckv"], ckv_new, pos)
    _write_latent(cache["k_rope"], kr_new, pos)
    ckv = cache["ckv"].to(F32)
    w_uk = p["w_uk"].to(x.dtype).reshape(-1, h, nope)           # [C, H, n]
    w_uv = p["w_uv"].to(x.dtype).reshape(-1, h, vd)             # [C, H, v]
    q_c = torch.einsum("bhn,chn->bhc", q_nope, w_uk)   # absorb W_uk
    scale = 1.0 / float(nope + cfg.mla_rope_dim) ** 0.5
    logits = (torch.einsum("bhc,btc->bht", q_c.to(F32), ckv)
              + torch.einsum("bhr,btr->bht", q_rope.to(F32),
                             cache["k_rope"].to(F32))) * scale
    valid = (torch.arange(ckv.shape[1], device=x.device)[None, None, :]
             <= pos.to(x.device)[:, None, None])
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o_c = torch.einsum("bht,btc->bhc", w, ckv)                  # latent out
    o = torch.einsum("bhc,chv->bhv", o_c.to(x.dtype), w_uv)
    return o.reshape(b, 1, h * vd) @ p["wo"].to(x.dtype), cache
