"""Decoder-only LM: embeds -> blocks -> norm -> logits (dense-GQA subset).

The reference stacks its body over groups and applies it with
``lax.scan``; this package holds the blocks as a plain list in layer order
(the prefix layers, then group by group the slots of the period) and loops
over it. Supported here: every block whose mixer is GQA attention
(``attn_type="gqa"``) and whose FFN is dense, which covers qwen3-14b,
qwen2-72b, minicpm-2b, starcoder2-7b and llava-next-34b (through
``embeds``). MLA, MoE, the mamba/mLSTM/sLSTM mixers and the training loss
raise ``NotImplementedError``; they are queued in ROADMAP item 9.

Parameters: ``{"embed": {"table"}, "final_norm": {"scale"},
"lm_head" (untied only), "layers": [block, ...]}`` with each block
``{"norm1", "mixer": attention params, "norm2", "ffn": SwiGLU params}``.

Caches: a list with one dict per layer in the same order, ``{"k", "v":
[B, Hkv, max_seq, D]}`` in the compute dtype, or the int8 form ``{"k",
"v": int8, "k_scale", "v_scale": float16 [B, Hkv, max_seq, 1]}`` when
``cfg.kv_quant``. ``decode_step`` updates them in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    F32,
    embed,
    init_embedding,
    init_rmsnorm,
    init_swiglu,
    rmsnorm,
    swiglu,
    truncated_normal,
)

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]

_ROADMAP = "queued in ROADMAP item 9 (LLM model stack)"


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer in order: the prefix, then each group's
    period."""
    period = list(zip(cfg.period, cfg.ffn_period))
    return list(cfg.prefix) + period * cfg.groups


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family this package does not
    port yet."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; "
            + _ROADMAP)
    for mixer, ffn in layer_kinds(cfg):
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the {mixer} mixer is not ported yet; "
                + _ROADMAP)
        if cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.attn_type} attention is not ported yet; "
                + _ROADMAP)
        if ffn != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {ffn} FFN is not ported yet; " + _ROADMAP)


# ---------------------------------------------------------------- blocks ----

def init_block(gen: torch.Generator, cfg: ArchConfig, device=None,
               dtype=F32) -> Params:
    """One ("attn", "dense") block: GQA attention and a SwiGLU FFN."""
    return {
        "norm1": init_rmsnorm(cfg.d_model, device),
        "mixer": attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.qk_norm, cfg.qkv_bias, device=device, dtype=dtype),
        "norm2": init_rmsnorm(cfg.d_model, device),
        "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff, device=device,
                           dtype=dtype),
    }


def apply_block_full(p: Params, x: torch.Tensor, cfg: ArchConfig,
                     positions: Optional[torch.Tensor],
                     collect_cache: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Pre-norm residual block. Returns (x, {"k", "v"} or None)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, (k, v) = attn_lib.attn_full(
        p["mixer"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        qk_norm=cfg.qk_norm, eps=cfg.norm_eps, positions=positions,
        use_rope=cfg.use_rope)
    x = x + mix
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    x = x + swiglu(p["ffn"], h)
    return x, ({"k": k, "v": v} if collect_cache else None)


def apply_block_decode(p: Params, x: torch.Tensor, cache: Dict[str, Any],
                       cfg: ArchConfig, pos: torch.Tensor,
                       backend: str = "kernel"
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, cache = attn_lib.attn_decode(
        p["mixer"], h, cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        eps=cfg.norm_eps, pos=pos, use_rope=cfg.use_rope, backend=backend)
    x = x + mix
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + swiglu(p["ffn"], h), cache


# ---------------------------------------------------------------- model ----

def init_params(cfg: ArchConfig, gen: torch.Generator, device=None,
                dtype=F32) -> Params:
    """Random parameters drawn from ``gen`` and placed on ``device``:
    matrices in ``dtype`` (each drawn in float32 and cast before the next
    is drawn, so the largest transient is one float32 matrix), norm scales
    and biases in float32."""
    cfg.validate()
    check_supported(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device=device,
                                dtype=dtype),
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                             device=device, dtype=dtype)
    params["layers"] = [init_block(gen, cfg, device=device, dtype=dtype)
                        for _ in layer_kinds(cfg)]
    return params


def head_matrix(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])


def logits_of(cfg: ArchConfig, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head in the compute dtype, then float32 (the
    reference's order: the logits are not computed in float32)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ head_matrix(cfg, params).to(x.dtype)).to(F32)


def forward(cfg: ArchConfig, params: Params,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            collect_caches: bool = False, dtype=F32
            ) -> Tuple[torch.Tensor, Caches, torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B, S, d], caches (one
    {"k", "v"} per layer when ``collect_caches``, else empty), aux loss 0).

    ``embeds`` (precomputed modality embeddings, [B, S, d_model]) may
    replace ``tokens``.
    """
    check_supported(cfg)
    if embeds is not None:
        x = embeds.to(dtype)
    else:
        x = embed(params["embed"], tokens, dtype)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    caches: Caches = []
    for p in params["layers"]:
        x, cache = apply_block_full(p, x, cfg, positions, collect_caches)
        if collect_caches:
            caches.append(cache)
    return x, caches, torch.zeros((), dtype=F32, device=x.device)


def lm_loss(*args, **kwargs):
    raise NotImplementedError("lm_loss (training) is not ported yet; "
                              + _ROADMAP)


# ---------------------------------------------------------------- decode ----

def _zero_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                device=None) -> Dict[str, torch.Tensor]:
    """One GQA attention layer's cache."""
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    if cfg.kv_quant:
        scale_shape = shape[:3] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float16,
                                   device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float16,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, dtype=F32,
                device=None) -> Caches:
    check_supported(cfg)
    return [_zero_cache(cfg, batch, max_seq, dtype, device)
            for _ in layer_kinds(cfg)]


def decode_step(cfg: ArchConfig, params: Params, caches: Caches,
                token: torch.Tensor, pos: torch.Tensor, dtype=F32,
                backend: str = "kernel") -> Tuple[torch.Tensor, Caches]:
    """One decode step. token int32[B]; pos int32[B] current lengths (both
    on the parameters' device).

    Returns (logits float32 [B, vocab], the caches, updated in place).
    """
    x = embed(params["embed"], token[:, None], dtype)         # [B, 1, d]
    for p, cache in zip(params["layers"], caches):
        x, _ = apply_block_decode(p, x, cache, cfg, pos, backend)
    return logits_of(cfg, params, x[:, 0]), caches
