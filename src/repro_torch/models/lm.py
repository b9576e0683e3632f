"""Decoder-only LM: embeds -> blocks -> norm -> logits.

The reference stacks its body over groups and applies it with
``lax.scan``; this package holds the blocks as a plain list in layer order
(the prefix layers, then group by group the slots of the period) and loops
over it. Each layer has a mixer and an FFN kind, ``layer_kinds(cfg)``.
Supported here: GQA attention (``attn_type="gqa"``) and Mamba mixers,
dense SwiGLU, MoE or no FFN. That covers qwen3-14b, qwen2-72b, minicpm-2b,
starcoder2-7b, llava-next-34b (through ``embeds``), phi3.5-moe and jamba.
MLA, the mLSTM/sLSTM mixers, encoder-decoder models and the training loss
raise ``NotImplementedError``; they are queued in ROADMAP.md §1, LLM model
stack.

Parameters: ``{"embed": {"table"}, "final_norm": {"scale"},
"lm_head" (untied only), "layers": [block, ...]}`` with each block
``{"norm1", "mixer": attention or Mamba params, "norm2", "ffn": SwiGLU or
MoE params}`` (no ``norm2``/``ffn`` where the FFN kind is ``"none"``).

Caches: a list with one dict per layer in the same order. Attention:
``{"k", "v": [B, Hkv, max_seq, D]}`` in the compute dtype, or the int8
form ``{"k", "v": int8, "k_scale", "v_scale": float16 [B, Hkv, max_seq,
1]}`` when ``cfg.kv_quant``. Mamba: ``{"h": float32 [B, d_inner,
d_state], "conv": [B, d_conv - 1, d_inner]}`` in the compute dtype.
``decode_step`` updates them in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
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

_ROADMAP = "queued in ROADMAP.md §1, LLM model stack"
MIXERS = ("attn", "mamba")


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer in order: the prefix, then each group's
    period."""
    period = list(zip(cfg.period, cfg.ffn_period))
    return list(cfg.prefix) + period * cfg.groups


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family this package does not
    port yet: encoder-decoder models, MLA attention and the mLSTM/sLSTM
    mixers."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; "
            + _ROADMAP)
    for mixer, ffn in layer_kinds(cfg):
        if mixer not in MIXERS:
            raise NotImplementedError(
                f"{cfg.name}: the {mixer} mixer is not ported yet (ported: "
                f"{', '.join(MIXERS)}); " + _ROADMAP)
        if mixer == "attn" and cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.attn_type} attention is not ported yet "
                f"(ported: gqa); " + _ROADMAP)


# ---------------------------------------------------------------- blocks ----

def init_block(gen: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
               device=None, dtype=F32) -> Params:
    """One block: a GQA attention or Mamba mixer and a SwiGLU, MoE or no
    FFN."""
    p: Params = {"norm1": init_rmsnorm(cfg.d_model, device)}
    if mixer == "attn":
        p["mixer"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.qk_norm, cfg.qkv_bias, device=device, dtype=dtype)
    else:
        p["mixer"] = ssm_lib.init_mamba(gen, cfg, device=device, dtype=dtype)
    if ffn == "none":
        return p
    p["norm2"] = init_rmsnorm(cfg.d_model, device)
    if ffn == "moe":
        p["ffn"] = moe_lib.init_moe(gen, cfg, device=device, dtype=dtype)
    else:
        p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, device=device,
                               dtype=dtype)
    return p


def _mixer_full(p: Params, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if mixer == "mamba":
        return ssm_lib.mamba_full(p, x, cfg)
    out, (k, v) = attn_lib.attn_full(
        p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        qk_norm=cfg.qk_norm, eps=cfg.norm_eps, positions=positions,
        use_rope=cfg.use_rope)
    return out, {"k": k, "v": v}


def _mixer_decode(p: Params, x: torch.Tensor, cache: Dict[str, Any],
                  cfg: ArchConfig, mixer: str, pos: torch.Tensor,
                  backend: str) -> Tuple[torch.Tensor, Dict[str, Any]]:
    if mixer == "mamba":
        return ssm_lib.mamba_decode(p, x, cache, cfg)
    return attn_lib.attn_decode(
        p, x, cache, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        eps=cfg.norm_eps, pos=pos, use_rope=cfg.use_rope, backend=backend)


def _ffn(p: Params, x: torch.Tensor, cfg: ArchConfig, ffn: str
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-norm FFN residual: (x + ffn(norm2(x)), MoE aux loss, 0
    unless the FFN is MoE)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    if ffn == "none":
        return x, aux
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        out, metrics = moe_lib.moe_forward(p["ffn"], h, cfg)
        return x + out, metrics["aux_loss"]
    return x + swiglu(p["ffn"], h), aux


def apply_block_full(p: Params, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                     ffn: str, positions: Optional[torch.Tensor],
                     collect_cache: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]],
                                torch.Tensor]:
    """Pre-norm residual block. Returns (x, cache or None, MoE aux)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, cache = _mixer_full(p["mixer"], h, cfg, mixer, positions)
    x, aux = _ffn(p, x + mix, cfg, ffn)
    return x, (cache if collect_cache else None), aux


def apply_block_decode(p: Params, x: torch.Tensor, cache: Dict[str, Any],
                       cfg: ArchConfig, mixer: str, ffn: str,
                       pos: torch.Tensor, backend: str = "kernel"
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix, cache = _mixer_decode(p["mixer"], h, cache, cfg, mixer, pos,
                               backend)
    x, _ = _ffn(p, x + mix, cfg, ffn)
    return x, cache


# ---------------------------------------------------------------- model ----

def init_params(cfg: ArchConfig, gen: torch.Generator, device=None,
                dtype=F32) -> Params:
    """Random parameters drawn from ``gen`` and placed on ``device``:
    matrices in ``dtype`` (each drawn in float32 and cast before the next
    is drawn, so the largest transient is one float32 matrix) except the
    reference's float32 ones (``layers.REFERENCE_F32``), norm scales,
    biases and other vectors in float32."""
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
    params["layers"] = [init_block(gen, cfg, m, f, device=device, dtype=dtype)
                        for m, f in layer_kinds(cfg)]
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
    """Full-sequence forward. Returns (hidden [B, S, d], caches (one per
    layer when ``collect_caches``: attention {"k", "v"} [B, Hkv, S, D],
    Mamba {"h", "conv"}; else empty), the MoE aux loss summed over the
    layers).

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
    aux = torch.zeros((), dtype=F32, device=x.device)
    for p, (mixer, ffn) in zip(params["layers"], layer_kinds(cfg)):
        x, cache, a = apply_block_full(p, x, cfg, mixer, ffn, positions,
                                       collect_caches)
        aux = aux + a
        if collect_caches:
            caches.append(cache)
    return x, caches, aux


def lm_loss(*args, **kwargs):
    raise NotImplementedError("lm_loss (training) is not ported yet; "
                              + _ROADMAP)


# ---------------------------------------------------------------- decode ----

def _zero_cache(cfg: ArchConfig, mixer: str, batch: int, max_seq: int,
                dtype, device=None) -> Dict[str, torch.Tensor]:
    """One layer's cache: GQA attention's KV cache or Mamba's state."""
    if mixer == "mamba":
        di = cfg.ssm_expand * cfg.d_model
        return {"h": torch.zeros((batch, di, cfg.ssm_d_state), dtype=F32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, di),
                                    dtype=dtype, device=device)}
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
    return [_zero_cache(cfg, m, batch, max_seq, dtype, device)
            for m, _ in layer_kinds(cfg)]


def decode_step(cfg: ArchConfig, params: Params, caches: Caches,
                token: torch.Tensor, pos: torch.Tensor, dtype=F32,
                backend: str = "kernel") -> Tuple[torch.Tensor, Caches]:
    """One decode step. token int32[B]; pos int32[B] current lengths (both
    on the parameters' device).

    Returns (logits float32 [B, vocab], the caches, updated in place).
    """
    x = embed(params["embed"], token[:, None], dtype)         # [B, 1, d]
    for p, cache, (mixer, ffn) in zip(params["layers"], caches,
                                      layer_kinds(cfg)):
        x, _ = apply_block_decode(p, x, cache, cfg, mixer, ffn, pos, backend)
    return logits_of(cfg, params, x[:, 0]), caches
