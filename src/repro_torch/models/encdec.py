"""Encoder-decoder backbone (seamless-m4t-medium).

A speech encoder (bidirectional self-attention over precomputed frame
embeddings: the modality frontend is a stub) and a text decoder with
causal self-attention, cross-attention to the encoder's output and SwiGLU
FFNs, as the reference's. The reference stacks each stack's layers and
scans them; this package holds them as lists, ``params["enc"]`` and
``params["dec"]``, and loops (``core.interop.encdec_params_from_numpy``
carries the reference's stacked trees across).

On the card ``encode`` launches K6 once a layer (not causal, a base form);
each ``decode_step`` launches K5 twice a layer: the self-attention over
the decoder's cache and the cross-attention over the whole source. A CPU
tensor runs the kernels' plain versions.

Parameters: ``{"embed": {"table"}, "enc": [layer, ...], "dec": [layer,
...], "enc_norm", "final_norm": {"scale"}, "lm_head"}``, an encoder layer
``{"norm1", "self_attn", "norm2", "ffn"}``, a decoder layer ``{"norm1",
"self_attn", "norm_x", "cross_attn", "norm2", "ffn"}``.

Caches: one ``{"k", "v": [B, Hkv, max_seq, D]}`` a decoder layer, written
in place by ``decode_step``; the cross K/V one ``(k, v)`` pair [B, Hkv,
S_src, D] a decoder layer, computed once (``precompute_cross_kv``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    F32,
    chunked_softmax_xent,
    embed,
    init_embedding,
    init_rmsnorm,
    init_swiglu,
    rmsnorm,
    swiglu,
    truncated_normal,
)

Params = Dict[str, Any]
Cross = List[Tuple[torch.Tensor, torch.Tensor]]


def _init_attn(gen, cfg: ArchConfig, device, dtype) -> Params:
    return attn_lib.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.qk_norm, cfg.qkv_bias, device=device, dtype=dtype)


def _init_layer(gen, cfg: ArchConfig, cross: bool, device, dtype) -> Params:
    p: Params = {"norm1": init_rmsnorm(cfg.d_model, device),
                 "self_attn": _init_attn(gen, cfg, device, dtype)}
    if cross:
        p["norm_x"] = init_rmsnorm(cfg.d_model, device)
        p["cross_attn"] = _init_attn(gen, cfg, device, dtype)
    p["norm2"] = init_rmsnorm(cfg.d_model, device)
    p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, device=device,
                           dtype=dtype)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, device=None,
                dtype=F32) -> Params:
    """Random parameters drawn from ``gen`` and placed on ``device``:
    matrices in ``dtype``, norm scales and biases in float32."""
    cfg.validate()
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device=device,
                                dtype=dtype),
        "enc": [_init_layer(gen, cfg, False, device, dtype)
                for _ in range(cfg.n_enc_layers)],
        "dec": [_init_layer(gen, cfg, True, device, dtype)
                for _ in range(cfg.n_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, device),
        "final_norm": init_rmsnorm(cfg.d_model, device),
        "lm_head": truncated_normal(gen, (cfg.d_model, cfg.vocab),
                                    device=device, dtype=dtype),
    }


def _attn_kw(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.head_dim, rope_theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, eps=cfg.norm_eps)


def _cross_kw(cfg: ArchConfig) -> Dict[str, Any]:
    return dict(n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
                qk_norm=cfg.qk_norm, eps=cfg.norm_eps)


def _ffn(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + swiglu(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))


def encode(cfg: ArchConfig, params: Params,
           src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds [B, S_src, d] (precomputed frame embeddings) -> the
    encoder's output [B, S_src, d] in their dtype."""
    x = src_embeds
    kw = _attn_kw(cfg)
    for p in params["enc"]:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        o, _ = attn_lib.attn_full(p["self_attn"], h, causal=False, **kw)
        x = _ffn(p, x + o, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(cfg: ArchConfig, params: Params, enc_out: torch.Tensor,
                 tgt_tokens: torch.Tensor, dtype=F32) -> torch.Tensor:
    """Teacher-forced decoder forward. Returns the hidden states [B, S_tgt,
    d]; the cross-attention over S_tgt rows goes through
    ``blocked_attention``."""
    x = embed(params["embed"], tgt_tokens, dtype)
    kw = _attn_kw(cfg)
    for p in params["dec"]:
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        o, _ = attn_lib.attn_full(p["self_attn"], h, causal=True, **kw)
        x = x + o
        h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        ekv = attn_lib.cross_kv(p["cross_attn"], enc_out, **_cross_kw(cfg))
        o = attn_lib.attn_cross(p["cross_attn"], h, ekv,
                                n_heads=cfg.n_heads, **_cross_kw(cfg))
        x = _ffn(p, x + o, cfg)
    return x


def seq2seq_loss(cfg: ArchConfig, params: Params, src_embeds: torch.Tensor,
                 tgt_tokens: torch.Tensor, labels: torch.Tensor, dtype=F32
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's sequence-to-sequence loss: encode ``src_embeds``,
    decode ``tgt_tokens`` teacher-forced, ``chunked_softmax_xent`` of the
    head against ``labels``. Returns (loss, {"ce_loss", "tokens"}). On the
    card its backward runs K6's backward in the encoder (a base form) and
    K6's general backward in the decoder's cross-attention (S_tgt rows
    against S_src keys)."""
    enc_out = encode(cfg, params, src_embeds.to(dtype))
    x = decode_train(cfg, params, enc_out, tgt_tokens, dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    loss, count = chunked_softmax_xent(x, params["lm_head"], labels,
                                       cfg.loss_chunk)
    return loss, {"ce_loss": loss, "tokens": count}


def weight_decay_mask(cfg: ArchConfig, params: Params) -> Params:
    """A tree of bools like ``params``: the leaves the reference's AdamW
    decays. Its rule is ndim >= 2 on its own tree, whose encoder and
    decoder layers are stacked ``[L, ...]``; so every leaf of an encoder
    or decoder layer is decayed (norm scales and biases too), and elsewhere
    (the embedding, the head, the two final norms) only matrices."""
    def mark(tree, layer):
        if isinstance(tree, dict):
            return {k: mark(v, layer) for k, v in tree.items()}
        return layer or tree.dim() >= 2

    return {k: ([mark(p, True) for p in v] if k in ("enc", "dec")
                else mark(v, False)) for k, v in params.items()}


def init_dec_caches(cfg: ArchConfig, batch: int, max_seq: int, dtype=F32,
                    device=None) -> List[Dict[str, torch.Tensor]]:
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def precompute_cross_kv(cfg: ArchConfig, params: Params,
                        enc_out: torch.Tensor) -> Cross:
    """Every decoder layer's cross K/V from the encoder's output: one (k,
    v) pair [B, Hkv, S_src, D] a layer."""
    return [attn_lib.cross_kv(p["cross_attn"], enc_out, **_cross_kw(cfg))
            for p in params["dec"]]


def decode_step(cfg: ArchConfig, params: Params,
                caches: List[Dict[str, torch.Tensor]], cross: Cross,
                token: torch.Tensor, pos: torch.Tensor, dtype=F32,
                backend: str = "kernel"
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decoder token. token int32[B]; pos int32[B]; cross: the
    precomputed per-layer cross K/V. Returns (logits float32 [B, vocab],
    the caches, updated in place). ``backend="plain"`` runs K5's plain
    version in both attentions, on any device."""
    x = embed(params["embed"], token[:, None], dtype)
    kw = _attn_kw(cfg)
    for p, cache, ekv in zip(params["dec"], caches, cross):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        o, _ = attn_lib.attn_decode(p["self_attn"], h, cache, pos=pos,
                                    backend=backend, **kw)
        x = x + o
        h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        o = attn_lib.attn_cross(p["cross_attn"], h, ekv, n_heads=cfg.n_heads,
                                backend=backend, **_cross_kw(cfg))
        x = _ffn(p, x + o, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"].to(x.dtype)).to(F32)
    return logits, caches
