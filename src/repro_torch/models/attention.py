"""GQA attention (RoPE, optional qk-norm / QKV bias) with KV-cache support.

Covers the qwen2/qwen3/minicpm/starcoder2/llava/phi3.5/jamba attention
layers and the seamless encoder and decoder (cross-attention included).
Kernel dispatch goes through ``repro_torch.kernels``: a CUDA tensor
launches K6 (prefill) and K5 (decode) and a CPU tensor runs their plain
versions. ``attn_decode`` and ``attn_cross`` also take
``backend="plain"``, which runs K5's plain version on any device: the
card's reference for the decode checks.

``attn_decode`` writes the new token into the cache IN PLACE and returns
the same dict: the reference returns a new cache, but copying every
layer's cache on every step would double the decode's memory traffic.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.blocked_attention import blocked_attention
from repro_torch.models.layers import (
    F32,
    apply_rope,
    init_rmsnorm,
    rmsnorm,
    truncated_normal,
)

Params = Dict[str, torch.Tensor]
BACKENDS = ("kernel", "plain")


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, qk_norm: bool = False,
                   qkv_bias: bool = False, device=None, dtype=F32) -> Params:
    """Matrices in ``dtype``; biases and norm scales in float32."""
    def w(shape, std=0.02):
        return truncated_normal(gen, shape, std, device=device, dtype=dtype)

    p: Params = {
        "wq": w((d_model, n_heads * d_head)),
        "wk": w((d_model, n_kv_heads * d_head)),
        "wv": w((d_model, n_kv_heads * d_head)),
        "wo": w((n_heads * d_head, d_model), 0.02 / math.sqrt(2.0)),
    }
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv_heads),
                        ("bv", n_kv_heads)):
            p[name] = torch.zeros((n * d_head,), dtype=F32, device=device)
    if qk_norm:
        p["q_norm"] = init_rmsnorm(d_head, device)
        p["k_norm"] = init_rmsnorm(d_head, device)
    return p


def _project(p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int,
             d_head: int, qk_norm: bool, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> q [B, Hq, S, D], k, v [B, Hkv, S, D] (views with the
    head axis swapped in, not contiguous)."""
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, n_heads, d_head).transpose(1, 2)
    k = k.reshape(b, s, n_kv_heads, d_head).transpose(1, 2)
    v = v.reshape(b, s, n_kv_heads, d_head).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q, eps)
        k = rmsnorm(p["k_norm"], k, eps)
    return q, k, v


def attn_full(p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              d_head: int, rope_theta: float = 10000.0, causal: bool = True,
              qk_norm: bool = False, eps: float = 1e-5,
              positions: Optional[torch.Tensor] = None,
              use_rope: bool = True
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).

    Returns (out [B, S, d_model], (k, v) [B, Hkv, S, D] for the cache).
    """
    b, s, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv_heads, d_head, qk_norm, eps)
    if use_rope:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None, :]
        q = apply_rope(q, positions[:, None, :], rope_theta)
        k = apply_rope(k, positions[:, None, :], rope_theta)
    o = flash_attention(q, k, v, causal)
    o = o.transpose(1, 2).reshape(b, s, n_heads * d_head)
    return o @ p["wo"].to(x.dtype), (k, v)


def _quant_token(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (batch, head, token): t [B, Hkv, 1, D] ->
    (int8 values, float16 scales [B, Hkv, 1, 1])."""
    tf = t.to(F32)
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _write_token(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """cache[b, :, pos[b]] = new[b, :, 0] in place, for every b. A position
    past the end is clamped to the last slot and a negative one to 0, as
    ``dynamic_update_slice`` clamps its start index."""
    s = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.to(device=cache.device, dtype=torch.long).clamp(0, s - 1)
    cache[rows, :, idx] = new[:, :, 0]


def attn_decode(p: Params, x: torch.Tensor, kv_cache: Dict[str, torch.Tensor],
                *, n_heads: int, n_kv_heads: int, d_head: int,
                rope_theta: float = 10000.0, qk_norm: bool = False,
                eps: float = 1e-5, pos: torch.Tensor, use_rope: bool = True,
                backend: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: [B, 1, d]; pos: int32[B] current lengths, on
    x's device.

    Cache forms: {k, v: [B, Hkv, S, D]} in x's dtype, or int8-quantised
    {k, v: int8 [B, Hkv, S, D], k_scale, v_scale: float16 [B, Hkv, S, 1]},
    whose whole cache is dequantised into x's dtype before attention, as
    the reference does. Returns (out [B, 1, d], the cache, updated in
    place).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    b = x.shape[0]
    q, k, v = _project(p, x, n_heads, n_kv_heads, d_head, qk_norm, eps)
    if use_rope:
        q = apply_rope(q, pos[:, None, None], rope_theta)
        k = apply_rope(k, pos[:, None, None], rope_theta)
    if "k_scale" in kv_cache:
        kq, ks = _quant_token(k)
        vq, vs = _quant_token(v)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _write_token(kv_cache[name], new, pos)
        dtype = x.dtype
        ck = kv_cache["k"].to(dtype) * kv_cache["k_scale"].to(dtype)
        cv = kv_cache["v"].to(dtype) * kv_cache["v_scale"].to(dtype)
    else:
        _write_token(kv_cache["k"], k, pos)
        _write_token(kv_cache["v"], v, pos)
        ck, cv = kv_cache["k"], kv_cache["v"]
    kv_len = (pos + 1).to(torch.int32)
    if backend == "plain":
        o = decode_attention_ref(q[:, :, 0], ck, cv, kv_len)
    else:
        o = decode_attention(q[:, :, 0], ck, cv, kv_len)
    o = o.reshape(b, 1, n_heads * d_head)
    return o @ p["wo"].to(x.dtype), kv_cache


def attn_cross(p: Params, x: torch.Tensor,
               enc_kv: Tuple[torch.Tensor, torch.Tensor], *, n_heads: int,
               n_kv_heads: int, d_head: int, qk_norm: bool = False,
               eps: float = 1e-5, backend: str = "kernel") -> torch.Tensor:
    """Cross-attention: queries from x [B, S, d], K and V [B, Hkv, S_src,
    D] precomputed from the encoder's output (``cross_kv``). One query row
    (a decode step) is K5 over the whole source (``kv_len = S_src`` for
    every row; its plain version with ``backend="plain"``); more rows go
    through ``blocked_attention`` (K6's general form, not causal)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, n_heads, d_head).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q, eps)
    k, v = enc_kv
    if s == 1:
        kv_len = torch.full((b,), k.shape[2], dtype=torch.int32,
                            device=x.device)
        attend = decode_attention_ref if backend == "plain" \
            else decode_attention
        o = attend(q[:, :, 0], k, v, kv_len)[:, None]      # [B, 1, Hq, D]
    else:
        o = blocked_attention(q, k, v, causal=False).transpose(1, 2)
    return o.reshape(b, s, n_heads * d_head) @ p["wo"].to(x.dtype)


def cross_kv(p: Params, enc_out: torch.Tensor, *, n_kv_heads: int,
             d_head: int, qk_norm: bool = False, eps: float = 1e-5
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K and V for cross-attention, [B, Hkv, S_src, D] each,
    contiguous (they are read by every decode step)."""
    b, s, _ = enc_out.shape
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    if "bk" in p:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    k = k.reshape(b, s, n_kv_heads, d_head).transpose(1, 2)
    v = v.reshape(b, s, n_kv_heads, d_head).transpose(1, 2)
    if qk_norm:
        k = rmsnorm(p["k_norm"], k, eps)
    return k.contiguous(), v.contiguous()
