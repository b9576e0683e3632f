"""Decoder-only LM: embeds -> blocks -> norm -> logits.

The reference stacks its body over groups and applies it with
``lax.scan``; this package holds the blocks as a plain list in layer order
(the prefix layers, then group by group the slots of the period) and loops
over it. Each layer has a mixer and an FFN kind, ``layer_kinds(cfg)``.
Supported here: GQA (``attn_type="gqa"``) and MLA (``"mla"``)
attention, Mamba, mLSTM and sLSTM mixers, dense SwiGLU, MoE or no FFN.
That covers every decoder-only config: qwen3-14b, qwen2-72b, minicpm-2b,
starcoder2-7b, llava-next-34b (through ``embeds``), phi3.5-moe, jamba,
deepseek-v3 and xlstm. Encoder-decoder models are ``models.encdec``'s.
The training loss (``lm_loss``) takes every one of them: on the card a
Mamba layer trains through K7's backward, MLA through K6's general
backward, and the mLSTM/sLSTM mixers through their chunked remat
(``scan_utils.chunked_scan``).

While grad is enabled and its input or parameters require grad (not in
serving), ``forward`` checkpoints each group of the period as
``cfg.remat`` says (the reference's ``_remat_wrap``): ``"full"``
recomputes the group in the backward (``torch.utils.checkpoint``,
non-reentrant), ``"dots"`` saves the matrix products' outputs and
recomputes the rest, ``"none"`` saves everything.

Parameters: ``{"embed": {"table"}, "final_norm": {"scale"},
"lm_head" (untied only), "layers": [block, ...]}`` with each block
``{"norm1", "mixer": GQA, MLA, Mamba, mLSTM or sLSTM params, "norm2",
"ffn": SwiGLU or MoE params}`` (no ``norm2``/``ffn`` where the FFN kind is
``"none"``).

Caches: a list with one dict per layer in the same order. Attention:
``{"k", "v": [B, Hkv, max_seq, D]}`` in the compute dtype, or the int8
form ``{"k", "v": int8, "k_scale", "v_scale": float16 [B, Hkv, max_seq,
1]}`` when ``cfg.kv_quant``. MLA: the latent cache ``{"ckv": [B,
max_seq, kv_lora], "k_rope": [B, max_seq, rope]}`` in the compute dtype.
Mamba: ``{"h": float32 [B, d_inner, d_state], "conv": [B, d_conv - 1,
d_inner]}`` in the compute dtype. mLSTM ``{"c": [B, H, dh, dh], "n": [B,
H, dh], "m": [B, H]}`` and sLSTM ``{"c", "n", "m": [B, d_model]}``, all
float32. ``decode_step`` updates them in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
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
from repro_torch.optim.adamw import tree_leaves

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]

_ROADMAP = "queued in ROADMAP.md §1, LLM model stack"
MIXERS = ("attn", "mamba", "mlstm", "slstm")
ATTN_TYPES = ("gqa", "mla")


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer in order: the prefix, then each group's
    period."""
    period = list(zip(cfg.period, cfg.ffn_period))
    return list(cfg.prefix) + period * cfg.groups


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config this module does not
    build: an encoder-decoder model (``models.encdec``'s), a mixer or an
    attention type it does not know."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder model is models.encdec's, not "
            f"the decoder-only LM's")
    for mixer, ffn in layer_kinds(cfg):
        if mixer not in MIXERS:
            raise NotImplementedError(
                f"{cfg.name}: the {mixer} mixer is not ported (ported: "
                f"{', '.join(MIXERS)}); " + _ROADMAP)
        if mixer == "attn" and cfg.attn_type not in ATTN_TYPES:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.attn_type} attention is not ported "
                f"(ported: {', '.join(ATTN_TYPES)}); " + _ROADMAP)


def weight_decay_mask(cfg: ArchConfig, params: Params) -> Params:
    """A tree of bools like ``params``: the leaves the reference's AdamW
    decays. Its rule is ndim >= 2 on its own tree, whose body leaves are
    stacked over groups ``[G, ...]``; so every leaf of a body layer is
    decayed (norm scales and biases too), and elsewhere (the embedding,
    the head, the final norm, the prefix layers) only matrices."""
    def mark(tree, body):
        if isinstance(tree, dict):
            return {k: mark(v, body) for k, v in tree.items()}
        return body or tree.dim() >= 2

    out = {k: mark(v, False) for k, v in params.items() if k != "layers"}
    out["layers"] = [mark(p, i >= len(cfg.prefix))
                     for i, p in enumerate(params["layers"])]
    return out


# ---------------------------------------------------------------- blocks ----

#: the recurrent mixers' (init, full-sequence, one-token decode) forms
_RECURRENT = {
    "mamba": (ssm_lib.init_mamba, ssm_lib.mamba_full, ssm_lib.mamba_decode),
    "mlstm": (xlstm_lib.init_mlstm, xlstm_lib.mlstm_full,
              xlstm_lib.mlstm_decode),
    "slstm": (xlstm_lib.init_slstm, xlstm_lib.slstm_full,
              xlstm_lib.slstm_decode),
}


def init_block(gen: torch.Generator, cfg: ArchConfig, mixer: str, ffn: str,
               device=None, dtype=F32) -> Params:
    """One block: a GQA or MLA attention, Mamba, mLSTM or sLSTM mixer and
    a SwiGLU, MoE or no FFN."""
    p: Params = {"norm1": init_rmsnorm(cfg.d_model, device)}
    if mixer == "attn" and cfg.attn_type == "mla":
        p["mixer"] = mla_lib.init_mla(gen, cfg, device=device, dtype=dtype)
    elif mixer == "attn":
        p["mixer"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.qk_norm, cfg.qkv_bias, device=device, dtype=dtype)
    else:
        p["mixer"] = _RECURRENT[mixer][0](gen, cfg, device=device,
                                          dtype=dtype)
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
    if mixer in _RECURRENT:
        return _RECURRENT[mixer][1](p, x, cfg)
    if cfg.attn_type == "mla":
        return mla_lib.mla_full(p, x, cfg, positions)
    out, (k, v) = attn_lib.attn_full(
        p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        qk_norm=cfg.qk_norm, eps=cfg.norm_eps, positions=positions,
        use_rope=cfg.use_rope)
    return out, {"k": k, "v": v}


def _mixer_decode(p: Params, x: torch.Tensor, cache: Dict[str, Any],
                  cfg: ArchConfig, mixer: str, pos: torch.Tensor,
                  backend: str) -> Tuple[torch.Tensor, Dict[str, Any]]:
    if mixer in _RECURRENT:
        return _RECURRENT[mixer][2](p, x, cache, cfg)
    if cfg.attn_type == "mla":
        return mla_lib.mla_decode(p, x, cache, cfg, pos)
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
    layer when ``collect_caches``: GQA attention {"k", "v"} [B, Hkv, S, D],
    MLA {"ckv", "k_rope"}, the recurrent mixers' state after the last
    token; else empty), the MoE aux loss summed over the
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
    kinds = layer_kinds(cfg)
    n_pre, period = len(cfg.prefix), len(cfg.period)
    for p, (mixer, ffn) in zip(params["layers"][:n_pre], kinds[:n_pre]):
        x, cache, a = apply_block_full(p, x, cfg, mixer, ffn, positions,
                                       collect_caches)
        aux = aux + a
        if collect_caches:
            caches.append(cache)

    def group(x, g):
        a_g = torch.zeros((), dtype=F32, device=x.device)
        cs = []
        for slot in range(period):
            i = n_pre + g * period + slot
            x, cache, a = apply_block_full(params["layers"][i], x, cfg,
                                           *kinds[i], positions,
                                           collect_caches)
            a_g = a_g + a
            cs.append(cache)
        return x, a_g, cs

    # checkpoint only a forward that builds a graph (not serving's)
    train = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree_leaves(params["layers"])))
    wrapped = _remat_wrap(cfg, group) if train else group
    for g in range(cfg.groups):
        x, a_g, cs = wrapped(x, g)
        aux = aux + a_g
        if collect_caches:
            caches.extend(cs)
    return x, caches, aux


#: the matrix products whose outputs ``remat="dots"`` saves (the
#: reference's ``checkpoint_policies.checkpoint_dots``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: ArchConfig, fn):
    """``fn`` checkpointed as ``cfg.remat`` says."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat must be none, dots or full, got "
                         f"{cfg.remat!r}")

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def lm_loss(cfg: ArchConfig, params: Params,
            tokens: Optional[torch.Tensor], labels: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=F32,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss: ``forward``, the final norm, the tied or untied
    head, ``chunked_softmax_xent`` over ``cfg.loss_chunk``, plus
    ``aux_weight`` times the MoE aux loss. Returns (total, {"ce_loss",
    "aux_loss", "tokens"})."""
    check_supported(cfg)
    x, _, aux = forward(cfg, params, tokens, embeds, dtype=dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    loss, count = chunked_softmax_xent(x, head_matrix(cfg, params), labels,
                                       cfg.loss_chunk)
    total = loss + aux_weight * aux
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": count}


# ---------------------------------------------------------------- decode ----

def _zero_cache(cfg: ArchConfig, mixer: str, batch: int, max_seq: int,
                dtype, device=None) -> Dict[str, torch.Tensor]:
    """One layer's cache: GQA attention's KV cache, MLA's latent cache,
    or the recurrent state of a Mamba, mLSTM or sLSTM mixer."""
    if mixer == "mlstm":
        return xlstm_lib.mlstm_state(batch, cfg, device)
    if mixer == "slstm":
        return xlstm_lib.slstm_state(batch, cfg, device)
    if cfg.attn_type == "mla" and mixer == "attn":
        return {"ckv": torch.zeros((batch, max_seq, cfg.mla_kv_lora),
                                   dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_seq, cfg.mla_rope_dim),
                                      dtype=dtype, device=device)}
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
