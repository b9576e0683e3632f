"""Architecture configuration schema shared by all assigned archs.

One frozen dataclass describes every LM family in the assignment pool:
dense GQA decoders, MoE (top-k + shared experts, MLA), hybrid
Mamba/attention (jamba), xLSTM stacks, and encoder-decoder backbones.

Layer structure = optional ``prefix`` layers (unrolled, e.g. DeepSeek-V3's
3 leading dense layers) + ``groups`` repetitions of a ``period`` of mixer
types (scanned with stacked params — this keeps an 80-layer model's HLO the
size of one period). ``ffn_period`` selects dense/MoE/none per period slot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|hybrid|ssm|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: Optional[int] = None    # default d_model // n_heads

    # ---- layer pattern ----------------------------------------------------
    period: Tuple[str, ...] = ("attn",)
    ffn_period: Tuple[str, ...] = ("dense",)
    prefix: Tuple[Tuple[str, str], ...] = ()   # [(mixer, ffn), ...] unrolled

    # ---- attention ----------------------------------------------------------
    attn_type: str = "gqa"          # gqa|mla
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True           # jamba: no positional encoding
    causal: bool = True

    # ---- MLA (DeepSeek-V3) ---------------------------------------------------
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128

    # ---- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim (0 = use d_ff)
    capacity_factor: float = 1.25

    # ---- Mamba ------------------------------------------------------------------
    ssm_expand: int = 2
    ssm_d_state: int = 16
    ssm_d_conv: int = 4

    # ---- encoder-decoder -----------------------------------------------------------
    n_enc_layers: int = 0           # >0 => enc-dec; n_layers = decoder depth

    # ---- modality frontend (STUB: precomputed embeddings via input_specs) -----
    frontend: str = "none"          # none|vision_stub|audio_stub

    # ---- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    max_seq: int = 131_072
    # sub-quadratic decode state (SSM/hybrid): eligible for long_500k
    subquadratic: bool = False
    # beyond-paper perf knobs (see EXPERIMENTS.md §Perf)
    remat: str = "full"             # none|dots|full — activation checkpointing
    loss_chunk: int = 512           # sequence chunk for big-vocab CE loss
    train_microbatches: int = 8     # gradient-accumulation depth for train_4k
    kv_quant: bool = False          # int8 KV cache (serving; §Perf cell C)

    # ---------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.period) == 0, (
            f"{self.name}: {body} body layers not divisible by period "
            f"{len(self.period)}"
        )
        return body // len(self.period)

    @property
    def ffn_hidden(self) -> int:
        return self.d_ff_expert if self.d_ff_expert else self.d_ff

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def validate(self) -> "ArchConfig":
        assert len(self.period) == len(self.ffn_period)
        for m in self.period:
            assert m in MIXERS, m
        for f in self.ffn_period:
            assert f in FFNS, f
        for m, f in self.prefix:
            assert m in MIXERS and f in FFNS
        _ = self.groups  # divisibility check
        if self.is_moe:
            assert self.top_k > 0
        return self

    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = self.period
        prefix = self.prefix[: min(len(self.prefix), 1)]
        n_layers = len(prefix) + len(period)  # one group
        return dataclasses.replace(
            self,
            name=self.name + "-tiny",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            d_ff_expert=64 if self.is_moe else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            mla_q_lora=32,
            mla_kv_lora=16,
            mla_rope_dim=8,
            mla_nope_dim=16,
            mla_v_dim=16,
            ssm_d_state=8,
            n_enc_layers=min(self.n_enc_layers, 2),
            max_seq=128,
            remat="none",
            loss_chunk=64,
            prefix=prefix,
        )
