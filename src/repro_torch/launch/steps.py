"""Step factories: prefill and the one-token decode step of the serve path.

Each factory resolves its device once (``device=None`` is the CUDA card
and raises without one; pass ``device="cpu"`` for the CPU) and returns a
function that moves its token and position inputs there. The training step
is not ported yet (ROADMAP.md §1, LLM model stack).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.models import lm


def _as_int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32).to(device)


def make_prefill(cfg: ArchConfig, dtype=torch.bfloat16,
                 device=None) -> Callable:
    """Full-sequence forward producing last-token logits (float32 [B,
    vocab]) and the per-layer caches: {"k", "v"} [B, Hkv, S, D] of an
    attention layer, {"h", "conv"} (the state after the last token) of a
    Mamba layer. ``batch`` holds ``tokens`` int [B, S] or ``embeds``
    [B, S, d_model]."""
    dev = resolve_device(device)

    def prefill(params, batch):
        tokens = batch.get("tokens")
        embeds = batch.get("embeds")
        x, caches, _ = lm.forward(
            cfg, params,
            None if tokens is None else _as_int32(tokens, dev),
            None if embeds is None else embeds.to(dev),
            collect_caches=True, dtype=dtype)
        return lm.logits_of(cfg, params, x[:, -1]), caches

    return prefill


def make_decode_step(cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                     backend: str = "kernel") -> Callable:
    """One-token serve step: (params, caches, token, pos) -> (next_token
    int32[B] on the device, logits float32 [B, vocab], caches). The next
    token is the greedy argmax (the first maximal index on ties).
    ``backend="plain"`` runs K5's plain version on any device: the card's
    reference for the decode-vs-prefill check."""
    lm.check_supported(cfg)
    dev = resolve_device(device)

    def step(params, caches, token, pos):
        logits, caches = lm.decode_step(cfg, params, caches,
                                        _as_int32(token, dev),
                                        _as_int32(pos, dev), dtype, backend)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step
