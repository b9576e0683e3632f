"""Arch-id -> model entry points (init / loss / decode / caches),
family-dispatched: encoder-decoder configs to ``models.encdec``, every
other to ``models.lm``. The entry points run on the CUDA card unless given
``device="cpu"``, and raise when there is no card. Every config trains:
``loss_fn`` is ``encdec.seq2seq_loss`` for an encoder-decoder config and
``lm.lm_loss`` for the others, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.models import encdec, lm


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.is_encdec


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                dtype=torch.float32):
    """Random parameters from ``torch.Generator().manual_seed(seed)`` (a
    host generator, so one seed gives the same weights on the CPU and on
    the card), placed on ``device``: matrices in ``dtype``, norm scales and
    biases in float32. Each matrix is drawn in float32 on the host and
    cast to ``dtype`` before it is moved.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if cfg.is_encdec:
        return encdec.init_params(cfg, gen, device=dev, dtype=dtype)
    return lm.init_params(cfg, gen, device=dev, dtype=dtype)


def loss_fn(cfg: ArchConfig) -> Callable[..., Any]:
    """Returns loss(params, batch, dtype) -> (scalar, metrics). Batch keys:
    decoder-only ``tokens`` or ``embeds``, and ``labels``; encoder-decoder
    ``src_embeds``, ``tgt_tokens`` and ``labels``."""
    if cfg.is_encdec:
        def f_encdec(params, batch, dtype):
            return encdec.seq2seq_loss(cfg, params, batch["src_embeds"],
                                       batch["tgt_tokens"], batch["labels"],
                                       dtype)
        return f_encdec
    lm.check_supported(cfg)

    def f(params, batch, dtype):
        return lm.lm_loss(cfg, params, batch.get("tokens"), batch["labels"],
                          embeds=batch.get("embeds"), dtype=dtype)
    return f


def decode_entry(cfg: ArchConfig) -> Callable[..., Any]:
    if cfg.is_encdec:
        return encdec.decode_step
    lm.check_supported(cfg)
    return lm.decode_step


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.float32, device=None):
    dev = resolve_device(device)
    if cfg.is_encdec:
        return encdec.init_dec_caches(cfg, batch, max_seq, dtype, device=dev)
    return lm.init_caches(cfg, batch, max_seq, dtype, device=dev)
