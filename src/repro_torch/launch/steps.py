"""Step factories: the train step (forward, backward, AdamW), prefill and
the one-token decode step of the serve path.

Each factory resolves its device once (``device=None`` is the CUDA card
and raises without one; pass ``device="cpu"`` for the CPU) and returns a
function that moves its token and position inputs there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.models import encdec, lm, registry
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp_lib
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map

F32 = torch.float32


def _as_int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32).to(device)


def _batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Every array of a batch as a tensor on ``device`` (integer arrays
    as int32, float ones as float32)."""
    def one(v):
        t = torch.as_tensor(v)
        return t.to(device, F32 if t.is_floating_point() else torch.int32)
    return {k: one(v) for k, v in batch.items()}


def loss_and_grads(loss_fn: Callable, params: Any, batch: Dict[str, Any],
                   dtype) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                   Any]:
    """(loss, metrics, gradients) of ``loss_fn(params', batch, dtype)``,
    where ``params'`` is ``params`` with every float32 leaf of ndim >= 2
    cast to ``dtype`` once (norms and vectors stay float32, as the
    reference's train step casts). The gradients are a tree like
    ``params``, each leaf in its parameter's dtype (a leaf the loss does
    not reach gets zeros). ``params`` is not changed."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)

    def cast(x):
        if x.dtype == F32 and x.dim() >= 2:
            return x.to(dtype)
        return x

    loss, metrics = loss_fn(tree_map(cast, live), batch, dtype)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, got)])
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, schedule: Optional[Callable] = None,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    dtype=torch.bfloat16, num_microbatches: int = 1,
                    grad_compression: bool = False,
                    device=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), as the reference's: the loss and its gradients in ``dtype``
    (float32 master leaves of ndim >= 2 cast once a step), averaged over
    ``num_microbatches`` slices of the batch (gradient accumulation),
    error-feedback int8 compression when ``grad_compression`` (the error
    tree in ``opt_state["err"]``), the learning rate ``schedule(count)``
    (3e-4 without one), then AdamW, decaying the leaves the reference
    decays (``encdec.weight_decay_mask`` for an encoder-decoder config,
    ``lm.weight_decay_mask`` for the others). Metrics: ``loss``,
    ``ce_loss``, ``aux_loss`` (decoder-only) and ``tokens`` (of the last
    microbatch), ``grad_norm``, ``lr``. Every config trains, as in the
    reference.

    The parameters and optimizer state are updated IN PLACE and returned
    (the reference donates them); the batch's arrays move to the step's
    device."""
    lfn = registry.loss_fn(cfg)
    dev = resolve_device(device)
    decay_mask = (encdec if cfg.is_encdec else lm).weight_decay_mask

    def train_step(params, opt_state, batch):
        batch = _batch_to(batch, dev)
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(lfn, params, batch, dtype)
        else:
            n = num_microbatches
            grads, lsum = None, torch.zeros((), dtype=F32, device=dev)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, metrics, g = loss_and_grads(lfn, params, mb, dtype)
                if grads is None:
                    grads = tree_map(lambda x: x.to(F32), g)
                else:
                    with torch.no_grad():
                        for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                            a.add_(b)
                del g
                lsum = lsum + loss_i
            inv = 1.0 / n
            with torch.no_grad():
                for a in tree_leaves(grads):
                    a.mul_(inv)
            loss = lsum * inv
        opt_state = dict(opt_state)
        if grad_compression:
            grads, opt_state["err"] = comp_lib.compress_tree(
                grads, opt_state["err"])
        err = opt_state.pop("err", None)
        lr = (schedule(opt_state["count"]) if schedule
              else torch.tensor(3e-4, dtype=F32, device=dev))
        params, new_opt, om = adamw.update(params, grads, opt_state, lr,
                                           opt_cfg,
                                           decay_mask(cfg, params))
        if err is not None:
            new_opt["err"] = err
        return params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill(cfg: ArchConfig, dtype=torch.bfloat16,
                 device=None) -> Callable:
    """Full-sequence forward producing last-token logits (float32 [B,
    vocab]) and the per-layer caches: {"k", "v"} [B, Hkv, S, D] of a GQA
    attention layer, {"ckv", "k_rope"} of an MLA layer, the state after
    the last token of a recurrent mixer. ``batch`` holds ``tokens`` int
    [B, S] or ``embeds`` [B, S, d_model]. An encoder-decoder config's
    prefill is ``(params, src_embeds [B, S_src, d]) -> (enc_out, cross)``:
    the encoder's output and every decoder layer's cross K/V."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        def prefill_encdec(params, src_embeds):
            enc_out = encdec.encode(cfg, params, src_embeds.to(dev, dtype))
            return enc_out, encdec.precompute_cross_kv(cfg, params, enc_out)
        return prefill_encdec

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
    reference for the decode-vs-prefill check. An encoder-decoder config's
    step is ``(params, caches, cross, token, pos)``, ``cross`` from its
    prefill."""
    entry = registry.decode_entry(cfg)
    dev = resolve_device(device)
    if cfg.is_encdec:
        def step_encdec(params, caches, cross, token, pos):
            logits, caches = entry(cfg, params, caches, cross,
                                   _as_int32(token, dev),
                                   _as_int32(pos, dev), dtype, backend)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return nxt, logits, caches
        return step_encdec

    def step(params, caches, token, pos):
        logits, caches = entry(cfg, params, caches, _as_int32(token, dev),
                               _as_int32(pos, dev), dtype, backend)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step
