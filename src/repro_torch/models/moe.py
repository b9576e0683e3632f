"""Top-k capacity-based Mixture of Experts with shared experts.

Covers phi3.5-moe (16 experts, top-2) and jamba (16 experts, top-2 on
every other layer). Dispatch is the reference's sort-based capacity
scheme: token-expert assignments are sorted by expert id (stably),
positions past each expert's capacity drop (GShard semantics), the kept
ones fill an ``[E, capacity, d]`` buffer, the experts run as batched
products over it, and the outputs are gathered back and summed per token
with their gates.

Routing is float32 with the router kept float32 (``layers.REFERENCE_F32``).
The top-k takes the k largest probabilities with ties to the lower expert
index, as ``jax.lax.top_k``. The reference scatters dropped assignments
out of bounds with ``mode="drop"``; here they land in a sink row ``E`` of
the buffer, which no expert reads.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import F32, init_swiglu, swiglu, \
    truncated_normal

Params = Dict[str, torch.Tensor]

#: token-chunked dispatch above this many tokens (when they divide evenly),
#: with the same per-chunk capacity semantics and the metrics averaged
#: over the chunks, as in the reference
MOE_CHUNK_TOKENS = 65536


def init_moe(gen: torch.Generator, cfg: ArchConfig, device=None,
             dtype=F32) -> Params:
    """Expert tensors in ``dtype``; the router float32."""
    e, d, h = cfg.n_experts, cfg.d_model, cfg.ffn_hidden

    def w(shape, std=0.02, dt=dtype):
        return truncated_normal(gen, shape, std, device=device, dtype=dt)

    p: Params = {
        "router": w((d, e), dt=F32),
        "w_gate": w((e, d, h)),
        "w_up": w((e, d, h)),
        "w_down": w((e, h, d), 0.02 / math.sqrt(2.0)),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = init_swiglu(gen, d, h * cfg.n_shared_experts,
                                  device=device, dtype=dtype)
    return p


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    cap = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (out [B, S, d], metrics {aux_loss, drop_frac})."""
    b, s, d = x.shape
    t = b * s
    if t > MOE_CHUNK_TOKENS and t % MOE_CHUNK_TOKENS == 0:
        outs, metrics = [], []
        for xc in x.reshape(t // MOE_CHUNK_TOKENS, MOE_CHUNK_TOKENS, 1, d):
            o, m = moe_forward(p, xc, cfg)
            outs.append(o)
            metrics.append(m)
        return torch.stack(outs).reshape(b, s, d), {
            k: torch.stack([m[k] for m in metrics]).mean()
            for k in metrics[0]}
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    xf = x.reshape(t, d)
    dev = x.device

    # ---- routing (float32) --------------------------------------------------
    probs = torch.softmax(xf.to(F32) @ p["router"].to(F32), dim=-1)  # [T, E]
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]                              # [T, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum(f_e * p_e)
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=F32, device=dev).index_add_(
        0, ids.reshape(-1), torch.ones((t * k,), dtype=F32, device=dev)) \
        / (t * k)
    aux = e * torch.sum(me * ce)

    # ---- sort-based dispatch ------------------------------------------------
    flat_ids = ids.reshape(-1)                                       # [T*k]
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    se, st, sg = flat_ids[order], flat_tok[order], gate.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < cap
    drop_frac = 1.0 - keep.to(F32).mean()
    slot = torch.clamp(pos, max=cap - 1)

    buf = torch.zeros((e + 1, cap, d), dtype=x.dtype, device=dev)
    buf[torch.where(keep, se, e), slot] = xf[st]                # row e: sink
    buf = buf[:e]

    # ---- expert FFN (batched over experts) ----------------------------------
    g = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    y = torch.bmm(g * u, p["w_down"].to(x.dtype))                    # [E, C, d]

    # ---- combine ------------------------------------------------------------
    gathered = y[torch.clamp(se, max=e - 1), slot] \
        * (sg * keep).to(x.dtype)[:, None]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, st, gathered)
    if "shared" in p:
        out = out + swiglu(p["shared"], xf)
    return out.reshape(b, s, d), {"aux_loss": aux, "drop_frac": drop_frac}
