"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory), with
exponential gating and the max-based stabiliser state m, as the
reference's (the same simplifications: sLSTM without recurrent weights,
both with the Mamba-style up/down projection and a SiLU-gated z path):

  mLSTM: C_t = f' C + i' (v k^T)   [B, H, dh, dh]
         n_t = f' n + i' k          [B, H, dh]
         h_t = (C_t q) / max(|n_t . q|, 1)
  sLSTM: c_t = f' c + i' z          [B, di] (a scalar memory a cell)

The states are float32 whatever the compute dtype, as in the reference
(q, k and v enter the mLSTM scan in float32). The full-sequence forms scan
over time with ``scan_utils.chunked_scan`` in the reference's chunks (64
steps for mLSTM, 128 for sLSTM; under grad each chunk is recomputed in the
backward, so it keeps one carry a chunk); no kernel runs here (the
reference has no Pallas kernel for these mixers either). The decode forms
update the state dict ``{"c", "n", "m"}`` IN PLACE and return it (the
reference returns a new one), in the reference's order of operations. A
step that builds an autograd graph (training) replaces its carry instead
of updating it in place, with the same arithmetic.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import F32, truncated_normal
from repro_torch.models.scan_utils import chunked_scan

Params = Dict[str, torch.Tensor]
#: the reference's remat chunks (``src/repro/models/xlstm.py``: 64 steps
#: for mLSTM, whose carry is [B, H, dh, dh], 128 for sLSTM)
MLSTM_CHUNK = 64
SLSTM_CHUNK = 128


def _dims(cfg: ArchConfig, kind: str) -> Tuple[int, int, int]:
    """(d_inner, heads, head_dim). mLSTM up-projects by 2, sLSTM stays at
    d."""
    di = (2 if kind == "mlstm" else 1) * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device=None,
               dtype=F32) -> Params:
    """Matrices in ``dtype``; the gate bias float32."""
    d = cfg.d_model
    di, h, _ = _dims(cfg, "mlstm")

    def w(shape, std=0.02):
        return truncated_normal(gen, shape, std, device=device, dtype=dtype)

    return {
        "w_in": w((d, 2 * di)),
        "w_q": w((di, di)),
        "w_k": w((di, di)),
        "w_v": w((di, di)),
        "w_if": w((di, 2 * h)),
        "b_if": torch.cat([torch.zeros(h), torch.full((h,), 3.0)]).to(
            device=device, dtype=F32),
        "w_out": w((di, d), 0.02 / math.sqrt(2.0)),
    }


def init_slstm(gen: torch.Generator, cfg: ArchConfig, device=None,
               dtype=F32) -> Params:
    """Matrices in ``dtype``; the gate biases float32."""
    d = cfg.d_model
    di, _, _ = _dims(cfg, "slstm")
    return {
        "w_gates": truncated_normal(gen, (d, 4 * di), device=device,
                                    dtype=dtype),     # i, f, z, o pre-acts
        "b_gates": torch.cat([torch.zeros(di), torch.full((di,), 3.0),
                              torch.zeros(2 * di)]).to(device=device,
                                                       dtype=F32),
        "w_out": truncated_normal(gen, (di, d), 0.02 / math.sqrt(2.0),
                                  device=device, dtype=dtype),
    }


def _in_graph(*tensors) -> bool:
    """Whether a step builds an autograd graph: then it must not update its
    carry in place (autograd keeps the old carry for the backward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _mlstm_step(carry, inp):
    """One mLSTM step on float32 [B, H, ...] tensors; the carry is updated
    in place, or, when the step builds a graph, replaced (the same
    arithmetic, the same bits)."""
    c, n, m = carry
    qt, kt, vt, li, lf = inp
    m_new = torch.maximum(lf + m, li)                          # [B, H]
    i_p = torch.exp(li - m_new)[..., None]                     # [B, H, 1]
    f_p = torch.exp(lf + m - m_new)[..., None]
    vk = vt[..., :, None] * kt[..., None, :]
    if _in_graph(c, n, m, qt, kt, vt, li, lf):
        n = n * f_p + i_p * kt
        c = c * f_p[..., None] + i_p[..., None] * vk
        m = m_new
    else:
        n.mul_(f_p).add_(i_p * kt)                             # [B, H, dh]
        c.mul_(f_p[..., None]).add_(i_p[..., None] * vk)
        m.copy_(m_new)
    num = torch.einsum("bhde,bhe->bhd", c, qt)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", n, qt).abs()[..., None],
                      min=1.0)
    return (c, n, m), num / den


def _mlstm_gates(p: Params, xi: torch.Tensor, h: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    gates = (xi @ p["w_if"].to(xi.dtype)).to(F32) + p["b_if"]
    return gates[..., :h], F.logsigmoid(gates[..., h:])


def mlstm_state(batch: int, cfg: ArchConfig, device=None
                ) -> Dict[str, torch.Tensor]:
    """A zero mLSTM state: c [B, H, dh, dh], n [B, H, dh], m [B, H] = -1e30,
    float32."""
    _, h, dh = _dims(cfg, "mlstm")
    return {"c": torch.zeros((batch, h, dh, dh), dtype=F32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=F32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=F32, device=device)}


def slstm_state(batch: int, cfg: ArchConfig, device=None
                ) -> Dict[str, torch.Tensor]:
    """A zero sLSTM state: c, n, m [B, d_model] (m = -1e30), float32."""
    di, _, _ = _dims(cfg, "slstm")
    return {"c": torch.zeros((batch, di), dtype=F32, device=device),
            "n": torch.zeros((batch, di), dtype=F32, device=device),
            "m": torch.full((batch, di), -1e30, dtype=F32, device=device)}


def mlstm_full(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (out [B, S, d], the state after the last token)."""
    b, s, _ = x.shape
    di, h, dh = _dims(cfg, "mlstm")
    xi, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    q = (xi @ p["w_q"].to(x.dtype)).reshape(b, s, h, dh)
    k = (xi @ p["w_k"].to(x.dtype)).reshape(b, s, h, dh) * (dh ** -0.5)
    v = (xi @ p["w_v"].to(x.dtype)).reshape(b, s, h, dh)
    log_i, log_f = _mlstm_gates(p, xi, h)
    state = mlstm_state(b, cfg, x.device)

    def to_t(a):
        return a.transpose(0, 1).to(F32)

    (c, n, m), hs = chunked_scan(
        _mlstm_step, (state["c"], state["n"], state["m"]),
        (to_t(q), to_t(k), to_t(v), log_i.transpose(0, 1),
         log_f.transpose(0, 1)), chunk=MLSTM_CHUNK)
    y = hs.transpose(0, 1).reshape(b, s, di).to(x.dtype) * F.silu(z)
    return y @ p["w_out"].to(x.dtype), {"c": c, "n": n, "m": m}


def mlstm_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, 1, d] -> (out [B, 1, d], the state, updated in place)."""
    b = x.shape[0]
    di, h, dh = _dims(cfg, "mlstm")
    xi, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    xi1 = xi[:, 0]
    q = (xi1 @ p["w_q"].to(x.dtype)).reshape(b, h, dh).to(F32)
    k = ((xi1 @ p["w_k"].to(x.dtype)) * (dh ** -0.5)).reshape(b, h, dh).to(
        F32)
    v = (xi1 @ p["w_v"].to(x.dtype)).reshape(b, h, dh).to(F32)
    log_i, log_f = _mlstm_gates(p, xi1, h)
    (state["c"], state["n"], state["m"]), y = _mlstm_step(
        (state["c"], state["n"], state["m"]), (q, k, v, log_i, log_f))
    y = y.reshape(b, 1, di).to(x.dtype) * F.silu(z)
    return y @ p["w_out"].to(x.dtype), state


def _slstm_pre(p: Params, x: torch.Tensor):
    """(i, log f, tanh z, sigmoid o) pre-activations, float32."""
    pre = (x @ p["w_gates"].to(x.dtype)).to(F32) + p["b_gates"]
    i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    return i_pre, F.logsigmoid(f_pre), torch.tanh(z_pre), torch.sigmoid(o_pre)


def _slstm_step(carry, inp):
    """One sLSTM step on float32 [B, di] tensors; the carry is updated in
    place, or replaced when the step builds a graph."""
    c, n, m = carry
    li, lf, z_in = inp
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    if _in_graph(c, n, m, li, lf, z_in):
        c = c * f_p + i_p * z_in
        n = n * f_p + i_p
        m = m_new
    else:
        c.mul_(f_p).add_(i_p * z_in)
        n.mul_(f_p).add_(i_p)
        m.copy_(m_new)
    return (c, n, m), c / torch.clamp(n, min=1.0)


def slstm_full(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (out [B, S, d], the state after the last token)."""
    b = x.shape[0]
    i_pre, log_f, zt, ot = _slstm_pre(p, x)                   # [B, S, di]
    state = slstm_state(b, cfg, x.device)
    (c, n, m), hs = chunked_scan(
        _slstm_step, (state["c"], state["n"], state["m"]),
        (i_pre.transpose(0, 1), log_f.transpose(0, 1), zt.transpose(0, 1)),
        chunk=SLSTM_CHUNK)
    y = (hs.transpose(0, 1) * ot).to(x.dtype)
    return y @ p["w_out"].to(x.dtype), {"c": c, "n": n, "m": m}


def slstm_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, 1, d] -> (out [B, 1, d], the state, updated in place)."""
    i_pre, log_f, zt, ot = _slstm_pre(p, x[:, 0])
    (state["c"], state["n"], state["m"]), h_t = _slstm_step(
        (state["c"], state["n"], state["m"]), (i_pre, log_f, zt))
    y = (h_t * ot).to(x.dtype)
    return y[:, None] @ p["w_out"].to(x.dtype), state
