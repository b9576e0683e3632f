"""Mamba selective-SSM mixer (jamba's dominant layer type).

Recurrent form: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t . h_t + D x_t`` with input-dependent (dt, B, C). The
full-sequence scan goes through ``kernels.selective_scan.ops`` (K7 on a
CUDA tensor, its plain version on the CPU); the one-token decode step is
eager and runs no kernel, as in the reference.

Parameters keep the reference's names and ``[d_in, d_out]`` layout;
``A_log`` stays float32 (``layers.REFERENCE_F32``). The decode state is
``{"h": float32 [B, d_inner, d_state], "conv": [B, d_conv - 1, d_inner]}``
in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import F32, truncated_normal

Params = Dict[str, torch.Tensor]


def _dt_rank(cfg: ArchConfig) -> int:
    return max(1, -(-cfg.d_model // 16))


def init_mamba(gen: torch.Generator, cfg: ArchConfig, device=None,
               dtype=F32) -> Params:
    """Matrices in ``dtype`` except ``A_log`` (float32); vectors in
    float32."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_d_state
    dr = _dt_rank(cfg)

    def w(shape, std=0.02):
        return truncated_normal(gen, shape, std, device=device, dtype=dtype)

    return {
        "w_in": w((d, 2 * di)),
        "conv_w": w((cfg.ssm_d_conv, di), 0.1),
        "conv_b": torch.zeros((di,), dtype=F32, device=device),
        "w_x": w((di, dr + 2 * ds)),
        "w_dt": w((dr, di), dr ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, dtype=F32,
                                                    device=device))),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=F32,
                                        device=device)).repeat(di, 1),
        "D": torch.ones((di,), dtype=F32, device=device),
        "w_out": w((di, d), 0.02 / math.sqrt(2.0)),
    }


def _conv_causal(p: Params, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x: [B, S, di]. Returns (out,
    new_state), the state carrying the trailing (d_conv - 1) inputs."""
    b, s, di = x.shape
    kw = p["conv_w"].shape[0]
    if state is None:
        state = torch.zeros((b, kw - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                        # [B, kw-1+S, di]
    w = p["conv_w"].to(x.dtype)                              # [kw, di]
    out = torch.zeros_like(x)
    for i in range(kw):
        out = out + xp[:, i:i + s] * w[i]
    out = out + p["conv_b"].to(x.dtype)
    return F.silu(out), xp[:, -(kw - 1):]


def _ssm_params(p: Params, xc: torch.Tensor, cfg: ArchConfig):
    dr = _dt_rank(cfg)
    ds = cfg.ssm_d_state
    proj = xc @ p["w_x"].to(xc.dtype)                        # [B, S, dr+2ds]
    dt = F.softplus(proj[..., :dr] @ p["w_dt"].to(xc.dtype)
                    + p["dt_bias"].to(xc.dtype))             # [B, S, di]
    return dt, proj[..., dr:dr + ds], proj[..., dr + ds:]


def _a(p: Params) -> torch.Tensor:
    return -torch.exp(p["A_log"].to(F32))                    # [di, ds]


def mamba_full(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence selective scan. Returns (out, state for decode)."""
    x1, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)     # [B, S, di]
    xc, conv_state = _conv_causal(p, x1)
    dt, bc, cc = _ssm_params(p, xc, cfg)
    y, h_final = selective_scan(xc, dt, bc, cc, _a(p))
    y = (y + xc * p["D"].to(x.dtype)) * F.silu(z)
    return y @ p["w_out"].to(x.dtype), {"h": h_final,
                                        "conv": conv_state.contiguous()}


def mamba_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: [B, 1, d]; state {h [B, di, ds], conv [B, kw-1,
    di]}, whose entries are replaced IN the given dict, which is
    returned."""
    x1, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    xc, conv_state = _conv_causal(p, x1, state["conv"])
    dt, bc, cc = _ssm_params(p, xc, cfg)
    dtt, xt = dt[:, 0], xc[:, 0]
    da = torch.exp(dtt[..., None].to(F32) * _a(p))
    h = da * state["h"] + (dtt * xt)[..., None].to(F32) \
        * bc[:, 0, None, :].to(F32)
    y = torch.einsum("bds,bs->bd", h, cc[:, 0].to(F32)).to(x.dtype)
    y = (y + xt * p["D"].to(x.dtype)) * F.silu(z[:, 0])
    state["h"] = h
    state["conv"] = conv_state.contiguous()
    return (y @ p["w_out"].to(x.dtype))[:, None], state
