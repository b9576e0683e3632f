"""Analytic FLOP/byte accounting per (arch x shape) cell.

PyTorch counterpart of ``repro.perfmodel.analytic``: the transparent FLOP
and byte model behind the roofline, for the total executed FLOPs and HBM
bytes of a cell, which a trace of a step that loops over layers or time
does not give whole.

Conventions:
  * FLOPs = 2 x MACs; executed FLOPs include the implementation's real
    overheads: full-rectangle causal attention in the blocked path and
    remat recompute (fwd again in bwd).
  * MODEL_FLOPS: 6 * N_active * tokens for train (2 * N_active * tokens
    for inference cells, which have no backward), where N_active counts
    routed-expert params at top_k/E utilization.
  * HBM bytes: parameter traffic (bf16 compute casts, fp32 optimizer),
    activation carry traffic, KV/state traffic. Per device = global /
    devices (everything is sharded).

The roofline's constants are an NVIDIA H100 SXM5's datasheet figures
(dense BF16 tensor-core peak, HBM3 bandwidth, NVLink 4 per direction).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.adamw import map_with_path
from repro_torch.launch.specs import SHAPES, param_shapes


# -------------------------------------------------------------- params ----

def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Exact parameter counts from the tree on ``meta`` (no allocation).

    A routed expert tensor is a rank-3 ``w_gate`` / ``w_up`` / ``w_down``
    by the reference's rule on its own tree, whose encoder and decoder
    layers are stacked ``[L, ...]``: so an encoder-decoder's FFN matrices
    count as routed too (they do not change ``active``, which is the
    total for a config without MoE)."""
    total = 0
    routed = 0

    def visit(path, leaf):
        nonlocal total, routed
        n = leaf.numel()
        total += n
        stacked = path[0] in ("enc", "dec")
        if leaf.dim() + stacked == 3 and path[-1] in (
                "w_gate", "w_up", "w_down"):
            routed += n

    map_with_path(visit, param_shapes(cfg))
    active = total - routed
    if cfg.is_moe and cfg.n_experts > 0:
        active += routed * cfg.top_k / cfg.n_experts
    else:
        active = total
    return {"total": float(total), "routed_experts": float(routed),
            "active": float(active)}


# ------------------------------------------------------- per-layer flops ----

def _attn_flops_per_token(cfg: ArchConfig, s_kv: float,
                          causal_skip: bool) -> float:
    """Score + value matmul FLOPs per query token (projections counted via
    params)."""
    eff = s_kv / 2 if causal_skip else s_kv
    if cfg.attn_type == "mla":
        dk = cfg.mla_nope_dim + cfg.mla_rope_dim
        return 2 * cfg.n_heads * (dk + cfg.mla_v_dim) * eff
    return 2 * cfg.n_heads * cfg.head_dim * 2 * eff


def _mixer_attn_layers(cfg: ArchConfig) -> int:
    return _scan_layers(cfg, "attn")


def _scan_layers(cfg: ArchConfig, kind: str) -> int:
    per = sum(1 for m in cfg.period if m == kind)
    pre = sum(1 for m, _ in cfg.prefix if m == kind)
    return pre + per * cfg.groups


def _recurrent_flops_per_token(cfg: ArchConfig) -> float:
    """Non-matmul recurrence FLOPs (mamba/mlstm/slstm state updates)."""
    f = 0.0
    di = cfg.ssm_expand * cfg.d_model
    f += _scan_layers(cfg, "mamba") * (8.0 * di * cfg.ssm_d_state)
    dh_m = (2 * cfg.d_model) // cfg.n_heads
    f += _scan_layers(cfg, "mlstm") * (6.0 * cfg.n_heads * dh_m * dh_m)
    f += _scan_layers(cfg, "slstm") * (10.0 * cfg.d_model)
    return f


@dataclasses.dataclass
class CellCost:
    arch: str
    shape: str
    tokens: float              # tokens processed by the step
    params_total: float
    params_active: float
    flops_fwd: float           # executed forward FLOPs (global)
    flops_total: float         # executed incl. bwd + remat (global)
    model_flops: float         # 6*N_active*T (train) / 2*N_active*T (serve)
    hbm_bytes: float           # per-DEVICE HBM traffic of one step
    kv_bytes: float            # per-device KV/state bytes touched (decode)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def cell_cost(cfg: ArchConfig, shape: str, devices: int = 256,
              causal_skip: bool = False) -> CellCost:
    """Executed-FLOPs + HBM-bytes model for one cell."""
    info = SHAPES[shape]
    s, b, kind = info["seq"], info["batch"], info["kind"]
    pc = param_counts(cfg)
    n_act = pc["active"]

    if kind in ("train", "prefill"):
        tokens = float(b) * s
        # parameter-matmul flops: every active param is one MAC per token
        flops_mat = 2 * n_act * tokens
        # MoE capacity padding: dispatch einsums run at capacity_factor
        if cfg.is_moe:
            routed_act = pc["routed_experts"] * cfg.top_k / cfg.n_experts
            flops_mat += 2 * routed_act * tokens * (cfg.capacity_factor - 1.0)
        attn_l = _mixer_attn_layers(cfg)
        enc_dec_extra = 0.0
        if cfg.is_encdec:
            # encoder self-attn (non-causal) + decoder cross-attn vs S_src=s
            enc_dec_extra = (cfg.n_enc_layers + cfg.n_layers) * \
                _attn_flops_per_token(cfg, s, False) * tokens
        flops_attn = attn_l * _attn_flops_per_token(cfg, s, causal_skip) \
            * tokens + enc_dec_extra
        flops_rec = _recurrent_flops_per_token(cfg) * tokens
        fwd = flops_mat + flops_attn + flops_rec
        if kind == "train":
            # bwd = 2x fwd; remat(full) recomputes fwd; blocked attention's
            # inner checkpoint recomputes the attention fwd once more
            total = fwd * 4 + flops_attn
            model = 6 * n_act * tokens
        else:
            total = fwd
            model = 2 * n_act * tokens
    else:  # decode: one token per sequence
        tokens = float(b)
        flops_mat = 2 * n_act * tokens
        attn_l = _mixer_attn_layers(cfg)
        flops_attn = attn_l * _attn_flops_per_token(cfg, s, False) * tokens
        if cfg.is_encdec:
            flops_attn += cfg.n_layers * _attn_flops_per_token(
                cfg, 4096, False) * tokens
        fwd = flops_mat + flops_attn + _recurrent_flops_per_token(cfg) \
            * tokens
        total = fwd
        model = 2 * n_act * tokens

    # ---- HBM bytes per device ------------------------------------------------
    n_tot = pc["total"]
    d = cfg.d_model
    layers = cfg.n_layers + cfg.n_enc_layers
    if kind == "train":
        # params: bf16 read fwd+bwd+remat (3x2N) + fp32 grad w/r (8N)
        # + adam m/v r/w (16N) + fp32 param r/w (8N)
        p_bytes = n_tot * (6 + 8 + 16 + 8)
        act_bytes = tokens * d * 2 * layers * 8     # carry + block intern, bf16
        kv_bytes = 0.0
    else:
        p_bytes = n_tot * 2
        act_bytes = tokens * d * 2 * layers * 4
        kv_bytes = _cache_bytes(cfg, b, s)
    hbm = (p_bytes + act_bytes + kv_bytes) / devices
    return CellCost(
        arch=cfg.name, shape=shape, tokens=tokens,
        params_total=n_tot, params_active=n_act,
        flops_fwd=fwd, flops_total=total, model_flops=model,
        hbm_bytes=hbm, kv_bytes=kv_bytes / devices,
    )


def _cache_bytes(cfg: ArchConfig, b: int, s: int) -> float:
    """Bytes of KV/state read by one decode step (bf16 cache)."""
    total = 0.0
    attn_l = _mixer_attn_layers(cfg)
    if cfg.attn_type == "mla":
        total += attn_l * b * s * (cfg.mla_kv_lora + cfg.mla_rope_dim) * 2
    elif cfg.kv_quant:   # int8 payload + f16 per-token scales
        total += attn_l * b * s * cfg.n_kv_heads * (cfg.head_dim * 1 + 4) * 2
    else:
        total += attn_l * b * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    di = cfg.ssm_expand * cfg.d_model
    total += _scan_layers(cfg, "mamba") * b * di * cfg.ssm_d_state * 4
    dh_m = (2 * cfg.d_model) // cfg.n_heads
    total += _scan_layers(cfg, "mlstm") * b * cfg.n_heads * dh_m * dh_m * 4
    total += _scan_layers(cfg, "slstm") * b * cfg.d_model * 4 * 3
    if cfg.is_encdec:
        total += cfg.n_layers * b * 4096 * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return total


# ------------------------------------------------------------- roofline ----

# NVIDIA H100 SXM5 (datasheet)
PEAK_FLOPS = 989e12       # dense BF16 FLOP/s per card
HBM_BW = 3.35e12          # HBM3 bytes/s per card
LINK_BW = 450e9           # NVLink 4 bytes/s per direction per card


def roofline_terms(cost: CellCost, collective_bytes: float,
                   devices: int) -> Dict[str, float]:
    """The three roofline terms in seconds + dominance + MFU-style ratios.

    ``collective_bytes`` is a device's bytes on the wire (its shards), so
    the term is bytes / per-link bandwidth."""
    t_compute = cost.flops_total / (devices * PEAK_FLOPS)
    t_memory = cost.hbm_bytes / HBM_BW            # hbm_bytes is per-device
    t_coll = collective_bytes / LINK_BW           # per-device bytes / link BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    useful = cost.model_flops / max(cost.flops_total, 1.0)
    # roofline fraction: useful model FLOPs per second at the bound,
    # relative to cluster peak
    mfu_bound = (cost.model_flops / max(bound, 1e-12)) / (devices
                                                          * PEAK_FLOPS)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "model_flops": cost.model_flops,
        "hlo_flops_analytic": cost.flops_total,
        "useful_ratio": useful,
        "roofline_fraction": mfu_bound,
    }
