"""Parameter partition rules: TP over 'model', FSDP/ZeRO-3 over 'data'.

PyTorch counterpart of ``repro.distributed.partition``. Every weight
matrix is sharded on its contraction-parallel dim over the 'model' axis
(column-parallel in-projections, row-parallel out-projections,
expert-parallel MoE tensors) and on its other large dim over 'data'
(FSDP/ZeRO-3). Optimizer moments mirror parameter specs, so optimizer
state is fully sharded (ZeRO semantics).

This package keeps one tree a layer (``params["layers"]``, ``"enc"``,
``"dec"``: lists), so no leaf carries the reference's stacked layer axis
and no spec gets its leading ``None``.
"""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.distributed.shard import P
from repro_torch.optim.adamw import map_with_path

# name -> spec for the parameter
_RULES = {
    # embeddings / head
    "table": P("model", None),
    "lm_head": P("data", "model"),
    # attention
    "wq": P("data", "model"),
    "wk": P("data", "model"),
    "wv": P("data", "model"),
    "wo": P("model", "data"),
    "bq": P("model"),
    "bk": P("model"),
    "bv": P("model"),
    # MLA
    "w_dq": P("data", None),
    "w_uq": P(None, "model"),
    "w_dkv": P("data", None),
    "w_uk": P(None, "model"),
    "w_uv": P(None, "model"),
    "w_kr": P("data", None),
    # dense FFN (SwiGLU)
    "w_gate": P("data", "model"),
    "w_up": P("data", "model"),
    "w_down": P("model", "data"),
    # MoE (3D expert tensors override by rank below)
    "router": P("data", None),
    # mamba
    "w_in": P("data", "model"),
    "conv_w": P(None, "model"),
    "conv_b": P("model"),
    "w_x": P("model", None),
    "w_dt": P(None, "model"),
    "dt_bias": P("model"),
    "A_log": P("model", None),
    "D": P("model"),
    "w_out": P("model", "data"),
    # xlstm
    "w_q": P("data", "model"),
    "w_k": P("data", "model"),
    "w_v": P("data", "model"),
    "w_if": P("data", None),
    "b_if": P(),
    "w_gates": P("data", "model"),
    "b_gates": P("model"),
    # norms
    "scale": P(),
    "bias": P(),
}

_MOE_3D = {
    "w_gate": P("model", "data", None),
    "w_up": P("model", "data", None),
    "w_down": P("model", None, "data"),
}


def _spec_one(path: Tuple[str, ...], leaf) -> P:
    name = path[-1]
    rank = leaf.dim()
    if name in _MOE_3D and rank == 3:
        return _MOE_3D[name]
    if name in _RULES:
        spec = _RULES[name]
        # rule written for the canonical rank; pad/trim to the actual rank
        if len(spec) > rank:
            return P(*spec[:rank])
        return P(*(spec + (None,) * (rank - len(spec))))
    return P(*([None] * rank))


def param_specs(params: Any) -> Any:
    """Spec tree matching ``params`` (works for opt moments too)."""
    return map_with_path(_spec_one, params)


def opt_state_specs(opt_state: Any) -> Any:
    """Specs for the AdamW state {m, v, count}."""
    return {
        "m": param_specs(opt_state["m"]),
        "v": param_specs(opt_state["v"]),
        "count": P(),
    }
