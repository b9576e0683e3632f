"""Per-(arch x shape) input shapes and shardings.

PyTorch counterpart of ``repro.launch.specs``: ``input_specs(cfg, shape)``
returns tensors on the ``meta`` device for every model input (shapes and
dtypes, no allocation, no draw), ``param_shapes`` the parameter tree on
``meta``, and ``cache_specs`` / ``to_named`` the specs and DTensor
placements the production mesh needs. The trees are this package's: one
parameter and one cache tree a layer, and an encoder-decoder's cross K/V
a ``(k, v)`` pair a decoder layer.

The four assigned shapes:
  train_4k     seq 4,096   global_batch 256  (train_step)
  prefill_32k  seq 32,768  global_batch 32   (serve prefill)
  decode_32k   KV 32,768   global_batch 128  (serve_step, one token)
  long_500k    KV 524,288  global_batch 1    (serve_step; SSM/hybrid only)

Cache sharding: batch over 'data' when it covers the axis, sequence over
'model' (and over 'data' too when batch = 1) — KV at 32k x 128 otherwise
exceeds per-device HBM. Encoder-decoder prefill = the encoder pass (its
"prompt" is the source audio); its decode cells use a fixed 4,096-frame
source for cross-attention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.shard import P, sharding
from repro_torch.models import registry
from repro_torch.optim.adamw import map_with_path

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

CROSS_SRC_LEN = 4096  # encoder source length for enc-dec decode cells

META = torch.device("meta")


def shape_skips(cfg: ArchConfig, shape: str) -> Optional[str]:
    """Reason a cell is skipped by design, else None."""
    if shape == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: 500k decode requires sub-quadratic state"
    return None


# ------------------------------------------------------------------ specs ----

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: str,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Tensors on ``meta`` for the data batch of a cell (no allocation)."""
    info = SHAPES[shape]
    s, b = info["seq"], info["batch"]
    kind = info["kind"]
    i32 = torch.int32
    if kind == "train":
        if cfg.is_encdec:
            return {
                "src_embeds": _meta((b, s, cfg.d_model), dtype),
                "tgt_tokens": _meta((b, s), i32),
                "labels": _meta((b, s), i32),
            }
        if cfg.frontend != "none":
            return {
                "embeds": _meta((b, s, cfg.d_model), dtype),
                "labels": _meta((b, s), i32),
            }
        return {
            "tokens": _meta((b, s), i32),
            "labels": _meta((b, s), i32),
        }
    if kind == "prefill":
        if cfg.is_encdec:
            return {"src_embeds": _meta((b, s, cfg.d_model), dtype)}
        if cfg.frontend != "none":
            return {"embeds": _meta((b, s, cfg.d_model), dtype)}
        return {"tokens": _meta((b, s), i32)}
    # decode
    out = {
        "token": _meta((b,), i32),
        "pos": _meta((b,), i32),
        "caches": registry.init_caches(cfg, b, s, dtype, device=META),
    }
    if cfg.is_encdec:
        kv = (b, cfg.n_kv_heads, CROSS_SRC_LEN, cfg.head_dim)
        out["cross"] = [(_meta(kv, dtype), _meta(kv, dtype))
                        for _ in range(cfg.n_layers)]
    return out


def input_specs(cfg: ArchConfig, shape: str = "train_4k",
                dtype=torch.bfloat16):
    """Public entry: tensors on ``meta`` for every model input."""
    return batch_specs(cfg, shape, dtype)


def param_shapes(cfg: ArchConfig, dtype=None):
    """The parameter tree on ``meta`` (float32 as initialised, or every
    leaf in ``dtype``)."""
    shapes = registry.init_params(cfg, device=META)
    if dtype is not None:
        shapes = map_with_path(lambda _, t: t.to(dtype), shapes)
    return shapes


# --------------------------------------------------------------- shardings ----

def _resolve(mesh, spec: P) -> P:
    """Expand the logical 'data' axis to ('pod','data') on multi-pod meshes."""
    multi = "pod" in mesh.mesh_dim_names
    out = []
    for e in spec:
        if e == "data" and multi:
            out.append(("pod", "data"))
        elif isinstance(e, tuple):
            flat = []
            for a in e:
                if a == "data" and multi:
                    flat.extend(["pod", "data"])
                else:
                    flat.append(a)
            out.append(tuple(flat))
        else:
            out.append(e)
    return P(*out)


def _axis_size(mesh, entry) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def _sanitize(mesh, spec: P, shape) -> P:
    """Drop axes whose extent does not divide the dim (e.g. minicpm's vocab
    122753 on a 16-way axis), as the reference's jit input shardings
    require."""
    out = []
    for i, entry in enumerate(spec):
        if entry is not None and i < len(shape) and \
                shape[i] % _axis_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return P(*out)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _at(tree: Any, path: Tuple[str, ...]) -> Any:
    """The leaf of ``tree`` at ``path`` (a path ``map_with_path`` gives)."""
    for key in path:
        tree = tree[int(key[1:-1])] if key.startswith("[") else tree[key]
    return tree


def to_named(mesh, spec_tree: Any, shape_tree: Any = None) -> Any:
    """The spec tree bound to ``mesh`` (``shard.NamedSharding`` leaves:
    spec and DTensor placements); with ``shape_tree``, each spec first
    drops the axes that do not divide its leaf's dimensions."""
    def bind(path, spec):
        spec = _resolve(mesh, spec)
        if shape_tree is not None:
            spec = _sanitize(mesh, spec, _at(shape_tree, path).shape)
        return sharding(mesh, spec)

    return map_with_path(bind, spec_tree, is_leaf=_is_spec)


def _cache_spec_one(path: Tuple[str, ...], leaf, batched: bool) -> P:
    name = path[-1]
    rank = leaf.dim()
    b_ax = "data" if batched else None

    if name in ("k", "v", "k_scale", "v_scale"):   # [B, Hkv, S, D|1]
        return P(b_ax, None, "model" if batched else ("data", "model"), None)
    if name in ("ckv", "k_rope"):  # [B, S, C]
        return P(b_ax, "model" if batched else ("data", "model"), None)
    if name == "h":                # [B, di, ds]
        return P(b_ax, "model", None)
    if name == "conv":             # [B, kw-1, di]
        return P(b_ax, None, "model")
    if name == "c":
        return P(b_ax, None, "model", None) if rank == 4 else P(b_ax, "model")
    if name == "n":
        return P(b_ax, None, "model") if rank == 3 else P(b_ax, "model")
    if name == "m":
        return P(b_ax, None) if rank == 2 else P(b_ax, "model")
    return P(*([None] * rank))


def cache_specs(cfg: ArchConfig, cache_shapes: Any, batched: bool) -> Any:
    if cfg.is_encdec:
        # one {k, v: [B, Hkv, S, dh]} a decoder layer
        b_ax = "data" if batched else None
        s_ax = "model" if batched else ("data", "model")
        return [{k: P(b_ax, None, s_ax, None) for k in layer}
                for layer in cache_shapes]
    return map_with_path(lambda p, leaf: _cache_spec_one(p, leaf, batched),
                         cache_shapes)


def _batch_data_specs(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: P("data", *([None] * (v.dim() - 1))) for k, v in batch.items()}
