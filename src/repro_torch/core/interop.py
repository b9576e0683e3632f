"""Carry simulator objects between the JAX reference and this package.

Both packages' objects cross as numpy arrays, so this module imports
neither JAX nor the reference package:

* :func:`trace_from_numpy` — a trace's four arrays (already arrival-sorted)
  -> :class:`Trace` on a device;
* :func:`schedule_from_numpy` — a packed schedule ``(bounds [S, 1] or [S],
  rp [T*S, NP])`` -> :class:`ParamSchedule`;
* :func:`flatten` — any register file made of NamedTuples, dicts and
  arrays (this package's or the reference's) -> ``{dotted.name: ndarray}``;
* :func:`state_from_numpy` / :func:`state_to_numpy` — a flat dict of every
  :class:`SimState` leaf <-> this package's :class:`SimState`, adding and
  stripping the write-sink slots (see ``repro_torch.core.simulator``);
* :func:`lm_params_from_numpy` / :func:`lm_params_to_numpy` — the
  reference's LM parameter tree (body leaves stacked ``[G, ...]``) <->
  this package's parameters (``repro_torch.models.lm``: one block per
  layer, in layer order); the same two carry gradient and AdamW-moment
  trees, which have the parameters' structure (float32 throughout);
* :func:`lm_caches_from_numpy` / :func:`lm_caches_to_numpy` — the
  reference's LM caches ``{"prefix": [...], "body": {slot: [G, ...]}}``
  <-> this package's per-layer cache list (every mixer's: GQA, MLA,
  Mamba, mLSTM, sLSTM);
* :func:`encdec_params_from_numpy` / :func:`encdec_params_to_numpy` and
  :func:`encdec_caches_from_numpy` / :func:`encdec_caches_to_numpy` — the
  reference's encoder-decoder tree (``enc``/``dec`` stacked ``[L, ...]``)
  and its decoder caches ``{"k", "v": [L, ...]}`` <-> this package's
  per-layer lists.

The LM blocks keep the reference's names and its ``[d_in, d_out]`` weight
layout, so every parameter maps to the same path and no matrix is
transposed; only the group stacking is undone.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.bank_fsm import BankState
from repro_torch.core.dram_model import TimingState
from repro_torch.core.params import ParamSchedule
from repro_torch.core.queues import BankedFifo, Fifo
from repro_torch.core.simulator import SimState, Trace
from repro_torch.models.layers import REFERENCE_F32

#: SimState leaves that carry a trailing write-sink slot in this package
SINK_FIELDS = ("mem", "t_admit", "t_dispatch", "t_start", "t_complete",
               "rdata")


def _t(x, device) -> torch.Tensor:
    a = np.asarray(x).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(
        device)


def trace_from_numpy(t, addr, is_write, wdata, device=None) -> Trace:
    """A :class:`Trace` from arrays already sorted by arrival (as a
    reference trace holds them)."""
    return Trace(_t(t, device), _t(addr, device), _t(is_write, device),
                 _t(wdata, device))


def schedule_from_numpy(bounds, rp_mat) -> ParamSchedule:
    """A :class:`ParamSchedule` (CPU tensors) from a packed schedule."""
    b = _t(bounds, None).reshape(-1)
    return ParamSchedule.unpack(b, _t(rp_mat, None))


def flatten(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{dotted.name: ndarray}`` of every leaf of a nest of NamedTuples
    and dicts (tensors of any device, or anything ``np.asarray`` reads)."""
    out: Dict[str, np.ndarray] = {}
    if hasattr(obj, "_fields"):
        for f in obj._fields:
            out.update(flatten(getattr(obj, f), f"{prefix}{f}."))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            out.update(flatten(obj[k], f"{prefix}{k}."))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    elif isinstance(obj, torch.Tensor):
        out[prefix[:-1]] = obj.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(obj)
    return out


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """Every leaf of a :class:`SimState`, sink slots stripped, so the dict
    compares key for key with ``flatten`` of a reference state."""
    flat = flatten(state)
    for f in SINK_FIELDS:
        flat[f] = flat[f][:-1]
    return flat


def state_from_numpy(flat: Dict[str, np.ndarray], device=None) -> SimState:
    """A :class:`SimState` on ``device`` from a flat dict of every leaf
    (as :func:`flatten` gives it for a reference state)."""
    def g(name):
        return _t(flat[name], device)

    def sink(name):
        a = np.asarray(flat[name])
        return _t(np.concatenate([a, np.zeros((1,), a.dtype)]), device)

    counters = {k[len("counters."):]: g(k) for k in flat
                if k.startswith("counters.")}
    return SimState(
        next_arrival=g("next_arrival"),
        req_q=Fifo(*[g(f"req_q.{f}") for f in Fifo._fields]),
        bank_q=BankedFifo(*[g(f"bank_q.{f}") for f in BankedFifo._fields]),
        bank=BankState(*[g(f"bank.{f}") for f in BankState._fields]),
        timing=TimingState(*[g(f"timing.{f}") for f in TimingState._fields]),
        cmd_rr=g("cmd_rr"),
        resp_rr=g("resp_rr"),
        resp_q=Fifo(*[g(f"resp_q.{f}") for f in Fifo._fields]),
        mem=sink("mem"),
        t_admit=sink("t_admit"),
        t_dispatch=sink("t_dispatch"),
        t_start=sink("t_start"),
        t_complete=sink("t_complete"),
        rdata=sink("rdata"),
        counters=counters,
        blocked_arrival=g("blocked_arrival"),
        blocked_dispatch=g("blocked_dispatch"),
    )


def _torch_of(a) -> torch.Tensor:
    """A CPU tensor holding a copy of a numpy array (the caller's array may
    be read-only, and caches are written in place); bfloat16 arrays
    (numpy's extension type, which ``torch.from_numpy`` does not read) go
    through float32."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _layer_trees(cfg, tree) -> List[Any]:
    """One subtree per layer, in layer order: the prefix layers, then for
    each group g the period's slots with every leaf taken at [g]."""
    out = list(tree.get("prefix", []))
    for g in range(cfg.groups):
        for slot in range(len(cfg.period)):
            out.append(_tree_map(lambda a, g=g: np.asarray(a)[g],
                                 tree["body"][str(slot)]))
    return out


def _params_of(node, device, dtype, name=""):
    """A parameter subtree on ``device``: matrices (ndim >= 2) cast to
    ``dtype``, except ``REFERENCE_F32``; vectors as they are."""
    if isinstance(node, dict):
        return {k: _params_of(v, device, dtype, k) for k, v in node.items()}
    t = _torch_of(node)
    if t.is_floating_point() and t.dim() >= 2 and name not in REFERENCE_F32:
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_numpy(cfg, tree, device=None,
                         dtype=torch.float32) -> Dict[str, Any]:
    """This package's LM parameters from the reference's tree as numpy
    arrays. Matrices (ndim >= 2) are cast to ``dtype`` once, here, on the
    host (the reference casts them at every use), except the ones the
    reference uses in float32 (``REFERENCE_F32``: the MoE router and the
    Mamba ``A_log``); norm scales, biases and other vectors stay
    float32."""
    params = _params_of({k: tree[k] for k in ("embed", "final_norm",
                                              "lm_head") if k in tree},
                        device, dtype)
    params["layers"] = [_params_of(t, device, dtype)
                        for t in _layer_trees(cfg, tree)]
    return params


def _np_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16 of its own
        t = t.float()
    return t.numpy()


def _unstack(tree, n: int) -> List[Any]:
    """A tree of leaves stacked [n, ...] -> n trees, one a layer."""
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], tree)
            for i in range(n)]


def _stack(trees) -> Any:
    """Per-layer trees -> one tree of numpy leaves stacked [n, ...]."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([_np_of(t) for t in trees])


def _stack_layers(cfg, layers) -> Dict[str, Any]:
    """``{"prefix": [...], "body": {slot: leaves stacked [G, ...]}}`` from
    per-layer trees in layer order (the inverse of ``_layer_trees``)."""
    n_pre = len(cfg.prefix)
    period = len(cfg.period)
    return {"prefix": [_tree_map(_np_of, t) for t in layers[:n_pre]],
            "body": {str(slot): _stack(layers[n_pre + slot::period])
                     for slot in range(period)}}


def lm_params_to_numpy(cfg, params) -> Dict[str, Any]:
    """The reference's LM parameter tree as numpy arrays (``embed``,
    ``final_norm``, ``lm_head`` when untied, ``prefix`` and ``body``
    stacked over groups) from this package's parameters, or from a
    gradient or AdamW-moment tree of the same structure; bfloat16 leaves
    come out as float32."""
    tree = {k: _tree_map(_np_of, params[k])
            for k in ("embed", "final_norm", "lm_head") if k in params}
    tree.update(_stack_layers(cfg, params["layers"]))
    return tree


def lm_caches_from_numpy(cfg, tree, device=None) -> List[Dict[str, Any]]:
    """This package's per-layer caches from the reference's cache tree,
    every leaf keeping its dtype."""
    return [_tree_map(lambda a: _torch_of(a).to(device), t)
            for t in _layer_trees(cfg, tree)]


def lm_caches_to_numpy(cfg, caches) -> Dict[str, Any]:
    """The reference's cache tree (``{"prefix": [...], "body": {slot:
    leaves stacked [G, ...]}}``) from this package's per-layer caches."""
    return _stack_layers(cfg, caches)


_ENCDEC_TOP = ("embed", "enc_norm", "final_norm", "lm_head")


def encdec_params_from_numpy(cfg, tree, device=None,
                             dtype=torch.float32) -> Dict[str, Any]:
    """This package's encoder-decoder parameters (``models.encdec``: the
    layers as lists) from the reference's tree, whose ``enc`` and ``dec``
    leaves are stacked [L, ...]; matrices cast to ``dtype`` as
    :func:`lm_params_from_numpy` casts them."""
    params = _params_of({k: tree[k] for k in _ENCDEC_TOP}, device, dtype)
    for k, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
        params[k] = [_params_of(t, device, dtype)
                     for t in _unstack(tree[k], n)]
    return params


def encdec_params_to_numpy(cfg, params) -> Dict[str, Any]:
    """The reference's encoder-decoder tree (``enc``/``dec`` stacked [L,
    ...]) as numpy arrays from this package's parameters; bfloat16 leaves
    come out as float32."""
    tree = {k: _tree_map(_np_of, params[k]) for k in _ENCDEC_TOP}
    tree["enc"] = _stack(params["enc"])
    tree["dec"] = _stack(params["dec"])
    return tree


def encdec_caches_from_numpy(cfg, tree, device=None
                             ) -> List[Dict[str, Any]]:
    """This package's decoder caches (one {"k", "v"} a layer) from the
    reference's ``init_dec_caches`` tree {"k", "v": [L, B, Hkv, S, D]}."""
    return [_tree_map(lambda a: _torch_of(a).to(device), t)
            for t in _unstack(tree, cfg.n_layers)]


def encdec_caches_to_numpy(cfg, caches) -> Dict[str, Any]:
    """The reference's decoder cache tree {"k", "v": [L, B, Hkv, S, D]}
    from this package's per-layer caches."""
    return _stack(caches)


__all__ = ["SINK_FIELDS", "trace_from_numpy", "schedule_from_numpy",
           "flatten", "state_to_numpy", "state_from_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy",
           "lm_caches_from_numpy", "lm_caches_to_numpy",
           "encdec_params_from_numpy", "encdec_params_to_numpy",
           "encdec_caches_from_numpy", "encdec_caches_to_numpy"]
