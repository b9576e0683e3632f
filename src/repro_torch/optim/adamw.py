"""AdamW with global-norm clipping over parameter trees.

PyTorch counterpart of ``repro.optim.adamw``: the same clipping on the
global norm, bias correction and decoupled weight decay on matrices
(ndim >= 2), in float32. A tree is nested dicts and lists of tensors (the
LM parameters of ``repro_torch.models.lm``); the optimizer state mirrors
it, ``{"m": tree, "v": tree, "count": int32 0-d}``.

``update`` works leaf by leaf IN PLACE: the parameters and both moments
are overwritten under ``torch.no_grad()`` and returned, where the
reference returns new trees. At minicpm-2b's width the float32 masters,
gradients and moments are 43.6 GB, so no second copy of any of them is
ever made; the temporaries are one leaf's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (keys sorted) and lists, in one
    fixed order, so that trees of one structure list their leaves alike."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``, the leaves
    visited in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                  path: Tuple[str, ...] = (),
                  is_leaf: Callable[[Any], bool] = lambda x: False) -> Any:
    """``tree`` (dicts, lists and tuples) with every leaf replaced by
    ``fn(path, leaf)``; ``path`` holds the dict keys and list indices
    down to the leaf."""
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (f"[{i}]",), is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def init(params: Any) -> Dict[str, Any]:
    def zeros(t):
        return tree_map(lambda x: torch.zeros_like(x, dtype=F32), t)

    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    with torch.no_grad():
        sq = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(sq)))


def update(params: Any, grads: Any, state: Dict[str, Any], lr,
           cfg: AdamWConfig = AdamWConfig(), decay: Optional[Any] = None
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on every leaf, in place. ``lr`` is a float or a
    float32 0-d tensor. ``decay`` is a tree of bools like ``params``
    naming the leaves that take weight decay (default: those of ndim >=
    2, the reference's rule on its own tree). Returns (params, {"m", "v",
    "count": count + 1}, {"grad_norm", "lr"}); ``params`` and the moments
    are the objects given, overwritten."""
    gnorm = global_norm(grads)
    with torch.no_grad():
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        count = state["count"] + 1
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                           device=count.device),
                              count.to(F32))
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                           device=count.device),
                              count.to(F32))
        lr = torch.as_tensor(lr, dtype=F32, device=count.device)
        p_leaves = tree_leaves(params)
        wd_leaves = ([p.dim() >= 2 for p in p_leaves] if decay is None
                     else tree_leaves(decay))
        for p, g, m, v, wd in zip(p_leaves, tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"]), wd_leaves):
            g = g.to(F32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            pf = p.to(F32)
            if wd:  # decoupled weight decay
                step = step + cfg.weight_decay * pf
            p.copy_(pf - lr * step)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
