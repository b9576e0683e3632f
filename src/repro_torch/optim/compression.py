"""Error-feedback int8 gradient compression.

PyTorch counterpart of ``repro.optim.compression``'s numerics: per-tensor
symmetric int8 quantisation with an error-feedback residual, so the
compression noise is re-injected at the next step (Seide et al. /
EF-SGD). ``compress_tree`` is the transform the train step applies to
its gradients. The reference's ``compressed_psum`` (int8 on the wire of
a data-parallel all-reduce) needs a collective over a mesh axis and waits
for ``distributed/`` (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map

F32 = torch.float32


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def init_error(params: Any) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=F32), params)


def compress_tree(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Quantise and dequantise each gradient leaf with error feedback.

    Returns (the compressed gradients, a tree of their leaves in the
    gradients' dtypes; the error tree, its leaves overwritten in place
    with the quantisation residual that the next step adds back)."""
    out = []
    with torch.no_grad():
        for g, e in zip(tree_leaves(grads), tree_leaves(error)):
            gf = g.to(F32) + e
            deq = _dequant(*_quant_int8(gf))
            e.copy_(gf - deq)
            out.append(deq.to(g.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), grads), error
