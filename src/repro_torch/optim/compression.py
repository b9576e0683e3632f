"""Error-feedback int8 gradient compression.

PyTorch counterpart of ``repro.optim.compression``'s numerics: per-tensor
symmetric int8 quantisation with an error-feedback residual, so the
compression noise is re-injected at the next step (Seide et al. /
EF-SGD). ``compress_tree`` is the transform the train step applies to
its gradients; ``compressed_psum`` puts int8 on the wire of a
data-parallel all-reduce over a ``torch.distributed`` group (the
reference's over a mesh axis inside ``shard_map``).
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


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire all-reduce sum over ``group`` (the default group
    when None): quantise locally, take the largest scale of the group,
    requantise against it, all-reduce the int32 payload and dequantise.
    Works over NCCL for tensors on the card and over gloo for tensors on
    the CPU; raises when no process group is initialised."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("compressed_psum needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    _, scale = _quant_int8(x)
    scale_max = scale.reshape(1).clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    scale_max = scale_max.reshape(())
    # requantise against the global scale so the sum is well-defined
    q = torch.clamp(torch.round(x / scale_max), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(F32) * scale_max
