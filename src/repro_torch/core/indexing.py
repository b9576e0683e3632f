"""Indexing by a device-resident scalar without a host round trip.

Indexing a tensor with a 0-d integer tensor (``x[i]``) makes PyTorch read
``i`` on the host, which on a CUDA tensor waits for the device. The cycle
loops index with device scalars (queue heads, arbiter winners, the next
trace entry) on every step, so they go through these helpers, which keep
the index on the device as a one-element index tensor.

JAX clamps out-of-range gathers and drops out-of-range scatters; PyTorch
raises (CPU) or asserts on the device (CUDA). Callers therefore only pass
in-range indices: gathers clamp first, scatters aim masked-off writes at a
sink slot one past the real data (see ``repro_torch.core.simulator``).
"""

from __future__ import annotations

import torch


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along dim 0 for a 0-d int index tensor."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def put_(x: torch.Tensor, i: torch.Tensor, value: torch.Tensor) -> None:
    """``x[i] = value`` along dim 0, in place, for a 0-d int index."""
    x.index_put_((i.reshape(1),), value.unsqueeze(0))


def fill_at_(x: torch.Tensor, idx: torch.Tensor, value) -> None:
    """``x[idx] = value`` for an int index tensor of any shape and a scalar
    ``value`` (Python number or 0-d device tensor), in place. Duplicate
    indices are harmless: they all write the same value. (A tensor value
    goes through ``index_put_``: ``index_fill_`` would read it on the
    host.)"""
    if isinstance(value, torch.Tensor):
        x.index_put_((idx.reshape(-1),), value.reshape(()).to(x.dtype))
    else:
        x.index_fill_(0, idx.reshape(-1).long(), value)
