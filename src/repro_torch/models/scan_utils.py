"""The scan of the recurrent mixers, and its chunked remat (the
reference's ``chunked_scan``).

The reference nests two ``lax.scan``s, the inner one under
``jax.checkpoint(nothing_saveable)``, so that its backward keeps one carry
a chunk and recomputes the steps inside a chunk: memory O(T / chunk +
chunk) carries instead of O(T), for one more forward over each chunk.
Here the outer scan is a Python loop over chunks, each chunk one
``torch.utils.checkpoint.checkpoint`` (non-reentrant) of the plain loop
``scan``, and a tail of T % chunk steps a plain ``scan``, as the
reference's. Without a graph to build (grad off, or no input requiring
grad, as in serving) ``chunked_scan`` is ``scan``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch
import torch.utils.checkpoint as ckpt


def scan(step: Callable, init: Any, xs: Sequence[torch.Tensor]
         ) -> Tuple[Any, Any]:
    """``lax.scan(step, init, xs)``: ``step(carry, x) -> (carry, y)`` with
    ``x`` the tuple of every ``xs`` tensor at one time step (``xs`` tensors
    have a leading time axis T). Returns (final carry, the ys stacked
    [T, ...])."""
    carry, ys = init, []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step: Callable, init: Tuple[torch.Tensor, ...],
                 xs: Sequence[torch.Tensor], chunk: int = 128
                 ) -> Tuple[Any, Any]:
    """``scan(step, init, xs)`` whose backward keeps one carry a chunk of
    ``chunk`` steps: while grad is enabled and an input or the carry
    requires grad, each whole chunk runs under a non-reentrant
    checkpoint and the T % chunk steps left run plainly; T <= chunk is one
    plain scan. ``step`` must not update a carry that requires grad in
    place. Returns (final carry, the ys stacked [T, ...])."""
    t = xs[0].shape[0]
    graph = torch.is_grad_enabled() and any(
        a.requires_grad for a in (*xs, *init))
    if not graph or t <= chunk:
        return scan(step, init, xs)
    n_chunks = t // chunk
    carry, ys = init, []
    for c in range(n_chunks):
        part = tuple(a[c * chunk:(c + 1) * chunk] for a in xs)
        carry, y = ckpt.checkpoint(scan, step, carry, part,
                                   use_reentrant=False)
        ys.append(y)
    if t > n_chunks * chunk:
        carry, y = scan(step, carry, tuple(a[n_chunks * chunk:] for a in xs))
        ys.append(y)
    return carry, torch.cat(ys)
