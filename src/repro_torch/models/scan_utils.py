"""The scan of the recurrent mixers (the reference's ``chunked_scan``).

The reference nests two ``lax.scan``s, the inner one under
``jax.checkpoint(nothing_saveable)``, so that its backward keeps one carry
a chunk; without a backward the result is that of one scan over time.
This package serves these mixers and does not train them yet, so the scan
is one Python loop over time; the chunks and their remat come with their
training (ROADMAP §1).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch


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
