"""Plain PyTorch version of K7: the Mamba selective scan (the reference's
``selective_scan_ref``, which is also the step of ``mamba_full``).

    h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t ;  y_t = C_t . h_t

The dtype order is the reference's: ``dt * x`` in the input dtype, then
float32; ``exp(dt_f32 * a)``; each step's ``y`` cast to x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
                       cc: torch.Tensor, a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [B, T, D]; bc, cc: [B, T, S]; a: [D, S] (negative) ->
    (y [B, T, D] in x's dtype, h_final [B, D, S] float32); h0 = 0."""
    b, t, d = x.shape
    s = bc.shape[-1]
    a = a.to(F32)
    h = torch.zeros((b, d, s), dtype=F32, device=x.device)
    y = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    for i in range(t):
        dtt = dt[:, i]
        da = torch.exp(dtt[..., None].to(F32) * a)               # [B, D, S]
        h = da * h + (dtt * x[:, i])[..., None].to(F32) \
            * bc[:, i, None, :].to(F32)
        y[:, i] = torch.einsum("bds,bs->bd", h, cc[:, i].to(F32)).to(x.dtype)
    return y, h
