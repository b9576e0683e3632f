"""Wrapper of the K7 CUDA kernel (``csrc/selective_scan.cu``).

``selective_scan_cuda`` takes CUDA tensors only (``ops.py`` sends CPU
tensors to the plain version in ``ref.py``), allocates y and h_final,
launches one kernel on PyTorch's current stream, never synchronises, and
raises on a launch error. One call is one K7 launch in
``build.LAUNCHES["k7"]``.
It has no backward: called while grad mode is on with an input that
requires grad, it raises (``build.refuse_grad``) rather than return an
output detached from the graph.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

#: d_state values the kernel is instantiated for (the tiny configs', jamba's)
STATE_SIZES = (8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
                        cc: torch.Tensor, a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7. x, dt [B, T, D] and bc, cc [B, T, S] in one dtype
    (float32 or bfloat16); a [D, S] float32; all contiguous on the card.
    Returns (y [B, T, D] in x's dtype, h_final [B, D, S] float32)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"selective_scan: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.refuse_grad("selective_scan", x=x, dt=dt, bc=bc, cc=cc, a=a)
    build.require_cuda("selective_scan", dtype=x.dtype, x=x, dt=dt, bc=bc,
                       cc=cc)
    build.require_cuda("selective_scan", dtype=torch.float32, a=a)
    if x.dim() != 3 or bc.dim() != 3:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} must be "
                         f"[B, T, D] and bc {tuple(bc.shape)} [B, T, S]")
    b, t, d = x.shape
    s = bc.shape[2]
    if dt.shape != x.shape or bc.shape != (b, t, s) or cc.shape != bc.shape \
            or a.shape != (d, s):
        raise ValueError(f"selective_scan: dt {tuple(dt.shape)}, bc "
                         f"{tuple(bc.shape)}, cc {tuple(cc.shape)}, a "
                         f"{tuple(a.shape)} do not fit x [B={b}, T={t}, "
                         f"D={d}] and S={s}")
    if s not in STATE_SIZES:
        raise ValueError(f"selective_scan: d_state {s} not one of "
                         f"{STATE_SIZES}")
    y = torch.empty_like(x)
    h = torch.empty((b, d, s), dtype=torch.float32, device=x.device)
    if b * t * d == 0:
        h.zero_()
        return y, h
    lib = build.load()["selective_scan"]
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), bc.data_ptr(), cc.data_ptr(),
        a.data_ptr(), y.data_ptr(), h.data_ptr(), b, t, d, s,
        DTYPES[x.dtype], build.stream_of(x))
    build.check(err, "selective_scan")
    build.LAUNCHES["k7"] += 1
    return y, h
