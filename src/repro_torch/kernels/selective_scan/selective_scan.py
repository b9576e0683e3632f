"""Wrappers of K7 (``csrc/selective_scan.cu``) and of its backward
(``csrc/selective_scan_bwd.cu``).

``selective_scan_cuda``, ``selective_scan_save_cuda`` and
``selective_scan_bwd_cuda`` take CUDA tensors only (``ops.py`` sends CPU
tensors to the plain version in ``ref.py``), allocate their outputs and
scratch, launch on PyTorch's current stream, never synchronise, and raise
on a launch error. A forward call, plain or saving, is one K7 launch in
``build.LAUNCHES["k7"]``; a backward call is one ``LAUNCHES["k7bwd"]``
(its two kernels: the reverse scan, then the sums of the per-block
partials of dB, dC and dA).

``SelectiveScan`` binds the two as a ``torch.autograd.Function``: its
forward is K7's saving form, which also writes h at the start of every
``BWD_CHUNK`` steps (the checkpoints the backward recomputes its chunks
from), its backward K7's backward kernels. ``selective_scan_cuda`` called
directly while grad mode is on and an input requires grad raises
(``build.refuse_grad``): its output, filled through a raw pointer, would
carry no ``grad_fn``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: d_state values the kernel is instantiated for (the tiny configs', jamba's)
STATE_SIZES = (8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the backward's channels a CTA and steps a chunk, which is also the
#: stride of the saving forward's checkpoints (its scratch layout); the C
#: entry point refuses other values
BWD_CHANNELS = 64
BWD_CHUNK = 16


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
                        cc: torch.Tensor, a: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7. x, dt [B, T, D] and bc, cc [B, T, S] in one dtype
    (float32 or bfloat16); a [D, S] float32; all contiguous on the card.
    Returns (y [B, T, D] in x's dtype, h_final [B, D, S] float32)."""
    build.refuse_grad("selective_scan", x=x, dt=dt, bc=bc, cc=cc, a=a)
    return _forward("selective_scan", x, dt, bc, cc, a, None)


def selective_scan_save_cuda(x: torch.Tensor, dt: torch.Tensor,
                             bc: torch.Tensor, cc: torch.Tensor,
                             a: torch.Tensor, chunk: int = BWD_CHUNK
                             ) -> Tuple[torch.Tensor, ...]:
    """Launch K7's saving form on ``selective_scan_cuda``'s inputs: returns
    (y, h_final, hs), y and h_final those of the plain launch bit for bit,
    hs float32 [B, ceil(T / chunk), D, S] the state h at the start of every
    ``chunk`` steps (16 or 32), the checkpoints of K7's backward."""
    return _forward("selective_scan_save", x, dt, bc, cc, a, chunk)


def _forward(name, x, dt, bc, cc, a, chunk):
    """K7's launch: the plain form where ``chunk`` is None, else the saving
    form with checkpoints every ``chunk`` steps (returned third)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.require_cuda(name, dtype=x.dtype, x=x, dt=dt, bc=bc, cc=cc)
    build.require_cuda(name, dtype=torch.float32, a=a)
    if x.dim() != 3 or bc.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, T, D] "
                         f"and bc {tuple(bc.shape)} [B, T, S]")
    b, t, d = x.shape
    s = bc.shape[2]
    if dt.shape != x.shape or bc.shape != (b, t, s) or cc.shape != bc.shape \
            or a.shape != (d, s):
        raise ValueError(f"{name}: dt {tuple(dt.shape)}, bc "
                         f"{tuple(bc.shape)}, cc {tuple(cc.shape)}, a "
                         f"{tuple(a.shape)} do not fit x [B={b}, T={t}, "
                         f"D={d}] and S={s}")
    if s not in STATE_SIZES:
        raise ValueError(f"{name}: d_state {s} not one of {STATE_SIZES}")
    if chunk not in (None, 16, 32):
        raise ValueError(f"{name}: chunk {chunk} not 16 or 32")
    y = torch.empty_like(x)
    h = torch.empty((b, d, s), dtype=torch.float32, device=x.device)
    hs = None if chunk is None else torch.empty(
        (b, -(-t // chunk), d, s), dtype=torch.float32, device=x.device)
    if b * t * d == 0:
        h.zero_()
        return (y, h) if hs is None else (y, h, hs)
    lib = build.load()["selective_scan"]
    ptrs = (x.data_ptr(), dt.data_ptr(), bc.data_ptr(), cc.data_ptr(),
            a.data_ptr(), y.data_ptr(), h.data_ptr())
    if hs is None:
        err = lib.selective_scan_launch(*ptrs, b, t, d, s, DTYPES[x.dtype],
                                        build.stream_of(x))
    else:
        err = lib.selective_scan_save_launch(
            *ptrs, hs.data_ptr(), b, t, d, s, chunk, DTYPES[x.dtype],
            build.stream_of(x))
    build.check(err, name)
    build.LAUNCHES["k7"] += 1
    return (y, h) if hs is None else (y, h, hs)


def selective_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor,
                            bc: torch.Tensor, cc: torch.Tensor,
                            a: torch.Tensor, dy: torch.Tensor,
                            dh: Optional[torch.Tensor] = None,
                            hs: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Launch K7's backward: from K7's inputs (as ``selective_scan_cuda``
    takes them), the gradient of y ``dy`` (x's dtype, [B, T, D]) and
    optionally of h_final ``dh`` (float32 [B, D, S]; None is zeros),
    returns (dx, ddt [B, T, D], dbc, dcc [B, T, S] in the inputs' dtype,
    da float32 [D, S]). ``hs`` is the saving forward's checkpoints
    (float32 [B, ceil(T / BWD_CHUNK), D, S]); without them, the saving
    forward is launched first to make them. The float32 scratch it
    allocates: the per-block partials of dB and dC [B, ceil(D /
    BWD_CHANNELS), T, 2 S] and each batch row's dA [B, D, S]."""
    if x.dtype not in DTYPES:
        raise ValueError(f"selective_scan_bwd: dtype {x.dtype} not "
                         f"supported (float32 or bfloat16)")
    build.require_cuda("selective_scan_bwd", dtype=x.dtype, x=x, dt=dt,
                       bc=bc, cc=cc, dy=dy)
    build.require_cuda("selective_scan_bwd", dtype=torch.float32, a=a)
    if x.dim() != 3 or bc.dim() != 3:
        raise ValueError(f"selective_scan_bwd: x {tuple(x.shape)} must be "
                         f"[B, T, D] and bc {tuple(bc.shape)} [B, T, S]")
    b, t, d = x.shape
    s = bc.shape[2]
    if dt.shape != x.shape or dy.shape != x.shape or bc.shape != (b, t, s) \
            or cc.shape != bc.shape or a.shape != (d, s):
        raise ValueError(f"selective_scan_bwd: dt {tuple(dt.shape)}, dy "
                         f"{tuple(dy.shape)}, bc {tuple(bc.shape)}, cc "
                         f"{tuple(cc.shape)}, a {tuple(a.shape)} do not fit "
                         f"x [B={b}, T={t}, D={d}] and S={s}")
    if dh is not None:
        build.require_cuda("selective_scan_bwd", dtype=torch.float32, dh=dh)
        if dh.shape != (b, d, s):
            raise ValueError(f"selective_scan_bwd: dh {tuple(dh.shape)} must "
                             f"be [B={b}, D={d}, S={s}]")
    if s not in STATE_SIZES:
        raise ValueError(f"selective_scan_bwd: d_state {s} not one of "
                         f"{STATE_SIZES}")
    if hs is not None:
        build.require_cuda("selective_scan_bwd", dtype=torch.float32, hs=hs)
        if hs.shape != (b, -(-t // BWD_CHUNK), d, s):
            raise ValueError(f"selective_scan_bwd: hs {tuple(hs.shape)} "
                             f"must be [B={b}, ceil(T / {BWD_CHUNK}), "
                             f"D={d}, S={s}]")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbc, dcc = torch.empty_like(bc), torch.empty_like(cc)
    da = torch.empty((d, s), dtype=torch.float32, device=x.device)
    if b * t * d == 0:
        for g in (dx, ddt, dbc, dcc, da):
            g.zero_()
        return dx, ddt, dbc, dcc, da
    if hs is None:
        hs = selective_scan_save_cuda(x, dt, bc, cc, a)[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((b, -(-d // BWD_CHANNELS), t, 2 * s), **f32)
    pa = torch.empty((b, d, s), **f32)
    lib = build.load()["selective_scan_bwd"]
    err = lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), bc.data_ptr(), cc.data_ptr(),
        a.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
        hs.data_ptr(), part.data_ptr(), pa.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dbc.data_ptr(), dcc.data_ptr(), da.data_ptr(), b, t,
        d, s, BWD_CHANNELS, BWD_CHUNK, DTYPES[x.dtype], build.stream_of(x))
    build.check(err, "selective_scan_bwd")
    build.LAUNCHES["k7bwd"] += 1
    return dx, ddt, dbc, dcc, da


class SelectiveScan(torch.autograd.Function):
    """K7 with a backward: the forward launches K7's saving form and keeps
    (x, dt, bc, cc, a) and the checkpoints hs; the backward launches
    ``selective_scan_bwd_cuda`` on them with the gradients of y and of
    h_final (None where the loss does not reach them). Under ``remat=
    "full"`` only the recompute runs under grad, so one layer's hs is live
    at a time."""

    @staticmethod
    def forward(ctx, x, dt, bc, cc, a):
        y, h, hs = selective_scan_save_cuda(x, dt, bc, cc, a)
        ctx.save_for_backward(x, dt, bc, cc, a, hs)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, bc, cc, a, hs = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        return selective_scan_bwd_cuda(
            x, dt, bc, cc, a, dy, None if dh is None else dh.contiguous(),
            hs)
