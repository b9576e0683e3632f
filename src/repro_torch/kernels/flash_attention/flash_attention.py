"""Wrappers of K6 (``csrc/flash_attention.cu``) and of its backward
(``csrc/flash_attention_bwd.cu``).

``flash_attention_cuda`` and ``flash_attention_bwd_cuda`` take CUDA
tensors only (``ops.py`` sends CPU tensors to the plain version in
``ref.py``), allocate their outputs, launch on PyTorch's current stream,
never synchronise, and raise on a launch error. A forward call is one K6
launch in ``build.LAUNCHES["k6"]``; a backward call is one
``LAUNCHES["k6bwd"]`` (its three kernels: the row sums dO . O, dK/dV, dQ;
bf16 with D 64 or 128 takes the tensor-core form, on ``wgmma`` and TMA,
every other dtype and D the FMA form, as K6's forward chooses). The
backward's float32 scratch (the row sums and the log2 LSE, padded to 64
rows a head) is allocated here, like its outputs.

``FlashAttention`` binds the two as a ``torch.autograd.Function``: its
forward launches K6 with the log-sum-exp output, its backward the
backward kernels. ``flash_attention_cuda`` called directly while grad
mode is on and an input requires grad raises (``build.refuse_grad``):
its output, filled through a raw pointer, would carry no ``grad_fn``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
#: the backward's scratch rows a head are S rounded up to this
BWD_ROWS = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.require_cuda(name, dtype=q.dtype, q=q, k=k, v=v)
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != (s, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be [B={b}, Hkv, S={s}, "
                         f"D={d}]")
    hkv = k.shape[1]
    if hq % hkv or d not in HEAD_DIMS or s < 1:
        raise ValueError(f"{name}: Hq={hq} must be a multiple of "
                         f"Hkv={hkv} and D={d} one of {HEAD_DIMS}")
    return b, hq, hkv, s, d


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K6. q [B, Hq, S, D]; k, v [B, Hkv, S, D] (q's dtype).
    Returns [B, Hq, S, D] in q's dtype. Given ``lse`` (float32 [B, Hq, S],
    contiguous), K6 also writes there each row's log-sum-exp of its
    scaled logits; the output is the same bits either way."""
    build.refuse_grad("flash_attention", q=q, k=k, v=v)
    b, hq, hkv, s, d = _check("flash_attention", q, k, v)
    if lse is not None:
        build.require_cuda("flash_attention", dtype=torch.float32, lse=lse)
        if lse.shape != (b, hq, s):
            raise ValueError(f"flash_attention: lse {tuple(lse.shape)} must "
                             f"be [B={b}, Hq={hq}, S={s}]")
    out = torch.empty_like(q)
    lib = build.load()["flash_attention"]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, s, d,
        int(causal), DTYPES[q.dtype], build.stream_of(q))
    build.check(err, "flash_attention")
    build.LAUNCHES["k6"] += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K6's backward: (dq [B, Hq, S, D], dk, dv [B, Hkv, S, D]) in
    q's dtype from the forward's inputs, its output ``out``, its ``lse``
    (float32 [B, Hq, S]) and the output's gradient ``dout``."""
    b, hq, hkv, s, d = _check("flash_attention_bwd", q, k, v)
    build.require_cuda("flash_attention_bwd", dtype=q.dtype, out=out,
                       dout=dout)
    build.require_cuda("flash_attention_bwd", dtype=torch.float32, lse=lse)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hq, s):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be q's "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} "
                         f"[B, Hq, S]")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must start on a "
                             f"16-byte boundary (the kernels' TMA and "
                             f"16-byte loads)")
    scratch = torch.empty((2, b, hq, -(-s // BWD_ROWS) * BWD_ROWS),
                          dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    lib = build.load()["flash_attention_bwd"]
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s, d, int(causal),
        DTYPES[q.dtype], build.stream_of(q))
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["k6bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K6 with a backward: the forward keeps (q, k, v, out, lse) and the
    backward launches ``flash_attention_bwd_cuda``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = flash_attention_cuda(q, k, v, causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view into the middle of a buffer
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              ctx.causal)
        return dq, dk, dv, None
