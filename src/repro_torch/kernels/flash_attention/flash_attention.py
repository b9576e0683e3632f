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
The backward of the general form (any call that is not a base form) takes
(Dqk, Dv) with Sq and Sk apart and the forward's scale, and picks its
kernels as the forward does (:func:`general_form`): bf16 at a pair of
``TC_DIMS`` the tensor-core kernels of ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_gen_tc_launch``, on ``wgmma`` and TMA), counted
under ``LAUNCHES["k6bwd_gen_tc"]``; float32, and bf16 at the small widths,
its FMA kernels (``flash_attention_bwd_gen_launch``), counted under
``LAUNCHES["k6bwd_gen"]``. Its scratch is sized by Sq.

K6's general form takes every call that the base forms do not: MLA's
prefill (Dqk 192, Dv 128), cross-attention (Sq != Sk, not causal) and an
explicit scale other than 1/sqrt(Dqk). :func:`general_form` picks its
kernel from dtype and (Dqk, Dv): bf16 at a pair of ``TC_DIMS`` launches
the tensor-core kernel (``flash_attention_gen_tc_launch``, on ``wgmma``
and TMA), counted under ``LAUNCHES["k6gen_tc"]``; float32, and bf16 at the
small widths, the FMA kernel (``flash_attention_gen_launch``), counted
under ``LAUNCHES["k6gen"]``. There is no fallback between the two: a
launch that fails raises. A shape that no form takes raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
#: (Dqk, Dv) of the general form: equal widths (a cross-attention), MLA at
#: full width (nope 128 + rope 64, v 128) and at the tests' tiny width
GEN_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (24, 16), (192, 128))
#: (Dqk, Dv) that the general form runs on the tensor cores, in bf16
TC_DIMS = ((64, 64), (128, 128), (192, 128))
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


def is_base_form(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float] = None) -> bool:
    """Whether a call is one of K6's base forms (its backward's too): one
    length, one head width in ``HEAD_DIMS``, the scale 1/sqrt(D)."""
    d = q.shape[-1]
    return (k.shape[2] == q.shape[2] and k.shape[-1] == v.shape[-1] == d
            and d in HEAD_DIMS
            and (scale is None or scale == 1.0 / math.sqrt(d)))


def general_form(dtype: torch.dtype, dqk: int, dv: int) -> str:
    """The general form's kernel for a dtype and (Dqk, Dv): ``"tc"`` (the
    tensor cores: bf16 at a pair of ``TC_DIMS``) or ``"fma"`` (float32,
    whose 1e-5 tolerance TF32 cannot hold, and bf16 at the small widths)."""
    return "tc" if dtype == torch.bfloat16 and (dqk, dv) in TC_DIMS \
        else "fma"


def _check_general(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, causal: bool
                   ) -> Tuple[int, int, int, int, int, int, int]:
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.require_cuda(name, dtype=q.dtype, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be 4-D")
    b, hq, sq, dqk = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (b, hkv, sk, dqk) or v.shape[:3] != (b, hkv, sk):
        raise ValueError(f"{name}: k {tuple(k.shape)} must be [B={b}, Hkv, "
                         f"Sk, Dqk={dqk}] and v {tuple(v.shape)} [B={b}, Hkv, "
                         f"Sk, Dv]")
    if hq % hkv or sq < 1 or sk < 1:
        raise ValueError(f"{name}: Hq={hq} must be a multiple of Hkv={hkv}")
    if (dqk, dv) not in GEN_DIMS:
        raise ValueError(f"{name}: (Dqk, Dv) = ({dqk}, {dv}) is not one of "
                         f"K6's forms {GEN_DIMS}")
    if causal and sq != sk:
        raise ValueError(f"{name}: causal attention needs Sq == Sk (got "
                         f"{sq}, {sk})")
    return b, hq, hkv, sq, sk, dqk, dv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         lse: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch K6. q [B, Hq, Sq, Dqk]; k [B, Hkv, Sk, Dqk]; v [B, Hkv, Sk,
    Dv] (q's dtype); the logits times ``scale`` (1/sqrt(Dqk) by default);
    causal only with Sq == Sk. Returns [B, Hq, Sq, Dv] in q's dtype. A base
    form (:func:`is_base_form`) launches the tensor-core or FMA kernel of
    ``flash_attention_launch``, anything else the general form. Given
    ``lse`` (float32 [B, Hq, Sq], contiguous), K6 also writes there each
    row's log-sum-exp of its scaled logits; the output is the same bits
    either way."""
    build.refuse_grad("flash_attention", q=q, k=k, v=v)
    base = is_base_form(q, k, v, scale)
    if base:
        b, hq, hkv, sq, d = _check("flash_attention", q, k, v)
    else:
        b, hq, hkv, sq, sk, dqk, dv = _check_general("flash_attention", q, k,
                                                     v, causal)
    if lse is not None:
        build.require_cuda("flash_attention", dtype=torch.float32, lse=lse)
        if lse.shape != (b, hq, sq):
            raise ValueError(f"flash_attention: lse {tuple(lse.shape)} must "
                             f"be [B={b}, Hq={hq}, Sq={sq}]")
    lse_p = None if lse is None else lse.data_ptr()
    lib = build.load()["flash_attention"]
    if base:
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_p,
            b, hq, hkv, sq, d, int(causal), DTYPES[q.dtype],
            build.stream_of(q))
        build.check(err, "flash_attention")
        build.LAUNCHES["k6"] += 1
        return out
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(dqk) if scale is None else float(scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_p)
    if general_form(q.dtype, dqk, dv) == "tc":
        err = lib.flash_attention_gen_tc_launch(
            *ptrs, b, hq, hkv, sq, sk, dqk, dv, int(causal), scale,
            build.stream_of(q))
        build.check(err, "flash_attention (general form, tensor cores)")
        build.LAUNCHES["k6gen_tc"] += 1
        return out
    err = lib.flash_attention_gen_launch(
        *ptrs, b, hq, hkv, sq, sk, dqk, dv, int(causal), DTYPES[q.dtype],
        scale, build.stream_of(q))
    build.check(err, "flash_attention (general form, FMA)")
    build.LAUNCHES["k6gen"] += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K6's backward: (dq [B, Hq, Sq, Dqk], dk [B, Hkv, Sk, Dqk],
    dv [B, Hkv, Sk, Dv]) in q's dtype from the forward's inputs, its
    output ``out``, its ``lse`` (float32 [B, Hq, Sq]), the output's
    gradient ``dout`` and the forward's ``scale`` (1/sqrt(Dqk) by
    default). A base form (:func:`is_base_form`) launches
    ``flash_attention_bwd_launch`` (``LAUNCHES["k6bwd"]``), anything else
    the general form's kernels for :func:`general_form`: the tensor-core
    ones (``flash_attention_bwd_gen_tc_launch``, ``LAUNCHES["k6bwd_gen_tc"]``)
    or the FMA ones (``flash_attention_bwd_gen_launch``,
    ``LAUNCHES["k6bwd_gen"]``). No fallback between the two."""
    base = is_base_form(q, k, v, scale)
    if base:
        b, hq, hkv, sq, d = _check("flash_attention_bwd", q, k, v)
        dv_ = d
    else:
        b, hq, hkv, sq, sk, dqk, dv_ = _check_general("flash_attention_bwd",
                                                      q, k, v, causal)
    build.require_cuda("flash_attention_bwd", dtype=q.dtype, out=out,
                       dout=dout)
    build.require_cuda("flash_attention_bwd", dtype=torch.float32, lse=lse)
    if out.shape != (b, hq, sq, dv_) or dout.shape != out.shape \
            or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be [B={b}, Hq={hq}, "
                         f"Sq={sq}, Dv={dv_}], lse {tuple(lse.shape)} "
                         f"[B, Hq, Sq]")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must start on a "
                             f"16-byte boundary (the kernels' TMA and "
                             f"16-byte loads)")
    scratch = torch.empty((2, b, hq, -(-sq // BWD_ROWS) * BWD_ROWS),
                          dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    lib = build.load()["flash_attention_bwd"]
    if base:
        err = lib.flash_attention_bwd_launch(
            *ptrs, b, hq, hkv, sq, d, int(causal), DTYPES[q.dtype],
            build.stream_of(q))
        build.check(err, "flash_attention_bwd")
        build.LAUNCHES["k6bwd"] += 1
        return dq, dk, dv
    scale = 1.0 / math.sqrt(dqk) if scale is None else float(scale)
    if general_form(q.dtype, dqk, dv_) == "tc":
        err = lib.flash_attention_bwd_gen_tc_launch(
            *ptrs, b, hq, hkv, sq, sk, dqk, dv_, int(causal), scale,
            build.stream_of(q))
        build.check(err, "flash_attention_bwd (general form, tensor cores)")
        build.LAUNCHES["k6bwd_gen_tc"] += 1
        return dq, dk, dv
    err = lib.flash_attention_bwd_gen_launch(
        *ptrs, b, hq, hkv, sq, sk, dqk, dv_, int(causal), DTYPES[q.dtype],
        scale, build.stream_of(q))
    build.check(err, "flash_attention_bwd (general form, FMA)")
    build.LAUNCHES["k6bwd_gen"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K6 with a backward: the forward keeps (q, k, v, out, lse) and the
    scale, and the backward launches ``flash_attention_bwd_cuda``, a base
    form's kernels or the general form's."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float] = None):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = flash_attention_cuda(q, k, v, causal, lse=lse, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view into the middle of a buffer
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None
