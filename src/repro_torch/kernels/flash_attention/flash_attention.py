"""Wrapper of the K6 CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention_cuda`` takes CUDA tensors only (``ops.py`` sends CPU
tensors to the plain version in ``ref.py``), allocates the output,
launches on PyTorch's current stream, never synchronises, and raises on a
launch error. One call is one K6 launch in ``build.LAUNCHES["k6"]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch K6. q [B, Hq, S, D]; k, v [B, Hkv, S, D] (q's dtype).
    Returns [B, Hq, S, D] in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.require_cuda("flash_attention", dtype=q.dtype, q=q, k=k, v=v)
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be [B={b}, Hkv, S={s}, "
                         f"D={d}]")
    hkv = k.shape[1]
    if hq % hkv or d not in HEAD_DIMS or s < 1:
        raise ValueError(f"flash_attention: Hq={hq} must be a multiple of "
                         f"Hkv={hkv} and D={d} one of {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = build.load()["flash_attention"]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        s, d, int(causal), DTYPES[q.dtype], build.stream_of(q))
    build.check(err, "flash_attention")
    build.LAUNCHES["k6"] += 1
    return out
