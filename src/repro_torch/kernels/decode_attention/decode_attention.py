"""Wrapper of the K5 CUDA kernel (``csrc/decode_attention.cu``).

``decode_attention_cuda`` takes CUDA tensors only (``ops.py`` sends CPU
tensors to the plain version in ``ref.py``), allocates the output and the
float32 split workspace, launches the split and combine kernels on
PyTorch's current stream, never synchronises, and raises on a launch
error. One call is one K5 launch in ``build.LAUNCHES["k5"]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: cache positions per split are a multiple of the kernel's 32-row tile
TILE = 32
#: largest split; shorter when the (batch, kv-head) pairs are too few to
#: give the card's 132 SMs two CTAs each
MAX_CHUNK = 256
_TARGET_CTAS = 2 * 132
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_chunk(batch_heads: int, s: int) -> int:
    """Cache positions per CTA: enough splits for ~2 CTAs per SM over the
    whole cache, in tiles of 32, at most 256."""
    want = -(-s * batch_heads // _TARGET_CTAS)
    return max(TILE, min(MAX_CHUNK, -(-want // TILE) * TILE))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """Launch K5. q [B, Hq, D]; k, v [B, Hkv, S, D] (q's dtype); kv_len
    int32[B] on the card. Returns [B, Hq, D] in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.require_cuda("decode_attention", dtype=q.dtype, q=q, k=k, v=v)
    build.require_cuda("decode_attention", kv_len=kv_len)
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be [B={b}, Hkv, S, "
                         f"D={d}]")
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv or d not in HEAD_DIMS or kv_len.shape != (b,) or s < 1:
        raise ValueError(f"decode_attention: Hq={hq} must be a multiple of "
                         f"Hkv={hkv}, D={d} one of {HEAD_DIMS}, kv_len "
                         f"[{b}] (got {tuple(kv_len.shape)})")
    g = hq // hkv
    chunk = split_chunk(b * hkv, s)
    n_splits = -(-s // chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty((b * hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = build.load()["decode_attention"]
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, hq, hkv,
        s, d, chunk, DTYPES[q.dtype], build.stream_of(q))
    build.check(err, "decode_attention")
    build.LAUNCHES["k5"] += 1
    return out
