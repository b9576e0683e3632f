"""Wrapper of the K5 CUDA kernel (``csrc/decode_attention.cu``).

``decode_attention_cuda`` takes CUDA tensors only (``ops.py`` sends CPU
tensors to the plain version in ``ref.py``), allocates the output and the
float32 split workspace, launches the one kernel (splits and their merge)
on PyTorch's current stream, never synchronises, and raises on a launch
error. One call is one K5 launch in ``build.LAUNCHES["k5"]``.
It has no backward: called while grad mode is on with an input that
requires grad, it raises (``build.refuse_grad``) rather than return an
output detached from the graph.

The kernel's last split to finish a row merges the row, found by an int32
counter per row that the kernel leaves at 0; the counters are kept per
device (``_COUNTERS``), zeroed once, so a call costs no memset. Calls on
one device run on one stream at a time, as the serve loop runs them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: cache positions per split are a multiple of the kernel's 32-row tile
TILE = 32
#: shortest split: a shorter one costs more in the merge than it saves
MIN_CHUNK = 256
#: one CTA per SM: each keeps ~48 KB of K/V in flight, enough for the card
_TARGET_CTAS = 132
#: below this many CTAs a short cache splits a GQA group over more CTAs
_MIN_CTAS = 96
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_chunk(batch_heads: int, s: int) -> int:
    """Cache positions per CTA: about one CTA per SM over the whole cache
    (``batch_heads`` rows of the cache), in tiles of 32, at least 256 and at
    most the cache rounded up to a tile."""
    want = -(-s * batch_heads // _TARGET_CTAS)
    chunk = max(MIN_CHUNK, -(-want // TILE) * TILE)
    return min(chunk, -(-s // TILE) * TILE)


#: the kernel's head-slot counts (GC); 5 is qwen3-14b's group of 40 / 8
HEAD_SLOTS = (1, 2, 4, 5, 8)


def heads_per_cta(g: int) -> int:
    """Query heads a CTA holds in registers (the kernel's GC): the least
    slot count that holds the group's g; a group of more than 8 takes
    ceil(g / 8) CTAs per split."""
    return next((c for c in HEAD_SLOTS if c >= g), HEAD_SLOTS[-1])


def split_plan(b: int, hkv: int, g: int, s: int) -> Tuple[int, int]:
    """(heads per CTA, cache positions per CTA) for a launch: the split of
    :func:`split_chunk`, and the head slots of :func:`heads_per_cta`, cut to
    fewer heads per CTA (down to 2) while the grid has under 96 CTAs, as a
    short cache has (at S = 256 one split and 3 CTAs per group of 5 beat
    4 splits of the whole group; ``PERF.md``)."""
    chunk = split_chunk(b * hkv, s)
    splits = -(-s // chunk)
    gc = heads_per_cta(g)
    for smaller in (4, 2):
        if b * hkv * -(-g // gc) * splits >= _MIN_CTAS:
            break
        gc = min(gc, smaller)
    return gc, chunk


#: zeroed merge counters per CUDA device index, grown on demand
_COUNTERS: Dict[int, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    have = _COUNTERS.get(device.index)
    if have is None or have.numel() < n:
        have = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device.index] = have
    return have


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """Launch K5. q [B, Hq, D]; k, v [B, Hkv, S, D] (q's dtype); kv_len
    int32[B] on the card. Returns [B, Hq, D] in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    build.refuse_grad("decode_attention", q=q, k=k, v=v)
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
    gc, chunk = split_plan(b, hkv, g, s)
    rows = b * hkv * -(-g // gc)
    n_splits = -(-s // chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty((rows, n_splits, gc, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((rows, n_splits, gc, 2), dtype=torch.float32,
                          device=q.device)
    counter = _counters(q.device, rows)
    lib = build.load()["decode_attention"]
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        counter.data_ptr(), b, hq, hkv, s, d, chunk, gc, DTYPES[q.dtype],
        build.stream_of(q))
    build.check(err, "decode_attention")
    build.LAUNCHES["k5"] += 1
    return out
