"""The paper's four target microbenchmarks (§7) as analytic trace generators.

The paper captured address traces with Valgrind over small C kernels; no
Valgrind exists in this environment, so each generator synthesizes the same
access *pattern* the C source would produce, at a configurable issue
intensity:

  * ``conv2d``               — sliding-window spatial locality, bursty
    9-read + 1-write groups per output pixel.
  * ``multihead_attention``  — QK^T dot products with K/V re-read per query
    (softmax-induced reuse), per-head blocked.
  * ``trace_example``        — sequential write-then-read validation sweep
    (request sequencing + correct data return).
  * ``vector_similarity``    — irregular hashed gathers over a vector
    database plus a reduction write per vector.

All generators return a CPU :class:`repro_torch.core.Trace` whose ``t`` fields are
strictly increasing (the front-end admits one request per cycle) and whose
average issue intensity is ``rate`` requests/cycle — the paper's 100k-cycle
runs correspond to the defaults here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.simulator import Trace


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    num_requests: int
    read_frac: float
    description: str


def _emit(times: List[int], addrs: List[int], writes: List[int],
          wdata: List[int] | None = None) -> Trace:
    t = np.asarray(times, np.int64)
    # keep t strictly increasing (1 admission/cycle front-end port)
    t = np.maximum.accumulate(np.maximum(t, np.arange(len(t)) * 0 + t))
    for i in range(1, len(t)):
        if t[i] <= t[i - 1]:
            t[i] = t[i - 1] + 1
    wd = wdata if wdata is not None else list(np.arange(len(times)) & 0x7FFFFFFF)
    return Trace.from_numpy(t.astype(np.int32), np.asarray(addrs, np.int64) & 0x3FFFFFFF,
                            np.asarray(writes, np.int32), np.asarray(wd, np.int64) & 0x7FFFFFFF)


def conv2d(h: int = 34, w: int = 34, k: int = 3, burst_gap: int = 48,
           seed: int = 0) -> Trace:
    """2D convolution: for each output pixel, 9 window reads + 1 write.

    Input image at base 0, 3x3 weights re-read each pixel (they live in a
    register in the C kernel after the first load, so only re-read every
    ``w`` pixels, modelling a row change), output at base h*w + 16.
    """
    in_base, wt_base, out_base = 0, h * w, h * w + 16
    times, addrs, writes = [], [], []
    t = 0
    oh, ow = h - k + 1, w - k + 1
    for i in range(oh):
        for j in range(ow):
            if j == 0:  # weight reload at row start
                for kk in range(k * k):
                    times.append(t); addrs.append(wt_base + kk); writes.append(0); t += 1
            for di in range(k):
                for dj in range(k):
                    times.append(t)
                    addrs.append(in_base + (i + di) * w + (j + dj))
                    writes.append(0)
                    t += 1
            times.append(t); addrs.append(out_base + i * ow + j); writes.append(1)
            t += burst_gap  # compute gap between output pixels
    return _emit(times, addrs, writes)


def multihead_attention(seq: int = 24, dim: int = 8, heads: int = 2,
                        burst_gap: int = 80, mac_gap: int = 5, seed: int = 0) -> Trace:
    """Toy MHA: per (head, query): read q row, stream K rows, stream V rows,
    write one output row — K/V blocks are re-read for every query (reuse).

    ``mac_gap`` models the multiply-accumulate cycles between loads in the
    C kernel's inner loop (loads are not back-to-back at the memory port).
    """
    q_base = 0
    k_base = heads * seq * dim
    v_base = 2 * heads * seq * dim
    o_base = 3 * heads * seq * dim
    times, addrs, writes = [], [], []
    t = 0
    for hd in range(heads):
        for qi in range(seq):
            for d in range(dim):  # q row
                times.append(t); addrs.append(q_base + (hd * seq + qi) * dim + d)
                writes.append(0); t += 2
            for kj in range(seq):  # scores: stream K
                for d in range(0, dim, 2):  # unrolled-by-2 loads in the C kernel
                    times.append(t); addrs.append(k_base + (hd * seq + kj) * dim + d)
                    writes.append(0); t += mac_gap
            for vj in range(seq):  # weighted sum: stream V
                for d in range(0, dim, 2):
                    times.append(t); addrs.append(v_base + (hd * seq + vj) * dim + d)
                    writes.append(0); t += mac_gap
            for d in range(dim):  # output row
                times.append(t); addrs.append(o_base + (hd * seq + qi) * dim + d)
                writes.append(1); t += 2
            t += burst_gap
    return _emit(times, addrs, writes)


def trace_example(n: int = 2000, gap: int = 5, seed: int = 0) -> Trace:
    """Minimal validation trace: write a region sequentially, read it back.

    Used by the correctness tests: read i must return the value written by
    write i at the same address.
    """
    rng = np.random.default_rng(seed)
    base = 128
    times, addrs, writes, wdata = [], [], [], []
    t = 0
    vals = rng.integers(1, 1 << 30, size=n)
    for i in range(n):
        times.append(t); addrs.append(base + i); writes.append(1)
        wdata.append(int(vals[i])); t += gap
    for i in range(n):
        times.append(t); addrs.append(base + i); writes.append(0)
        wdata.append(0); t += gap
    return _emit(times, addrs, writes, wdata)


def vector_similarity(num_vectors: int = 400, dim: int = 16,
                      burst_gap: int = 36, seed: int = 0) -> Trace:
    """Cosine-similarity scan: hashed (irregular) vector bases, sequential
    within a vector, one score write per vector + final argmax read pass."""
    rng = np.random.default_rng(seed)
    db_span = 1 << 18
    bases = rng.integers(0, db_span - dim, size=num_vectors)
    q_base = db_span + 64
    s_base = db_span + 64 + dim
    times, addrs, writes = [], [], []
    t = 0
    for d in range(dim):  # query vector once
        times.append(t); addrs.append(q_base + d); writes.append(0); t += 1
    for v in range(num_vectors):
        for d in range(dim):
            times.append(t); addrs.append(int(bases[v]) + d); writes.append(0)
            t += 3  # fused multiply-add between loads
        times.append(t); addrs.append(s_base + v); writes.append(1)
        t += burst_gap
    for v in range(num_vectors):  # reduction: re-read all scores
        times.append(t); addrs.append(s_base + v); writes.append(0); t += 2
    return _emit(times, addrs, writes)


BENCHMARKS: Dict[str, Callable[..., Trace]] = {
    "conv2d": conv2d,
    "multihead_attention": multihead_attention,
    "trace_example": trace_example,
    "vector_similarity": vector_similarity,
}


def make(name: str, **kw) -> Trace:
    return BENCHMARKS[name](**kw)
