"""LLM workload -> DRAM trace (the paper's motivation, made concrete).

The paper motivates MemorySim with LLM memory-boundedness but never closes
the loop from an actual model to a DRAM trace. We do: given one of the
assigned architecture configs and a step kind, synthesize the per-device
HBM access stream of one step at a configurable sampling ratio, so the
cycle-accurate simulator can estimate *effective* (not peak) bandwidth for
that workload (the reference's ``perfmodel.effective_bw`` studies use it
to refine the roofline memory term). Every generator is numpy and returns
a CPU :class:`~repro_torch.core.simulator.Trace`; the same arguments give
the reference's ``repro.traces.llm_workload`` streams element for
element.

Access stream model (per device, per step):

  * ``decode``  — weight streaming dominates: every parameter shard is read
    once per token (sequential, large rows); the KV cache / SSM state is
    read (and appended) per layer; activations are negligible.
  * ``train``   — parameters read (fwd+bwd), gradients written, activations
    written in fwd and re-read in bwd, optimizer state read+written.
  * ``prefill`` — weights read once, activations streamed per layer.

Every simulated request stands for ``bytes_per_req`` real bytes (one DRAM
burst of 64B times ``sample_every`` — the trace subsampling keeps simulated
request counts ~10k while preserving the bank/row access *pattern*).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.simulator import Trace

BURST_BYTES = 64  # one DRAM burst (BL8 x 64-bit channel)


@dataclasses.dataclass(frozen=True)
class WorkloadTraffic:
    """Per-device HBM traffic of one step, in bytes."""

    name: str
    weight_read: float
    act_read: float
    act_write: float
    kv_read: float
    kv_write: float

    @property
    def total(self) -> float:
        return (self.weight_read + self.act_read + self.act_write
                + self.kv_read + self.kv_write)


def traffic_from_cost(name: str, bytes_accessed: float,
                      weight_frac: float = 0.6, read_frac: float = 0.8) -> WorkloadTraffic:
    """Build a traffic split from a compiled ``cost_analysis`` byte count."""
    wr = bytes_accessed * weight_frac
    rest = bytes_accessed - wr
    return WorkloadTraffic(
        name=name,
        weight_read=wr,
        act_read=rest * read_frac * 0.5,
        act_write=rest * (1 - read_frac),
        kv_read=rest * read_frac * 0.5,
        kv_write=0.0,
    )


def synthesize(traffic: WorkloadTraffic, target_requests: int = 12_000,
               rate: float = 0.9, seed: int = 0) -> Tuple[Trace, float]:
    """Turn a traffic split into a request trace.

    Returns ``(trace, bytes_per_request)``. Streams are interleaved the way
    an accelerator's DMA engines would issue them: long sequential weight
    runs, strided activation bursts, and KV-region appends, shuffled at
    coarse granularity. ``rate`` is requests/cycle offered to the front end.
    """
    rng = np.random.default_rng(seed)
    total = traffic.total
    if total <= 0:
        raise ValueError("empty traffic")
    bytes_per_req = max(BURST_BYTES, total / target_requests)

    def _n(x: float) -> int:
        return max(1, int(round(x / bytes_per_req)))

    # address regions (word = 4B granularity; addresses in words)
    wspan = 1 << 22
    w_base, a_base, k_base = 0, wspan, wspan + (wspan >> 1)
    stride = max(1, int(bytes_per_req // 4))

    chunks = []
    # weights: one long sequential stream, chunked per layer-ish granule
    n_w = _n(traffic.weight_read)
    per_chunk = max(16, n_w // 64)
    pos = 0
    while pos < n_w:
        c = min(per_chunk, n_w - pos)
        addr = w_base + (np.arange(c) + pos) * stride
        chunks.append((addr % wspan, np.zeros(c, np.int32)))
        pos += c
    # activations: strided read + write bursts
    for frac, is_w in ((traffic.act_read, 0), (traffic.act_write, 1)):
        n = _n(frac)
        pos = 0
        while pos < n:
            c = min(256, n - pos)
            base = a_base + int(rng.integers(0, wspan >> 2))
            addr = base + np.arange(c) * stride
            chunks.append((addr % (wspan << 1), np.full(c, is_w, np.int32)))
            pos += c
    # KV: sequential reads over the cache + small append writes
    for frac, is_w in ((traffic.kv_read, 0), (traffic.kv_write, 1)):
        n = _n(frac)
        pos = 0
        while pos < n:
            c = min(512, n - pos)
            addr = k_base + (np.arange(c) + pos) * stride
            chunks.append((addr % (wspan << 1), np.full(c, is_w, np.int32)))
            pos += c

    order = rng.permutation(len(chunks))
    addrs = np.concatenate([chunks[i][0] for i in order]).astype(np.int64)
    writes = np.concatenate([chunks[i][1] for i in order])
    n = len(addrs)
    gaps = rng.random(n) < rate
    t = np.cumsum(np.where(gaps, 1, 1 + rng.integers(1, 4, size=n))).astype(np.int64)
    return (
        Trace.from_numpy(t.astype(np.int32), addrs & 0x3FFFFFFF, writes,
                         np.arange(n, dtype=np.int64) & 0x7FFFFFFF),
        float(bytes_per_req),
    )


def decode_serving_trace(tokens: int = 96, reads_per_token: int = 16,
                         compute_gap: int = 4000, kv_frac: float = 0.25,
                         seed: int = 0) -> Trace:
    """Token-by-token decode serving stream — the WAIT-heavy regime.

    Each generated token triggers a burst of weight-shard and KV-cache
    reads (one per cycle, striped across banks), then the memory port goes
    quiet for ``compute_gap`` cycles while the accelerator does the matmul.
    During the burst drain the banks sit in *staggered* ACT/RW/PRE WAIT
    states and blocked column bids — exactly the phase the event-horizon
    engine collapses to its event count and a drained-gate engine cannot.

    Weight reads walk sequential rows (a fresh region per token — decode
    re-streams every shard); KV reads gather from a growing cache region.
    """
    rng = np.random.default_rng(seed)
    w_base, k_base = 0, 1 << 24
    times, addrs, writes = [], [], []
    t = 0
    n_kv = max(1, int(reads_per_token * kv_frac))
    n_w = reads_per_token - n_kv
    for tok in range(tokens):
        # unit stride: consecutive words stripe across banks/bankgroups
        # (the {bank, bankgroup, rank} bits are the address LSBs), the way
        # a weight shard's DMA burst fans out over the whole device
        w_start = (tok * n_w) % (1 << 23)
        for i in range(n_w):
            times.append(t)
            addrs.append(w_base + w_start + i)
            writes.append(0)
            t += 1
        for i in range(n_kv):
            times.append(t)
            addrs.append(k_base + int(rng.integers(0, (tok + 1) * 512)))
            writes.append(0)
            t += 1
        # KV append for the new token
        times.append(t)
        addrs.append(k_base + (tok + 1) * 512)
        writes.append(1)
        t += compute_gap
    n = len(times)
    return Trace.from_numpy(
        np.asarray(times, np.int64).astype(np.int32),
        np.asarray(addrs, np.int64) & 0x3FFFFFFF,
        np.asarray(writes, np.int32),
        np.arange(n, dtype=np.int64) & 0x7FFFFFFF,
    )


def dram_words(idx, interleave_log2: int, cxl_frac_log2: int):
    """Word address of the ``idx``-th word of the *DRAM-resident* sequential
    space under block placement (``repro_torch.core.dram_model.tier_select``):
    addresses are split into ``2^interleave_log2``-word blocks and the CXL
    expander owns the all-ones residue of every ``2^cxl_frac_log2`` blocks,
    so a DRAM stream walks the remaining ``2^k - 1`` of each group.
    Vectorized numpy; inverse of the placement decode (every returned
    address satisfies ``tier_select == False``)."""
    idx = np.asarray(idx, np.int64)
    il, k = interleave_log2, cxl_frac_log2
    m = (1 << k) - 1  # DRAM blocks per group
    blk = idx >> il
    off = idx & ((1 << il) - 1)
    phys = (blk // m) * (1 << k) + (blk % m)
    return (phys << il) | off


def cxl_words(idx, interleave_log2: int, cxl_frac_log2: int):
    """Word address of the ``idx``-th word of the *CXL-resident* sequential
    space: the all-ones block residue of every ``2^cxl_frac_log2``-block
    group (``tier_select == True``). Vectorized numpy twin of
    :func:`dram_words`."""
    idx = np.asarray(idx, np.int64)
    il, k = interleave_log2, cxl_frac_log2
    blk = idx >> il
    off = idx & ((1 << il) - 1)
    phys = (blk << k) | ((1 << k) - 1)
    return (phys << il) | off


def tiered_decode_trace(tokens: int = 48, reads_per_token: int = 16,
                        compute_gap: int = 2500, kv_frac: float = 0.5,
                        hot_frac: float = 0.5,
                        interleave_log2: int = 6, cxl_frac_log2: int = 1,
                        seed: int = 0) -> Trace:
    """:func:`decode_serving_trace` with tiered hot/cold KV placement.

    Weights and the *hot* KV window (the most recent tokens — reused every
    decode step) live in DRAM; the *cold* KV tail is demoted to the CXL
    expander. ``hot_frac`` of each token's KV gather hits the hot window.
    Addresses are laid out through :func:`dram_words` / :func:`cxl_words`
    for the given placement flags, so the stream must be simulated with a
    matching ``(tier_interleave_log2, tier_cxl_frac_log2)`` parameter
    point — the capacity-split x interleave sweep of the reference's
    ``perfmodel.effective_bw.cxl_tier_study`` regenerates the trace per
    placement lane."""
    rng = np.random.default_rng(seed)
    w_base, k_base = 0, 1 << 22        # word indices within each tier space
    times, addrs, writes = [], [], []
    t = 0
    n_kv = max(1, int(reads_per_token * kv_frac))
    n_hot = max(1, int(n_kv * hot_frac))
    n_cold = n_kv - n_hot
    n_w = reads_per_token - n_kv
    kv_words_per_tok = 512
    for tok in range(tokens):
        w_start = (tok * n_w) % (1 << 21)
        widx = w_base + w_start + np.arange(n_w)
        for a in dram_words(widx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(0)
            t += 1
        # hot KV: gather over the most recent 4 tokens' appends (DRAM)
        hot_lo = max(0, tok - 3) * kv_words_per_tok
        hot_hi = (tok + 1) * kv_words_per_tok
        hidx = k_base + rng.integers(hot_lo, hot_hi, n_hot)
        for a in dram_words(hidx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(0)
            t += 1
        # cold KV: gather over the demoted tail (CXL)
        cidx = rng.integers(0, hot_hi, n_cold)
        for a in cxl_words(cidx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(0)
            t += 1
        # KV append for the new token lands hot (DRAM)
        times.append(t)
        addrs.append(int(dram_words(k_base + hot_hi, interleave_log2,
                                    cxl_frac_log2)))
        writes.append(1)
        t += compute_gap
    n = len(times)
    return Trace.from_numpy(
        np.asarray(times, np.int64).astype(np.int32),
        np.asarray(addrs, np.int64) & 0x3FFFFFFF,
        np.asarray(writes, np.int32),
        np.arange(n, dtype=np.int64) & 0x7FFFFFFF,
    )


def tiered_prefill_trace(chunks: int = 24, writes_per_chunk: int = 24,
                         reads_per_chunk: int = 8, gap: int = 24,
                         hot_frac: float = 0.5,
                         interleave_log2: int = 6, cxl_frac_log2: int = 1,
                         seed: int = 0) -> Trace:
    """Prefill stream under tiered placement: the KV cache is written
    densely chunk by chunk — ``hot_frac`` of each chunk to DRAM, the rest
    straight to the CXL expander — interleaved with sequential DRAM weight
    reads, at a near-saturating arrival rate (the bandwidth-bound regime,
    vs the WAIT-heavy :func:`tiered_decode_trace`)."""
    w_base, k_base = 0, 1 << 22
    times, addrs, writes = [], [], []
    t = 0
    n_hot = max(1, int(writes_per_chunk * hot_frac))
    n_cold = writes_per_chunk - n_hot
    hot_pos = cold_pos = 0
    for c in range(chunks):
        widx = w_base + c * reads_per_chunk + np.arange(reads_per_chunk)
        for a in dram_words(widx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(0)
            t += 1
        hidx = k_base + hot_pos + np.arange(n_hot)
        hot_pos += n_hot
        for a in dram_words(hidx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(1)
            t += 1
        cidx = k_base + cold_pos + np.arange(n_cold)
        cold_pos += n_cold
        for a in cxl_words(cidx, interleave_log2, cxl_frac_log2):
            times.append(t)
            addrs.append(int(a))
            writes.append(1)
            t += 1
        t += gap
    n = len(times)
    return Trace.from_numpy(
        np.asarray(times, np.int64).astype(np.int32),
        np.asarray(addrs, np.int64) & 0x3FFFFFFF,
        np.asarray(writes, np.int32),
        np.arange(n, dtype=np.int64) & 0x7FFFFFFF,
    )


def thermal_throttle_schedule(total_cycles: int, *,
                              base=None,
                              boost_frac: float = 0.2,
                              sustained_frac: float = 0.4,
                              boost_scale: float = 1.0,
                              sustained_scale: float = 1.25,
                              throttle_scale: float = 1.75,
                              throttle_refresh_scale: int = 2):
    """The canonical decode-serving DVFS/thermal schedule: boost ->
    sustained -> throttled.

    Models the operating-point trajectory LLM serving hardware actually
    lives through: the part starts a request burst at its boost clock
    (``base`` timings, default the paper's Table-1 nominals), drops to a
    sustained point as the power budget bites (latency-class timings
    derated by ``sustained_scale``), then thermally throttles (derated by
    ``throttle_scale``, and the refresh interval divided by
    ``throttle_refresh_scale`` — hot DRAM refreshes more often, the JEDEC
    high-temperature 2x/4x refresh derating).

    Returns a segment-spec list ``[(start_cycle, override_dict), ...]``:
    the form :func:`repro_torch.core.engine.lane_schedule` and the ``sweep_grid``
    ``"schedule"`` grid axis consume. The override values are ABSOLUTE
    cycles derated from ``base`` (a :class:`~repro_torch.core.params.RuntimeParams`
    or config carrying the operating point to scale), so every DVFS-class
    latency field (tRP/tRRDL/tFAW/tRCD*/tCCDL/tWTR/tRTW/tCL/tXS, plus
    tREFI when refresh-derated) is pinned by the schedule in every segment
    — a grid that also sweeps one of THOSE axes must pass the swept value
    via ``base`` instead. Non-derated fields (tRFC, policies, queue
    depths, ...) stay the lane's own and do compose. Segment boundaries
    land at ``boost_frac`` / ``boost_frac + sustained_frac`` of
    ``total_cycles``.
    """
    from repro_torch.core.params import RuntimeParams

    if not 0 < boost_frac < boost_frac + sustained_frac < 1:
        raise ValueError(
            f"fractions must satisfy 0 < boost ({boost_frac}) < boost + "
            f"sustained ({boost_frac + sustained_frac}) < 1")
    if base is None:
        nominal = RuntimeParams()
    elif isinstance(base, RuntimeParams):
        nominal = base
    else:
        nominal = base.runtime()  # MemSimConfig facade
    #: the latency-class parameters an operating-point change re-prices
    _DVFS_FIELDS = ("tRP", "tRRDL", "tFAW", "tRCDRD", "tRCDWR", "tCCDL",
                    "tWTR", "tRTW", "tCL", "tXS")

    def derated(scale: float, refresh_scale: int = 1) -> dict:
        ov = {f: max(1, int(round(int(getattr(nominal, f)) * scale)))
              for f in _DVFS_FIELDS}
        # keep the cross-field invariant under independent rounding
        ov["tFAW"] = max(ov["tFAW"], ov["tRRDL"])
        if refresh_scale != 1:
            ov["tREFI"] = max(int(nominal.tRFC) + 1,
                              int(nominal.tREFI) // refresh_scale)
        return ov

    t1 = max(1, int(total_cycles * boost_frac))
    t2 = max(t1 + 1, int(total_cycles * (boost_frac + sustained_frac)))
    return [
        (0, derated(boost_scale)),
        (t1, derated(sustained_scale)),
        (t2, derated(throttle_scale, throttle_refresh_scale)),
    ]


def decode_step_traffic(name: str, params_bytes_per_device: float,
                        kv_bytes_per_device: float) -> WorkloadTraffic:
    """Single-token decode: read all weight shards once + the full KV/state."""
    return WorkloadTraffic(
        name=name,
        weight_read=params_bytes_per_device,
        act_read=params_bytes_per_device * 0.01,
        act_write=params_bytes_per_device * 0.01,
        kv_read=kv_bytes_per_device,
        kv_write=kv_bytes_per_device * 0.002,
    )


def train_step_traffic(name: str, params_bytes_per_device: float,
                       act_bytes_per_device: float) -> WorkloadTraffic:
    """Training: params fwd+bwd reads, grad writes, act write+read, opt r/w."""
    return WorkloadTraffic(
        name=name,
        weight_read=params_bytes_per_device * 3.0,   # fwd + bwd + optimizer read
        act_read=act_bytes_per_device,
        act_write=act_bytes_per_device + params_bytes_per_device * 2.0,  # acts + grad + opt write
        kv_read=0.0,
        kv_write=0.0,
    )


def prefill_step_traffic(name: str, params_bytes_per_device: float,
                         act_bytes_per_device: float,
                         kv_bytes_per_device: float = 0.0) -> WorkloadTraffic:
    """Prompt prefill: weights read once, activations streamed per layer,
    the KV cache written as it is built (read side negligible)."""
    return WorkloadTraffic(
        name=name,
        weight_read=params_bytes_per_device,
        act_read=act_bytes_per_device * 0.5,
        act_write=act_bytes_per_device,
        kv_read=0.0,
        kv_write=kv_bytes_per_device,
    )
