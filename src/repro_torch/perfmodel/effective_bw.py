"""Memsim-refined memory roofline: effective (not peak) DRAM bandwidth.

PyTorch counterpart of ``repro.perfmodel.effective_bw``: the same public
names, arguments (plus ``device=None``, the CUDA card, raising without
one), row dicts and key order. A behavioural roofline assumes peak DRAM
bandwidth, but bank conflicts, refresh, closed-page overheads and queue
backpressure make *effective* bandwidth workload-dependent. Each study
turns an LLM stream's traffic into a DRAM access trace
(:mod:`repro_torch.traces.llm_workload`), runs the simulator and the ideal
model over it, and reports

    efficiency = ideal_cycles_at_peak / simulated_cycles

On the card the studies run on the port's kernels: :func:`measure` (and
``cxl_tier_study``'s ``bit_check``) runs the per-cycle :func:`simulate`,
one launch of K3's per-cycle persistent form; :func:`grid_study`,
:func:`dvfs_study` and :func:`cxl_tier_study` run every cell as a lane of
ONE lane-batched K3 launch (``timings["launches"] == 1``);
:func:`topo_grid_study` one launch a topology a stream
(:func:`~repro_torch.core.engine.sweep_topologies`); :func:`serving_study`
one lane-batched launch a window. The rows are computed with numpy from
the int32 records, so they equal the reference's exactly.

Grids stream as the reference's do: :func:`grid_study` runs each traffic
stream as its own streaming sweep, and :func:`topo_grid_study` passes the
streaming options to ``sweep_topologies``, each stream checkpointing
under ``checkpoint_dir/stream_<i>_<name>``
(:mod:`repro_torch.core.sweep_stream`: one lane-batched launch a chunk).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    MemSimConfig,
    simulate,
    simulate_batch,
    simulate_ideal,
    stats,
)
from repro_torch.core.engine import (
    _stream_threshold,
    grid_points,
    lane_schedule,
    sweep_grid,
    sweep_topologies,
)
from repro_torch.traces import llm_workload


@dataclasses.dataclass
class EffectiveBW:
    name: str
    requests: int
    bytes_per_request: float
    sim_cycles: int
    ideal_cycles: int
    efficiency: float          # effective/peak bandwidth ratio
    read_latency_mean: float
    refresh_share: float


def _row_from_result(name: str, res, ideal_span: int, bpr: float,
                     horizon: int) -> EffectiveBW:
    done = res.completed
    sim_span = int(res.t_complete[done].max()) if done.any() else horizon
    lat = res.latency[done & (res.is_write == 0)]
    counts = res.counters["cmd_counts"]
    total_cmds = max(int(counts[1:6].sum()), 1)
    return EffectiveBW(
        name=name,
        requests=int(done.sum()),
        bytes_per_request=bpr,
        sim_cycles=sim_span,
        ideal_cycles=ideal_span,
        efficiency=min(1.0, ideal_span / max(sim_span, 1)),
        read_latency_mean=float(lat.mean()) if lat.size else float("nan"),
        refresh_share=float(counts[5]) / total_cmds,
    )


def _ideal_span(cfg: MemSimConfig, trace, device) -> int:
    return int(simulate_ideal(cfg, trace, device=device).t_complete.max())


def _max_t(trace) -> int:
    return int(trace.t.max())


def measure(name: str, traffic: llm_workload.WorkloadTraffic,
            cfg: MemSimConfig = MemSimConfig(),
            target_requests: int = 8000, seed: int = 0,
            device=None) -> EffectiveBW:
    """One stream through the per-cycle :func:`simulate` over its trace
    plus 200 000 cycles, against the ideal model."""
    trace, bpr = llm_workload.synthesize(traffic, target_requests, seed=seed)
    horizon = _max_t(trace) + 200_000
    res = simulate(cfg, trace, num_cycles=horizon, device=device)
    return _row_from_result(name, res, _ideal_span(cfg, trace, device), bpr,
                            horizon)


#: timing fields the ideal open-page reference consumes (it ignores
#: policies and queue depths): the cache key subset for its spans.
_IDEAL_FIELDS = ("tRP", "tRCDRD", "tRCDWR", "tCCDL", "tCL", "tRFC", "tREFI")


def _stream_ckpt_dir(checkpoint_dir: Optional[str], si: int,
                     sname: str) -> Optional[str]:
    """Per-stream checkpoint subdirectory of a grid study (each stream is
    its own streaming sweep with its own manifest and chunks)."""
    if checkpoint_dir is None:
        return None
    return os.path.join(checkpoint_dir, f"stream_{si:02d}_{sname}")


def grid_study(streams: Sequence[Tuple[str, llm_workload.WorkloadTraffic]],
               grid: Mapping[str, Sequence],
               cfg: MemSimConfig = MemSimConfig(),
               target_requests: int = 4000, seed: int = 0,
               tail_cycles: int = 50_000,
               batch_mode: str = "auto",
               stream: Optional[bool] = None,
               chunk_lanes: Optional[int] = None,
               memory_budget_bytes: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               resume: bool = True,
               timings: Optional[dict] = None,
               device=None) -> List[Dict]:
    """Effective bandwidth of every (stream x config) cell, one launch.

    ``streams`` are named traffic splits (decode / prefill / train, see
    :mod:`repro_torch.traces.llm_workload`); ``grid`` is a
    :func:`~repro_torch.core.engine.sweep_grid` axis dict over runtime
    parameters. All ``len(streams) * len(points)`` lanes run as ONE
    :func:`simulate_batch` (one lane-batched K3 launch on the card); the
    ideal reference runs once a stream and timing point. Returns one dict
    per cell: ``{stream, config, name, requests, ..., refresh_share}``.

    Grids stream as the reference's do: with at least
    ``MEMSIM_STREAM_THRESHOLD`` lanes in all, a ``checkpoint_dir`` or
    ``stream=True``, each traffic stream runs as its own streaming
    ``sweep_grid`` (chunked under ``chunk_lanes`` /
    ``memory_budget_bytes``, checkpointed under
    ``checkpoint_dir/stream_<i>_<name>``, resumable after a kill), bit-exact
    per cell vs the one-batch path.
    """
    points = grid_points(grid)
    lane_cfgs = [dataclasses.replace(cfg, **ov)
                 for _ in streams for ov in points]
    traces, bprs = [], []
    for name, traffic in streams:
        tr, bpr = llm_workload.synthesize(traffic, target_requests, seed=seed)
        traces.append(tr)
        bprs.append(bpr)
    horizon = max(_max_t(tr) for tr in traces) + tail_cycles

    if stream is None:
        stream = (checkpoint_dir is not None
                  or len(lane_cfgs) >= _stream_threshold())
    if stream:
        results = []
        for si, (sname, _) in enumerate(streams):
            results.extend(sweep_grid(
                cfg, traces[si], grid, num_cycles=horizon, stream=True,
                chunk_lanes=chunk_lanes,
                memory_budget_bytes=memory_budget_bytes,
                checkpoint_dir=_stream_ckpt_dir(checkpoint_dir, si, sname),
                resume=resume, timings=timings, device=device))
    else:
        cap = max(c.queue_size for c in lane_cfgs)
        rcap = max(c.resp_queue_size for c in lane_cfgs)
        cfg_cap = dataclasses.replace(cfg, queue_size=cap,
                                      resp_queue_size=rcap)
        lane_traces = [traces[si] for si in range(len(streams))
                       for _ in points]
        results = simulate_batch(
            cfg_cap, lane_traces, num_cycles=horizon,
            queue_sizes=[c.queue_size for c in lane_cfgs],
            resp_queue_sizes=[c.resp_queue_size for c in lane_cfgs],
            params=[c.runtime() for c in lane_cfgs], lane_cfgs=lane_cfgs,
            batch_mode=batch_mode, timings=timings, device=device)

    # the ideal reference ignores policies and queue depths, so its span is
    # cached per (stream, timing-relevant parameter subset)
    ideal_spans: Dict[tuple, int] = {}

    def ideal_span_for(si: int, c: MemSimConfig) -> int:
        key = (si,) + tuple(getattr(c, f) for f in _IDEAL_FIELDS)
        if key not in ideal_spans:
            ideal_spans[key] = _ideal_span(c, traces[si], device)
        return ideal_spans[key]

    rows = []
    for (si, (sname, _)), (pi, ov) in itertools.product(
            enumerate(streams), enumerate(points)):
        li = si * len(points) + pi
        bw = _row_from_result(sname, results[li],
                              ideal_span_for(si, lane_cfgs[li]), bprs[si],
                              horizon)
        rows.append({"stream": sname, "config": dict(ov),
                     **dataclasses.asdict(bw)})
    return rows


#: shape fields the ideal open-page reference is also sensitive to on a
#: topology grid; joined with ``_IDEAL_FIELDS`` to key its cached spans.
_IDEAL_TOPO_FIELDS = ("channels", "ranks", "bankgroups", "banks_per_group",
                      "column_bits", "mem_words")


def topo_grid_study(streams: Sequence[Tuple[str, llm_workload.WorkloadTraffic]],
                    grid: Mapping[str, Sequence],
                    cfg: MemSimConfig = MemSimConfig(),
                    target_requests: int = 4000, seed: int = 0,
                    tail_cycles: int = 50_000,
                    stream: Optional[bool] = None,
                    chunk_lanes: Optional[int] = None,
                    memory_budget_bytes: Optional[int] = None,
                    checkpoint_dir: Optional[str] = None,
                    resume: bool = True,
                    timings: Optional[dict] = None,
                    device=None) -> List[Dict]:
    """Effective bandwidth across hardware shapes: every (stream x
    topology x runtime) cell through
    :func:`~repro_torch.core.engine.sweep_topologies`, one sweep a stream
    (one lane-batched K3 launch a topology, the topologies' launches
    overlapped on CUDA streams).

    ``grid`` may mix structural axes (``channels``, ``banks_per_group``,
    ...) with runtime axes. Returns one dict per cell: ``{stream, config,
    num_banks, name, ..., refresh_share}``. The streaming options pass
    straight through to ``sweep_topologies``, each stream checkpointing
    under its own ``checkpoint_dir/stream_<i>_<name>``.
    """
    rows = []
    ideal_spans: Dict[tuple, int] = {}
    for si, (sname, traffic) in enumerate(streams):
        tr, bpr = llm_workload.synthesize(traffic, target_requests,
                                          seed=seed)
        horizon = _max_t(tr) + tail_cycles
        sweep = sweep_topologies(cfg, tr, grid, num_cycles=horizon,
                                 stream=stream, chunk_lanes=chunk_lanes,
                                 memory_budget_bytes=memory_budget_bytes,
                                 checkpoint_dir=_stream_ckpt_dir(
                                     checkpoint_dir, si, sname),
                                 resume=resume, timings=timings,
                                 device=device)
        for point, res in zip(sweep.points, sweep.results):
            c = res.cfg
            key = ((sname,)
                   + tuple(getattr(c, f) for f in _IDEAL_FIELDS)
                   + tuple(getattr(c, f) for f in _IDEAL_TOPO_FIELDS))
            if key not in ideal_spans:
                ideal_spans[key] = _ideal_span(c, tr, device)
            bw = _row_from_result(sname, res, ideal_spans[key], bpr,
                                  horizon)
            rows.append({"stream": sname, "config": dict(point),
                         "num_banks": c.num_banks,
                         **dataclasses.asdict(bw)})
    return rows


def _serving_streams(arch_name: str, params_bytes_per_dev: float,
                     kv_bytes_per_dev: float,
                     act_bytes_per_dev: float) -> list:
    """The decode and prefill streams of one architecture."""
    return [
        ("decode", llm_workload.decode_step_traffic(
            arch_name, params_bytes_per_dev, kv_bytes_per_dev)),
        ("prefill", llm_workload.prefill_step_traffic(
            arch_name, params_bytes_per_dev, act_bytes_per_dev,
            kv_bytes_per_dev * 0.5)),
    ]


def topo_llm_grid_study(arch_name: str, params_bytes_per_dev: float,
                        kv_bytes_per_dev: float, act_bytes_per_dev: float,
                        grid: Mapping[str, Sequence], **kw) -> List[Dict]:
    """Decode + prefill streams of one architecture against a
    hardware-shape grid (:func:`topo_grid_study`)."""
    return topo_grid_study(
        _serving_streams(arch_name, params_bytes_per_dev, kv_bytes_per_dev,
                         act_bytes_per_dev), grid, **kw)


def dvfs_study(streams: Sequence[Tuple[str, llm_workload.WorkloadTraffic]],
               schedules: Optional[Sequence[Tuple[str, object]]] = None,
               cfg: MemSimConfig = MemSimConfig(),
               target_requests: int = 4000, seed: int = 0,
               tail_cycles: int = 50_000,
               batch_mode: str = "auto",
               timings: Optional[dict] = None,
               device=None) -> List[Dict]:
    """Effective bandwidth under time-varying (DVFS / thermal-throttle)
    parameter schedules: every (stream x schedule) cell as a lane of ONE
    :func:`simulate_batch` (one lane-batched K3 launch on the card).

    ``schedules`` are named specs in any
    :func:`~repro_torch.core.engine.lane_schedule` form. When omitted: the
    constant nominal point, and the canonical boost / sustained /
    throttled trajectory at a mild and an aggressive throttle scaled to the
    simulated horizon. Efficiency is against the un-throttled ideal
    reference; each row also carries ``seg_cycle_frac``, the fraction of
    the horizon spent under each operating point.
    """
    traces, bprs = [], []
    for name, traffic in streams:
        tr, bpr = llm_workload.synthesize(traffic, target_requests, seed=seed)
        traces.append(tr)
        bprs.append(bpr)
    horizon = max(_max_t(tr) for tr in traces) + tail_cycles
    if schedules is None:
        schedules = [
            ("nominal", None),
            ("throttle_mild", llm_workload.thermal_throttle_schedule(
                horizon, throttle_scale=1.5)),
            ("throttle_hard", llm_workload.thermal_throttle_schedule(
                horizon, throttle_scale=2.0, throttle_refresh_scale=4)),
        ]

    lane_traces = [traces[si] for si in range(len(streams))
                   for _ in schedules]
    lane_scheds = [lane_schedule(cfg, spec)
                   for _ in streams for _, spec in schedules]
    results = simulate_batch(
        cfg, lane_traces, num_cycles=horizon,
        params=lane_scheds, batch_mode=batch_mode, timings=timings,
        device=device)

    ideal_spans = [_ideal_span(cfg, tr, device) for tr in traces]
    rows = []
    for (si, (sname, _)), (ci, (cname, _)) in itertools.product(
            enumerate(streams), enumerate(schedules)):
        res = results[si * len(schedules) + ci]
        bw = _row_from_result(f"{sname}:{cname}", res, ideal_spans[si],
                              bprs[si], horizon)
        seg = np.asarray(res.counters["seg_cycles"], dtype=np.int64)
        total = float(max(int(seg.sum()), 1))
        rows.append({"stream": sname, "schedule": cname,
                     "seg_cycle_frac": [round(int(c) / total, 4)
                                        for c in seg],
                     **dataclasses.asdict(bw)})
    return rows


def dvfs_llm_study(arch_name: str, params_bytes_per_dev: float,
                   kv_bytes_per_dev: float, act_bytes_per_dev: float,
                   schedules: Optional[Sequence[Tuple[str, object]]] = None,
                   **kw) -> List[Dict]:
    """Decode + prefill streams of one architecture under thermal-throttle
    schedules (:func:`dvfs_study`)."""
    return dvfs_study(
        _serving_streams(arch_name, params_bytes_per_dev, kv_bytes_per_dev,
                         act_bytes_per_dev), schedules, **kw)


def cxl_tier_point(cfg: MemSimConfig, interleave_log2: int,
                   cxl_frac_log2: int, *, latency_adder: int = 30,
                   link_ccd_scale: int = 2, refi_scale: int = 1):
    """One tier-stacked parameter point for a tiered ``cfg``: tier 0 is the
    config's nominal DRAM timing, tier 1 the CXL expander: the nominal
    point plus a link-latency adder on the access path (tCL/tRCDRD/tRCDWR),
    a narrower link modeled as a stretched column-to-column gap
    (tCCDL/tWTR/tRTW x ``link_ccd_scale``), and optionally denser refresh
    (``tREFI / refi_scale``). The placement flags are tier-uniform
    run-time data, so a (capacity split x interleave x timing) grid runs
    as lanes of one launch."""
    from repro_torch.core.params import tiered_params

    dram = cfg.runtime()._replace(tier_interleave_log2=interleave_log2,
                                  tier_cxl_frac_log2=cxl_frac_log2)
    cxl = dram._replace(
        tCL=dram.tCL + latency_adder,
        tRCDRD=dram.tRCDRD + latency_adder,
        tRCDWR=dram.tRCDWR + latency_adder,
        tCCDL=dram.tCCDL * link_ccd_scale,
        tWTR=dram.tWTR * link_ccd_scale,
        tRTW=dram.tRTW * link_ccd_scale,
        tREFI=max(dram.tREFI // max(refi_scale, 1), dram.tRFC + 1),
    )
    return tiered_params(dram, cxl)


def cxl_tier_study(cfg: Optional[MemSimConfig] = None,
                   capacity_splits: Sequence[int] = (1, 2),
                   interleaves: Sequence[int] = (6, 8),
                   *, latency_adder: int = 30, link_ccd_scale: int = 2,
                   tokens: int = 32, chunks: int = 16,
                   tail_cycles: int = 30_000, seed: int = 0,
                   batch_mode: str = "vmap", bit_check: bool = True,
                   timings: Optional[dict] = None,
                   device=None) -> List[Dict]:
    """Tiered-KV placement sweep: decode + prefill effective bandwidth vs
    DRAM:CXL capacity split and interleave ratio, every cell a lane of ONE
    lane-batched K3 launch on the tiered topology
    (``timings["launches"] == 1`` on the card).

    ``capacity_splits`` are ``tier_cxl_frac_log2`` values (the CXL expander
    owns 1 of every ``2^k`` interleave blocks, a DRAM:CXL split of
    ``(2^k - 1):1``); ``interleaves`` are ``tier_interleave_log2`` values.
    Each lane pairs a tier-stacked parameter point (:func:`cxl_tier_point`)
    with a hot/cold-placement trace regenerated for its flags. Efficiency
    is against the untiered nominal-DRAM ideal reference.
    ``bit_check=True`` re-runs every lane through the per-cycle
    :func:`simulate` (K3's per-cycle form on the card) and reports
    field-for-field identity in the row's ``bit_identical``.
    """
    if cfg is None:
        cfg = MemSimConfig(channels=2, tiers=2, cxl_channels=1)
    if cfg.tiers != 2:
        raise ValueError("cxl_tier_study needs a tiered config (tiers=2)")
    points = [(k, il) for k in capacity_splits for il in interleaves]
    streams = [
        ("decode", lambda il, k: llm_workload.tiered_decode_trace(
            tokens=tokens, interleave_log2=il, cxl_frac_log2=k, seed=seed)),
        ("prefill", lambda il, k: llm_workload.tiered_prefill_trace(
            chunks=chunks, interleave_log2=il, cxl_frac_log2=k, seed=seed)),
    ]
    lane_traces, lane_params, lane_meta = [], [], []
    for sname, build in streams:
        for k, il in points:
            lane_traces.append(build(il, k))
            lane_params.append(cxl_tier_point(
                cfg, il, k, latency_adder=latency_adder,
                link_ccd_scale=link_ccd_scale))
            lane_meta.append((sname, k, il))
    horizon = max(_max_t(tr) for tr in lane_traces) + tail_cycles
    results = simulate_batch(cfg, lane_traces, num_cycles=horizon,
                             params=lane_params, batch_mode=batch_mode,
                             timings=timings, device=device)

    # untiered nominal ideal reference: an all-DRAM device at the nominal
    # point over the same request stream
    ideal_cfg = dataclasses.replace(cfg, tiers=1, cxl_channels=0)
    rows = []
    for li, ((sname, k, il), res) in enumerate(zip(lane_meta, results)):
        bw = _row_from_result(f"{sname}:split{(1 << k) - 1}:1:il{il}", res,
                              _ideal_span(ideal_cfg, lane_traces[li],
                                          device),
                              float(llm_workload.BURST_BYTES), horizon)
        row = {"stream": sname, "cxl_frac_log2": k,
               "dram_cxl_split": f"{(1 << k) - 1}:1",
               "interleave_log2": il,
               **dataclasses.asdict(bw)}
        ta = np.asarray(res.counters["tier_active_cycles"], np.int64)
        row["tier_active_cycles"] = [int(v) for v in ta]
        if bit_check:
            ref = simulate(cfg, lane_traces[li], num_cycles=horizon,
                           params=lane_params[li], device=device)
            same = all(
                np.array_equal(getattr(ref, f), getattr(res, f))
                for f in ("t_admit", "t_dispatch", "t_start", "t_complete",
                          "rdata"))
            same = same and all(
                np.array_equal(ref.counters[c], res.counters[c])
                for c in ref.counters)
            row["bit_identical"] = bool(same)
        rows.append(row)
    return rows


def saturation_knee(loads: Sequence[float],
                    tput: Sequence[float], *,
                    efficiency: float = 0.7) -> Optional[float]:
    """The saturation knee of a tokens/sec-vs-offered-load curve: the first
    load whose throughput gain falls below ``efficiency`` of the offered
    gain. ``None`` when the curve still scales at its last point, and on
    curve segments that carry no evidence: non-finite throughput, or a
    curve at zero (a 0 -> 0 step is not a knee)."""
    for i in range(1, len(loads)):
        prev, cur = float(tput[i - 1]), float(tput[i])
        if not (np.isfinite(prev) and np.isfinite(cur)) or prev <= 0:
            continue
        load_gain = loads[i] / max(loads[i - 1], 1e-9)
        tput_gain = cur / prev
        if tput_gain < efficiency * load_gain:
            return float(loads[i])
    return None


def serving_row(tname: str, mix: str, load: float, res) -> Dict:
    """One serving-study row off a :class:`repro_torch.serving.ServingResult`.
    Empty completion sets (zero windows planned or zero requests finished)
    give NaN instead of raising on ``mean``/``min`` of nothing."""
    ab = np.asarray(res.admitted_batch, np.float64)
    bt = np.asarray(res.batch_target, np.float64)
    return {
        "topology": tname, "mixture": mix,
        "offered_load_per_kcycle": float(load),
        "offered": res.offered, "completed": res.completed,
        "tokens": res.tokens, "cycles": res.cycles,
        "tokens_per_kcycle": res.tokens_per_kcycle,
        "admitted_batch_mean": (float(ab.mean()) if ab.size
                                else float("nan")),
        "admitted_batch_min": (int(ab.min()) if ab.size else 0),
        "batch_target_mean": (float(bt.mean()) if bt.size
                              else float("nan")),
        "queueing": stats.latency_percentiles(res.queueing),
        "service": stats.latency_percentiles(res.service),
    }


def serving_capacity(request_lists, serving) -> int:
    """The serving study's session capacity: the most arrivals any
    scenario can emit, plus 64, rounded up to a power of two (``serving``
    a ``ServingConfig``), so every run of one topology shares one
    capacity."""

    def emissions(reqs):
        return sum((-(-r.prompt_tokens // serving.prefill_tokens_per_step))
                   * serving.weight_reads_per_token
                   + r.prompt_tokens * 32
                   + r.decode_tokens * (serving.weight_reads_per_token
                                        + serving.kv_reads_per_token + 32)
                   for r in reqs)

    need = max((emissions(r) for r in request_lists), default=1) + 64
    return 1 << max(need - 1, 1).bit_length()


def serving_study(loads: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
                  mixtures: Sequence[str] = ("chat",),
                  topologies=None, *, process: str = "poisson",
                  horizon: int = 10_000, window_cycles: int = 400,
                  serving=None, seed: int = 0, batch_lanes: bool = True,
                  timings: Optional[dict] = None,
                  device=None) -> List[Dict]:
    """Closed-loop serving sweep: offered load x length mixture x topology.

    The continuous-batching scheduler emits each window's traffic from
    what the memory system completed in the previous window, so
    tokens/sec saturates (the knee :func:`saturation_knee` finds) and the
    admitted batch shrinks under memory backpressure.

    With ``batch_lanes`` (the default) each topology runs its whole load x
    mixture grid as lanes of ONE
    :func:`repro_torch.serving.run_serving_batched` (one lane-batched K3
    launch a window on the card); the rows equal the sequential
    (``batch_lanes=False``) path's. ``topologies`` is ``[(name, cfg,
    params-or-None), ...]``; the default pairs a 2-channel DRAM device with
    a CXL-heavy tiered device (:func:`cxl_tier_point` with a deep link
    penalty). The session capacity is fixed study-wide
    (:func:`serving_capacity`).

    Rows carry tokens/kilocycle, admitted-batch statistics and
    request-level p50/p95/p99 queueing and service percentiles.
    """
    from repro_torch.serving import (ServingConfig, generate_request_batch,
                                     run_serving, run_serving_batched)

    serving = serving or ServingConfig()
    if topologies is None:
        cxl_cfg = MemSimConfig(channels=2, tiers=2, cxl_channels=1)
        topologies = [
            ("dram", MemSimConfig(channels=2), None),
            ("cxl", cxl_cfg,
             cxl_tier_point(cxl_cfg, cxl_cfg.tier_interleave_log2,
                            cxl_cfg.tier_cxl_frac_log2, latency_adder=200,
                            link_ccd_scale=8)),
        ]

    # every lane reuses the study seed verbatim, so a batched and a
    # sequential run of the same study feed identical scenarios
    keys = [(mix, load) for mix in mixtures for load in loads]
    scenarios = dict(zip(keys, generate_request_batch(
        [dict(process=process, mixture=mix, rate_per_kcycle=load,
              horizon=horizon) for mix, load in keys],
        seed=seed, independent_streams=False)))
    capacity = serving_capacity(scenarios.values(), serving)

    rows = []
    for tname, cfg, params in topologies:
        if batch_lanes:
            res_by_key = dict(zip(keys, run_serving_batched(
                cfg, [scenarios[k] for k in keys], serving, params=params,
                window_cycles=window_cycles, capacity=capacity,
                timings=timings, seed=seed, device=device)))
        else:
            res_by_key = {k: run_serving(
                cfg, scenarios[k], serving, params=params,
                window_cycles=window_cycles, capacity=capacity,
                timings=timings, seed=seed, device=device) for k in keys}
        for mix in mixtures:
            curve = [serving_row(tname, mix, load, res_by_key[(mix, load)])
                     for load in loads]
            knee = saturation_knee([r["offered_load_per_kcycle"]
                                    for r in curve],
                                   [r["tokens_per_kcycle"] for r in curve])
            for r in curve:
                r["knee_load"] = knee
            rows.extend(curve)
    return rows


def llm_grid_study(arch_name: str, params_bytes_per_dev: float,
                   kv_bytes_per_dev: float, act_bytes_per_dev: float,
                   grid: Mapping[str, Sequence], **kw) -> List[Dict]:
    """Decode + prefill + train streams of one architecture through a
    runtime-parameter grid (:func:`grid_study`)."""
    streams = _serving_streams(arch_name, params_bytes_per_dev,
                               kv_bytes_per_dev, act_bytes_per_dev) + [
        ("train", llm_workload.train_step_traffic(
            arch_name, params_bytes_per_dev, act_bytes_per_dev)),
    ]
    return grid_study(streams, grid, **kw)


def decode_efficiency(arch_name: str, params_bytes_per_dev: float,
                      kv_bytes_per_dev: float, **kw) -> EffectiveBW:
    tr = llm_workload.decode_step_traffic(arch_name, params_bytes_per_dev,
                                          kv_bytes_per_dev)
    return measure(arch_name + ":decode", tr, **kw)


def train_efficiency(arch_name: str, params_bytes_per_dev: float,
                     act_bytes_per_dev: float, **kw) -> EffectiveBW:
    tr = llm_workload.train_step_traffic(arch_name, params_bytes_per_dev,
                                         act_bytes_per_dev)
    return measure(arch_name + ":train", tr, **kw)
