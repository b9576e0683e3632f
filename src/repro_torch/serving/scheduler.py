"""Continuous-batching scheduler + the closed-loop serving driver.

One scheduler instance drives one :class:`repro_torch.core.SimSession` window by
window (:func:`run_serving`):

1. **Admission / join-at-sequence-boundary** — arrived requests wait in an
   admission queue; they join the running batch only when a slot exists
   (a sequence finished, or the batch is below the admitted-batch target)
   AND the KV pager has blocks for their prompt. Nothing preempts a
   running sequence mid-stream.
2. **Prefill/decode interleave** — each running sequence emits its next
   step's memory traffic only after its previous step's requests all
   completed (the memory system's latency throttles its token rate — the
   co-simulation coupling). Prefill steps write prompt-KV chunks alongside
   weight reads; decode steps read weights, gather KV through the pager
   and append the new token's KV.
3. **Memory backpressure (AIMD)** — the admitted-batch target halves when
   the closing window shows memory pressure: sequences *persistently
   stalled* (they emitted nothing all window because their previous step
   was still in the memory system, and it STILL is at window end — i.e. a
   step outlived a full window) above the stall high-water, reqQueue
   occupancy above its high-water, or new front-end stall cycles
   (``blocked_arrival`` growth); it creeps up by one otherwise. A slower
   memory system (e.g. a CXL-heavy topology) therefore *measurably
   shrinks the admitted batch* — the closed loop the open-loop traces
   cannot express.

The emitted per-window address stream is capped at one request per cycle
(the front-end's own admission bandwidth), steps interleaved round-robin
across sequences — the same shape ``traces/llm_workload.decode_serving_trace``
gives the open-loop regime.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.session import SimSession, WindowReport
from repro_torch.core.session_batch import SessionBatch, _per_lane
from repro_torch.serving.kv_pager import KVPager
from repro_torch.serving.workload import Request
from repro_torch.traces.llm_workload import dram_words


@dataclasses.dataclass
class ServingConfig:
    """Scheduler knobs (memory-side; model shapes are abstracted into
    reads/writes per token)."""

    max_batch: int = 8                 # admitted-batch hard cap
    weight_reads_per_token: int = 8    # sequential weight-shard reads/step
    kv_reads_per_token: int = 4        # KV gather reads per decode step
    prefill_tokens_per_step: int = 8   # prompt tokens written per prefill step
    occupancy_high: float = 0.5        # reqQueue high-water fraction (AIMD)
    stall_high: float = 0.34           # stalled-sequence fraction high-water
    additive_increase: float = 1.0
    multiplicative_decrease: float = 0.5


@dataclasses.dataclass
class _SeqState:
    req: Request
    joined: int
    phase: str = "prefill"             # "prefill" -> "decode"
    prefill_done: int = 0
    decode_done: int = 0
    outstanding: Set[int] = dataclasses.field(default_factory=set)
    last_complete: int = -1
    first_token: int = -1
    done_at: int = -1


@dataclasses.dataclass
class ServingResult:
    """Closed-loop run summary; per-request latencies are *request-level*
    (arrival -> join queueing, join -> last token service), distinct from
    the per-DRAM-request records inside ``session.result()``."""

    offered: int
    completed: int
    tokens: int
    cycles: int
    admitted_batch: List[int]          # running-batch size per window
    batch_target: List[float]          # AIMD target per window
    queueing: np.ndarray               # per completed request, cycles
    service: np.ndarray
    session: object                    # SimSession, or a SessionLane view
                                       # when the run came from the
                                       # lane-batched path

    @property
    def tokens_per_kcycle(self) -> float:
        return 1000.0 * self.tokens / max(self.cycles, 1)


class ContinuousBatchScheduler:
    """See the module docstring. ``queue_limit`` is the simulated
    reqQueue's runtime depth (the AIMD high-water reference)."""

    def __init__(self, cfg: ServingConfig, pager: KVPager,
                 requests: List[Request], queue_limit: int, seed: int = 0):
        self.cfg = cfg
        self.pager = pager
        self.queue_limit = max(int(queue_limit), 1)
        self.waiting = deque(sorted(requests, key=lambda r: r.arrival))
        self.running: Dict[int, _SeqState] = {}
        self.target = float(cfg.max_batch)
        self.admitted_batch: List[int] = []
        self.batch_target: List[float] = []
        self.finished: List[_SeqState] = []
        self.tokens = 0
        self._rng = np.random.default_rng(seed)
        self._owner: Dict[int, int] = {}   # trace slot -> rid
        self._next_slot = 0
        self._wcursor = 0                  # sequential weight-stream cursor
        self._blocked_seen = 0
        self._waited: Set[int] = set()  # rids that emitted nothing all window
        self._tiered = pager.tiered

    # ---- emission ----------------------------------------------------------

    def _weight_addrs(self, n: int) -> List[int]:
        idx = (self._wcursor + np.arange(n)) % (1 << 21)
        self._wcursor += n
        if self._tiered:  # weights always stay DRAM-resident
            idx = dram_words(idx, self.pager.interleave_log2,
                             self.pager.cxl_frac_log2)
        return [int(a) & 0x3FFFFFFF for a in idx]

    def _step_requests(self, s: _SeqState):
        """(addr, is_write) list of the sequence's next step, advancing its
        phase bookkeeping. The step is emitted atomically or not at all."""
        c = self.cfg
        reqs = []
        if s.phase == "prefill":
            tokens = min(c.prefill_tokens_per_step,
                         s.req.prompt_tokens - s.prefill_done)
            for a in self._weight_addrs(c.weight_reads_per_token):
                reqs.append((a, 0))
            for a in self.pager.append_addrs(s.req.rid, tokens):
                reqs.append((a, 1))
            s.prefill_done += tokens
            if s.prefill_done >= s.req.prompt_tokens:
                s.phase = "decode"
        else:
            for a in self._weight_addrs(c.weight_reads_per_token):
                reqs.append((a, 0))
            for a in self.pager.gather_addrs(s.req.rid, c.kv_reads_per_token,
                                             self._rng):
                reqs.append((a, 0))
            for a in self.pager.append_addrs(s.req.rid, 1):
                reqs.append((a, 1))
        return reqs

    def plan_window(self, t0: int, t1: int):
        """Admissions + one step per ready sequence, as (t, addr, is_write)
        arrival arrays inside ``[t0, t1)`` — or ``None`` when the window
        emits nothing. Feed the result to ``session.advance``."""
        # join at sequence boundaries: open slots only (nothing preempts)
        while (self.waiting and self.waiting[0].arrival <= t0
               and len(self.running) < min(int(self.target),
                                           self.cfg.max_batch)
               and self.pager.can_admit(self.waiting[0].prompt_tokens)):
            req = self.waiting.popleft()
            self.pager.admit(req.rid)
            self.running[req.rid] = _SeqState(req=req, joined=t0)

        budget = t1 - t0
        streams = []
        self._waited = set()
        for s in self.running.values():
            if s.outstanding:
                # previous step still in the memory system: if it is STILL
                # there when this window closes, the step outlived a full
                # window — the persistent-stall backpressure signal
                self._waited.add(s.req.rid)
                continue
            need = (self.cfg.weight_reads_per_token
                    + (self.cfg.kv_reads_per_token + self.pager.words_per_token
                       if s.phase == "decode"
                       else min(self.cfg.prefill_tokens_per_step,
                                s.req.prompt_tokens - s.prefill_done)
                       * self.pager.words_per_token))
            if need > budget:
                continue  # deferred: front-end bandwidth exhausted
            budget -= need
            streams.append((s, self._step_requests(s)))

        self.admitted_batch.append(len(self.running))
        self.batch_target.append(self.target)
        if not streams:
            return None

        # round-robin interleave across sequences, one request per cycle
        ts, addrs, writes = [], [], []
        t = t0
        queues = deque((s, deque(reqs)) for s, reqs in streams)
        while queues:
            s, q = queues.popleft()
            a, w = q.popleft()
            slot = self._next_slot
            self._next_slot += 1
            self._owner[slot] = s.req.rid
            s.outstanding.add(slot)
            ts.append(t)
            addrs.append(a)
            writes.append(w)
            t += 1
            if q:
                queues.append((s, q))
        return (np.asarray(ts, np.int64), np.asarray(addrs, np.int64),
                np.asarray(writes, np.int64))

    # ---- feedback ----------------------------------------------------------

    def observe(self, report: WindowReport) -> None:
        """Fold one window's completions and occupancy back into the
        batch: finished steps unblock their sequences, finished sequences
        leave (freeing their KV blocks), and the AIMD target reacts to
        memory backpressure."""
        for slot, at in zip(report.completed_ids, report.completed_at):
            rid = self._owner.pop(int(slot))
            s = self.running.get(rid)
            if s is None:
                continue
            s.outstanding.discard(int(slot))
            s.last_complete = max(s.last_complete, int(at))
            if not s.outstanding:
                if s.phase == "decode":
                    s.decode_done += 1
                    self.tokens += 1
                    if s.first_token < 0:
                        s.first_token = s.last_complete
                    if s.decode_done >= s.req.decode_tokens:
                        s.done_at = s.last_complete
                        self.pager.free_seq(rid)
                        self.finished.append(self.running.pop(rid))

        blocked_new = report.blocked_arrival - self._blocked_seen
        self._blocked_seen = report.blocked_arrival
        stalled = sum(1 for rid in self._waited
                      if rid in self.running and self.running[rid].outstanding)
        pressured = (stalled > self.cfg.stall_high
                     * max(len(self.running), 1)
                     or report.req_q_len > self.cfg.occupancy_high
                     * self.queue_limit
                     or blocked_new > 0)
        if pressured:
            self.target = max(1.0,
                              self.target * self.cfg.multiplicative_decrease)
        else:
            self.target = min(float(self.cfg.max_batch),
                              self.target + self.cfg.additive_increase)

    def idle(self) -> bool:
        return not self.running and not self.waiting


def run_serving(cfg, requests: List[Request],
                serving: Optional[ServingConfig] = None, *,
                params=None, pager: Optional[KVPager] = None,
                window_cycles: int = 2000, capacity: int = 8192,
                max_cycles: Optional[int] = None,
                timings: Optional[dict] = None, seed: int = 0,
                device=None) -> ServingResult:
    """The closed loop: scheduler -> addresses -> session -> completions ->
    scheduler, until every request drains (or ``max_cycles``).

    ``cfg`` is the memory device (:class:`repro_torch.core.MemSimConfig`);
    ``params`` an optional RuntimeParams/ParamSchedule override (e.g. a
    CXL tier stack from ``perfmodel.effective_bw.cxl_tier_point``). The
    pager defaults to tier-aware placement whenever ``cfg.tiers > 1``,
    with the placement flags read off the config. ``timings`` (shareable
    across calls) accumulates the session's ``compile_s``, ``run_s``,
    ``windows``, ``launches`` and ``captures`` (see
    :meth:`repro_torch.core.SimSession.open`). ``device=None`` runs the
    session on the CUDA card and raises without one; on the card a window
    is one persistent K3 launch (fused backend).
    """
    serving = serving or ServingConfig()
    if pager is None:
        pager = KVPager(tiered=cfg.tiers > 1,
                        interleave_log2=cfg.tier_interleave_log2,
                        cxl_frac_log2=cfg.tier_cxl_frac_log2)
    session = SimSession.open(cfg, capacity=capacity, params=params,
                              timings=timings, device=device)
    sched = ContinuousBatchScheduler(serving, pager, requests,
                                     queue_limit=cfg.queue_size, seed=seed)
    last_arrival = max((r.arrival for r in requests), default=0)
    if max_cycles is None:
        max_cycles = last_arrival + 400 * window_cycles
    while session.cycle < max_cycles:
        if sched.idle() and session.cycle > last_arrival:
            break
        t0 = session.cycle
        arrivals = sched.plan_window(t0, t0 + window_cycles)
        report = session.advance(window_cycles, arrivals)
        sched.observe(report)

    done = [s for s in sched.finished if s.done_at >= 0]
    return ServingResult(
        offered=len(requests),
        completed=len(done),
        tokens=sched.tokens,
        cycles=session.cycle,
        admitted_batch=sched.admitted_batch,
        batch_target=sched.batch_target,
        queueing=np.asarray([s.joined - s.req.arrival for s in done],
                            np.int64),
        service=np.asarray([s.done_at - s.joined for s in done], np.int64),
        session=session,
    )


# --------------------------------------------------------------------------
# the lane-batched closed loop
# --------------------------------------------------------------------------

def plan_window_batch(scheds: List[ContinuousBatchScheduler], t0: int,
                      t1: int, active: Optional[List[bool]] = None):
    """One ``plan_window`` per *live* lane — the per-lane arrival payload
    list :meth:`repro_torch.core.SessionBatch.advance` takes (drained lanes get
    ``None`` and emit nothing, exactly like their sequential run after its
    loop exited)."""
    if active is None:
        active = [True] * len(scheds)
    return [s.plan_window(t0, t1) if live else None
            for s, live in zip(scheds, active)]


def observe_batch(scheds: List[ContinuousBatchScheduler],
                  reports: List[WindowReport],
                  active: Optional[List[bool]] = None) -> None:
    """Fold one batched window's per-lane reports back into each live
    lane's scheduler. The reports all come from a SINGLE copy to the host
    inside ``SessionBatch.advance`` — one host transfer per window for the
    whole grid, not one per lane per field."""
    if active is None:
        active = [True] * len(scheds)
    for s, rep, live in zip(scheds, reports, active):
        if live:
            s.observe(rep)


def run_serving_batched(cfg, request_lists: List[List[Request]],
                        serving: Optional[ServingConfig] = None, *,
                        params=None, pagers: Optional[List[KVPager]] = None,
                        window_cycles: int = 2000, capacity: int = 8192,
                        max_cycles: Optional[int] = None,
                        batch_mode: str = "auto",
                        timings: Optional[dict] = None, seed: int = 0,
                        seeds: Optional[List[int]] = None,
                        device=None) -> List[ServingResult]:
    """L closed loops on ONE windowed program: lane ``i`` serves
    ``request_lists[i]`` through its own scheduler/pager while all lanes'
    device states advance as a :class:`repro_torch.core.SessionBatch`.

    Per-lane results are bit-identical to L separate :func:`run_serving`
    calls with the same arguments: each lane's scheduler sees exactly the
    reports its sequential run would (the batched engine is bit-exact per
    lane), and a lane whose sequential loop would have exited — drained
    and past its last arrival, or at ``max_cycles`` — stops planning and
    observing at that same cycle (recorded as its ``cycles``), riding
    inert while slower lanes finish. All lanes share ``cfg``, ``capacity``
    and ``window_cycles`` (heterogeneous capacities need the sequential
    path); ``params``/``seeds`` may vary per lane. ``batch_mode`` takes
    the reference's values; every mode runs independent lanes (see
    :class:`repro_torch.core.SessionBatch`). ``timings`` accumulates the
    batch's ``compile_s``, ``run_s``, ``windows``, ``launches`` and
    ``captures``. ``device=None`` runs on the CUDA card and raises
    without one; on the card a window of every lane is one launch of the
    lane-batched K3 (fused backend).
    """
    serving = serving or ServingConfig()
    lanes = len(request_lists)
    if lanes < 1:
        raise ValueError("request_lists must name at least one lane")
    if pagers is None:
        pagers = [KVPager(tiered=cfg.tiers > 1,
                          interleave_log2=cfg.tier_interleave_log2,
                          cxl_frac_log2=cfg.tier_cxl_frac_log2)
                  for _ in range(lanes)]
    elif len(pagers) != lanes:
        raise ValueError(f"{len(pagers)} pagers for {lanes} lanes")
    lane_seeds = _per_lane(seed if seeds is None else seeds, lanes, "seeds")
    batch = SessionBatch.open(cfg, lanes, capacity=capacity, params=params,
                              batch_mode=batch_mode, timings=timings,
                              device=device)
    scheds = [ContinuousBatchScheduler(serving, pagers[i], request_lists[i],
                                       queue_limit=cfg.queue_size,
                                       seed=lane_seeds[i])
              for i in range(lanes)]
    last_arrival = [max((r.arrival for r in reqs), default=0)
                    for reqs in request_lists]
    lane_max = [(la + 400 * window_cycles if max_cycles is None
                 else max_cycles) for la in last_arrival]
    done_cycle: List[Optional[int]] = [None] * lanes
    while True:
        t0 = batch.cycle
        for i in range(lanes):
            if done_cycle[i] is None and (
                    t0 >= lane_max[i]
                    or (scheds[i].idle() and t0 > last_arrival[i])):
                done_cycle[i] = t0
        active = [d is None for d in done_cycle]
        if not any(active):
            break
        arrivals = plan_window_batch(scheds, t0, t0 + window_cycles, active)
        reports = batch.advance(window_cycles, arrivals)
        observe_batch(scheds, reports, active)

    results = []
    for i in range(lanes):
        done = [s for s in scheds[i].finished if s.done_at >= 0]
        results.append(ServingResult(
            offered=len(request_lists[i]),
            completed=len(done),
            tokens=scheds[i].tokens,
            cycles=done_cycle[i],
            admitted_batch=scheds[i].admitted_batch,
            batch_target=scheds[i].batch_target,
            queueing=np.asarray([s.joined - s.req.arrival for s in done],
                                np.int64),
            service=np.asarray([s.done_at - s.joined for s in done],
                               np.int64),
            session=batch.lane_view(i, done_cycle[i]),
        ))
    return results
