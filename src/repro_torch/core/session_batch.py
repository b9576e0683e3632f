"""Lane-batched re-entrant sessions: L closed-loop sessions advancing in
lock-step windows, the PyTorch counterpart of
``repro.core.session_batch``.

:class:`SessionBatch` is the many-session twin of
:class:`repro_torch.core.session.SimSession`:

* Each lane holds its own ``SimState`` (queues, banks, memory image,
  counters), arrival buffer and schedule, on the device between windows.
  The states stay separate (as ``simulate_batch``'s lanes do); the arrival
  buffers are rows of one device tensor allocated at :meth:`open`, and
  appends reach it in one in-place copy a window.
* One :meth:`advance` call advances every lane through the window and
  returns one :class:`~repro_torch.core.session.WindowReport` a lane,
  built from ONE copy to the host of every lane's report fields.
* On the fused backend a window of every lane is one launch of the
  lane-batched persistent K3 on the card (one CTA a lane, each lane its
  own clock and event horizon; :func:`repro_torch.core.engine.
  run_window_batch`), its plain version on the CPU. The ``split`` and
  ``plain`` backends run the lanes one after another, each with its own
  CUDA graphs kept across windows.

``batch_mode`` takes the reference's values (``"auto"``, ``"vmap"``,
``"lanes"``), and every mode runs independent lanes: the reference's
``"lanes"`` semantics. So ``WindowReport.steps`` is each lane's own count
in every mode; the reference's ``"vmap"`` mode reports its shared clock's
count for every lane instead. Every other report field and every result
is identical in all modes.

Exactness contract (``tests/test_torch_session.py``, all three backends):
lane ``i`` of a batch fed some arrival stream is bit-identical — records,
counters, blocked totals and every window report — to a standalone
``SimSession`` replaying the same stream through the same window
partition.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import graphs as graphs_lib
from repro_torch.core.engine import _lane_views, _sched_i32, \
    run_window_batch
from repro_torch.core.params import MemSimConfig, ParamSchedule, \
    RuntimeParams
from repro_torch.core.session import (
    WindowReport, _add_timings, _ArrivalBuffers, _checked_limit, _reports,
    _state_result, report_fetch)
from repro_torch.core.simulator import SimResult, Trace, init_state, \
    resolve_device
from repro_torch.kernels import build


def _per_lane(value, lanes: int, what: str) -> list:
    """Broadcast a scalar-or-sequence option to a per-lane list. A
    RuntimeParams/ParamSchedule is a NamedTuple, so the single-value case
    is detected by type, not by iterability."""
    if isinstance(value, (list, tuple)) and not isinstance(
            value, (RuntimeParams, ParamSchedule)):
        if len(value) != lanes:
            raise ValueError(
                f"per-lane {what} has {len(value)} entries for {lanes} lanes")
        return list(value)
    return [value] * lanes


class SessionBatch:
    """L re-entrant windowed sessions advancing in lock-step windows.

    Use :meth:`open`. All lanes share the topology, the arrival-buffer
    ``capacity`` and the window clock; schedules, queue limits and arrival
    streams are per lane. See the module docstring for the exactness
    contract.
    """

    def __init__(self, cfg: MemSimConfig, lanes: int, capacity: int,
                 views, states, timings: Dict, batch_mode: str = "auto"):
        self.cfg = cfg
        self.topo = cfg.topology()
        self.lanes = int(lanes)
        self.capacity = int(capacity)
        self.batch_mode = "lanes" if batch_mode == "auto" else batch_mode
        self.device = states[0].mem.device
        self._views = views
        self._states = states
        self.timings = timings
        self._buf = _ArrivalBuffers(self.lanes, capacity, self.device)
        self._graphs = ([graphs_lib.graphs_for(st) for st in states]
                        if self.topo.fsm_backend != "fused" else None)
        self._cycle = 0

    # ---- construction -----------------------------------------------------

    @classmethod
    def open(cls, cfg: MemSimConfig, lanes: int, *, capacity: int = 4096,
             params=None, queue_size=None, resp_queue_size=None,
             batch_mode: str = "auto",
             timings: Optional[Dict] = None, device=None) -> "SessionBatch":
        """Open ``lanes`` sessions on ``cfg``'s topology.

        ``params`` is a single RuntimeParams/ParamSchedule applied to all
        lanes, or a per-lane sequence (entries may be ``None`` for the
        config default; heterogeneous segment counts pad to the common
        count). ``queue_size`` / ``resp_queue_size`` likewise broadcast or
        go per lane. ``capacity`` is shared by every lane. ``batch_mode``
        is ``"vmap"``, ``"lanes"`` or ``"auto"``; each runs independent
        lanes (see the module docstring). ``timings`` accumulates
        ``compile_s``, ``run_s``, ``windows``, ``launches`` (lane-batched
        K3 launches) and ``captures`` (CUDA graphs, ``split``/``plain`` on
        the card). ``device=None`` runs on the CUDA card and raises
        without one.
        """
        dev = resolve_device(device)
        cfg.validate()
        if lanes < 1:
            raise ValueError(f"lanes={lanes} must be >= 1")
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if batch_mode not in ("auto", "vmap", "lanes"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        topo = cfg.topology()
        scheds = [_sched_i32(cfg.runtime() if p is None else p)
                  for p in _per_lane(params, lanes, "params")]
        s_max = max(sc.num_segments for sc in scheds)
        scheds = [sc.pad_to(s_max) for sc in scheds]
        qls = [_checked_limit(q, cfg.queue_size, "queue_size")
               for q in _per_lane(queue_size, lanes, "queue_size")]
        rls = [_checked_limit(r, cfg.resp_queue_size, "resp_queue_size")
               for r in _per_lane(resp_queue_size, lanes, "resp_queue_size")]
        timings = {} if timings is None else timings
        t0 = time.perf_counter()
        if dev.type == "cuda" and topo.fsm_backend != "plain":
            build.load()
        _add_timings(timings, compile_s=time.perf_counter() - t0)
        views = _lane_views(topo, scheds, dev)
        states = [init_state(topo, v, capacity, q, r, device=dev)
                  for v, q, r in zip(views, qls, rls)]
        return cls(cfg, lanes, capacity, views, states, timings, batch_mode)

    # ---- arrivals ----------------------------------------------------------

    @property
    def cycle(self) -> int:
        """The shared batch clock: every lane has simulated every cycle
        below it."""
        return self._cycle

    def arrivals_total(self, lane: int) -> int:
        return self._buf.filled[lane]

    def append(self, lane: int, new_arrivals) -> int:
        """Append arrivals to one lane's realized trace; returns the index
        of the first appended slot. Same sortedness/sentinel/capacity
        contract as :meth:`SimSession.append`, enforced per lane."""
        if not (0 <= lane < self.lanes):
            raise ValueError(f"lane={lane} not in [0, {self.lanes})")
        return self._buf.append(lane, new_arrivals, batched=True)

    def trace(self, lane: int) -> Trace:
        """Lane ``lane``'s realized arrival stream so far (filled slots, on
        the CPU)."""
        return self._buf.trace(lane)

    # ---- the windowed run --------------------------------------------------

    def advance(self, window_cycles: int,
                new_arrivals: Optional[Sequence] = None
                ) -> List[WindowReport]:
        """Simulate ``[cycle, cycle + window_cycles)`` on every lane and
        report back per lane.

        ``new_arrivals`` (optional) is a length-``lanes`` sequence of
        per-lane payloads (entries may be ``None``) appended before the
        window runs. One lane-batched K3 launch advances every lane on the
        card (fused backend); ONE copy fetches every lane's report fields.
        """
        if window_cycles < 0:
            raise ValueError(f"window_cycles={window_cycles} must be >= 0")
        if new_arrivals is not None:
            if len(new_arrivals) != self.lanes:
                raise ValueError(
                    f"new_arrivals has {len(new_arrivals)} entries for "
                    f"{self.lanes} lanes")
            for lane, payload in enumerate(new_arrivals):
                if payload is not None:
                    self.append(lane, payload)
        t0 = self._cycle
        t1 = t0 + int(window_cycles)
        steps = [0] * self.lanes
        if t1 > t0:
            self._buf.flush()
            g0 = self._captures()
            ts = time.perf_counter()
            steps, launches = run_window_batch(
                self.topo, self._views, self._buf.traces, self._states, t0,
                t1, self._graphs)
            _add_timings(self.timings, run_s=time.perf_counter() - ts,
                         windows=1, launches=launches,
                         captures=self._captures() - g0)
            self._cycle = t1
        filled = self._buf.filled
        packed = torch.cat([x for st, n in zip(self._states, filled)
                            for x in report_fetch(st, n)]).cpu().numpy()
        return _reports(t0, t1, filled, steps, packed)

    def _captures(self) -> int:
        return sum(g.captures for g in self._graphs if g is not None) \
            if self._graphs else 0

    def run_until(self, t_end: int,
                  window_cycles: int) -> List[List[WindowReport]]:
        """Advance in fixed windows until the clock reaches ``t_end``;
        returns one report list per window."""
        reports = []
        while self._cycle < t_end:
            w = min(window_cycles, t_end - self._cycle)
            reports.append(self.advance(w))
        return reports

    # ---- results -----------------------------------------------------------

    def lane_result(self, lane: int,
                    num_cycles: Optional[int] = None) -> SimResult:
        """Lane ``lane``'s host-side result bundle — bit-identical to a
        standalone :meth:`SimSession.result` over the same arrivals and
        the same final clock. ``num_cycles`` relabels the cycle count for
        lanes that went idle before the batch clock stopped (the state
        past that point is inert for them)."""
        return _state_result(
            self.cfg, self._states[lane], self._buf.trace(lane),
            self._cycle if num_cycles is None else int(num_cycles))

    def results(self) -> List[SimResult]:
        return [self.lane_result(i) for i in range(self.lanes)]

    def lane_view(self, lane: int, cycle: Optional[int] = None
                  ) -> "SessionLane":
        return SessionLane(self, lane, self._cycle if cycle is None
                           else int(cycle))


class SessionLane:
    """Read-only single-lane view over a :class:`SessionBatch` with the
    same surface downstream consumers read off a ``SimSession`` —
    ``trace()``, ``result()``, ``cycle``, ``arrivals_total`` — so e.g.
    :func:`repro_torch.traces.io.save_session_trace` and
    :class:`repro_torch.serving.ServingResult` work unchanged on batched
    runs."""

    def __init__(self, batch: SessionBatch, lane: int, cycle: int):
        self._batch = batch
        self._lane = int(lane)
        self.cycle = int(cycle)

    @property
    def cfg(self) -> MemSimConfig:
        return self._batch.cfg

    @property
    def arrivals_total(self) -> int:
        return self._batch.arrivals_total(self._lane)

    def trace(self) -> Trace:
        return self._batch.trace(self._lane)

    def result(self) -> SimResult:
        return self._batch.lane_result(self._lane, num_cycles=self.cycle)
