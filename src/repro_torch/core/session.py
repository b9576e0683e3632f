"""Re-entrant windowed engine sessions: the closed-loop co-simulation API,
the PyTorch counterpart of ``repro.core.session``.

The batch engines keep the "whole trace in, stats out" contract: every
arrival is fixed before the first cycle runs. :class:`SimSession` opens it
up:

* ``SimSession.open(cfg, params=...)`` builds the initial ``SimState`` once
  and keeps it on the device between calls (queues, counters and the
  runtime queue limits all live in the state).
* ``session.advance(window_cycles, new_arrivals=...)`` runs the
  event-horizon engine with the horizon capped at the window end
  (:func:`repro_torch.core.engine.run_window`) and returns a
  :class:`WindowReport`: the completions and queue occupancies a
  closed-loop scheduler (``repro_torch.serving``) reads before it decides
  the next window's traffic.
* Arrivals go into a fixed-capacity trace whose empty slots hold the
  engine's never-due ``_PAD_T`` sentinel. Its device buffers are allocated
  once, at :meth:`SimSession.open`, and an append copies only the new
  slots into them, in place: a launch's arguments and a captured CUDA
  graph hold raw pointers to them.

On the card a fused window is one launch of the persistent K3 and one copy
of the report (every field in one tensor). In place of the reference's
"one XLA compile" the port's contract is: the kernels are built once a
process (``timings["compile_s"]``), nothing is rebuilt for a later window
or session, and a ``split``/``plain`` session captures one CUDA graph a
schedule segment, which every later window replays
(``timings["captures"]``).

Exactness contract (``tests/test_torch_session.py``): replaying the same
arrivals through any window partition, window = 1 and windows cutting
refresh, self-refresh and DVFS seams included, ends in a
:class:`SimResult` bit-identical to one monolithic
:func:`repro_torch.core.engine.simulate_fast` run over the concatenated
trace, on every backend; every :class:`WindowReport` equals the
reference's, its ``steps`` included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import graphs as graphs_lib
from repro_torch.core.engine import _PAD_T, _sched_i32, run_window
from repro_torch.core.params import MemSimConfig
from repro_torch.core.simulator import (
    ScheduleView, SimResult, SimState, Trace, init_state, resolve_device,
    state_to_result)
from repro_torch.kernels import build

#: fields of one report row after a lane's ``t_complete`` slots
_REPORT_SCALARS = 4


@dataclasses.dataclass
class WindowReport:
    """What one ``advance`` window observably did — the feedback signal.

    ``completed_ids`` are the request indices (slots of the session's
    realized trace, emission order) acked inside ``[t_start, t_end)``,
    with ``completed_at`` their ack cycles. ``req_q_len`` /
    ``resp_q_len`` are the end-of-window global queue occupancies, and
    ``blocked_arrival`` the *cumulative* cycles an arrival has stalled on
    a full reqQueue — the memory-backpressure signals a scheduler turns
    into its next admission decision.
    """

    t_start: int
    t_end: int
    completed_ids: np.ndarray
    completed_at: np.ndarray
    req_q_len: int
    resp_q_len: int
    admitted: int          # arrivals admitted into the reqQueue so far
    arrivals_total: int    # trace slots filled so far
    blocked_arrival: int
    steps: int             # executed steps this window

    @property
    def n_completed(self) -> int:
        return int(self.completed_ids.size)


def _as_arrival_arrays(new_arrivals):
    """Normalize an arrivals payload to host numpy (t, addr, is_write,
    wdata). Accepts a :class:`Trace` or a 3/4-tuple of array-likes."""
    if isinstance(new_arrivals, Trace):
        t, addr, wr, wd = (x.cpu().numpy().astype(np.int64)
                           for x in new_arrivals)
    else:
        parts = tuple(new_arrivals)
        if len(parts) == 3:
            t, addr, wr = (np.asarray(p, np.int64) for p in parts)
            wd = np.zeros_like(t)
        elif len(parts) == 4:
            t, addr, wr, wd = (np.asarray(p, np.int64) for p in parts)
        else:
            raise ValueError(
                "new_arrivals must be a Trace or (t, addr, is_write[, "
                f"wdata]); got {len(parts)} components")
    if not (t.shape == addr.shape == wr.shape == wd.shape):
        raise ValueError("arrival component shapes disagree")
    return t, addr, wr, wd


def report_fetch(state: SimState, n: int) -> List[torch.Tensor]:
    """The device tensors a :class:`WindowReport` is built from, each 1-d:
    ``t_complete`` of the first ``n`` slots, then the reqQueue and
    respQueue counts, ``next_arrival`` and ``blocked_arrival``. The caller
    concatenates them (a lane-batched session: every lane's) and copies
    the result to the host once a window."""
    return [state.t_complete[:n], state.req_q.count.reshape(1),
            state.resp_q.count.reshape(1), state.next_arrival.reshape(1),
            state.blocked_arrival.reshape(1)]


def _build_report(t0: int, t1: int, n_filled: int, steps: int,
                  t_complete, req_q_len, resp_q_len, admitted,
                  blocked) -> WindowReport:
    t_complete = np.asarray(t_complete)[:n_filled]
    in_window = (t_complete >= t0) & (t_complete < t1)
    ids = np.nonzero(in_window)[0].astype(np.int64)
    return WindowReport(
        t_start=t0, t_end=t1,
        completed_ids=ids,
        completed_at=t_complete[ids],
        req_q_len=int(req_q_len),
        resp_q_len=int(resp_q_len),
        admitted=int(admitted),
        arrivals_total=n_filled,
        blocked_arrival=int(blocked),
        steps=steps,
    )


def _reports(t0: int, t1: int, n_filled: Sequence[int],
             steps: Sequence[int], packed: np.ndarray) -> List[WindowReport]:
    """Split one host copy of concatenated :func:`report_fetch` rows into
    one report a lane."""
    out, pos = [], 0
    for n, k in zip(n_filled, steps):
        row = packed[pos:pos + n + _REPORT_SCALARS]
        pos += n + _REPORT_SCALARS
        out.append(_build_report(t0, t1, n, int(k), row[:n], *row[n:]))
    return out


def _state_result(cfg: MemSimConfig, state: SimState, trace: Trace,
                  num_cycles: int) -> SimResult:
    """The host-side result bundle of a session's state over the filled
    slots ``trace``, labelled as the reference labels it: ``cfg`` with the
    runtime queue limits."""
    return state_to_result(
        dataclasses.replace(cfg, queue_size=int(state.req_q.limit),
                            resp_queue_size=int(state.resp_q.limit)),
        trace, state, num_cycles)


def _checked_limit(value, default: int, name: str) -> int:
    v = default if value is None else value
    if not (1 <= v <= default):
        raise ValueError(f"{name}={v} not in [1, {default}]")
    return int(v)


class _ArrivalBuffers:
    """The fixed-capacity arrival buffers of ``lanes`` sessions: host rows
    ``[lanes, 4, capacity]`` and their device copy, allocated once. Each
    lane's device :class:`Trace` is a set of views of its rows, so its
    pointers never move; :meth:`flush` copies the slots appended since the
    last flush, in place, in one copy."""

    def __init__(self, lanes: int, capacity: int, device):
        self.capacity = int(capacity)
        # (t, addr, is_write, wdata) rows; an empty slot is never due
        self.host = np.zeros((lanes, 4, capacity), np.int32)
        self.host[:, 0] = _PAD_T
        self.dev = torch.from_numpy(self.host.copy()).to(device)
        self.traces = [Trace(*self.dev[i]) for i in range(lanes)]
        self.filled = [0] * lanes
        self.last_t = [0] * lanes
        self._dirty: Optional[List[int]] = None  # [lo, hi) not on the card

    def append(self, lane: int, new_arrivals, batched: bool) -> int:
        """Append a payload to lane ``lane`` with the checks and error
        texts of ``SimSession.append`` (``SessionBatch.append`` when
        ``batched``); returns the first appended slot."""
        who = f"lane {lane}: " if batched else ""
        t, addr, wr, wd = _as_arrival_arrays(new_arrivals)
        n = int(t.size)
        if n == 0:
            return self.filled[lane]
        if np.any(np.diff(t) < 0):
            raise ValueError("arrival times must be non-decreasing")
        if self.filled[lane] and int(t[0]) < self.last_t[lane]:
            raise ValueError(
                f"{who}arrival t={int(t[0])} precedes already-appended "
                f"t={self.last_t[lane]}; the concatenated trace must stay "
                "sorted")
        if int(t[-1]) >= _PAD_T:
            raise ValueError(
                f"arrival t={int(t[-1])} reaches the padding sentinel "
                f"{_PAD_T}; arrivals must stay below it")
        first = self.filled[lane]
        if first + n > self.capacity:
            raise ValueError(
                f"{who}appending {n} arrivals overflows "
                f"{'' if batched else 'session '}capacity {self.capacity} "
                f"({first} filled); open the "
                f"{'batch' if batched else 'session'} with a larger "
                "capacity")
        sl = slice(first, first + n)
        rows = self.host[lane]
        rows[0, sl] = t.astype(np.int32)
        rows[1, sl] = (addr & 0x3FFFFFFF).astype(np.int32)
        rows[2, sl] = wr.astype(np.int32)
        rows[3, sl] = wd.astype(np.int32)
        self.filled[lane] += n
        self.last_t[lane] = int(t[-1])
        lo, hi = (first, first + n) if self._dirty is None else (
            min(self._dirty[0], first), max(self._dirty[1], first + n))
        self._dirty = [lo, hi]
        return first

    def flush(self) -> None:
        if self._dirty is not None:
            lo, hi = self._dirty
            self.dev[:, :, lo:hi].copy_(
                torch.from_numpy(self.host[:, :, lo:hi]))
            self._dirty = None

    def trace(self, lane: int) -> Trace:
        """Lane ``lane``'s filled slots, on the CPU."""
        n = self.filled[lane]
        return Trace(*[torch.from_numpy(self.host[lane, f, :n].copy())
                       for f in range(4)])


def _add_timings(timings: Dict, **kw) -> None:
    for k, v in kw.items():
        timings[k] = timings.get(k, 0) + v


class SimSession:
    """A re-entrant windowed simulation of one memory device.

    Use :meth:`open` to construct. The session owns a fixed-capacity
    arrival buffer (slots beyond the filled prefix sit at the engine's
    never-due padding sentinel) and the ``SimState`` on its device;
    repeated :meth:`advance` calls move the clock forward window by window,
    feeding in arrivals as they become known. See the module docstring for
    the exactness and build contracts.
    """

    def __init__(self, cfg: MemSimConfig, capacity: int, view: ScheduleView,
                 state: SimState, timings: Dict):
        self.cfg = cfg
        self.topo = cfg.topology()
        self.capacity = int(capacity)
        self.device = state.mem.device
        self._view = view
        self._state = state
        self.timings = timings
        self._buf = _ArrivalBuffers(1, capacity, self.device)
        self._graphs = (graphs_lib.graphs_for(state)
                        if self.topo.fsm_backend != "fused" else None)
        self._cycle = 0

    # ---- construction -----------------------------------------------------

    @classmethod
    def open(cls, cfg: MemSimConfig, *, capacity: int = 4096,
             params=None, queue_size: Optional[int] = None,
             resp_queue_size: Optional[int] = None,
             timings: Optional[Dict] = None, device=None) -> "SimSession":
        """Open a session on ``cfg``'s topology.

        ``capacity`` is the arrival-buffer size; every arrival ever
        appended must fit. ``params`` is a constant :class:`RuntimeParams`
        point or a :class:`ParamSchedule` (absolute boundaries — a window
        cutting a DVFS segment seam stays bit-exact). ``queue_size`` /
        ``resp_queue_size`` are the runtime occupancy limits (default: the
        static capacities). ``timings`` (optional dict, shareable across
        sessions) accumulates ``compile_s`` (kernel builds), ``run_s``,
        ``windows``, ``launches`` (persistent K3 launches) and
        ``captures`` (CUDA graphs captured by a ``split``/``plain``
        session on the card). ``device=None`` runs on the CUDA card and
        raises without one.
        """
        dev = resolve_device(device)
        cfg.validate()
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        topo = cfg.topology()
        sched = _sched_i32(cfg.runtime() if params is None else params)
        ql = _checked_limit(queue_size, cfg.queue_size, "queue_size")
        rl = _checked_limit(resp_queue_size, cfg.resp_queue_size,
                            "resp_queue_size")
        timings = {} if timings is None else timings
        t0 = time.perf_counter()
        if dev.type == "cuda" and topo.fsm_backend != "plain":
            build.load()
        _add_timings(timings, compile_s=time.perf_counter() - t0)
        view = ScheduleView(topo, sched, dev)
        state = init_state(topo, view, capacity, ql, rl, device=dev)
        return cls(cfg, capacity, view, state, timings)

    # ---- arrivals ----------------------------------------------------------

    @property
    def cycle(self) -> int:
        """The session clock: every cycle < ``cycle`` has been simulated."""
        return self._cycle

    @property
    def arrivals_total(self) -> int:
        return self._buf.filled[0]

    def append(self, new_arrivals) -> int:
        """Append arrivals to the realized trace; returns the index of the
        first appended slot. Arrival times must be non-decreasing within
        the payload AND not precede any already-appended arrival (the
        concatenated trace must satisfy the sorted :class:`Trace`
        contract, which is also what makes the windowed run comparable to
        one monolithic run over it). The new slots reach the device before
        the next window runs."""
        return self._buf.append(0, new_arrivals, batched=False)

    def trace(self) -> Trace:
        """The realized arrival stream so far (filled slots only, on the
        CPU) — what a monolithic run replaying this session would be fed,
        and what :func:`repro_torch.traces.io.save_session_trace`
        exports."""
        return self._buf.trace(0)

    # ---- the windowed run --------------------------------------------------

    def advance(self, window_cycles: int,
                new_arrivals=None) -> WindowReport:
        """Simulate ``[cycle, cycle + window_cycles)`` and report back.

        ``new_arrivals`` (optional) is appended first — the closed loop:
        a scheduler reads the previous window's :class:`WindowReport`,
        decides what traffic to emit, and hands it in here. On the card a
        fused window is one persistent K3 launch (one host read), and the
        report is one copy of every field it needs.
        """
        if window_cycles < 0:
            raise ValueError(f"window_cycles={window_cycles} must be >= 0")
        if new_arrivals is not None:
            self.append(new_arrivals)
        t0 = self._cycle
        t1 = t0 + int(window_cycles)
        steps = 0
        if t1 > t0:
            self._buf.flush()
            g0 = self._graphs.captures if self._graphs else 0
            ts = time.perf_counter()
            steps, launches = run_window(self.topo, self._view,
                                         self._buf.traces[0], self._state,
                                         t0, t1, self._graphs)
            _add_timings(self.timings, run_s=time.perf_counter() - ts,
                         windows=1, launches=launches,
                         captures=(self._graphs.captures - g0
                                   if self._graphs else 0))
            self._cycle = t1
        n = self._buf.filled[0]
        packed = torch.cat(report_fetch(self._state, n)).cpu().numpy()
        return _reports(t0, t1, [n], [steps], packed)[0]

    def run_until(self, t_end: int,
                  window_cycles: int) -> Sequence[WindowReport]:
        """Advance in fixed windows until the clock reaches ``t_end``."""
        reports = []
        while self._cycle < t_end:
            w = min(window_cycles, t_end - self._cycle)
            reports.append(self.advance(w))
        return reports

    # ---- results -----------------------------------------------------------

    def result(self) -> SimResult:
        """Host-side result bundle over the filled arrival slots — the
        same surface a monolithic :func:`repro_torch.core.simulate_fast`
        run over :meth:`trace` for ``cycle`` cycles returns (bit-identical
        to it, per the session exactness contract)."""
        return _state_result(self.cfg, self._state, self._buf.trace(0),
                             self._cycle)
