"""Event-horizon engine: PyTorch counterpart of ``repro.core.engine``, the
single lane, batches of independent lanes of one topology
(``simulate_batch``, ``sweep_queue_sizes``, ``sweep_grid``) and grids over
hardware shapes (``sweep_topologies``: one batch a topology, the
topologies' launches overlapped on CUDA streams); grids the reference
streams go to ``core.sweep_stream.stream_sweep``.

After every executed cycle the engine computes the distance to the next
event — a min over per-bank bounds (WAIT expiries, blocked bids turning
legal, refresh windows, self-refresh thresholds), the next trace arrival,
the next schedule boundary and the horizon — and jumps the clock there;
``_apply_skip`` advances timers, idle counters and the power counters by
exactly the skipped cycles. Results are bit-identical to the per-cycle
engine (the exactness contract of ``repro.core.engine``).

With ``fsm_backend="fused"`` (the default) the loop runs in K3's
persistent form (:func:`fused_run`): on the card one launch of
``kernels.bank_fsm.fused.fused_run_cuda`` executes every step from the
clock to the horizon (or a step budget) and the host reads ``(t, steps)``
once per launch; on the CPU the same loop runs eagerly
(:func:`fused_run_plain`). The per-cycle loop (``cycle_skip=False``, and
``simulate``) runs the same launches in K3's per-cycle form (no skip).
The other backends keep a Python loop on a host clock that reads one
value from the device per executed cycle, the skip ``delta``: ``"split"``
launches K1 for the edge and K2 for the bound, ``"plain"`` runs PyTorch
ops only.

A batch on the fused backend runs every lane in launches of K3's
lane-batched form (:func:`fused_run_batch`: one CTA a lane, each lane its
own clock and event horizon; its plain version on the CPU); the other
backends run a batch's lanes one after another.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import time
from contextlib import nullcontext
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import exec_cache
from repro_torch.core import graphs as graphs_lib
from repro_torch.core import power as power_lib
from repro_torch.core.bank_fsm import cycles_until_actionable, wait_mask
from repro_torch.core.fused_step import fused_cycle_step
from repro_torch.core.indexing import take
from repro_torch.core.params import (
    CMD_NOP,
    I32,
    MemSimConfig,
    ParamSchedule,
    RuntimeParams,
    S_IDLE,
    S_SREF,
    Topology,
    as_schedule,
    runtime_constraint_violations,
)
from repro_torch.core.simulator import (
    ScheduleView,
    SimResult,
    SimState,
    Trace,
    cycle_step,
    init_state,
    issue_eligibility,
    resolve_device,
    run_cycles,
    state_to_result,
)
from repro_torch.distributed.shard import round_robin_devices
from repro_torch.kernels import build
from repro_torch.kernels.bank_fsm.fused import (
    DEFAULT_RUN_BUDGET, FusedRunBatch, fused_run_cuda, fused_step_plain,
    preload_batch_forms)

_INF = 0x3FFFFFFF
_PAD_T = 0x3FFFFFFF  # arrival time for padded trace slots: never due


def _cap(b: torch.Tensor, x) -> torch.Tensor:
    """``min(b, x)`` for ``x`` a host int or a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        return torch.minimum(b, x)
    return b.clamp(max=x)


def _event_bound(topo, view: ScheduleView, trace: Trace, state: SimState,
                 nxt, horizon, seg: Optional[int] = None
                 ) -> torch.Tensor:
    """Number of provably inert cycles starting at ``nxt`` (0-d tensor),
    without the global-queue pre-gate of :func:`_next_event`. ``nxt`` and
    ``horizon`` are host ints or 0-d device tensors; ``seg`` the schedule
    segment of ``nxt`` (resolved from a host ``nxt`` when omitted)."""
    if seg is None:
        seg = view.segment_at(nxt)
    bank = state.bank
    st = bank.st
    eligible, cmds, legal_at = issue_eligibility(topo, view, state.timing,
                                                 bank, nxt, seg)
    blocked_bid = (cmds != CMD_NOP) & ~eligible

    # gate: nothing can happen at cycle `nxt` except timer/counter ticks
    bq_valid = ~state.bank_q.empty()
    inert = (wait_mask(st) | blocked_bid
             | (((st == S_IDLE) | (st == S_SREF)) & ~bq_valid))
    gate = inert.all()

    if topo.fsm_backend == "split":
        from repro_torch.kernels.bank_fsm.ops import bank_event_bound
        from repro_torch.kernels.bank_fsm.ref import pack_state

        local = bank_event_bound(pack_state(bank), nxt, view.packed,
                                 topo=topo)
    else:
        local = cycles_until_actionable(view.dev[seg], bank, nxt)
    # a blocked bid becomes actionable the cycle its command turns legal
    per_bank = torch.where(blocked_bid, legal_at - nxt, local).min()

    n = trace.num_requests
    idx = state.next_arrival.clamp(max=n - 1)
    arrival = torch.where(state.next_arrival < n, take(trace.t, idx) - nxt,
                          _INF)
    b = _cap(torch.minimum(per_bank, arrival), horizon - nxt)
    # the next operating-point change is an event
    b = _cap(b, view.boundary_after(seg) - nxt)
    return torch.where(gate, b.clamp(min=0), 0).to(I32)


def _next_event(topo, view: ScheduleView, trace: Trace, state: SimState,
                nxt, horizon, seg: Optional[int] = None
                ) -> torch.Tensor:
    """Distance to the event horizon from cycle ``nxt``: 0 whenever the
    global request or response queue holds work (both sides computed and
    selected on the device — the reference's ``lax.cond``)."""
    maybe = state.req_q.empty() & state.resp_q.empty()
    return torch.where(maybe, _event_bound(topo, view, trace, state, nxt,
                                           horizon, seg), 0)


def _apply_skip(topo, view: ScheduleView, state: SimState, delta,
                seg: int) -> SimState:
    """Fast-forward ``delta`` inert cycles (a host int, or a 0-d device
    tensor) that all lie in schedule segment ``seg``: WAIT timers count
    down, truly idle banks count up, every other idle counter resets, and
    the counters gain ``delta`` NOP cycles. The identity at ``delta == 0``
    (a host 0 returns ``state`` itself)."""
    if not isinstance(delta, torch.Tensor) and delta == 0:
        return state
    st = state.bank.st
    timer = torch.where(wait_mask(st), state.bank.timer - delta,
                        state.bank.timer)
    idle_ctr = torch.where(st == S_IDLE, state.bank.idle_ctr + delta, 0)
    if isinstance(delta, torch.Tensor):
        idle_ctr = torch.where(delta > 0, idle_ctr, state.bank.idle_ctr)
    bank = state.bank._replace(timer=timer.to(I32), idle_ctr=idle_ctr.to(I32))
    counters = power_lib.skip_counters(state.counters, st, delta,
                                       topo.channels, seg,
                                       tier_idx=view.tier_idx)
    return state._replace(bank=bank, counters=counters)


def _skip_step(topo, view: ScheduleView, trace: Trace, horizon,
               seg: int, seg_next: int, state: SimState, cycle
               ) -> Tuple[SimState, torch.Tensor]:
    """One executed cycle of the event-horizon engine at ``cycle`` (segment
    ``seg``; ``seg_next`` is the segment of ``cycle + 1``) on the split or
    plain backend: the clock edge, the distance ``delta`` to the next
    event (capped at ``horizon``, a host int or a 0-d device tensor), and
    the skip over it."""
    state = cycle_step(topo, view, trace, state, cycle, seg)
    delta = _next_event(topo, view, trace, state, cycle + 1, horizon,
                        seg_next)
    return _apply_skip(topo, view, state, delta, seg_next), delta


def fused_run_plain(topo, view: ScheduleView, trace: Trace,
                    state: SimState, t: int, t_end: int,
                    budget: Optional[int] = None, cycle_skip: bool = True
                    ) -> Tuple[int, int]:
    """The plain version of the persistent K3: the eager executed steps of
    the fused backend (the glue of ``core.fused_step`` around
    ``fused_step_plain``, then the skip) from clock ``t`` until ``t_end``
    or ``budget`` steps; ``state`` is updated in place. ``cycle_skip=False``
    is the per-cycle form: each step's horizon is ``t + 1`` (its delta 0),
    no skip, and ``t`` advances by 1. Returns ``(t, steps)``."""
    budget = DEFAULT_RUN_BUDGET if budget is None else int(budget)
    if budget < 1:
        raise ValueError(f"fused_run: budget={budget} must be >= 1")
    cur, steps = state, 0
    while t < t_end and steps < budget:
        seg = view.segment_at(t)
        if cycle_skip:
            cur, delta = fused_cycle_step(topo, view, trace, cur, t, t_end,
                                          seg, kernel=fused_step_plain)
            cur = _apply_skip(topo, view, cur, delta, view.segment_at(t + 1))
            t += 1 + int(delta)
        else:
            cur, _ = fused_cycle_step(topo, view, trace, cur, t, t + 1, seg,
                                      kernel=fused_step_plain)
            t += 1
        steps += 1
    graphs_lib.copy_into(state, cur)
    return t, steps


def fused_run(topo, view: ScheduleView, trace: Trace, state: SimState,
              t: int, t_end: int, budget: Optional[int] = None,
              cycle_skip: bool = True) -> Tuple[int, int]:
    """Executed steps of the fused backend from ``t`` until ``t_end`` or
    ``budget`` steps, in place: one launch of the persistent K3 for a state
    on the card, its plain version for one on the CPU; ``cycle_skip=False``
    runs its per-cycle form. Returns ``(t, steps)``."""
    run = fused_run_cuda if state.mem.is_cuda else fused_run_plain
    return run(topo, view, trace, state, t, t_end, budget, cycle_skip)


def fused_run_batch_plain(topo, views, traces, states, t_end: int,
                          budget: Optional[int] = None,
                          cycle_skip: bool = True, t=None,
                          max_launches: Optional[int] = None
                          ) -> Tuple[List[int], List[int], int]:
    """The plain version of the lane-batched persistent K3, with its
    launch protocol: a "launch" runs every lane that has not reached the
    horizon ``t_end`` for at most ``budget`` steps (:func:`fused_run_plain`
    on each lane in turn), until every lane has or ``max_launches`` have
    run. Each lane starts at ``t[i]`` (default 0); the states are updated
    in place. Returns (the clock of each lane, its executed steps,
    launches)."""
    budget = DEFAULT_RUN_BUDGET if budget is None else int(budget)
    if budget < 1:
        raise ValueError(f"fused_run_batch: budget={budget} must be >= 1")
    n = len(states)
    if len(views) != n or len(traces) != n:
        raise ValueError("fused_run_batch: one view and one trace per state")
    ts = [0] * n if t is None else [int(x) for x in t]
    steps = [0] * n
    launches = 0
    active = [i for i in range(n) if ts[i] < t_end]
    while active and launches != max_launches:
        for i in active:
            ts[i], k = fused_run_plain(topo, views[i], traces[i], states[i],
                                       ts[i], t_end, budget, cycle_skip)
            steps[i] += k
        launches += 1
        active = [i for i in active if ts[i] < t_end]
    return ts, steps, launches


def fused_run_batch(topo, views, traces, states, t_end: int,
                    budget: Optional[int] = None, cycle_skip: bool = True,
                    t=None, max_launches: Optional[int] = None,
                    start_only: bool = False):
    """Every lane (its own view, trace and state, one topology and
    capacities) from its clock to the horizon ``t_end``, in place: launches
    of the lane-batched persistent K3 for states on the card, its plain
    version for states on the CPU. Returns (the clock of each lane, its
    executed steps, launches). With ``start_only`` the first launch is
    enqueued on the card's current stream and the function that finishes
    the protocol (and returns that triple) is returned at once."""
    on_card = {s.mem.is_cuda for s in states}
    if len(on_card) > 1:
        raise ValueError("fused_run_batch: lanes on the card and on the CPU")
    if on_card != {True}:
        finish = functools.partial(fused_run_batch_plain, topo, views,
                                   traces, states, t_end, budget, cycle_skip,
                                   t, max_launches)
    else:
        run = FusedRunBatch(topo, views, traces, states, t_end, budget,
                            cycle_skip, t, max_launches)
        if start_only and run.active and max_launches != 0:
            run.launch()
        finish = run.finish
    return finish if start_only else finish()


def fused_cycles(topo, view: ScheduleView, trace: Trace, state: SimState,
                 t: int, t_end: int, cycle_skip: bool) -> Tuple[int, int]:
    """:func:`fused_run` launches from ``t`` until the horizon ``t_end``,
    in place. Returns ``(executed steps, launches)``."""
    steps = launches = 0
    while t < t_end:
        t, n = fused_run(topo, view, trace, state, t, t_end,
                         cycle_skip=cycle_skip)
        steps += n
        launches += 1
    return steps, launches


def _skip_loop(topo, view: ScheduleView, trace: Trace, state: SimState,
               t: int, t_end: int, graphs=None) -> Tuple[SimState, int]:
    """The split and plain backends' event-horizon loop from clock ``t`` to
    exactly ``t_end``: execute one cycle per event, then jump the clock to
    the next event horizon, capped at ``t_end``. Returns (final state,
    executed steps).

    The host reads ``delta`` once per executed cycle. With ``graphs`` (a
    :class:`~repro_torch.core.graphs.StepGraphs` of a state on the card)
    such a cycle is a CUDA-graph replay of :func:`_skip_step`, one graph
    per schedule segment, and the horizon is ``graphs.horizon``, a 0-d
    device tensor filled here: a graph captured in one window replays in
    the next with that window's horizon. The last cycle before a segment
    boundary, whose bound is taken under the next segment, runs eagerly,
    as every cycle does without ``graphs``."""
    if graphs is not None:
        graphs.horizon.fill_(t_end)
    steps = 0
    while t < t_end:
        seg, seg_next = view.segment_at(t), view.segment_at(t + 1)
        replayed = graphs is not None and seg == seg_next
        if replayed:
            delta = graphs.step(seg, t, functools.partial(
                _skip_step, topo, view, trace, graphs.horizon, seg,
                seg_next))
        else:
            state, delta = _skip_step(topo, view, trace, t_end, seg,
                                      seg_next,
                                      graphs.state if graphs else state, t)
            if graphs is not None:
                graphs.adopt(state)
        d = int(delta)  # the one host synchronisation per executed cycle
        t += 1 + d
        steps += 1
        if replayed:
            graphs.advanced_to(t)
    return (graphs.state if graphs is not None else state), steps


def _run_skip_core(topo, view: ScheduleView, trace: Trace, num_cycles: int,
                   state: SimState) -> Tuple[SimState, int, int]:
    """Event-driven loop from cycle 0 to ``num_cycles``. Returns (final
    state, executed steps, K3 launches).

    The fused backend runs :func:`fused_run` launches until the horizon,
    reading ``(t, steps)`` once per launch; the others run
    :func:`_skip_loop`, replaying its cycles from CUDA graphs on the
    card."""
    if topo.fsm_backend == "fused":
        return (state, *fused_cycles(topo, view, trace, state, 0, num_cycles,
                                     cycle_skip=True))
    final, steps = _skip_loop(topo, view, trace, state, 0, num_cycles,
                              graphs_lib.graphs_for(state))
    return final, steps, 0


def run_window(topo, view: ScheduleView, trace: Trace, state: SimState,
               t0: int, t1: int, graphs=None) -> Tuple[int, int]:
    """Advance a carried ``state`` from clock ``t0`` to exactly ``t1``, in
    place: the engine half of :class:`repro_torch.core.session.SimSession`
    (the reference's ``_run_window_core``). Returns (executed steps, K3
    launches).

    The fused backend runs :func:`fused_cycles` with the horizon ``t1``:
    on the card one launch of the persistent K3 (more only where a
    schedule's slice ends a launch early), on the CPU its plain version.
    The split and plain backends run :func:`_skip_loop`; ``graphs`` (the
    ``StepGraphs`` of ``state``, kept by the caller across windows) replays
    its cycles on the card, ``None`` runs them eagerly.

    A window boundary only caps the skip, and executing an inert cycle is
    bit-identical to skipping it, so any partition of a run into windows
    ends in the monolithic run's state; only the executed-step count
    differs."""
    if t1 <= t0:
        return 0, 0
    if topo.fsm_backend == "fused":
        return fused_cycles(topo, view, trace, state, t0, t1,
                            cycle_skip=True)
    if graphs is not None and graphs.state is not state:
        raise ValueError("run_window: graphs belong to another state")
    final, steps = _skip_loop(topo, view, trace, state, t0, t1, graphs)
    if final is not state:
        graphs_lib.copy_into(state, final)
    return steps, 0


def run_window_batch(topo, views, traces, states, t0: int, t1: int,
                     graphs=None) -> Tuple[List[int], int]:
    """:func:`run_window` over L lanes of one topology and capacities (each
    its own view, trace and state; ``graphs`` one ``StepGraphs`` or
    ``None`` a lane), every lane from ``t0`` to ``t1``, in place. The fused
    backend runs every lane in launches of the lane-batched persistent K3
    (:func:`fused_run_batch`: one launch a window on the card, unless a
    schedule slice ends one early); the split and plain backends run the
    lanes one after another. Returns (each lane's executed steps, K3
    launches)."""
    n = len(states)
    if t1 <= t0:
        return [0] * n, 0
    if topo.fsm_backend == "fused":
        _, steps, launches = fused_run_batch(topo, views, traces, states, t1,
                                             t=[t0] * n)
        return steps, launches
    graphs = [None] * n if graphs is None else graphs
    steps = [run_window(topo, v, tr, st, t0, t1, g)[0]
             for v, tr, st, g in zip(views, traces, states, graphs)]
    return steps, 0


def _run_scan_core(topo, view: ScheduleView, trace: Trace, num_cycles: int,
                   state: SimState) -> Tuple[SimState, int, int]:
    """Plain per-cycle loop with runtime limits/params. Returns (final
    state, executed steps = cycles, K3 launches): the fused backend runs
    K3's per-cycle form (:func:`fused_run` with ``cycle_skip=False``), the
    others :func:`run_cycles`."""
    if topo.fsm_backend == "fused":
        return (state, *fused_cycles(topo, view, trace, state, 0, num_cycles,
                                     cycle_skip=False))
    return run_cycles(topo, view, trace, state, 0, num_cycles), num_cycles, 0


def _pad_trace(tr: Trace, n_max: int) -> Trace:
    """Pad one trace to ``n_max`` requests with inert slots whose arrival
    ``_PAD_T`` is never due. Rejects traces whose real arrivals reach the
    sentinel."""
    n = int(tr.num_requests)
    t = tr.t.cpu().numpy()
    if n and int(t[n - 1]) >= _PAD_T:
        raise ValueError(
            f"trace arrival t={int(t[n - 1])} reaches the "
            f"padding sentinel {_PAD_T}; arrivals must stay below it")
    if n == n_max:
        return tr

    def pad(x, fill):
        out = np.full((n_max,), fill, np.int32)
        out[:n] = x.cpu().numpy()
        return torch.from_numpy(out).to(x.device)

    return Trace(t=pad(tr.t, _PAD_T), addr=pad(tr.addr, 0),
                 is_write=pad(tr.is_write, 0), wdata=pad(tr.wdata, 0))


def _sentinel_trace(n_max: int, device=None) -> Trace:
    """An all-padding lane: no request is ever due."""
    zeros = torch.zeros((n_max,), dtype=I32, device=device)
    return Trace(t=torch.full((n_max,), _PAD_T, dtype=I32, device=device),
                 addr=zeros, is_write=zeros.clone(), wdata=zeros.clone())


def _rp_i32(rp: RuntimeParams) -> RuntimeParams:
    """Validate a ``params=`` point with the config-construction error
    texts and lift every leaf to an int32 tensor. Tier-stacked ``[T]``
    leaves are not checked here (as in the reference); the schedule's
    per-tier validation covers them."""
    vals = {}
    for f in RuntimeParams._fields:
        try:
            vals[f] = int(getattr(rp, f))
        except (TypeError, ValueError):  # a tier-stacked [T] leaf
            vals[f] = None
    bad = runtime_constraint_violations(vals)
    if bad:
        raise ValueError("; ".join(bad))
    return RuntimeParams(*[torch.as_tensor(v).to(I32) for v in rp])


def _sched_i32(params) -> ParamSchedule:
    """Canonicalize a ``params=`` override to a validated int32
    :class:`ParamSchedule`."""
    if isinstance(params, RuntimeParams):
        return ParamSchedule.constant(_rp_i32(params))
    sched = as_schedule(params)  # raises TypeError on anything else
    sched.validate()
    return ParamSchedule(
        boundaries=sched.boundaries.to(I32),
        values=RuntimeParams(*[torch.as_tensor(v).to(I32)
                               for v in sched.values]))


def simulate_fast(cfg: MemSimConfig, trace: Trace, num_cycles: int = 100_000,
                  *, queue_size: Optional[int] = None,
                  resp_queue_size: Optional[int] = None,
                  cycle_skip: bool = True, params=None,
                  timings: Optional[dict] = None,
                  device=None) -> SimResult:
    """Single-trace run on the event-horizon engine; bit-exact vs
    :func:`repro_torch.core.simulate`.

    ``cfg.queue_size`` is the static capacity and ``queue_size`` (default:
    capacity) the runtime depth; ``params`` a :class:`RuntimeParams` or
    :class:`ParamSchedule` (default ``cfg.runtime()``). ``cycle_skip=False``
    runs the plain per-cycle loop. ``timings`` (optional dict) receives
    ``compile_s`` (kernel build), ``run_s``, ``steps`` (executed cycles)
    and ``launches`` (persistent K3 launches of the fused backend's loop,
    either form, 0 for the others). ``device=None`` runs on the CUDA card
    and raises without one.
    """
    dev = resolve_device(device)
    cfg.validate()
    topo = cfg.topology()
    sched = _sched_i32(cfg.runtime() if params is None else params)
    ql = cfg.queue_size if queue_size is None else queue_size
    rl = cfg.resp_queue_size if resp_queue_size is None else resp_queue_size
    if not (1 <= ql <= cfg.queue_size):
        raise ValueError(f"queue_size={ql} not in [1, {cfg.queue_size}]")
    if not (1 <= rl <= cfg.resp_queue_size):
        raise ValueError(f"resp_queue_size={rl} not in [1, {cfg.resp_queue_size}]")
    t0 = time.perf_counter()
    if dev.type == "cuda" and topo.fsm_backend != "plain":
        build.load()
    t1 = time.perf_counter()
    trace_d = trace.to(dev)
    view = ScheduleView(topo, sched, dev)
    state = init_state(topo, view, trace.num_requests, ql, rl, device=dev)
    runner = _run_skip_core if cycle_skip else _run_scan_core
    final, steps, launches = runner(topo, view, trace_d, num_cycles, state)
    res = state_to_result(cfg, trace_d, final, num_cycles)
    t2 = time.perf_counter()
    if timings is not None:
        timings["compile_s"] = timings.get("compile_s", 0.0) + (t1 - t0)
        timings["run_s"] = timings.get("run_s", 0.0) + (t2 - t1)
        timings["steps"] = int(steps)
        timings["launches"] = int(launches)
    label = cfg if params is None else sched.apply_to(cfg)
    res.cfg = dataclasses.replace(label, queue_size=int(ql),
                                  resp_queue_size=int(rl))
    return res


# --------------------------------------------------------------------------
# batches and sweeps: one topology a call, each lane an independent run


def stack_traces(traces: Sequence[Trace],
                 pad_lanes: int = 0) -> Tuple[Trace, List[int]]:
    """Pad traces to a common length (see :func:`_pad_trace`) and stack on
    a leading batch axis, appending ``pad_lanes`` all-sentinel lanes (see
    :func:`_sentinel_trace`). Returns the stacked trace and the real
    per-lane request counts (padding lanes excluded)."""
    ns = [int(tr.num_requests) for tr in traces]
    n_max = max(ns)
    padded = [_pad_trace(tr, n_max) for tr in traces]
    padded += [_sentinel_trace(n_max, traces[0].t.device)] * pad_lanes
    stacked = Trace(*[torch.stack(xs) for xs in zip(*padded)])
    return stacked, ns


def _lane_views(topo, scheds: List[ParamSchedule], dev) -> List[ScheduleView]:
    """One :class:`ScheduleView` a lane; lanes with equal schedules share
    one."""
    views, by_key = [], {}
    for sc in scheds:
        bounds, rp_mat = sc.pack()
        key = (bounds.numpy().tobytes(), rp_mat.numpy().tobytes())
        if key not in by_key:
            by_key[key] = ScheduleView(topo, sc, dev)
        views.append(by_key[key])
    return views


def simulate_batch(cfg: MemSimConfig,
                   traces: Union[Trace, Sequence[Trace]],
                   num_cycles: int = 100_000,
                   *, queue_sizes: Optional[Sequence[int]] = None,
                   resp_queue_sizes: Optional[Sequence[int]] = None,
                   params=None,
                   lane_cfgs: Optional[Sequence[MemSimConfig]] = None,
                   cycle_skip: bool = True,
                   shard: bool = True,
                   batch_mode: str = "auto",
                   timings: Optional[dict] = None,
                   device=None) -> List[SimResult]:
    """Run a batch of (trace, runtime-config) lanes of one topology; each
    lane is bit-exact vs an individual :func:`simulate_fast` run at its
    queue depths and parameter point or schedule.

    ``traces`` is a list of traces (a multi-trace workload) or one trace
    broadcast across the lanes that ``queue_sizes`` / ``params`` imply (a
    sweep). ``cfg.queue_size`` / ``cfg.resp_queue_size`` are the static
    capacities every lane shares; ``queue_sizes`` / ``resp_queue_sizes``
    the lanes' runtime depths (default: capacity); ``params`` one
    :class:`RuntimeParams` or :class:`ParamSchedule` a lane (mixed
    constant and schedule lanes are padded to a common segment count).
    Lanes are padded to a common request count. ``lane_cfgs`` (optional,
    one a lane) labels each ``SimResult.cfg``; by default the label is
    ``cfg`` with the lane's point and depths substituted.

    On the fused backend (the default) every lane runs in launches of the
    lane-batched persistent K3, one CTA a lane, each lane skipping by its
    own event horizon (:func:`fused_run_batch`); a batch that needs no
    relaunch is ONE launch. The split and plain backends run their lanes
    one after another through the single-lane loops.

    ``batch_mode`` takes the reference's values (``"auto"``, ``"vmap"``,
    ``"lanes"``), and every mode runs independent lanes: the reference's
    ``"lanes"`` semantics. The ``"vmap"`` mode's shared clock (joint
    skipping) is not reproduced: results are identical, and only
    ``timings["steps"]`` differs from the reference's ``"vmap"`` mode.
    ``shard`` is accepted; the batch runs on one device.

    ``timings`` (optional dict) receives ``compile_s``, ``run_s`` (split
    into ``setup_s``: traces, views and states; ``lanes_s``: the runs;
    ``results_s``: the copies to the host), ``steps`` (the largest lane's
    executed steps, as the reference's lanes mode), ``steps_total``,
    ``launches`` (lane-batched K3 launches, 0 for the split and plain
    backends) and ``per_lane`` (``{lane, device, steps}`` a lane).
    ``device=None`` runs on the CUDA card and raises without one.
    """
    return _start_batch(cfg, traces, num_cycles, queue_sizes=queue_sizes,
                        resp_queue_sizes=resp_queue_sizes, params=params,
                        lane_cfgs=lane_cfgs, cycle_skip=cycle_skip,
                        batch_mode=batch_mode,
                        dev=resolve_device(device))(timings)


def _start_batch(cfg: MemSimConfig, traces, num_cycles: int, *,
                 queue_sizes, resp_queue_sizes, params, lane_cfgs,
                 cycle_skip: bool, batch_mode: str, dev: torch.device):
    """:func:`simulate_batch` split at its first launch: validates the
    lanes and sets them up on ``dev``; on the fused backend the first
    launch is enqueued on the card's current stream
    (:func:`fused_run_batch` with ``start_only``). Returns
    ``finish(timings=None, as_states=False)``, which runs the rest and
    returns the results, or with ``as_states`` (the lanes' final states,
    each lane's executed steps, launches) and no copy to the host."""
    cfg.validate()
    topo = cfg.topology()
    if batch_mode not in ("auto", "vmap", "lanes"):
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    if isinstance(traces, Trace):
        n_lanes = (len(queue_sizes) if queue_sizes is not None
                   else len(params) if params is not None else None)
        if n_lanes is None:
            raise ValueError(
                "broadcasting a single trace requires queue_sizes or params")
        trace_list = [traces] * n_lanes
    else:
        trace_list = list(traces)
    lanes = len(trace_list)
    if lanes == 0:
        return lambda timings=None, as_states=False: []

    def _broadcast(vals, default, name, cap):
        if vals is None:
            vals = [default] * lanes
        vals = list(vals)
        if len(vals) != lanes:
            raise ValueError(f"{name} must have one entry per lane")
        for v in vals:
            if not (1 <= v <= cap):
                raise ValueError(f"{name} entry {v} not in [1, {cap}]")
        return [int(v) for v in vals]

    qs = _broadcast(queue_sizes, cfg.queue_size, "queue_sizes",
                    cfg.queue_size)
    rs = _broadcast(resp_queue_sizes, cfg.resp_queue_size,
                    "resp_queue_sizes", cfg.resp_queue_size)
    if params is None:
        scheds = [_sched_i32(cfg.runtime())] * lanes
    else:
        scheds = [_sched_i32(p) for p in params]
        if len(scheds) != lanes:
            raise ValueError("params must have one entry per lane")
    # mixed constant/schedule lanes: every lane padded to the common
    # segment count (inert SCHEDULE_INF rows), as the reference does
    s_max = max(sc.num_segments for sc in scheds)
    scheds = [sc.pad_to(s_max) for sc in scheds]
    if lane_cfgs is not None and len(lane_cfgs) != lanes:
        raise ValueError("lane_cfgs must have one entry per lane")

    t0 = time.perf_counter()
    if dev.type == "cuda" and topo.fsm_backend != "plain":
        build.load()
    t1 = time.perf_counter()
    n_max = max(int(tr.num_requests) for tr in trace_list)
    on_dev: Dict[int, Trace] = {}  # a broadcast trace goes over once
    for tr in trace_list:
        if id(tr) not in on_dev:
            on_dev[id(tr)] = _pad_trace(tr, n_max).to(dev)
    trs = [on_dev[id(tr)] for tr in trace_list]
    views = _lane_views(topo, scheds, dev)
    states = [init_state(topo, v, n_max, q, r, device=dev)
              for v, q, r in zip(views, qs, rs)]
    t_set = time.perf_counter()
    if topo.fsm_backend == "fused":
        fused_finish = fused_run_batch(topo, views, trs, states,
                                       num_cycles, cycle_skip=cycle_skip,
                                       start_only=True)

    def finish(timings: Optional[dict] = None, as_states: bool = False):
        if topo.fsm_backend == "fused":
            _, lane_steps, launches = fused_finish()
            finals = states
        else:
            runner = _run_skip_core if cycle_skip else _run_scan_core
            finals, lane_steps, launches = [], [], 0
            for v, tr, st in zip(views, trs, states):
                final, k, _ = runner(topo, v, tr, num_cycles, st)
                finals.append(final)
                lane_steps.append(int(k))
        t_lanes = time.perf_counter()
        if as_states:
            return finals, lane_steps, launches

        results = []
        for i in range(lanes):
            if lane_cfgs is not None:
                lane_cfg = lane_cfgs[i]
            else:
                lane_cfg = dataclasses.replace(scheds[i].apply_to(cfg),
                                               queue_size=qs[i],
                                               resp_queue_size=rs[i])
            results.append(state_to_result(lane_cfg, trace_list[i],
                                           finals[i], num_cycles))
        t2 = time.perf_counter()
        if timings is not None:
            timings["compile_s"] = timings.get("compile_s", 0.0) + (t1 - t0)
            timings["run_s"] = timings.get("run_s", 0.0) + (t2 - t1)
            timings["setup_s"] = t_set - t1
            timings["lanes_s"] = t_lanes - t_set
            timings["results_s"] = t2 - t_lanes
            timings["steps"] = max(lane_steps)
            timings["steps_total"] = sum(lane_steps)
            timings["launches"] = int(launches)
            timings.setdefault("per_lane", []).extend(
                {"lane": i, "device": str(dev), "steps": int(k)}
                for i, k in enumerate(lane_steps))
        return results

    return finish


def sweep_queue_sizes(cfg: MemSimConfig, trace: Trace,
                      queue_sizes: Sequence[int],
                      num_cycles: int = 100_000,
                      *, capacity: Optional[int] = None,
                      cycle_skip: bool = True,
                      batch_mode: str = "auto",
                      timings: Optional[dict] = None,
                      device=None) -> List[SimResult]:
    """The paper's queue sweep as one batch: a one-axis
    :func:`sweep_grid`. ``capacity`` (default ``max(queue_sizes)``) sizes
    the static buffers every lane shares."""
    return sweep_grid(cfg, trace, {"queue_size": list(queue_sizes)},
                      num_cycles, capacity=capacity, cycle_skip=cycle_skip,
                      batch_mode=batch_mode, timings=timings, device=device)


#: grid axes resolvable by :func:`sweep_grid`: every RuntimeParams field
#: (policies given as their config strings), the runtime queue depths, and
#: ``"schedule"``, whose values are time-varying parameter schedules (see
#: :func:`lane_schedule`)
GRID_AXES = tuple(RuntimeParams._fields) + ("queue_size", "resp_queue_size",
                                            "schedule")


def lane_schedule(cfg: MemSimConfig, spec) -> ParamSchedule:
    """Resolve a ``"schedule"`` grid-axis value against a lane's config:

      * ``None``: the constant schedule ``cfg.runtime()``;
      * a :class:`ParamSchedule`: used as it is (it does not compose with
        the lane's other axes);
      * a :class:`RuntimeParams`: a constant override point;
      * a sequence of ``(start_cycle, override_dict)`` segments: each
        segment is ``cfg`` with the overrides substituted and validated,
        so schedules compose with the other grid axes and a bad segment
        fails with the config's own ValueError.
    """
    if spec is None:
        return ParamSchedule.constant(cfg.runtime())
    if isinstance(spec, ParamSchedule):
        return spec
    if isinstance(spec, RuntimeParams):
        return ParamSchedule.constant(spec)
    segs = []
    for start, ov in spec:
        seg_cfg = dataclasses.replace(cfg, **dict(ov)).validate()
        segs.append((int(start), seg_cfg.runtime()))
    return ParamSchedule.from_segments(segs)


def _stream_threshold() -> int:
    """Lane count from which :func:`sweep_grid` and
    :func:`sweep_topologies` stream by default (``MEMSIM_STREAM_THRESHOLD``,
    default 4096, read every call)."""
    raw = os.environ.get("MEMSIM_STREAM_THRESHOLD", "").strip()
    try:
        v = int(raw) if raw else 4096
    except ValueError:
        v = 4096
    return max(1, v)


def aot_cache_stats() -> Dict:
    """Both layers of the kernel cache, as the reference's
    ``aot_cache_stats``: ``"memory"``, the :func:`build.load` calls served
    by the libraries already loaded in this process (``hits``) against
    those that went to disk or to nvcc (``misses``), and the libraries
    loaded (``entries``); ``"disk"``, the persistent cache's
    :func:`exec_cache.stats`. The reference's in-process cache holds one
    executable a program and evicts past ``MEMSIM_AOT_CACHE_SIZE``; the
    port holds one library set a process, never evicted, so that variable
    has no counterpart."""
    return {"memory": build.memory_stats(), "disk": exec_cache.stats()}


def grid_points(grid: Mapping[str, Sequence]) -> List[Dict]:
    """Expand an axis dict into the Cartesian product of override dicts,
    last axis fastest (``itertools.product`` order)."""
    keys = list(grid)
    for k in keys:
        if k not in GRID_AXES:
            raise ValueError(f"unknown grid axis {k!r}; valid: {GRID_AXES}")
        if len(grid[k]) == 0:
            raise ValueError(f"grid axis {k!r} is empty")
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def sweep_grid(cfg: MemSimConfig, trace: Trace,
               grid: Mapping[str, Sequence],
               num_cycles: int = 100_000,
               *, capacity: Optional[int] = None,
               resp_capacity: Optional[int] = None,
               cycle_skip: bool = True,
               shard: bool = True,
               batch_mode: str = "auto",
               stream: Optional[bool] = None,
               chunk_lanes: Optional[int] = None,
               memory_budget_bytes: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               resume: bool = True,
               timings: Optional[dict] = None,
               device=None) -> List[SimResult]:
    """A runtime-parameter grid as one batch (:func:`simulate_batch`), one
    lane per point of the Cartesian product in :func:`grid_points` order,
    each ``result.cfg`` that point's full config.

    ``grid`` maps axis names (:data:`GRID_AXES`) to value lists: any
    Table-1 timing, ``page_policy`` / ``sched_policy`` (config strings),
    ``sref_idle_cycles``, the runtime depths ``queue_size`` /
    ``resp_queue_size`` and ``"schedule"`` (see :func:`lane_schedule`).
    ``capacity`` / ``resp_capacity`` (defaults: the largest swept depth)
    size the static queue buffers.

    Streaming: grids of at least :func:`_stream_threshold` points (env
    ``MEMSIM_STREAM_THRESHOLD``, default 4096), or any call that gives a
    ``checkpoint_dir`` or sets ``stream=True``, run through the streaming
    executor (:func:`repro_torch.core.sweep_stream.stream_sweep`): chunks
    of ``chunk_lanes`` lanes (or as many as ``memory_budget_bytes``
    holds), one lane-batched launch a chunk, each finished chunk
    checkpointed to ``checkpoint_dir`` (kill/resume, ``resume``), the
    kernels loaded from ``MEMSIM_EXEC_CACHE_DIR`` when it is set; results
    bit-exact vs this materialising path, ``timings`` the executor's.
    ``stream=False`` forces the materialising path.
    """
    points = grid_points(grid)
    if stream is None:
        stream = (checkpoint_dir is not None
                  or len(points) >= _stream_threshold())
    if stream:
        from repro_torch.core.sweep_stream import stream_sweep

        return list(stream_sweep(
            cfg, trace, grid, num_cycles, capacity=capacity,
            resp_capacity=resp_capacity, cycle_skip=cycle_skip,
            chunk_lanes=chunk_lanes,
            memory_budget_bytes=memory_budget_bytes,
            checkpoint_dir=checkpoint_dir, resume=resume, timings=timings,
            device=device).results)
    # per-point full configs, validated as config construction would; the
    # "schedule" axis resolves against each lane's config
    lane_cfgs = [dataclasses.replace(
        cfg, **{k: v for k, v in ov.items() if k != "schedule"}).validate()
        for ov in points]
    lane_scheds = [lane_schedule(c, ov.get("schedule"))
                   for c, ov in zip(lane_cfgs, points)]
    qs = [c.queue_size for c in lane_cfgs]
    rs = [c.resp_queue_size for c in lane_cfgs]
    cap = max(qs) if capacity is None else capacity
    rcap = max(rs) if resp_capacity is None else resp_capacity
    if cap < max(qs):
        raise ValueError("capacity below largest swept queue size")
    if rcap < max(rs):
        raise ValueError("resp_capacity below largest swept resp queue size")
    cfg_cap = dataclasses.replace(cfg, queue_size=cap, resp_queue_size=rcap)
    return simulate_batch(cfg_cap, trace, num_cycles,
                          queue_sizes=qs, resp_queue_sizes=rs,
                          params=lane_scheds, lane_cfgs=lane_cfgs,
                          cycle_skip=cycle_skip, shard=shard,
                          batch_mode=batch_mode, timings=timings,
                          device=device)


# --------------------------------------------------------------------------
# multi-topology sweeps: one lane-batched launch a hardware shape

#: structural grid axes of :func:`sweep_topologies` on top of the runtime
#: :data:`GRID_AXES`: every shape-determining :class:`Topology` field.
#: ``queue_size`` / ``resp_queue_size`` stay runtime depths against a
#: grid-wide capacity, so a depth value never makes a topology of its own.
TOPO_AXES = tuple(f.name for f in dataclasses.fields(Topology)
                  if f.name not in ("queue_size", "resp_queue_size"))


def topo_grid_points(grid: Mapping[str, Sequence]) -> List[Dict]:
    """Expand a mixed (topology x runtime) axis dict into the Cartesian
    product of override dicts, last axis fastest (:func:`grid_points`
    order). Valid axes are :data:`TOPO_AXES` (structural: channels, ranks,
    bankgroups, banks_per_group, column_bits, tiers, cxl_channels,
    mem_words, fsm_backend) plus every runtime axis of :data:`GRID_AXES`."""
    keys = list(grid)
    for k in keys:
        if k not in TOPO_AXES and k not in GRID_AXES:
            raise ValueError(
                f"unknown grid axis {k!r}; valid: {TOPO_AXES + GRID_AXES}")
        if len(grid[k]) == 0:
            raise ValueError(f"grid axis {k!r} is empty")
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


@dataclasses.dataclass
class TopoGridResult:
    """Merged result table of a multi-topology sweep, keyed by the full
    config point.

    ``points[i]`` is the axis override dict of ``results[i]`` (grid
    order); ``topologies[topo_of_point[i]]`` its hardware shape; each
    result's ``cfg`` labels its exact grid point. ``timings`` is the
    sweep's own record (see :func:`sweep_topologies`)."""

    points: List[Dict]
    results: List[SimResult]
    topologies: List[Topology]
    topo_of_point: List[int]
    timings: Dict

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i: int) -> SimResult:
        return self.results[i]

    def table(self) -> List[Dict]:
        """One row per grid point: ``{point, topology, result}``."""
        return [{"point": dict(p), "topology": self.topologies[ti],
                 "result": r}
                for p, ti, r in zip(self.points, self.topo_of_point,
                                    self.results)]

    def result_at(self, **axes) -> SimResult:
        """The unique grid point matching every given axis value."""
        hits = [i for i, p in enumerate(self.points)
                if all(p.get(k) == v for k, v in axes.items())]
        if len(hits) != 1:
            raise KeyError(
                f"{axes} matches {len(hits)} grid points (need exactly 1)")
        return self.results[hits[0]]


def _topo_lanes(cfg: MemSimConfig, trace, points: List[Dict],
                capacity: Optional[int], resp_capacity: Optional[int]):
    """The lanes of a (topology x runtime) grid, as both multi-topology
    sweeps build them: ``(lane_cfgs, traces, qs, rs, cap, rcap, scheds,
    topologies, topo_of_point, groups)``, each point's validated config,
    its trace (one broadcast or one a point), its queue depths against the
    grid-wide capacities ``cap`` / ``rcap``, its int32 schedule padded to
    the grid's segment count, and the points grouped by
    :class:`Topology`."""
    lane_cfgs = [dataclasses.replace(
        cfg, **{k: v for k, v in ov.items() if k != "schedule"}).validate()
        for ov in points]
    n_points = len(points)
    if isinstance(trace, Trace):
        trace_list = [trace] * n_points
    else:
        trace_list = list(trace)
        if len(trace_list) != n_points:
            raise ValueError(
                f"got {len(trace_list)} traces for {n_points} grid points")

    qs = [c.queue_size for c in lane_cfgs]
    rs = [c.resp_queue_size for c in lane_cfgs]
    cap = max(qs) if capacity is None else capacity
    rcap = max(rs) if resp_capacity is None else resp_capacity
    if cap < max(qs):
        raise ValueError("capacity below largest swept queue size")
    if rcap < max(rs):
        raise ValueError("resp_capacity below largest swept resp queue size")
    scheds = [_sched_i32(lane_schedule(c, ov.get("schedule")))
              for c, ov in zip(lane_cfgs, points)]
    s_max = max(sc.num_segments for sc in scheds)
    scheds = [sc.pad_to(s_max) for sc in scheds]

    topologies: List[Topology] = []
    topo_of_point: List[int] = []
    for c in lane_cfgs:
        t = dataclasses.replace(c, queue_size=cap,
                                resp_queue_size=rcap).topology()
        if t not in topologies:
            topologies.append(t)
        topo_of_point.append(topologies.index(t))
    groups = [[i for i, ti in enumerate(topo_of_point) if ti == gi]
              for gi in range(len(topologies))]
    return (lane_cfgs, trace_list, qs, rs, cap, rcap, scheds, topologies,
            topo_of_point, groups)


def sweep_topologies(cfg: MemSimConfig,
                     trace: Union[Trace, Sequence[Trace]],
                     grid: Mapping[str, Sequence],
                     num_cycles: int = 100_000,
                     *, capacity: Optional[int] = None,
                     resp_capacity: Optional[int] = None,
                     cycle_skip: bool = True,
                     max_workers: Optional[int] = None,
                     stream: Optional[bool] = None,
                     chunk_lanes: Optional[int] = None,
                     memory_budget_bytes: Optional[int] = None,
                     checkpoint_dir: Optional[str] = None,
                     resume: bool = True,
                     timings: Optional[dict] = None,
                     device=None) -> TopoGridResult:
    """Run a full (topology x runtime-params x policy x depth) grid, one
    :func:`simulate_batch` a distinct hardware shape.

    1. Expand the grid (:func:`topo_grid_points`), validate each point's
       config, set every lane's queue depths against the grid-wide
       ``capacity`` / ``resp_capacity`` (defaults: the largest swept
       depth), so a depth never splits a group, pad the schedules to one
       grid-wide segment count, and group the points by their
       :class:`Topology`.
    2. Each ``fused`` topology runs its lanes through the lane-batched
       persistent K3 (:func:`fused_run_batch`): one launch a topology on
       the card unless the run budget relaunches it. Each topology gets a
       CUDA stream of its own; the calling thread sets up a topology's
       lanes on its stream, enqueues its launch and goes on to the next
       topology's set-up without waiting, so the launches run concurrently
       on the SMs while the host works, and reads each topology's
       ``(t, steps)`` and results afterwards. Every form of the kernel is
       loaded before the first launch, so no lazy load waits for running
       launches. ``max_workers`` bounds the
       topologies in flight at once (default: all of them; 1 runs them
       one after another). On the CPU their plain versions run.
    3. ``split`` and ``plain`` topologies run after every fused launch has
       been read, through the single-lane loops (their CUDA-graph
       captures then overlap no launch).
    4. The per-lane results merge into one :class:`TopoGridResult` in grid
       order.

    Every lane is bit-exact vs a :func:`simulate_fast` run of its point.
    ``trace`` is one Trace broadcast to every point, or one Trace a point.

    ``timings`` (optional dict; also the result's ``timings``): ``compiles``
    (kernel libraries this call built, 0 when the build is warm),
    ``compile_s`` and ``compile_s_wall`` (seconds in the build),
    ``run_s`` (wall of every topology's run), ``steps`` (the most any lane
    executed), ``topologies``, ``launches`` (lane-batched K3 launches) and
    ``per_topology`` (``{topology, lanes, compile_s, run_s, steps, device,
    launches}`` a topology). ``device=None`` runs on the CUDA cards, the
    topologies placed round-robin over them
    (``repro_torch.distributed.shard.round_robin_devices``; every one on
    ``cuda:0`` with one card), and raises without a card; a ``device``
    given runs every topology there.

    Streaming: grids of at least :func:`_stream_threshold` points, or any
    call that gives a ``checkpoint_dir`` or sets ``stream=True``, route
    through :func:`repro_torch.core.sweep_stream.stream_sweep` (chunked
    lanes under a memory budget, one launch a chunk, kill/resume
    checkpointing, the kernels from ``MEMSIM_EXEC_CACHE_DIR``), bit-exact
    vs this materialising path. ``stream=False`` forces the materialising
    path.
    """
    points = topo_grid_points(grid)
    if stream is None:
        stream = (checkpoint_dir is not None
                  or len(points) >= _stream_threshold())
    if stream:
        from repro_torch.core.sweep_stream import stream_sweep

        return stream_sweep(
            cfg, trace, grid, num_cycles, capacity=capacity,
            resp_capacity=resp_capacity, cycle_skip=cycle_skip,
            max_workers=max_workers, chunk_lanes=chunk_lanes,
            memory_budget_bytes=memory_budget_bytes,
            checkpoint_dir=checkpoint_dir, resume=resume, timings=timings,
            device=device)
    dev = resolve_device(device)
    (lane_cfgs, trace_list, qs, rs, cap, rcap, scheds, topologies,
     topo_of_point, groups) = _topo_lanes(cfg, trace, points, capacity,
                                          resp_capacity)
    n_points = len(points)
    devices = [torch.device(d) for d in round_robin_devices(
        len(topologies), None if device is None else [dev])]

    built0 = build.build_count()
    t_c0 = time.perf_counter()
    if dev.type == "cuda" and any(t.fsm_backend != "plain"
                                  for t in topologies):
        build.load()
        for d in dict.fromkeys(devices[gi] for gi, t in enumerate(topologies)
                               if t.fsm_backend == "fused"):
            with torch.cuda.device(d):
                preload_batch_forms()
    compile_s = time.perf_counter() - t_c0

    def on_stream(gi: int):
        """Topology ``gi``'s stream (fused on the card), else its card."""
        s = streams.get(gi)
        if s is not None:
            return torch.cuda.stream(s)
        d = devices[gi]
        return torch.cuda.device(d) if d.type == "cuda" else nullcontext()

    def start(gi: int):
        """Set up topology ``gi``'s lanes and, fused on the card, enqueue
        its first launch on its stream."""
        idxs = groups[gi]
        gcfg = dataclasses.replace(lane_cfgs[idxs[0]], queue_size=cap,
                                   resp_queue_size=rcap)
        t0 = time.perf_counter()
        with on_stream(gi):
            done = _start_batch(
                gcfg, [trace_list[i] for i in idxs], num_cycles,
                queue_sizes=[qs[i] for i in idxs],
                resp_queue_sizes=[rs[i] for i in idxs],
                params=[scheds[i] for i in idxs],
                lane_cfgs=[lane_cfgs[i] for i in idxs],
                cycle_skip=cycle_skip, batch_mode="lanes", dev=devices[gi])
        return gi, done, t0

    def finish(started) -> None:
        gi, done, t0 = started
        tm = {}
        with on_stream(gi):
            res = done(tm)
        outs[gi] = (res, tm, time.perf_counter() - t0)

    fused = [gi for gi, t in enumerate(topologies)
             if t.fsm_backend == "fused"]
    if max_workers is None:
        max_workers = max(1, len(fused))
    streams = {}
    if dev.type == "cuda":
        here = torch.cuda.current_stream(dev)
        for gi in fused:
            streams[gi] = torch.cuda.Stream(device=devices[gi])
            # a trace the caller put on the card may still be in flight,
            # also where the lanes copy it to another card
            streams[gi].wait_stream(here)
    outs: Dict[int, tuple] = {}
    t_r0 = time.perf_counter()
    in_flight: List[tuple] = []
    for gi in fused:
        in_flight.append(start(gi))
        if len(in_flight) >= max_workers:
            finish(in_flight.pop(0))
    for started in in_flight:
        finish(started)
    # split and plain topologies after every fused launch has been read:
    # their CUDA-graph captures then overlap no launch
    for gi in range(len(topologies)):
        if gi not in outs:
            finish(start(gi))
    run_wall = time.perf_counter() - t_r0

    results: List[Optional[SimResult]] = [None] * n_points
    for gi, (res, _, _) in outs.items():
        for i, r in zip(groups[gi], res):
            results[i] = r
    per = [{"topology": dataclasses.asdict(topologies[gi]),
            "lanes": len(groups[gi]),
            "compile_s": outs[gi][1]["compile_s"],
            "run_s": outs[gi][2],
            "steps": outs[gi][1]["steps"],
            "device": str(devices[gi]),
            "launches": outs[gi][1]["launches"]}
           for gi in range(len(topologies))]
    own = {
        "compiles": build.build_count() - built0,
        "compile_s": compile_s,
        "compile_s_wall": compile_s,
        "run_s": run_wall,
        "steps": max(p["steps"] for p in per),
        "topologies": len(topologies),
        "launches": sum(p["launches"] for p in per),
        "per_topology": per,
    }
    if timings is not None:
        for k in ("compiles", "topologies", "launches"):
            timings[k] = timings.get(k, 0) + own[k]
        for k in ("compile_s", "compile_s_wall", "run_s"):
            timings[k] = timings.get(k, 0.0) + own[k]
        timings["steps"] = max(timings.get("steps", 0), own["steps"])
        timings.setdefault("per_topology", []).extend(per)
    return TopoGridResult(points=points, results=results,
                          topologies=topologies,
                          topo_of_point=topo_of_point, timings=own)
