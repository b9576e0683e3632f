"""Event-horizon engine, single lane: PyTorch counterpart of the
single-lane part of ``repro.core.engine``.

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
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

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
from repro_torch.kernels import build
from repro_torch.kernels.bank_fsm.fused import (
    DEFAULT_RUN_BUDGET, fused_run_cuda, fused_step_plain)

_INF = 0x3FFFFFFF
_PAD_T = 0x3FFFFFFF  # arrival time for padded trace slots: never due


def _cap(b: torch.Tensor, x) -> torch.Tensor:
    """``min(b, x)`` for ``x`` a host int or a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        return torch.minimum(b, x)
    return b.clamp(max=x)


def _event_bound(topo, view: ScheduleView, trace: Trace, state: SimState,
                 nxt, horizon: int, seg: Optional[int] = None
                 ) -> torch.Tensor:
    """Number of provably inert cycles starting at ``nxt`` (0-d tensor),
    without the global-queue pre-gate of :func:`_next_event`. ``nxt`` is a
    host int or a 0-d device tensor; ``seg`` its schedule segment (resolved
    from a host ``nxt`` when omitted)."""
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
                nxt, horizon: int, seg: Optional[int] = None
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


def _skip_step(topo, view: ScheduleView, trace: Trace, horizon: int,
               seg: int, seg_next: int, state: SimState, cycle
               ) -> Tuple[SimState, torch.Tensor]:
    """One executed cycle of the event-horizon engine at ``cycle`` (segment
    ``seg``; ``seg_next`` is the segment of ``cycle + 1``) on the split or
    plain backend: the clock edge, the distance ``delta`` to the next
    event, and the skip over it."""
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


def _run_skip_core(topo, view: ScheduleView, trace: Trace, num_cycles: int,
                   state: SimState) -> Tuple[SimState, int, int]:
    """Event-driven loop: execute one cycle per event, then jump the clock
    to the next event horizon. Returns (final state, executed steps, K3
    launches).

    The fused backend runs :func:`fused_run` launches until the horizon,
    reading ``(t, steps)`` once per launch. The others read ``delta`` on
    the host once per executed cycle; on the card such a cycle is a
    CUDA-graph replay of :func:`_skip_step` (one graph per schedule
    segment; the last cycle before a boundary, whose bound is taken under
    the next segment, runs eagerly)."""
    if topo.fsm_backend == "fused":
        return (state, *fused_cycles(topo, view, trace, state, 0, num_cycles,
                                     cycle_skip=True))
    graphs = graphs_lib.graphs_for(state)
    t, steps = 0, 0
    while t < num_cycles:
        seg, seg_next = view.segment_at(t), view.segment_at(t + 1)
        fn = functools.partial(_skip_step, topo, view, trace, num_cycles,
                               seg, seg_next)
        replayed = graphs is not None and seg == seg_next
        if replayed:
            delta = graphs.step(seg, t, fn)
        else:
            state, delta = fn(graphs.state if graphs else state, t)
            if graphs is not None:
                graphs.adopt(state)
        d = int(delta)  # the one host synchronisation per executed cycle
        t += 1 + d
        steps += 1
        if replayed:
            graphs.advanced_to(t)
    return (graphs.state if graphs is not None else state), steps, 0


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
