"""CUDA-graph replay of one simulated cycle.

On the card the split and plain backends' cycle loops are bound by the
host: an executed cycle is a few hundred small kernels (the PyTorch glue
around K1/K2), each costing microseconds of Python and dispatch on the host
but about a microsecond on the device. (The fused backend runs both
engines in K3's persistent form and captures no graph.)
:class:`StepGraphs` captures one cycle — the same step function the CPU
runs eagerly — as a CUDA graph and replays it, so a cycle costs one graph
launch on the host.

A graph is captured per schedule segment: the step bakes in what the host
resolves per segment (the active parameters, the FR-FCFS branch, the
segment's counter slot). The cycle number is read on the device from
``StepGraphs.cycle``, which the graph itself advances by ``1 + delta``,
and the event-horizon step's horizon from ``StepGraphs.horizon``, which
the host fills before each run or window, so one capture serves every
window of a session.
The live :class:`SimState` tensors are the graph's static inputs: the step
updates the large buffers in place and the graph copies every other new
register back into them, so after a replay ``StepGraphs.state`` is the
state after the cycle.

Kernel launch counts (``repro_torch.kernels.build.LAUNCHES``): the warm-up
run and the capture are not counted; each replay adds the kernel launches
captured in its graph.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core.params import I32
from repro_torch.kernels import build


def _leaves(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _leaves(getattr(obj, f))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k])


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if hasattr(obj, "_fields"):
        return type(obj)(*[_clone(getattr(obj, f)) for f in obj._fields])
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


def copy_into(static, new) -> None:
    """Copy every register of ``new`` into the matching tensor of
    ``static`` (skipping the buffers that are already the same tensor)."""
    for s, n in zip(_leaves(static), _leaves(new)):
        if n is not s:
            s.copy_(n)


StepFn = Callable[[object, torch.Tensor], Tuple[object, Optional[torch.Tensor]]]


class StepGraphs:
    """CUDA graphs of one cycle step, one per key (schedule segment).

    ``fn(state, cycle)`` runs one cycle on ``state`` with ``cycle`` a 0-d
    int32 device tensor and returns ``(new_state, delta)``: ``delta`` the
    0-d skip the cycle computed (the graph advances the clock by
    ``1 + delta``), or ``None`` for a plain per-cycle step (advance 1).
    """

    def __init__(self, state):
        self.state = state
        self.cycle = torch.zeros((), dtype=I32, device=state.mem.device)
        self.horizon = torch.zeros((), dtype=I32, device=state.mem.device)
        self._device_t: Optional[int] = 0
        self._graphs: Dict[object, tuple] = {}

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per key)."""
        return len(self._graphs)

    def adopt(self, new_state) -> None:
        """Make ``new_state`` (from an eager step) the live state."""
        copy_into(self.state, new_state)

    def advanced_to(self, t: int) -> None:
        """Tell the helper the cycle the last replay advanced to."""
        self._device_t = t

    def step(self, key, t: int, fn: StepFn) -> Optional[torch.Tensor]:
        """Replay the graph of ``key`` for cycle ``t`` (capturing it on
        first use); returns the device ``delta`` (or ``None``)."""
        if self._device_t != t:
            self.cycle.fill_(t)
        if key not in self._graphs:
            self._graphs[key] = self._capture(fn)
        graph, delta, launches = self._graphs[key]
        graph.replay()
        for k, n in launches.items():
            build.LAUNCHES[k] += n
        self._device_t = t + 1 if delta is None else None
        return delta

    def _capture(self, fn: StepFn):
        counted = dict(build.LAUNCHES)
        # warm up on a scratch copy, on a side stream, so lazy
        # initialisation happens outside the capture and the live state is
        # untouched
        scratch, cyc = _clone(self.state), self.cycle.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(scratch, cyc)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new, delta = fn(self.state, self.cycle)
            copy_into(self.state, new)
            if delta is None:
                self.cycle.add_(1)
            else:
                self.cycle.add_(delta + 1)
        launches = {k: build.LAUNCHES[k] - before[k] for k in before}
        build.LAUNCHES.update(counted)
        return graph, delta, launches


def graphs_for(state) -> Optional[StepGraphs]:
    """Graph replay for a state on the card, ``None`` (eager steps) for a
    state on the CPU."""
    return StepGraphs(state) if state.mem.is_cuda else None
