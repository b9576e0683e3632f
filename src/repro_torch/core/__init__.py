"""MemorySim core on PyTorch: the cycle-accurate DRAM subsystem simulator
and the DRAMSim3-like open-page reference it is evaluated against."""

from repro_torch.core.params import (
    DEFAULT_CONFIG,
    MemSimConfig,
    ParamSchedule,
    RuntimeParams,
    Topology,
    as_schedule,
)
from repro_torch.core.simulator import SimResult, Trace, simulate
from repro_torch.core.engine import (
    GRID_AXES,
    TOPO_AXES,
    TopoGridResult,
    aot_cache_stats,
    grid_points,
    lane_schedule,
    simulate_batch,
    simulate_fast,
    stack_traces,
    sweep_grid,
    sweep_queue_sizes,
    sweep_topologies,
    topo_grid_points,
)
from repro_torch.core.sweep_stream import stream_sweep
from repro_torch.core.session import SimSession, WindowReport
from repro_torch.core.session_batch import SessionBatch, SessionLane
from repro_torch.core.ideal import ideal_latencies, simulate_ideal
from repro_torch.core import stats

__all__ = [
    "DEFAULT_CONFIG",
    "MemSimConfig",
    "ParamSchedule",
    "RuntimeParams",
    "Topology",
    "as_schedule",
    "SimResult",
    "Trace",
    "simulate",
    "simulate_fast",
    "simulate_batch",
    "stack_traces",
    "sweep_queue_sizes",
    "GRID_AXES",
    "lane_schedule",
    "grid_points",
    "sweep_grid",
    "TOPO_AXES",
    "topo_grid_points",
    "TopoGridResult",
    "sweep_topologies",
    "stream_sweep",
    "aot_cache_stats",
    "SimSession",
    "WindowReport",
    "SessionBatch",
    "SessionLane",
    "simulate_ideal",
    "ideal_latencies",
    "stats",
]
