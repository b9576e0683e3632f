"""Trace generation: the paper's four microbenchmarks and DRAMSim3 trace
files."""

from repro_torch.traces.microbench import (
    BENCHMARKS,
    conv2d,
    make,
    multihead_attention,
    trace_example,
    vector_similarity,
)
from repro_torch.traces.io import load_trace, save_session_trace, save_trace

__all__ = [
    "BENCHMARKS",
    "conv2d",
    "make",
    "multihead_attention",
    "trace_example",
    "vector_similarity",
    "load_trace",
    "save_session_trace",
    "save_trace",
]
