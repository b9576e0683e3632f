"""Trace generation: the paper's four microbenchmarks, LLM workload
streams and DRAMSim3 trace files."""

from repro_torch.traces.microbench import (
    BENCHMARKS,
    conv2d,
    make,
    multihead_attention,
    trace_example,
    vector_similarity,
)
from repro_torch.traces.io import load_trace, save_session_trace, save_trace
from repro_torch.traces import llm_workload

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
    "llm_workload",
]
