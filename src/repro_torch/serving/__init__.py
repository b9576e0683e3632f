"""Closed-loop LLM serving co-simulation on top of the windowed engine,
the PyTorch counterpart of ``repro.serving`` (the scheduler and pager are
host-side Python and numpy; the memory system runs in the port's
sessions, on the card by default).

The missing feedback loop the paper's co-simulation framing implies:
instead of fixing every memory request before the first cycle runs
(``traces/llm_workload.py``, open-loop), a continuous-batching scheduler
emits each window's address stream from what the memory system actually
completed in the previous window:

    scheduler -> addresses -> SimSession.advance -> completions -> scheduler

* :mod:`repro_torch.serving.workload` — request processes (Poisson / bursty /
  diurnal arrivals) and prompt/decode length mixtures: the *scenario* axis.
* :mod:`repro_torch.serving.kv_pager`  — paged KV-cache manager: block
  allocation/eviction and tier-aware placement (the DRAM/CXL tier flags).
* :mod:`repro_torch.serving.scheduler` — admission queue, prefill/decode
  interleave, join-at-sequence-boundary continuous batching, and AIMD
  admission control on memory backpressure; plus :func:`run_serving`, the
  closed-loop driver.
"""

from repro_torch.serving.kv_pager import KVPager, PageState
from repro_torch.serving.scheduler import (
    ContinuousBatchScheduler,
    ServingConfig,
    ServingResult,
    observe_batch,
    plan_window_batch,
    run_serving,
    run_serving_batched,
)
from repro_torch.serving.workload import (
    Request,
    generate_request_batch,
    generate_requests,
    spawn_seeds,
)

__all__ = [
    "ContinuousBatchScheduler",
    "KVPager",
    "PageState",
    "Request",
    "ServingConfig",
    "ServingResult",
    "generate_request_batch",
    "generate_requests",
    "observe_batch",
    "plan_window_batch",
    "run_serving",
    "run_serving_batched",
    "spawn_seeds",
]
