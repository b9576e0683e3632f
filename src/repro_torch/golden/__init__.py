"""Golden digests of the JAX reference's results on the main path.

``jax_reference.json`` holds, for each case (a benchmark trace at
``queue_size=128`` over a horizon, on the event-horizon engine), a digest
of the reference's :class:`SimResult`: the sha256 of the int32 bytes of
every per-request record, the counters, the blocked-cycle totals, the
executed step count and the Table-2 row against the ideal model.
``tests/test_torch_golden.py`` recomputes them from the reference package
and asserts the file is current; ``chip_smoke.py`` holds the port's card
runs against them, so the card run needs no JAX.

``jax_batch_reference.json`` holds the same digests of each lane of two
batches the reference runs in ``batch_mode="lanes"``: the Table-2 batch
(:data:`TABLE2_BATCH`: the four traces at queue 128 on buffers of
capacity :data:`BATCH_CAPACITY`, with the Table-2 row) and the Figs 6-9
queue sweep (:data:`FIG_SWEEP`: conv2d overloaded at ``burst_gap``
:data:`FIG_BURST_GAP`, the :data:`SWEEP_F8` depths, capacity
:data:`BATCH_CAPACITY`; no ideal model, so no Table-2 row), each with its
executed steps.

``jax_serving_reference.json`` holds the closed-loop serving study of the
reference's ``perfmodel.effective_bw.serving_study`` at its defaults
(:data:`SERVING_LOADS` of the :data:`SERVING_MIXTURE` mixture, Poisson
arrivals, horizon :data:`SERVING_HORIZON`, windows of
:data:`SERVING_WINDOW`, seed :data:`SERVING_SEED`, the study's capacity
rule ``perfmodel.effective_bw.serving_capacity``) on its two topologies
(:func:`serving_topologies`: 2-channel DRAM and a 2-channel tiered CXL
device), each topology's loads run as lanes of one
``run_serving_batched``: for each scenario every ``ServingResult`` field
and the digest of its lane's session result (:func:`serving_digest`).

``jax_perfmodel_reference.json`` holds the reference's
``perfmodel.effective_bw`` studies at the arguments of
:func:`perfmodel_calls` (qwen3-14b's streams, :data:`PERF_LLM`): every
row of ``decode_efficiency``, ``train_efficiency``, ``llm_grid_study``,
``topo_llm_grid_study``, ``dvfs_llm_study``, ``cxl_tier_study`` and
``serving_study`` in :func:`canonical` form, and the digest of each lane
of the small ``sweep_topologies`` grid :data:`TOPO_GRID`.
:func:`perfmodel_reference` makes it from either package, so the card
runs the same calls the file was made with.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.perfmodel.effective_bw import (  # noqa: F401
    cxl_tier_point,
    serving_capacity,
)

GOLDEN_PATH = Path(__file__).resolve().parent / "jax_reference.json"
BATCH_GOLDEN_PATH = GOLDEN_PATH.with_name("jax_batch_reference.json")
RECORDS = ("t_admit", "t_dispatch", "t_start", "t_complete", "rdata")
#: (trace name, horizon) of every golden case, all at queue_size=128
CASES = (("conv2d", 100_000), ("multihead_attention", 100_000),
         ("trace_example", 100_000), ("vector_similarity", 100_000),
         ("conv2d", 20_000))
QUEUE_SIZE = 128

#: the static queue capacity of both batches (the largest Fig 8 depth)
BATCH_CAPACITY = 2048
#: (batch name, horizon) of the Table-2 batch: the four traces at
#: queue QUEUE_SIZE
TABLE2_BATCH = ("table2_batch", 100_000)
#: (batch name, horizon) of the Figs 6-9 queue sweep (the benchmarks' smoke
#: horizon), over the SWEEP_F8 depths on conv2d at FIG_BURST_GAP
FIG_SWEEP = ("fig_sweep", 20_000)
SWEEP_F8 = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
FIG_BURST_GAP = 18


SERVING_GOLDEN_PATH = GOLDEN_PATH.with_name("jax_serving_reference.json")
#: the serving study's defaults (offered loads in requests a kilocycle)
SERVING_LOADS = (0.5, 1.0, 2.0, 4.0)
SERVING_MIXTURE = "chat"
SERVING_PROCESS = "poisson"
SERVING_HORIZON = 10_000
SERVING_WINDOW = 400
SERVING_SEED = 0
#: the CXL tier's link penalty in the study's tiered topology
SERVING_CXL = dict(latency_adder=200, link_ccd_scale=8)
SERVING_TOPOLOGIES = ("dram", "cxl")


def case_key(name: str, num_cycles: int) -> str:
    return f"{name}@{num_cycles}"


def batch_key(batch: str, lane: str, num_cycles: int) -> str:
    """A lane's key: the trace name (Table-2 batch) or ``q<depth>`` (Fig
    sweep)."""
    return f"{batch}/{lane}@{num_cycles}"


def _sha(x) -> str:
    a = np.ascontiguousarray(np.asarray(x).astype(np.int32))
    return hashlib.sha256(a.tobytes()).hexdigest()


def result_digest(res, ideal_t_complete, steps: Optional[int] = None
                  ) -> Dict:
    """Digest of a SimResult of either package (numpy fields); without an
    ideal model's completions (``None``), no Table-2 row."""
    from repro_torch.core.stats import cycle_diffs

    d = {f: _sha(getattr(res, f)) for f in RECORDS}
    d["counters"] = {k: np.asarray(v).astype(np.int64).reshape(-1).tolist()
                     for k, v in sorted(res.counters.items())}
    d["blocked_arrival"] = int(res.blocked_arrival)
    d["blocked_dispatch"] = int(res.blocked_dispatch)
    if ideal_t_complete is not None:
        d["ideal_t_complete"] = _sha(ideal_t_complete)
        d["table2"] = dataclasses.asdict(
            cycle_diffs(res, np.asarray(ideal_t_complete)))
    if steps is not None:
        d["steps"] = int(steps)
    return d


def serving_key(topology: str, load: float) -> str:
    return f"{topology}/{SERVING_MIXTURE}@{load}"


def serving_scenarios() -> list:
    """The study's scenarios, one ``generate_requests`` kwargs dict a load
    (every lane reuses :data:`SERVING_SEED`)."""
    return [dict(process=SERVING_PROCESS, mixture=SERVING_MIXTURE,
                 rate_per_kcycle=load, horizon=SERVING_HORIZON)
            for load in SERVING_LOADS]


def serving_topologies() -> list:
    """The study's ``(name, MemSimConfig, params)`` topologies in the port:
    2-channel DRAM, and the 2-channel tiered device with one CXL channel
    and the :data:`SERVING_CXL` link penalty."""
    from repro_torch.core.params import MemSimConfig

    cxl = MemSimConfig(channels=2, tiers=2, cxl_channels=1)
    return [("dram", MemSimConfig(channels=2), None),
            ("cxl", cxl, cxl_tier_point(cxl, cxl.tier_interleave_log2,
                                        cxl.tier_cxl_frac_log2,
                                        **SERVING_CXL))]


def serving_digest(res, capacity: int) -> Dict:
    """Every field of a ``ServingResult`` of either package, and the
    digest of its session's result and realized trace."""
    trace = res.session.trace()
    return {
        "offered": int(res.offered), "completed": int(res.completed),
        "tokens": int(res.tokens), "cycles": int(res.cycles),
        "tokens_per_kcycle": float(res.tokens_per_kcycle),
        "admitted_batch": [int(x) for x in res.admitted_batch],
        "batch_target": [float(x) for x in res.batch_target],
        "queueing": np.asarray(res.queueing).astype(np.int64).tolist(),
        "service": np.asarray(res.service).astype(np.int64).tolist(),
        "capacity": int(capacity),
        "arrivals_total": int(res.session.arrivals_total),
        "session_cycle": int(res.session.cycle),
        "trace": {f: _sha(getattr(trace, f)) for f in ("t", "addr",
                                                        "is_write")},
        "session": result_digest(res.session.result(), None),
    }


PERFMODEL_GOLDEN_PATH = GOLDEN_PATH.with_name("jax_perfmodel_reference.json")
#: the LLM streams of the studies: qwen3-14b, its 29.54 GB of bfloat16
#: weights on one device, 0.5 GB of KV cache and 0.3 GB of activations a
#: step (positional: arch, params, KV and activation bytes per device)
PERF_LLM = ("qwen3-14b", 29.54e9, 0.5e9, 0.3e9)
#: the runtime grid of ``llm_grid_study``: 3 streams x 4 points
PERF_GRID = {"page_policy": ["closed", "open"], "tREFI": [3600, 7200]}
#: the hardware-shape grid of ``topo_llm_grid_study``: 2 streams x 8
#: points, 4 topologies
PERF_TOPO_GRID = {"channels": [1, 2], "banks_per_group": [2, 4],
                  "tCL": [14, 18]}
#: the small ``sweep_topologies`` grid whose lanes the file digests: 3
#: topologies x 4 runtime lanes on :data:`TOPO_GRID_TRACE` at
#: :data:`TOPO_GRID_CYCLES`, capacity the largest depth
TOPO_GRID = {"ranks": [1, 2, 4], "tCL": [14, 18], "queue_size": [32, 128]}
TOPO_GRID_TRACE = "conv2d"
TOPO_GRID_CYCLES = 20_000


def perfmodel_calls() -> Dict[str, list]:
    """``{study: [positional args, keyword args]}`` of every study the
    perfmodel file holds, each a function of ``perfmodel.effective_bw``
    of the same name, at its defaults but for the LLM streams' bytes and
    the grids."""
    arch, params, kv, act = PERF_LLM
    return {
        "decode_efficiency": [[arch, params, kv], {}],
        "train_efficiency": [[arch, params, act], {}],
        "llm_grid_study": [[arch, params, kv, act, PERF_GRID], {}],
        "topo_llm_grid_study": [[arch, params, kv, act, PERF_TOPO_GRID],
                                {}],
        "dvfs_llm_study": [[arch, params, kv, act], {}],
        "cxl_tier_study": [[], {}],
        "serving_study": [[], {}],
    }


def perfmodel_args() -> Dict:
    """Every argument the perfmodel file was made with (JSON form)."""
    return canonical({"studies": perfmodel_calls(),
                      "topo_grid": {"grid": TOPO_GRID,
                                    "trace": TOPO_GRID_TRACE,
                                    "num_cycles": TOPO_GRID_CYCLES}})


def canonical(x):
    """``x`` in the JSON form the golden files hold: dataclasses as dicts,
    tuples as lists, numpy scalars as Python numbers, and NaN as the
    string ``"nan"`` (so two rows compare equal with ``==``)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {str(k): canonical(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canonical(v) for v in x]
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def perfmodel_rows(effective_bw, study: str, **kw):
    """The rows of ``study`` (a key of :func:`perfmodel_calls`) run through
    ``effective_bw``, the ``perfmodel.effective_bw`` module of either
    package, in :func:`canonical` form; ``kw`` (the port's ``device`` and
    ``timings``) go to the study."""
    args, kwargs = perfmodel_calls()[study]
    return canonical(getattr(effective_bw, study)(*args, **kwargs, **kw))


def topo_lane_key(point: Dict) -> str:
    return ",".join(f"{k}={v}" for k, v in point.items())


def topo_grid_digests(sweep_topologies, config, trace, **kw) -> Dict:
    """``{lane key: result_digest}`` of the small grid (:data:`TOPO_GRID`)
    run by ``sweep_topologies`` of either package, ``config`` its
    ``MemSimConfig`` class, over ``trace`` (that package's
    :data:`TOPO_GRID_TRACE`); ``kw`` (the port's ``device``, ``timings``)
    go to the sweep."""
    sweep = sweep_topologies(config(), trace, TOPO_GRID, TOPO_GRID_CYCLES,
                             **kw)
    return {topo_lane_key(p): result_digest(r, None)
            for p, r in zip(sweep.points, sweep.results)}


def perfmodel_reference(core, effective_bw, benchmarks) -> Dict:
    """The perfmodel file's contents from one package: its ``core``,
    ``perfmodel.effective_bw`` and ``traces.BENCHMARKS``: the arguments,
    every study's rows and the small grid's lane digests."""
    return {"args": perfmodel_args(),
            "rows": {s: perfmodel_rows(effective_bw, s)
                     for s in perfmodel_calls()},
            "topo_grid": topo_grid_digests(core.sweep_topologies,
                                           core.MemSimConfig,
                                           benchmarks[TOPO_GRID_TRACE]())}


def load() -> Dict[str, Dict]:
    return json.loads(GOLDEN_PATH.read_text())


def load_batch() -> Dict[str, Dict]:
    return json.loads(BATCH_GOLDEN_PATH.read_text())


def load_serving() -> Dict[str, Dict]:
    return json.loads(SERVING_GOLDEN_PATH.read_text())


def load_perfmodel() -> Dict:
    return json.loads(PERFMODEL_GOLDEN_PATH.read_text())


def mismatches(expected: Dict, got: Dict) -> list:
    """Keys whose values differ (empty when the digests agree)."""
    return sorted(k for k in set(expected) | set(got)
                  if expected.get(k) != got.get(k))
