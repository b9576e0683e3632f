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
rule :func:`serving_capacity`) on its two topologies
(:func:`serving_topologies`: 2-channel DRAM and a 2-channel tiered CXL
device), each topology's loads run as lanes of one
``run_serving_batched``: for each scenario every ``ServingResult`` field
and the digest of its lane's session result (:func:`serving_digest`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

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


def serving_capacity(request_lists, serving) -> int:
    """The study's session capacity: the most arrivals any scenario can
    emit, plus 64, rounded up to a power of two (``serving`` a
    ``ServingConfig`` of either package)."""

    def emissions(reqs):
        return sum((-(-r.prompt_tokens // serving.prefill_tokens_per_step))
                   * serving.weight_reads_per_token
                   + r.prompt_tokens * 32
                   + r.decode_tokens * (serving.weight_reads_per_token
                                        + serving.kv_reads_per_token + 32)
                   for r in reqs)

    need = max((emissions(r) for r in request_lists), default=1) + 64
    return 1 << max(need - 1, 1).bit_length()


def cxl_tier_point(cfg, interleave_log2: int, cxl_frac_log2: int, *,
                   latency_adder: int = 30, link_ccd_scale: int = 2,
                   refi_scale: int = 1):
    """The port's twin of the reference's
    ``perfmodel.effective_bw.cxl_tier_point``: a tier-stacked parameter
    point whose tier 0 is ``cfg``'s DRAM timing and tier 1 the CXL
    expander's (a link-latency adder on the access path, the
    column-to-column gaps stretched by ``link_ccd_scale``, refresh
    ``tREFI / refi_scale``)."""
    from repro_torch.core.params import tiered_params

    dram = cfg.runtime()._replace(tier_interleave_log2=interleave_log2,
                                  tier_cxl_frac_log2=cxl_frac_log2)
    cxl = dram._replace(
        tCL=dram.tCL + latency_adder,
        tRCDRD=dram.tRCDRD + latency_adder,
        tRCDWR=dram.tRCDWR + latency_adder,
        tCCDL=dram.tCCDL * link_ccd_scale,
        tWTR=dram.tWTR * link_ccd_scale,
        tRTW=dram.tRTW * link_ccd_scale,
        tREFI=max(dram.tREFI // max(refi_scale, 1), dram.tRFC + 1),
    )
    return tiered_params(dram, cxl)


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


def load() -> Dict[str, Dict]:
    return json.loads(GOLDEN_PATH.read_text())


def load_batch() -> Dict[str, Dict]:
    return json.loads(BATCH_GOLDEN_PATH.read_text())


def load_serving() -> Dict[str, Dict]:
    return json.loads(SERVING_GOLDEN_PATH.read_text())


def mismatches(expected: Dict, got: Dict) -> list:
    """Keys whose values differ (empty when the digests agree)."""
    return sorted(k for k in set(expected) | set(got)
                  if expected.get(k) != got.get(k))
