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


def load() -> Dict[str, Dict]:
    return json.loads(GOLDEN_PATH.read_text())


def load_batch() -> Dict[str, Dict]:
    return json.loads(BATCH_GOLDEN_PATH.read_text())


def mismatches(expected: Dict, got: Dict) -> list:
    """Keys whose values differ (empty when the digests agree)."""
    return sorted(k for k in set(expected) | set(got)
                  if expected.get(k) != got.get(k))
