"""Golden digests of the JAX reference (src/repro_torch/golden).

The digests let the card run of the port (``chip_smoke.py``) be held
against the reference without JAX on that machine. This test recomputes
them with ``repro.core.simulate_fast`` and asserts the committed file is
current, and holds the port's CPU ``simulate_fast`` against the
``conv2d@20000`` digest.

Regenerate the file with::

    PYTHONPATH=src python tests/test_torch_golden.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.core import simulate_ideal as jax_simulate_ideal  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch.core import MemSimConfig, simulate_fast, simulate_ideal  # noqa: E402
from repro_torch.traces import BENCHMARKS  # noqa: E402


def reference_digests():
    out = {}
    cfg = JaxConfig(queue_size=golden.QUEUE_SIZE)
    for name, num_cycles in golden.CASES:
        trace = JAX_BENCHMARKS[name]()
        tm = {}
        res = jax_simulate_fast(cfg, trace, num_cycles, timings=tm)
        ideal = np.asarray(jax_simulate_ideal(cfg, trace).t_complete)
        out[golden.case_key(name, num_cycles)] = golden.result_digest(
            res, ideal, tm["steps"])
    return out


def test_golden_file_is_current():
    assert golden.load() == reference_digests()


def test_port_cpu_matches_conv2d_20k_digest():
    """The port's event-horizon engine on the CPU, default (fused) backend,
    against the reference digest: every record, counter, the step count
    and the Table-2 row."""
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    trace = BENCHMARKS["conv2d"]()
    tm = {}
    res = simulate_fast(cfg, trace, 20_000, timings=tm, device="cpu")
    ideal = simulate_ideal(cfg, trace, device="cpu").t_complete.numpy()
    got = golden.result_digest(res, ideal, tm["steps"])
    expected = golden.load()[golden.case_key("conv2d", 20_000)]
    assert golden.mismatches(expected, got) == []


if __name__ == "__main__":
    golden.GOLDEN_PATH.write_text(
        json.dumps(reference_digests(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {golden.GOLDEN_PATH}")
