"""Golden digests of the JAX reference (src/repro_torch/golden).

The digests let the card run of the port (``chip_smoke.py``) be held
against the reference without JAX on that machine. This test recomputes
them with ``repro.core.simulate_fast`` and asserts the committed file is
current, and holds the port's CPU ``simulate_fast`` against the
``conv2d@20000`` digest. The batch digests (each lane of the Table-2 batch
and of the Figs 6-9 queue sweep) are recomputed with the reference's
``simulate_batch`` / ``sweep_queue_sizes`` in ``batch_mode="lanes"``; each
Table-2 lane equals its single-lane digest. The serving digests (the
closed-loop serving study's eight scenarios) are recomputed with the
reference's ``run_serving_batched``, one batch a topology. Of the
perfmodel file (every study's rows and the small ``sweep_topologies``
grid's lane digests) the test recomputes ``decode_efficiency`` and the
grid, and holds the rest to the arguments the file records.

Regenerate the file with::

    PYTHONPATH=src python tests/test_torch_golden.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.core import simulate_batch as jax_simulate_batch  # noqa: E402
from repro.core import simulate_ideal as jax_simulate_ideal  # noqa: E402
from repro.core import sweep_queue_sizes as jax_sweep_queue_sizes  # noqa: E402
from repro.perfmodel.effective_bw import \
    cxl_tier_point as jax_cxl_tier_point  # noqa: E402
from repro.serving import ServingConfig as JaxServingConfig  # noqa: E402
from repro.serving import \
    generate_request_batch as jax_generate_request_batch  # noqa: E402
from repro.serving import \
    run_serving_batched as jax_run_serving_batched  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
import repro.core as jax_core  # noqa: E402
from repro.perfmodel import effective_bw as jax_effective_bw  # noqa: E402
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


def batch_reference_digests():
    out = {}
    batch, cycles = golden.TABLE2_BATCH
    names = sorted(JAX_BENCHMARKS)
    traces = [JAX_BENCHMARKS[n]() for n in names]
    tm = {}
    results = jax_simulate_batch(
        JaxConfig(queue_size=golden.BATCH_CAPACITY), traces, cycles,
        queue_sizes=[golden.QUEUE_SIZE] * len(traces), batch_mode="lanes",
        timings=tm)
    for name, tr, res, lane in zip(names, traces, results, tm["per_lane"]):
        ideal = np.asarray(jax_simulate_ideal(
            JaxConfig(queue_size=golden.QUEUE_SIZE), tr).t_complete)
        out[golden.batch_key(batch, name, cycles)] = golden.result_digest(
            res, ideal, lane["steps"])
    batch, cycles = golden.FIG_SWEEP
    tm = {}
    results = jax_sweep_queue_sizes(
        JaxConfig(), JAX_BENCHMARKS["conv2d"](burst_gap=golden.FIG_BURST_GAP),
        list(golden.SWEEP_F8), cycles, capacity=golden.BATCH_CAPACITY,
        batch_mode="lanes", timings=tm)
    for q, res, lane in zip(golden.SWEEP_F8, results, tm["per_lane"]):
        out[golden.batch_key(batch, f"q{q}", cycles)] = golden.result_digest(
            res, None, lane["steps"])
    return out


def serving_reference_digests():
    serving = JaxServingConfig()
    lists = jax_generate_request_batch(golden.serving_scenarios(),
                                       seed=golden.SERVING_SEED,
                                       independent_streams=False)
    capacity = golden.serving_capacity(lists, serving)
    cxl = JaxConfig(channels=2, tiers=2, cxl_channels=1)
    topologies = {
        "dram": (JaxConfig(channels=2), None),
        "cxl": (cxl, jax_cxl_tier_point(cxl, cxl.tier_interleave_log2,
                                        cxl.tier_cxl_frac_log2,
                                        **golden.SERVING_CXL))}
    out = {}
    for name in golden.SERVING_TOPOLOGIES:
        cfg, params = topologies[name]
        results = jax_run_serving_batched(
            cfg, lists, serving, params=params,
            window_cycles=golden.SERVING_WINDOW, capacity=capacity,
            seed=golden.SERVING_SEED)
        for load, res in zip(golden.SERVING_LOADS, results):
            out[golden.serving_key(name, load)] = golden.serving_digest(
                res, capacity)
    return out


def test_serving_golden_file_is_current():
    assert golden.load_serving() == serving_reference_digests()


def test_perfmodel_golden_file_is_current():
    """The arguments the file records are the generator's; the reference's
    ``decode_efficiency`` row and the small grid's lane digests, recomputed,
    equal the file's; the rows of every study are there."""
    want = golden.load_perfmodel()
    assert want["args"] == golden.perfmodel_args()
    assert set(want["rows"]) == set(golden.perfmodel_calls())
    assert all(want["rows"][s] for s in want["rows"])
    assert all(r["bit_identical"] for r in want["rows"]["cxl_tier_study"])
    assert want["rows"]["decode_efficiency"] == golden.perfmodel_rows(
        jax_effective_bw, "decode_efficiency")
    assert want["topo_grid"] == golden.topo_grid_digests(
        jax_core.sweep_topologies, JaxConfig,
        JAX_BENCHMARKS[golden.TOPO_GRID_TRACE]())


def test_batch_golden_file_is_current():
    assert golden.load_batch() == batch_reference_digests()


def test_table2_batch_lanes_equal_single_lane_digests():
    """A lane of the batch (queue 128 on buffers of 2048) is the
    single-lane run at queue 128, its steps included."""
    batch, cycles = golden.TABLE2_BATCH
    single, lanes = golden.load(), golden.load_batch()
    for name in sorted(BENCHMARKS):
        assert lanes[golden.batch_key(batch, name, cycles)] == \
            single[golden.case_key(name, cycles)], name


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
    for path, digests in ((golden.GOLDEN_PATH, reference_digests),
                          (golden.BATCH_GOLDEN_PATH,
                           batch_reference_digests),
                          (golden.SERVING_GOLDEN_PATH,
                           serving_reference_digests)):
        path.write_text(json.dumps(digests(), indent=1, sort_keys=True)
                        + "\n")
        print(f"wrote {path}")
    golden.PERFMODEL_GOLDEN_PATH.write_text(json.dumps(
        golden.perfmodel_reference(jax_core, jax_effective_bw,
                                   JAX_BENCHMARKS),
        indent=1, sort_keys=True) + "\n")
    print(f"wrote {golden.PERFMODEL_GOLDEN_PATH}")
