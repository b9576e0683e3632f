"""The effective-bandwidth studies of the port
(``repro_torch.perfmodel.effective_bw``) on the CPU against the JAX
reference's ``repro.perfmodel.effective_bw``: every row of each study,
compared in the golden files' JSON form (``golden.canonical``: NaN as a
string, so a NaN row compares equal).

Cases: ``saturation_knee`` and ``serving_row`` on the same inputs (a
curve that scales, one with a knee, an idle and a non-finite one; a
result with completions and an all-blocked one); ``_row_from_result`` on a
``SimResult`` of the reference (and on one where nothing completed); and
``grid_study``, ``dvfs_study``, ``topo_grid_study``, ``cxl_tier_study``
(``bit_check=False``) and ``serving_study`` at a tiny size (at most 24
requests a stream and 200 tail cycles; the serving loop at two loads of
one request each, in windows of 400), each one lane-batched launch (one
a topology for the topology study) on the port's side; their streaming
options, streamed where the reference streams and equal to
``stream=False``. ``measure`` (the per-cycle simulate
over 200 000 cycles) is held on the card (``chip_smoke.py`` phase 15)
against the reference's rows in ``golden/jax_perfmodel_reference.json``.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.perfmodel import effective_bw as jeb  # noqa: E402
from repro.serving import ServingConfig as JaxServingConfig  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro.traces import llm_workload as jax_llm  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch.core import MemSimConfig  # noqa: E402
from repro_torch.perfmodel import effective_bw as teb  # noqa: E402
from repro_torch.serving import ServingConfig  # noqa: E402
from repro_torch.traces import llm_workload  # noqa: E402

#: a tiny stream: few requests and a short drained tail
TINY = dict(target_requests=24, tail_cycles=200)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def streams(llm, names=("decode", "train")):
    """Named qwen3-14b streams of one package's ``llm_workload``."""
    arch, params, kv, act = golden.PERF_LLM
    make = {"decode": lambda: llm.decode_step_traffic(arch, params, kv),
            "prefill": lambda: llm.prefill_step_traffic(arch, params, act,
                                                        kv * 0.5),
            "train": lambda: llm.train_step_traffic(arch, params, act)}
    return [(n, make[n]()) for n in names]


def assert_rows(ref, got, label):
    ref, got = golden.canonical(ref), golden.canonical(got)
    assert len(ref) == len(got) > 0, label
    for i, (r, g) in enumerate(zip(ref, got)):
        assert list(r) == list(g), f"{label}, row {i}: keys"
        assert r == g, f"{label}, row {i}"


def test_saturation_knee_equals_jax():
    loads = [0.5, 1.0, 2.0, 4.0]
    for tput in ([1.0, 2.0, 4.0, 8.0], [1.0, 2.0, 2.2, 2.3],
                 [0.0, 0.0, 0.0, 0.0], [1.0, float("nan"), 4.0, 4.1],
                 [1.0, 1.9, 3.0, 3.1]):
        for eff in (0.7, 0.9):
            assert teb.saturation_knee(loads, tput, efficiency=eff) == \
                jeb.saturation_knee(loads, tput, efficiency=eff), tput


def test_serving_row_equals_jax():
    busy = SimpleNamespace(
        offered=5, completed=4, tokens=120, cycles=3000,
        tokens_per_kcycle=40.0, admitted_batch=[1, 3, 4, 2],
        batch_target=[2.0, 3.0, 1.5, 2.5],
        queueing=np.array([3, 10, 7, 120]), service=np.array([50, 80, 9,
                                                             300]))
    idle = SimpleNamespace(
        offered=2, completed=0, tokens=0, cycles=1000,
        tokens_per_kcycle=0.0, admitted_batch=[], batch_target=[],
        queueing=np.array([], np.int64), service=np.array([], np.int64))
    for res in (busy, idle):
        assert_rows([jeb.serving_row("dram", "chat", 2.0, res)],
                    [teb.serving_row("dram", "chat", 2.0, res)], "serving")


@pytest.mark.parametrize("cycles", [5, 600])
def test_row_from_result_on_a_reference_result(cycles):
    """At 5 cycles nothing completes: the span is the horizon and the
    mean read latency NaN."""
    res = jax_simulate_fast(JaxConfig(queue_size=16),
                            JAX_BENCHMARKS["trace_example"](n=10, gap=5),
                            cycles)
    for r in (res, SimpleNamespace(
            completed=np.asarray(res.completed),
            t_complete=np.asarray(res.t_complete),
            latency=np.asarray(res.latency),
            is_write=np.asarray(res.is_write),
            counters={k: np.asarray(v) for k, v in res.counters.items()})):
        assert_rows([jeb._row_from_result("x", r, 321, 64.0, cycles)],
                    [teb._row_from_result("x", r, 321, 64.0, cycles)],
                    f"row at {cycles}")


def test_grid_study_equals_jax():
    grid = {"tCL": [14, 18]}
    ref = jeb.grid_study(streams(jax_llm), grid, **TINY)
    tm = {}
    got = teb.grid_study(streams(llm_workload), grid, timings=tm,
                         device="cpu", **TINY)
    assert_rows(ref, got, "grid_study")
    assert len(got) == 4 and tm["launches"] == 1


def test_dvfs_study_equals_jax():
    """The default schedules: nominal, and the mild and hard throttles
    scaled to the horizon."""
    ref = jeb.dvfs_study(streams(jax_llm, ("decode",)), **TINY)
    tm = {}
    got = teb.dvfs_study(streams(llm_workload, ("decode",)), timings=tm,
                         device="cpu", **TINY)
    assert_rows(ref, got, "dvfs_study")
    assert [r["schedule"] for r in got] == ["nominal", "throttle_mild",
                                            "throttle_hard"]
    assert tm["launches"] == 1


def test_topo_grid_study_equals_jax():
    grid = {"channels": [1, 2], "tCL": [14, 18]}
    ref = jeb.topo_grid_study(streams(jax_llm, ("prefill",)), grid, **TINY)
    tm = {}
    got = teb.topo_grid_study(streams(llm_workload, ("prefill",)), grid,
                              timings=tm, device="cpu", **TINY)
    assert_rows(ref, got, "topo_grid_study")
    assert [r["num_banks"] for r in got] == [32, 32, 64, 64]
    assert tm["topologies"] == 2 and tm["launches"] == 2


def test_cxl_tier_study_equals_jax():
    kw = dict(capacity_splits=(1,), interleaves=(6,), tokens=2, chunks=2,
              tail_cycles=200, bit_check=False)
    ref = jeb.cxl_tier_study(**kw)
    tm = {}
    got = teb.cxl_tier_study(timings=tm, device="cpu", **kw)
    assert_rows(ref, got, "cxl_tier_study")
    assert [r["stream"] for r in got] == ["decode", "prefill"]
    assert tm["launches"] == 1
    with pytest.raises(ValueError, match="tiered config"):
        teb.cxl_tier_study(MemSimConfig(), device="cpu")


def test_serving_study_equals_jax():
    """The Table-1 device at two loads of one chat request each, the loads
    as one ``run_serving_batched`` (the study's default topologies, 2-
    channel DRAM and tiered CXL, run on the card in ``chip_smoke.py``)."""
    kw = dict(loads=(0.5, 1.0), horizon=300, window_cycles=400, seed=3)

    def small(cls):
        return cls(max_batch=4, weight_reads_per_token=4,
                   kv_reads_per_token=2, prefill_tokens_per_step=4)

    ref = jeb.serving_study(serving=small(JaxServingConfig),
                            topologies=[("t1", JaxConfig(), None)], **kw)
    tm = {}
    got = teb.serving_study(serving=small(ServingConfig),
                            topologies=[("t1", MemSimConfig(), None)],
                            timings=tm, device="cpu", **kw)
    assert_rows(ref, got, "serving_study")
    assert [r["offered"] for r in got] == [1, 1]
    assert tm["launches"] == tm["windows"] > 0


def test_serving_capacity_rule_has_one_home():
    assert golden.serving_capacity is teb.serving_capacity
    assert golden.cxl_tier_point is teb.cxl_tier_point


@pytest.mark.parametrize("kw", [dict(stream=True),
                                dict(checkpoint_dir="ckpt"),
                                dict(chunk_lanes=2),
                                dict(memory_budget_bytes=1 << 20)])
@pytest.mark.parametrize("study", ["grid_study", "topo_grid_study"])
def test_streaming_options_raise(study, kw, tmp_path):
    """The streaming options route as the reference's do (``stream=True``
    or a ``checkpoint_dir`` stream, each traffic stream checkpointing in
    its own ``stream_<i>_<name>`` directory; ``chunk_lanes`` or
    ``memory_budget_bytes`` alone do not), and the rows equal the
    ``stream=False`` ones."""
    kw = dict(kw)
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    call = functools.partial(getattr(teb, study),
                             streams(llm_workload, ("decode",)),
                             {"tCL": [14]}, target_requests=8,
                             tail_cycles=10, device="cpu")
    tm = {}
    got = call(timings=tm, **kw)
    want = call(stream=False)
    assert_rows(want, got, study)
    assert tm.get("streamed", False) is bool(
        kw.get("stream") or kw.get("checkpoint_dir"))
    if "checkpoint_dir" in kw:
        assert (tmp_path / "ckpt" / "stream_00_decode"
                / "manifest.json").exists()
