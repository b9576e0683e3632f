"""The multi-topology sweep of the port (``sweep_topologies``) on the CPU,
where each fused topology's lanes run the lane-batched K3's plain version
``fused_run_batch_plain`` (one topology after another) and split
topologies run the single-lane loops, against the JAX reference's
``sweep_topologies``: every lane's ``SimResult`` fields, counters and
blocked totals, its ``cfg`` label, and ``points``, ``topo_of_point`` and
``topologies`` with the backend names mapped (port ``plain`` / ``split``
/ ``fused`` = reference ``jnp`` / ``pallas`` / ``fused``).

Cases (at most 40 requests a lane and 1200 cycles): the reference test's
grid (``ranks`` [1, 2, 4] x ``tCL`` [14, 18]); a queue-depth axis that
adds lanes, not topologies; one
trace a point and the count error; ``table``, ``result_at`` and its
``KeyError``; a ``split`` x ``fused`` backend axis; ``TOPO_AXES`` and
``topo_grid_points`` with the reference's order and errors; and the
calls the reference streams, streamed and equal to ``stream=False``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import sweep_topologies as jax_sweep_topologies  # noqa: E402
from repro.core import topo_grid_points as jax_topo_grid_points  # noqa: E402
from repro.core.engine import TOPO_AXES as JAX_TOPO_AXES  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    TOPO_AXES,
    MemSimConfig,
    TopoGridResult,
    simulate_fast,
    sweep_topologies,
    topo_grid_points,
)
from test_torch_batch import FIELDS, _burst_trace  # noqa: E402
from test_torch_engine import port_trace  # noqa: E402

#: port backend -> the reference's name for it
BACKENDS = {"plain": "jnp", "split": "pallas", "fused": "fused"}
CYCLES = 1_200
#: >= 3 topologies (ranks) x 2 runtime lanes (tCL): the reference test's
GRID = {"ranks": [1, 2, 4], "tCL": [14, 18]}
SMALL = dict(queue_size=16, mem_words=1 << 12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loop's ops are tiny: one intra-op thread runs them faster
    than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_trace(n=20, gap=5):
    """``2 n`` requests, ``gap`` cycles apart."""
    return JAX_BENCHMARKS["trace_example"](n=n, gap=gap)


def _label(cfg):
    d = dataclasses.asdict(cfg)
    d["fsm_backend"] = BACKENDS.get(d["fsm_backend"], d["fsm_backend"])
    return d


def _jax_point(point):
    return {k: BACKENDS[v] if k == "fsm_backend" else v
            for k, v in point.items()}


def assert_lane_same(ref, got, label):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f),
                                      err_msg=f"{label}: {f}")
    assert sorted(ref.counters) == sorted(got.counters), label
    for k in ref.counters:
        np.testing.assert_array_equal(np.asarray(ref.counters[k]),
                                      got.counters[k],
                                      err_msg=f"{label}: counter {k}")
    assert (ref.blocked_arrival, ref.blocked_dispatch, ref.num_cycles) == \
        (got.blocked_arrival, got.blocked_dispatch, got.num_cycles), label


def assert_sweeps_same(ref, got, label, backend_axis=False):
    """Every lane, label, point, group and topology; without a backend
    axis the two packages' default backends differ, so the backend is
    left out of the labels and topologies."""
    assert isinstance(got, TopoGridResult)
    assert [_jax_point(p) for p in got.points] == ref.points, label
    assert got.topo_of_point == ref.topo_of_point, label
    assert len(got) == len(ref), label
    for i, (r, g) in enumerate(zip(ref, got)):
        assert_lane_same(r, g, f"{label}, lane {i} {got.points[i]}")
        lr, lg = dataclasses.asdict(r.cfg), _label(g.cfg)
        if not backend_axis:
            del lr["fsm_backend"], lg["fsm_backend"]
        assert lr == lg, f"{label}, lane {i}"
    tr = [dataclasses.asdict(t) for t in ref.topologies]
    tg = [_label(t) for t in got.topologies]
    if not backend_axis:
        for d in tr + tg:
            del d["fsm_backend"]
    assert tr == tg, label


def test_topo_axes_and_grid_points_equal_reference():
    assert TOPO_AXES == JAX_TOPO_AXES
    grid = {"channels": [1, 2], "fsm_backend": ["fused", "split"],
            "tCL": [14, 18], "queue_size": [8, 16]}
    pts = topo_grid_points(grid)
    assert len(pts) == 16
    assert pts[0] == {"channels": 1, "fsm_backend": "fused", "tCL": 14,
                      "queue_size": 8}
    assert pts[1]["queue_size"] == 16  # last axis fastest
    assert [_jax_point(p) for p in pts] == jax_topo_grid_points(
        {k: [BACKENDS[v] for v in vs] if k == "fsm_backend" else vs
         for k, vs in grid.items()})
    for bad, match in (({"chanels": [1, 2]}, "unknown grid axis"),
                       ({"channels": []}, "empty")):
        with pytest.raises(ValueError, match=match) as got:
            topo_grid_points(bad)
        with pytest.raises(ValueError) as want:
            jax_topo_grid_points(bad)
        assert str(got.value) == str(want.value)
    # a bad value fails at config validation, as in the reference
    with pytest.raises(ValueError) as got:
        sweep_topologies(MemSimConfig(), port_trace(jax_trace(n=20)),
                         {"channels": [3]}, 100, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_sweep_topologies(JaxConfig(), jax_trace(n=20),
                             {"channels": [3]}, num_cycles=100)
    assert str(got.value) == str(want.value)


def test_sweep_topologies_equals_reference_every_lane():
    """Three topologies x two runtime lanes: every lane, label and group
    equal the reference's; one lane-batched launch a topology (its plain
    version's protocol on the CPU) and the timings' keys."""
    jtr = jax_trace()
    ref = jax_sweep_topologies(JaxConfig(**SMALL), jtr, GRID,
                               num_cycles=CYCLES)
    tm = {}
    got = sweep_topologies(MemSimConfig(**SMALL), port_trace(jtr), GRID,
                           CYCLES, timings=tm, max_workers=1, device="cpu")
    assert_sweeps_same(ref, got, "ranks x tCL")
    assert len(got.topologies) == 3
    assert got.timings["launches"] == tm["launches"] == 3
    assert got.timings["topologies"] == 3 and got.timings["compiles"] == 0
    per = got.timings["per_topology"]
    assert [p["lanes"] for p in per] == [2, 2, 2]
    assert [p["launches"] for p in per] == [1, 1, 1]
    assert set(per[0]) == {"topology", "lanes", "compile_s", "run_s",
                           "steps", "device", "launches"}
    assert got.timings["steps"] == max(p["steps"] for p in per) > 0
    for k in ("compile_s", "compile_s_wall", "run_s"):
        assert tm[k] == got.timings[k] >= 0


def test_queue_depth_axis_does_not_split_groups():
    """``queue_size`` is a run-time depth against the grid-wide capacity:
    it adds lanes, never topologies; the small depths stall a burst."""
    jtr = _burst_trace(16)
    grid = {"ranks": [1, 2], "queue_size": [2, 16]}
    ref = jax_sweep_topologies(JaxConfig(**SMALL), jtr, grid,
                               num_cycles=300)
    got = sweep_topologies(MemSimConfig(**SMALL), port_trace(jtr), grid,
                           300, device="cpu")
    assert_sweeps_same(ref, got, "ranks x queue_size")
    assert len(got) == 4 and len(got.topologies) == 2
    assert all(t.queue_size == 16 for t in got.topologies)
    assert got[0].blocked_arrival > 0 and got[1].blocked_arrival == 0


def test_one_trace_a_point_and_the_count_error():
    jtrs = [jax_trace(n=10, gap=4), jax_trace(n=15, gap=6)]
    grid = {"ranks": [1, 2]}
    ref = jax_sweep_topologies(JaxConfig(**SMALL), jtrs, grid,
                               num_cycles=CYCLES)
    got = sweep_topologies(MemSimConfig(**SMALL),
                           [port_trace(t) for t in jtrs], grid, CYCLES,
                           device="cpu")
    assert_sweeps_same(ref, got, "one trace a point")
    assert [len(g.t_complete) for g in got] == [20, 30]  # not padded
    with pytest.raises(ValueError, match="traces for") as err:
        sweep_topologies(MemSimConfig(), [port_trace(t) for t in jtrs],
                         {"ranks": [1, 2, 4]}, 100, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_sweep_topologies(JaxConfig(), jtrs, {"ranks": [1, 2, 4]},
                             num_cycles=100)
    assert str(err.value) == str(want.value)


def test_table_and_result_at():
    """``table`` rows, ``result_at`` of a unique point (the port's own
    single-lane run of it), and ``KeyError`` on an ambiguous or missing
    point."""
    tr = port_trace(jax_trace(n=10))
    cfg = MemSimConfig(queue_size=8, mem_words=1 << 12)
    sweep = sweep_topologies(cfg, tr, {"ranks": [1, 2], "tCL": [14, 18]},
                             800, device="cpu")
    rows = sweep.table()
    assert len(rows) == len(sweep) == 4
    for row, point, res in zip(rows, sweep.points, sweep.results):
        assert row["point"] == point
        assert row["result"] is res
        assert row["topology"] in sweep.topologies
    res = sweep.result_at(ranks=2, tCL=18)
    assert res.cfg == dataclasses.replace(cfg, ranks=2, tCL=18)
    assert_lane_same(simulate_fast(res.cfg, tr, 800, device="cpu"), res,
                     "result_at")
    with pytest.raises(KeyError, match="matches 2 grid points"):
        sweep.result_at(ranks=2)  # two tCL lanes
    with pytest.raises(KeyError, match="matches 0 grid points"):
        sweep.result_at(ranks=8)
    assert [p["lanes"] for p in sweep.timings["per_topology"]] == [2, 2]


def test_split_and_fused_backend_axis():
    """A backend axis (``pallas`` x ``fused`` in the reference, run in
    its interpret mode): the split topologies run the single-lane loops
    in the calling thread (no K3 launch), the fused ones the lane-batched
    K3, and every lane equals the reference's; split and fused lanes of
    a point are equal."""
    jtr = jax_trace(n=15, gap=6)
    grid = {"fsm_backend": ["split", "fused"], "tCL": [14, 18]}
    jgrid = dict(grid, fsm_backend=["pallas", "fused"])
    cfg = dict(queue_size=8, mem_words=1 << 12)
    ref = jax_sweep_topologies(JaxConfig(**cfg), jtr, jgrid,
                               num_cycles=1_200)
    tm = {}
    got = sweep_topologies(MemSimConfig(**cfg), port_trace(jtr), grid,
                           1_200, timings=tm, device="cpu")
    assert_sweeps_same(ref, got, "split x fused", backend_axis=True)
    assert [t.fsm_backend for t in got.topologies] == ["split", "fused"]
    assert [p["launches"] for p in tm["per_topology"]] == [0, 1]
    for i in range(2):
        assert_lane_same(got[i], got[i + 2], f"split vs fused, point {i}")


@pytest.mark.parametrize("kw", [dict(stream=True),
                                dict(checkpoint_dir="ckpt"),
                                dict(chunk_lanes=2),
                                dict(memory_budget_bytes=1 << 20)])
def test_streaming_options_raise(kw, tmp_path):
    """The streaming options route as the reference's do (``stream=True``
    or a ``checkpoint_dir`` stream; ``chunk_lanes`` or
    ``memory_budget_bytes`` alone do not), and the sweep equals the
    ``stream=False`` one."""
    kw = dict(kw)
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    tr = port_trace(jax_trace(n=20))
    got = sweep_topologies(MemSimConfig(**SMALL), tr, GRID, 100,
                           device="cpu", **kw)
    want = sweep_topologies(MemSimConfig(**SMALL), tr, GRID, 100,
                            stream=False, device="cpu")
    assert got.timings.get("streamed", False) is bool(
        kw.get("stream") or kw.get("checkpoint_dir"))
    assert (got.points, got.topologies, got.topo_of_point) == \
        (want.points, want.topologies, want.topo_of_point)
    for i, (a, b) in enumerate(zip(want, got)):
        assert_lane_same(a, b, f"point {i}")
        assert a.cfg == b.cfg


def test_stream_threshold_raises(monkeypatch):
    """At ``MEMSIM_STREAM_THRESHOLD`` points the sweep streams, and equals
    the materialising path that ``stream=False`` forces."""
    monkeypatch.setenv("MEMSIM_STREAM_THRESHOLD", "1")
    tr = port_trace(jax_trace(n=4))
    got = sweep_topologies(MemSimConfig(**SMALL), tr, {"ranks": [1]}, 100,
                           device="cpu")
    assert got.timings["streamed"] is True and got.timings["chunks"] == 1
    # stream=False forces the materializing path
    want = sweep_topologies(MemSimConfig(**SMALL), tr, {"ranks": [1]}, 100,
                            stream=False, device="cpu")
    assert "streamed" not in want.timings and len(want) == 1
    assert_lane_same(want[0], got[0], "threshold")
    assert want[0].cfg == got[0].cfg
