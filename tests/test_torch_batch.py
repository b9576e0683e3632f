"""Batches and sweeps of the port (``simulate_batch``, ``sweep_queue_sizes``,
``sweep_grid``) on the CPU, where the lane-batched persistent K3 runs its
plain version ``fused_run_batch_plain``, against the JAX reference's
``simulate_batch`` / ``sweep_queue_sizes`` / ``sweep_grid`` in
``batch_mode="lanes"``: every ``SimResult`` field of every lane, its
``cfg`` label, the per-lane executed steps and ``steps_total``.

Cases (at most 800 cycles and 64 requests a lane): a ragged batch of
three traces; a broadcast queue sweep whose small depths block; mixed
constant and DVFS lanes with an FR-FCFS segment; the per-cycle form
(``cycle_skip=False``); two-tier lanes; the split backend; launch budgets
1 / 7 / none leaving the same states; ``sweep_queue_sizes``; a
``sweep_grid`` with a ``"schedule"`` axis that composes with a timing
axis; ``grid_points`` order; the reference's ``ValueError`` texts; and
the calls the reference streams, streamed and equal to ``stream=False``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_batch as jax_simulate_batch  # noqa: E402
from repro.core import sweep_grid as jax_sweep_grid  # noqa: E402
from repro.core import sweep_queue_sizes as jax_sweep_queue_sizes  # noqa: E402
from repro.core.engine import GRID_AXES as JAX_GRID_AXES  # noqa: E402
from repro.core.engine import grid_points as jax_grid_points  # noqa: E402
from repro.core.engine import lane_schedule as jax_lane_schedule  # noqa: E402
from repro.core.params import RuntimeParams as JaxRP  # noqa: E402
from repro.core.params import tiered_params as jax_tiered  # noqa: E402
from repro.core.simulator import Trace as JaxTrace  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GRID_AXES,
    MemSimConfig,
    grid_points,
    simulate_batch,
    stack_traces,
    sweep_grid,
    sweep_queue_sizes,
)
from repro_torch.core import interop  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    _sched_i32,
    fused_run_batch,
    fused_run_batch_plain,
)
from repro_torch.core.params import RuntimeParams, tiered_params  # noqa: E402
from repro_torch.core.simulator import ScheduleView, init_state  # noqa: E402
from test_torch_engine import port_trace  # noqa: E402

FIELDS = ("t_intended", "is_write", "t_admit", "t_dispatch", "t_start",
          "t_complete", "rdata")
# capacities every case shares but the two-tier one (one compiled lane
# program per topology, request count and segment count on the JAX side)
CAP = dict(queue_size=32, resp_queue_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loop's ops are tiny: one intra-op thread runs them faster
    than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burst_trace(n=32):
    """Two arrivals a cycle aimed at four banks (rows at random): the
    small queue depths of a sweep stall admission and dispatch."""
    i = np.arange(n)
    rows = np.random.default_rng(3).integers(0, 8, n)
    return JaxTrace(*[jnp.asarray(v, jnp.int32) for v in (
        i // 2, (rows << 11) | (i % 4), i % 3 == 0, i * 7)])


def _ragged_traces():
    return [JAX_BENCHMARKS["trace_example"](n=20, gap=9),
            _burst_trace(),
            JAX_BENCHMARKS["trace_example"](n=28, gap=6, seed=1)]


def _label(cfg):
    """A config's fields but the backend, whose names are each package's
    own (the reference's default ``"jnp"``, the port's ``"fused"``)."""
    d = dataclasses.asdict(cfg)
    del d["fsm_backend"]
    return d


def assert_lanes_same(ref, got, jt, tt, label):
    """Every field, counter and label of every lane, and the steps."""
    assert len(ref) == len(got), label
    for i, (r, g) in enumerate(zip(ref, got)):
        where = f"{label}, lane {i}"
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(r, f)),
                                          getattr(g, f),
                                          err_msg=f"{where}: {f}")
        assert sorted(r.counters) == sorted(g.counters), where
        for k in r.counters:
            np.testing.assert_array_equal(np.asarray(r.counters[k]),
                                          g.counters[k],
                                          err_msg=f"{where}: counter {k}")
        assert (r.blocked_arrival, r.blocked_dispatch, r.num_cycles) == \
            (g.blocked_arrival, g.blocked_dispatch, g.num_cycles), where
        assert _label(r.cfg) == _label(g.cfg), where
    assert [p["steps"] for p in tt["per_lane"]] == \
        [p["steps"] for p in jt["per_lane"]], label
    assert tt["steps"] == jt["steps"], label
    assert tt["steps_total"] == jt["steps_total"], label


def _run_both(jcfg, cfg, jtraces, cycles, batch_mode="auto", **kw):
    """The same batch on both sides; ``kw`` values given as (JAX, port)
    pairs where they differ by package."""
    jkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
    pkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
    jt, tt = {}, {}
    ref = jax_simulate_batch(jcfg, jtraces, cycles, batch_mode="lanes",
                             timings=jt, **jkw)
    ptr = port_trace(jtraces) if isinstance(jtraces, JaxTrace) else \
        [port_trace(t) for t in jtraces]
    got = simulate_batch(cfg, ptr, cycles, batch_mode=batch_mode,
                         timings=tt, device="cpu", **pkw)
    return ref, got, jt, tt


def test_ragged_batch_matches_reference():
    """Three traces of 40, 32 and 56 requests as one batch (padded to 56
    as the reference pads them), at three queue depths."""
    traces = _ragged_traces()
    ref, got, jt, tt = _run_both(JaxConfig(**CAP), MemSimConfig(**CAP),
                                 traces, 700, queue_sizes=[32, 4, 16])
    assert_lanes_same(ref, got, jt, tt, "ragged")
    assert [len(g.t_complete) for g in got] == [40, 32, 56] == \
        [int(t.t.shape[0]) for t in traces]
    assert tt["launches"] == 1 and tt["compile_s"] >= 0 and tt["run_s"] > 0
    assert tt["setup_s"] + tt["lanes_s"] + tt["results_s"] == \
        pytest.approx(tt["run_s"])


def test_broadcast_queue_sweep_blocks_and_matches_reference():
    """One trace broadcast over depths and respQueue depths: the smallest
    lanes stall admission and dispatch, and ``batch_mode="vmap"`` runs
    independent lanes as ``"lanes"`` does."""
    ref, got, jt, tt = _run_both(
        JaxConfig(**CAP), MemSimConfig(**CAP), _burst_trace(), 600,
        batch_mode="vmap", queue_sizes=[2, 3, 32],
        resp_queue_sizes=[1, 16, 16])
    assert_lanes_same(ref, got, jt, tt, "broadcast")
    assert got[0].blocked_arrival > 0 and got[0].blocked_dispatch > 0
    assert got[2].blocked_arrival == 0


def test_mixed_constant_and_dvfs_lanes_match_reference():
    """A constant point, a 3-segment DVFS schedule (open page from cycle
    150, FR-FCFS from 300) and an FR-FCFS open-page point: the constant
    lanes are padded to three segments."""
    jcfg = JaxConfig(**CAP)
    jparams = [JaxRP(), jax_lane_schedule(jcfg, [
        (0, {}),
        (150, {"tCL": 18, "tRCDRD": 16, "page_policy": "open"}),
        (300, {"tRP": 17, "tCL": 16, "tREFI": 900,
               "sched_policy": "frfcfs", "page_policy": "open"})]),
        JaxRP(page_policy=1, sched_policy=1)]
    tparams = [RuntimeParams(),
               interop.schedule_from_numpy(*[np.asarray(x)
                                             for x in jparams[1].pack()]),
               RuntimeParams(page_policy=1, sched_policy=1)]
    ref, got, jt, tt = _run_both(jcfg, MemSimConfig(**CAP),
                                 JAX_BENCHMARKS["trace_example"](n=30, gap=9),
                                 700, params=(jparams, tparams))
    assert_lanes_same(ref, got, jt, tt, "mixed params")
    assert all(len(g.counters["seg_cycles"]) == 3 for g in got)


def test_per_cycle_batch_matches_reference():
    """``cycle_skip=False``: K3's per-cycle form, one step a cycle."""
    ref, got, jt, tt = _run_both(JaxConfig(**CAP), MemSimConfig(**CAP),
                                 _ragged_traces()[:2], 300,
                                 queue_sizes=[8, 32], cycle_skip=False)
    assert_lanes_same(ref, got, jt, tt, "per-cycle")
    assert tt["steps_total"] == 600


def test_two_tier_lanes_match_reference():
    kw = dict(queue_size=16, channels=2, tiers=2, cxl_channels=1)
    slow = dict(tRCDRD=30, tCL=24, tRFC=300, tREFI=5000)
    jp = [jax_tiered(JaxRP(), JaxRP(**slow)),
          jax_tiered(JaxRP(tCL=18), JaxRP(**slow))]
    tp = [tiered_params(RuntimeParams(), RuntimeParams(**slow)),
          tiered_params(RuntimeParams(tCL=18), RuntimeParams(**slow))]
    ref, got, jt, tt = _run_both(
        JaxConfig(**kw), MemSimConfig(**kw),
        JAX_BENCHMARKS["vector_similarity"](num_vectors=4, dim=8,
                                           burst_gap=12),
        800, params=(jp, tp))
    assert_lanes_same(ref, got, jt, tt, "two-tier")


def test_split_backend_lanes_match_reference():
    """The split backend runs its lanes one after another through the
    single-lane loop: no lane-batched launch."""
    jcfg = JaxConfig(**CAP)
    cfg = MemSimConfig(**CAP, fsm_backend="split")
    ref, got, jt, tt = _run_both(jcfg, cfg, _ragged_traces()[:2], 400,
                                 queue_sizes=[32, 4])
    assert_lanes_same(ref, got, jt, tt, "split")
    assert tt["launches"] == 0


def _fresh_lanes(cfg, traces, qs):
    """(topology, views, traces, states) of fresh lanes, lane i the i-th
    row of ``stack_traces(traces)`` at runtime depth ``qs[i]``."""
    topo = cfg.topology()
    view = ScheduleView(topo, _sched_i32(cfg.runtime()), "cpu")
    stacked, _ = stack_traces(traces)
    trs = [stacked.__class__(*[x[i] for x in stacked])
           for i in range(len(traces))]
    states = [init_state(topo, view, trs[0].num_requests, q, None,
                         device="cpu") for q in qs]
    return topo, [view] * len(qs), trs, states


def test_launch_budgets_leave_the_same_states():
    """The launch/relaunch protocol: budgets of 1 and 7 steps a launch
    (lanes reaching the horizon at different launches) end in the states
    of one unbounded launch, every leaf, with the same steps; a launch
    runs only the lanes left."""
    cfg = MemSimConfig(**CAP)
    traces = [port_trace(t) for t in _ragged_traces()[:2]]
    finals = {}
    for budget in (None, 7, 1):
        topo, views, trs, states = _fresh_lanes(cfg, traces, [32, 4])
        ts, steps, launches = fused_run_batch(topo, views, trs, states,
                                              300, budget=budget)
        assert ts == [300, 300]
        finals[budget] = ([interop.state_to_numpy(s) for s in states],
                          steps, launches)
    base, steps, launches = finals[None]
    assert launches == 1 and steps[0] != steps[1]
    for budget in (7, 1):
        got, k, n = finals[budget]
        assert k == steps
        assert n == -(-max(steps) // budget)
        for i, (a, b) in enumerate(zip(base, got)):
            for leaf in a:
                np.testing.assert_array_equal(
                    a[leaf], b[leaf], err_msg=f"budget {budget}, lane {i}, "
                    f"{leaf}")
    # a launch at a time: the first launch of budget 7 leaves each lane
    # at its clock after 7 steps
    topo, views, trs, states = _fresh_lanes(cfg, traces, [32, 4])
    ts, k, n = fused_run_batch_plain(topo, views, trs, states, 300, 7,
                                     max_launches=1)
    assert k == [7, 7] and n == 1 and all(0 < t < 300 for t in ts)
    with pytest.raises(ValueError, match="budget=0"):
        fused_run_batch_plain(*_fresh_lanes(cfg, traces, [32, 4]), 300,
                              budget=0)


def test_sweep_queue_sizes_matches_reference():
    jt, tt = {}, {}
    depths = [2, 8, 32]
    ref = jax_sweep_queue_sizes(JaxConfig(), _burst_trace(), depths, 600,
                                capacity=32, batch_mode="lanes", timings=jt)
    got = sweep_queue_sizes(MemSimConfig(), port_trace(_burst_trace()),
                            depths, 600, capacity=32, timings=tt,
                            device="cpu")
    assert_lanes_same(ref, got, jt, tt, "sweep_queue_sizes")
    assert [g.cfg.queue_size for g in got] == depths


def test_sweep_grid_schedule_axis_composes_and_matches_reference():
    """A ``"schedule"`` of segment overrides composes with the swept
    ``tCL``: its second segment keeps the lane's ``tCL``."""
    grid = {"tCL": [14, 18],
            "schedule": [None, [(0, {}),
                                (300, {"tRP": 17, "page_policy": "open"})]]}
    jt, tt = {}, {}
    ref = jax_sweep_grid(JaxConfig(**CAP), _burst_trace(), grid, 700,
                         batch_mode="lanes", timings=jt)
    got = sweep_grid(MemSimConfig(**CAP), port_trace(_burst_trace()), grid,
                     700, timings=tt, device="cpu")
    assert_lanes_same(ref, got, jt, tt, "sweep_grid")
    assert [g.cfg.tCL for g in got] == [14, 14, 18, 18]
    assert len(got[0].counters["seg_cycles"]) == 2


def test_grid_points_order_and_axes_match_reference():
    grid = {"queue_size": [4, 16], "page_policy": ["closed", "open"],
            "tRP": [14, 15, 16], "sched_policy": ["fcfs"]}
    assert grid_points(grid) == jax_grid_points(grid)
    assert GRID_AXES == JAX_GRID_AXES
    assert simulate_batch(MemSimConfig(), [], 10, device="cpu") == \
        jax_simulate_batch(JaxConfig(), [], 10, batch_mode="lanes") == []


def _error_cases():
    """(label, JAX call, port call) of inputs the reference rejects."""
    jtr = JAX_BENCHMARKS["trace_example"](n=4)
    ttr = port_trace(jtr)
    jc, tc = JaxConfig(queue_size=8), MemSimConfig(queue_size=8)

    def both(fn_j, fn_t, *args, jkw=None, tkw=None, **kw):
        return (lambda: fn_j(jc, jtr, *args, **kw, **(jkw or {})),
                lambda: fn_t(tc, ttr, *args, **kw, **(tkw or {}),
                             device="cpu"))

    lanes = dict(batch_mode="lanes")
    return [
        ("batch_mode", *both(jax_simulate_batch, simulate_batch, 10,
                             queue_sizes=[4], batch_mode="bogus")),
        ("broadcast", *both(jax_simulate_batch, simulate_batch, 10,
                            jkw=lanes)),
        ("queue_sizes range", *both(jax_simulate_batch, simulate_batch, 10,
                                    queue_sizes=[4, 9], jkw=lanes)),
        ("resp range", *both(jax_simulate_batch, simulate_batch, 10,
                             queue_sizes=[4], resp_queue_sizes=[0],
                             jkw=lanes)),
        ("resp length", *both(jax_simulate_batch, simulate_batch, 10,
                              queue_sizes=[4], resp_queue_sizes=[4, 4],
                              jkw=lanes)),
        ("params length", *both(
            jax_simulate_batch, simulate_batch, 10, queue_sizes=[4, 4],
            jkw=dict(params=[JaxRP()], **lanes),
            tkw=dict(params=[RuntimeParams()]))),
        ("params point", *both(
            jax_simulate_batch, simulate_batch, 10,
            jkw=dict(params=[JaxRP(tRP=0)], **lanes),
            tkw=dict(params=[RuntimeParams(tRP=0)]))),
        ("lane_cfgs length", *both(jax_simulate_batch, simulate_batch, 10,
                                   queue_sizes=[4], lane_cfgs=[jc, jc],
                                   jkw=lanes)),
        ("unknown axis", *both(jax_sweep_grid, sweep_grid,
                               {"tBOGUS": [1]}, 10)),
        ("empty axis", *both(jax_sweep_grid, sweep_grid, {"tCL": []}, 10)),
        ("capacity", *both(jax_sweep_grid, sweep_grid,
                           {"queue_size": [4, 8]}, 10, capacity=4)),
        ("resp_capacity", *both(jax_sweep_grid, sweep_grid,
                                {"resp_queue_size": [4, 8]}, 10,
                                resp_capacity=4)),
        ("grid point", *both(jax_sweep_grid, sweep_grid,
                             {"tREFI": [100]}, 10)),
        ("schedule segment", *both(jax_sweep_grid, sweep_grid,
                                   {"schedule": [[(0, {}), (5, {"tRP": 0})]]},
                                   10)),
        ("schedule start", *both(jax_sweep_grid, sweep_grid,
                                 {"schedule": [[(3, {})]]}, 10)),
        ("empty schedule", *both(jax_sweep_grid, sweep_grid,
                                 {"schedule": [[]]}, 10)),
        ("queue depth 0", *both(jax_sweep_queue_sizes, sweep_queue_sizes,
                              [0], 10)),
    ]


@pytest.mark.parametrize("case", _error_cases(), ids=lambda c: c[0])
def test_bad_inputs_raise_the_reference_value_errors(case):
    label, ref_call, port_call = case
    with pytest.raises(ValueError) as ref:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(ref.value), label


@pytest.mark.parametrize("kw", [dict(stream=True),
                                dict(checkpoint_dir="ckpt"),
                                dict(chunk_lanes=2),
                                dict(memory_budget_bytes=1 << 20),
                                dict(threshold=2)],
                         ids=["stream", "checkpoint_dir", "chunk_lanes",
                              "memory_budget_bytes", "threshold"])
def test_streaming_calls_raise_not_implemented(kw, monkeypatch, tmp_path):
    """What the reference hands to its streaming executor now streams
    (``stream=True``, a ``checkpoint_dir``, or at least
    ``MEMSIM_STREAM_THRESHOLD`` points; ``chunk_lanes`` or
    ``memory_budget_bytes`` alone do not, as in the reference), and every
    such call equals the ``stream=False`` result, lane by lane."""
    kw = dict(kw)
    if "threshold" in kw:
        monkeypatch.setenv("MEMSIM_STREAM_THRESHOLD", str(kw.pop("threshold")))
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    streams = bool(kw.get("stream") or kw.get("checkpoint_dir")
                   or not kw)
    tr = port_trace(_burst_trace())
    tm = {}
    got = sweep_grid(MemSimConfig(), tr, {"queue_size": [4, 8]}, 10,
                     timings=tm, device="cpu", **kw)
    want = sweep_grid(MemSimConfig(), tr, {"queue_size": [4, 8]}, 10,
                      stream=False, device="cpu")
    assert tm.get("streamed", False) is streams
    if streams:
        assert tm["launches"] == tm["chunks"] - tm["chunks_resumed"]
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert a.cfg == b.cfg
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for k in a.counters:
            np.testing.assert_array_equal(a.counters[k], b.counters[k])
        assert (a.blocked_arrival, a.blocked_dispatch) == \
            (b.blocked_arrival, b.blocked_dispatch)
