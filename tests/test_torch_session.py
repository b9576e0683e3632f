"""Windowed sessions of the port (``SimSession``, ``SessionBatch``,
``SessionLane``) on the CPU, where a fused window runs the persistent K3's
plain version and a batched one the lane-batched K3's, against the JAX
reference's ``repro.core.SimSession`` / ``SessionBatch`` fed the same
arrivals through the same windows: every ``WindowReport`` (its ``steps``
included; the reference's ``"vmap"`` mode counts a shared clock, so there
every field but ``steps``) and the final ``SimResult``, bit for bit. Each
windowed run also equals the port's monolithic ``simulate_fast``.

Cases, at the reference tests' sizes (``trace_example(n=24)`` over 1200
cycles, refresh and self-refresh intervals short enough that windows cut
their seams, the reference's four-segment DVFS schedule): window
partitions 1 / 7 / 113 / whole; windows cutting DVFS boundaries;
arrivals appended mid-run; the three backends; batches in ``"lanes"``
and ``"vmap"`` mode with ragged lanes (one empty), heterogeneous
schedules and queue limits, appends to some lanes only; a batch lane
against a standalone session; ``SessionLane``; the reference's error
texts; and the ``windows`` / ``launches`` / ``captures`` accounting.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import SessionBatch as JaxBatch  # noqa: E402
from repro.core import SimSession as JaxSession  # noqa: E402
from repro.core.engine import lane_schedule as jax_lane_schedule  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro.traces.llm_workload import \
    decode_serving_trace as jax_decode_serving_trace  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MemSimConfig,
    SessionBatch,
    SessionLane,
    SimSession,
    WindowReport,
    lane_schedule,
    simulate_fast,
)
from repro_torch.core.engine import _PAD_T  # noqa: E402
from repro_torch.traces import BENCHMARKS  # noqa: E402
from repro_torch.traces.llm_workload import decode_serving_trace  # noqa: E402

#: port backend -> the reference's
BACKENDS = {"plain": "jnp", "split": "pallas", "fused": "fused"}
#: refresh / self-refresh intervals that put seams inside a short horizon
_SEAM_KW = dict(tREFI=900, tRFC=120, sref_idle_cycles=60)
#: the reference tests' DVFS schedule: boundaries mid-burst, mid-quiet and
#: in the refresh-heavy tail
_SPEC = [
    (0, {}),
    (137, {"tCL": 20, "tRCDRD": 18, "tRCDWR": 19, "tREFI": 700}),
    (400, {"tCL": 26, "tCCDL": 4, "tWTR": 10, "tREFI": 600,
           "sref_idle_cycles": 45}),
    (900, {"tCL": 28, "tRP": 18, "tREFI": 450, "tRFC": 100}),
]
HORIZON = 1_200
RECORDS = ("t_intended", "is_write", "t_admit", "t_dispatch", "t_start",
           "t_complete", "rdata")
REPORT_FIELDS = ("t_start", "t_end", "req_q_len", "resp_q_len", "admitted",
                 "arrivals_total", "blocked_arrival", "steps")


def cfgs(backend="fused", **kw):
    """(port config, reference config) of the seam device."""
    return (MemSimConfig(queue_size=32, fsm_backend=backend, **_SEAM_KW,
                         **kw),
            JaxConfig(queue_size=32, fsm_backend=BACKENDS[backend],
                      **_SEAM_KW, **kw))


def schedules(pc, jc):
    return lane_schedule(pc, _SPEC), jax_lane_schedule(jc, _SPEC)


def trace_arrays(n=24, gap=4):
    """The seam trace as host arrays, equal in both packages."""
    ref = [np.asarray(x) for x in JAX_BENCHMARKS["trace_example"](n=n,
                                                                  gap=gap)]
    got = [x.numpy() for x in BENCHMARKS["trace_example"](n=n, gap=gap)]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    return tuple(got)


def lane_payloads():
    """Ragged per-lane arrivals: the whole seam trace, its first half, and
    an empty lane."""
    arrs = trace_arrays()
    half = arrs[0].size // 2
    return [arrs, tuple(x[:half] for x in arrs), None]


def assert_reports(ref, got, label, steps=True):
    assert len(ref) == len(got), label
    for i, (a, b) in enumerate(zip(ref, got)):
        assert isinstance(b, WindowReport)
        for f in REPORT_FIELDS:
            if f == "steps" and not steps:
                continue
            assert getattr(a, f) == getattr(b, f), (label, i, f)
        np.testing.assert_array_equal(a.completed_ids, b.completed_ids,
                                      err_msg=f"{label} window {i}")
        np.testing.assert_array_equal(a.completed_at, b.completed_at,
                                      err_msg=f"{label} window {i}")
        assert a.n_completed == b.n_completed


def assert_results(ref, got, label):
    for f in RECORDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f),
                                      err_msg=f"{label}: {f}")
    assert set(ref.counters) == set(got.counters), label
    for k in ref.counters:
        np.testing.assert_array_equal(np.asarray(ref.counters[k]),
                                      got.counters[k],
                                      err_msg=f"{label}: counter {k}")
    assert (ref.blocked_arrival, ref.blocked_dispatch) == \
        (got.blocked_arrival, got.blocked_dispatch), label
    assert ref.num_cycles == got.num_cycles, label
    assert (ref.cfg.queue_size, ref.cfg.resp_queue_size) == \
        (got.cfg.queue_size, got.cfg.resp_queue_size), label


def both_sessions(backend, payload, horizon, window, *, params=False,
                  capacity=256, queue_size=8):
    """The same arrivals through the same windows in both packages.
    Returns (reference session, its reports, port session, its
    reports)."""
    pc, jc = cfgs(backend)
    pp, jp = schedules(pc, jc) if params else (None, None)
    ref = JaxSession.open(jc, capacity=capacity, params=jp,
                          queue_size=queue_size)
    got = SimSession.open(pc, capacity=capacity, params=pp,
                          queue_size=queue_size, device="cpu")
    ref.append(payload)
    got.append(payload)
    return ref, ref.run_until(horizon, window), got, \
        got.run_until(horizon, window)


@functools.lru_cache(maxsize=None)
def monolithic(backend, params, horizon, queue_size=8):
    """The port's monolithic ``simulate_fast`` over the seam trace."""
    pc, jc = cfgs(backend)
    tr = BENCHMARKS["trace_example"](n=24, gap=4)
    return simulate_fast(pc, tr, horizon, queue_size=queue_size,
                         params=schedules(pc, jc)[0] if params else None,
                         device="cpu")


# --------------------------------------------------------------------------
# SimSession


@pytest.mark.parametrize("window", [1, 7, 113, HORIZON])
def test_window_partition_equals_jax_and_monolithic(window):
    """One-cycle windows, a short stride, a prime stride cutting refresh
    windows and self-refresh crossings, and the whole horizon: every
    report and the final result equal the reference's, and the result the
    monolithic run's."""
    ref, ref_reps, got, got_reps = both_sessions("fused", trace_arrays(),
                                                 HORIZON, window)
    assert got.cycle == HORIZON
    assert_reports(ref_reps, got_reps, f"window={window}")
    assert_results(ref.result(), got.result(), f"window={window}")
    assert_results(monolithic("fused", False, HORIZON), got.result(),
                   f"window={window} vs monolithic")


@pytest.mark.parametrize("window", [113, 250])
def test_windows_cutting_dvfs_boundaries(window):
    """Windows falling mid-segment of the DVFS schedule (boundaries at
    137 / 400 / 900): the window cap and the boundary cap compose."""
    ref, ref_reps, got, got_reps = both_sessions(
        "fused", trace_arrays(), HORIZON, window, params=True)
    assert_reports(ref_reps, got_reps, f"dvfs window={window}")
    assert_results(ref.result(), got.result(), f"dvfs window={window}")
    assert_results(monolithic("fused", True, HORIZON), got.result(),
                   f"dvfs window={window} vs monolithic")


def test_incremental_appends():
    """Arrivals revealed mid-run, each before its due cycle, replay as a
    monolithic run fed the whole trace up front, and as the reference's
    session fed the same appends."""
    tr = decode_serving_trace(tokens=6, reads_per_token=8, compute_gap=500)
    jtr = jax_decode_serving_trace(tokens=6, reads_per_token=8,
                                   compute_gap=500)
    arrs = tuple(x.numpy() for x in tr)
    for a, b in zip(jtr, arrs):
        np.testing.assert_array_equal(np.asarray(a), b)
    half = arrs[0].size // 2
    cut = int(arrs[0][half]) - 1
    horizon = int(arrs[0].max()) + 2_000
    pc, jc = cfgs()
    ref = JaxSession.open(jc, capacity=256, queue_size=16)
    got = SimSession.open(pc, capacity=256, queue_size=16, device="cpu")
    reps = []
    for s in (ref, got):
        s.append(tuple(x[:half] for x in arrs))
        r = list(s.run_until(cut, 97))
        s.append(tuple(x[half:] for x in arrs))
        reps.append(r + list(s.run_until(horizon, 97)))
    assert_reports(reps[0], reps[1], "incremental")
    assert_results(ref.result(), got.result(), "incremental")
    assert_results(simulate_fast(pc, tr, horizon, queue_size=16,
                                 device="cpu"),
                   got.result(), "incremental vs monolithic")
    # the realized trace is the concatenated appends
    for a, b in zip(got.trace(), arrs):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got.arrivals_total == arrs[0].size


@pytest.mark.parametrize("backend", ["plain", "split"])
def test_other_backends_equal_jax_and_monolithic(backend):
    """The ``plain`` and ``split`` backends' event-horizon loop started at
    each window's clock, with the window end as its horizon, on the DVFS
    schedule."""
    ref, ref_reps, got, got_reps = both_sessions(
        backend, trace_arrays(), 600, 97, params=True)
    assert_reports(ref_reps, got_reps, backend)
    assert_results(ref.result(), got.result(), backend)
    assert_results(monolithic(backend, True, 600), got.result(),
                   f"{backend} vs monolithic")


# --------------------------------------------------------------------------
# SessionBatch


def both_batches(backend, payloads, horizon, window, *, batch_mode="lanes",
                 params=None, queue_size=None, capacity=64):
    pc, jc = cfgs(backend)
    pp = jp = None
    if params is not None:  # per lane: None or the DVFS schedule
        sp, sj = schedules(pc, jc)
        pp = [sp if p else None for p in params]
        jp = [sj if p else None for p in params]
    ref = JaxBatch.open(jc, len(payloads), capacity=capacity, params=jp,
                        queue_size=queue_size, batch_mode=batch_mode)
    got = SessionBatch.open(pc, len(payloads), capacity=capacity, params=pp,
                            queue_size=queue_size, batch_mode=batch_mode,
                            device="cpu")
    for b in (ref, got):
        for i, payload in enumerate(payloads):
            if payload is not None:
                b.append(i, payload)
    return ref, ref.run_until(horizon, window), got, \
        got.run_until(horizon, window)


def assert_batches(ref, ref_reps, got, got_reps, label, steps=True):
    assert len(ref_reps) == len(got_reps), label
    for w, (a, b) in enumerate(zip(ref_reps, got_reps)):
        assert_reports(a, b, f"{label} window {w}", steps=steps)
    for i in range(ref.lanes):
        assert_results(ref.lane_result(i), got.lane_result(i),
                       f"{label} lane {i}")


@pytest.mark.parametrize("batch_mode", ["lanes", "vmap"])
def test_batch_heterogeneous_equals_jax(batch_mode):
    """Ragged lanes (one empty), a DVFS lane beside constant ones (padded
    to its segment count) and per-lane queue limits, windows cutting the
    DVFS boundaries; ``"vmap"`` compares every field but ``steps``."""
    ref, rr, got, gr = both_batches(
        "fused", lane_payloads(), HORIZON, 113, batch_mode=batch_mode,
        params=[False, True, False], queue_size=[8, 16, 6])
    assert got.batch_mode == batch_mode and got.cycle == HORIZON
    assert_batches(ref, rr, got, gr, batch_mode,
                   steps=batch_mode == "lanes")


def test_batch_incremental_ragged_appends_equal_jax():
    """Arrivals revealed mid-run on some lanes only, as payload lists with
    ``None`` entries."""
    arrs = trace_arrays()
    half = arrs[0].size // 2
    cut = int(arrs[0][half]) - 1
    first = tuple(x[:half] for x in arrs)
    second = tuple(x[half:] for x in arrs)
    pc, jc = cfgs()
    ref = JaxBatch.open(jc, 2, capacity=64, batch_mode="lanes")
    got = SessionBatch.open(pc, 2, capacity=64, device="cpu")
    reps = []
    for b in (ref, got):
        r = [b.advance(97, [first, first])]
        r += b.run_until(cut, 97)
        r.append(b.advance(97, [None, second]))
        reps.append(r + b.run_until(HORIZON, 97))
    assert_batches(ref, reps[0], got, reps[1], "ragged appends")


@pytest.mark.parametrize("backend", ["plain", "split"])
def test_batch_other_backends_equal_jax(backend):
    ref, rr, got, gr = both_batches(backend, lane_payloads(), 600, 97,
                                    params=[False, True, False])
    assert_batches(ref, rr, got, gr, backend)


def test_batch_lane_equals_standalone_session():
    """A lane of a batch reports, window by window, what a standalone
    session fed the same arrivals reports, and ends in its result."""
    pc, _ = cfgs()
    payloads = lane_payloads()[:2]
    batch = SessionBatch.open(pc, 2, capacity=64, device="cpu")
    seqs = []
    for i, payload in enumerate(payloads):
        batch.append(i, payload)
        s = SimSession.open(pc, capacity=64, device="cpu")
        s.append(payload)
        seqs.append(s)
    for per_window in batch.run_until(600, 200):
        for i, s in enumerate(seqs):
            assert_reports([s.advance(200)], [per_window[i]], f"lane {i}")
    for i, s in enumerate(seqs):
        assert_results(s.result(), batch.lane_result(i), f"lane {i}")
    results = batch.results()
    assert len(results) == 2
    assert_results(seqs[1].result(), results[1], "results()")


def test_session_lane_surface():
    """``SessionLane`` reads a lane as a session: its trace, result,
    cycle (relabelled), arrivals and config."""
    pc, _ = cfgs()
    payloads = lane_payloads()
    batch = SessionBatch.open(pc, 3, capacity=64, device="cpu")
    for i, payload in enumerate(payloads):
        if payload is not None:
            batch.append(i, payload)
    batch.run_until(300, 150)
    view = batch.lane_view(1, cycle=250)
    assert isinstance(view, SessionLane)
    assert view.cycle == 250 and view.cfg is batch.cfg
    assert view.arrivals_total == payloads[1][0].size
    for a, b in zip(view.trace(), payloads[1]):
        np.testing.assert_array_equal(a.numpy(), b)
    res = view.result()
    assert res.num_cycles == 250
    assert_results(batch.lane_result(1, num_cycles=250), res, "lane view")
    empty = batch.lane_view(2)
    assert empty.cycle == 300 and empty.arrivals_total == 0
    assert empty.result().t_complete.size == 0


# --------------------------------------------------------------------------
# surface contracts


def test_append_contract_violations_raise():
    """The reference's checks and error texts."""
    ses = SimSession.open(MemSimConfig(), capacity=8, device="cpu")
    ses.append((np.asarray([5, 9]), np.asarray([1, 2]), np.asarray([0, 0])))
    with pytest.raises(ValueError, match="non-decreasing"):
        ses.append((np.asarray([20, 12]), np.asarray([1, 2]),
                    np.asarray([0, 0])))
    with pytest.raises(ValueError, match="must stay sorted"):
        ses.append((np.asarray([3]), np.asarray([1]), np.asarray([0])))
    with pytest.raises(ValueError, match="padding sentinel"):
        ses.append((np.asarray([_PAD_T]), np.asarray([1]), np.asarray([0])))
    with pytest.raises(ValueError,
                       match="overflows session capacity 8 \\(2 filled\\)"):
        ses.append((np.full(9, 30), np.arange(9), np.zeros(9, np.int64)))
    with pytest.raises(ValueError, match="components"):
        ses.append((np.asarray([30]),))
    with pytest.raises(ValueError, match="shapes disagree"):
        ses.append((np.asarray([30, 31]), np.asarray([1]),
                    np.asarray([0])))
    with pytest.raises(ValueError, match="window_cycles=-1"):
        ses.advance(-1)
    with pytest.raises(ValueError, match="capacity=0"):
        SimSession.open(MemSimConfig(), capacity=0, device="cpu")
    with pytest.raises(ValueError, match="queue_size=200 not in"):
        SimSession.open(MemSimConfig(), queue_size=200, device="cpu")
    with pytest.raises(ValueError, match="resp_queue_size=0 not in"):
        SimSession.open(MemSimConfig(), resp_queue_size=0, device="cpu")
    # a failed append leaves the session as it was
    assert ses.arrivals_total == 2
    rep = ses.advance(0)
    assert (rep.t_start, rep.t_end, rep.steps, rep.arrivals_total) == \
        (0, 0, 0, 2)


def test_batch_option_validation():
    cfg, _ = cfgs()
    with pytest.raises(ValueError, match="lanes=0"):
        SessionBatch.open(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="batch_mode"):
        SessionBatch.open(cfg, 2, batch_mode="threads", device="cpu")
    with pytest.raises(ValueError,
                       match="per-lane queue_size has 2 entries for 3"):
        SessionBatch.open(cfg, 3, queue_size=[8, 8], device="cpu")
    with pytest.raises(ValueError, match="queue_size=99 not in"):
        SessionBatch.open(cfg, 2, queue_size=[8, 99], device="cpu")
    batch = SessionBatch.open(cfg, 2, capacity=8, device="cpu")
    with pytest.raises(ValueError, match="lane=5 not in"):
        batch.append(5, (np.asarray([3]), np.asarray([1]), np.asarray([0])))
    with pytest.raises(ValueError,
                       match="lane 0: appending 9 arrivals overflows "
                             "capacity 8"):
        batch.append(0, (np.full(9, 30), np.arange(9),
                         np.zeros(9, np.int64)))
    batch.append(1, (np.asarray([40]), np.asarray([1]), np.asarray([0])))
    with pytest.raises(ValueError, match="lane 1: arrival t=3 precedes"):
        batch.append(1, (np.asarray([3]), np.asarray([1]), np.asarray([0])))
    with pytest.raises(ValueError, match="entries for 2 lanes"):
        batch.advance(10, [None])


def test_window_launch_and_capture_accounting():
    """``timings`` counts windows, K3 launches and CUDA graphs: one
    launch a fused window (here the plain version's protocol), none on
    the ``split`` backend, and no graph on the CPU; a dict shared across
    sessions accumulates."""
    arrs = trace_arrays()
    pc, _ = cfgs()
    tm = {}
    for window in (113, 400):
        s = SimSession.open(pc, capacity=64, timings=tm, device="cpu")
        s.append(arrs)
        s.advance(0)  # an empty window runs nothing and is not counted
        s.run_until(600, window)
    windows = -(-600 // 113) + -(-600 // 400)
    assert tm["windows"] == tm["launches"] == windows, tm
    assert tm["captures"] == 0 and tm["run_s"] > 0 and "compile_s" in tm
    split, _ = cfgs("split")
    tm = {}
    s = SimSession.open(split, capacity=64, timings=tm, device="cpu")
    s.append(arrs)
    s.run_until(600, 200)
    assert (tm["windows"], tm["launches"], tm["captures"]) == (3, 0, 0), tm
    tm = {}
    b = SessionBatch.open(pc, 3, capacity=64, timings=tm, device="cpu")
    b.append(0, arrs)
    b.run_until(600, 200)
    assert (tm["windows"], tm["launches"], tm["captures"]) == (3, 3, 0), tm
