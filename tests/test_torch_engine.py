"""The port's event-horizon engine (repro_torch.core.simulate_fast) against
the JAX reference's simulate_fast, field for field and with equal
executed-step counts: all three FSM backends, a constant point and a
3-segment DVFS schedule, a runtime queue depth below capacity, a two-tier
(DRAM + CXL) topology, and the plain per-cycle loop (cycle_skip=False)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.core.engine import lane_schedule  # noqa: E402
from repro.core.params import RuntimeParams as JaxRP  # noqa: E402
from repro.core.params import tiered_params as jax_tiered  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import MemSimConfig, simulate_fast  # noqa: E402
from repro_torch.core import interop  # noqa: E402
from repro_torch.core.params import RuntimeParams, tiered_params  # noqa: E402
from repro_torch.core.simulator import resolve_device  # noqa: E402

CYCLES = 2_500


def port_trace(jax_trace):
    return interop.trace_from_numpy(*[np.asarray(x) for x in jax_trace])


def assert_same(ref, got, label):
    for f in ("t_admit", "t_dispatch", "t_start", "t_complete", "rdata"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f"{label}: {f}")
    for k in ref.counters:
        np.testing.assert_array_equal(np.asarray(ref.counters[k]),
                                      got.counters[k],
                                      err_msg=f"{label}: counter {k}")
    assert (ref.blocked_arrival, ref.blocked_dispatch) == \
        (got.blocked_arrival, got.blocked_dispatch), label
    assert (got.cfg.queue_size, got.cfg.resp_queue_size) == \
        (ref.cfg.queue_size, ref.cfg.resp_queue_size), label


def dvfs(cfg):
    return lane_schedule(cfg, [
        (0, {}),
        (500, {"tCL": cfg.tCL + 4, "tRCDRD": cfg.tRCDRD + 2,
               "page_policy": "open"}),
        (1300, {"tRP": cfg.tRP + 3, "tCL": cfg.tCL + 2, "tREFI": 900,
                "sched_policy": "frfcfs"}),
    ])


@pytest.mark.parametrize("backend", ["plain", "split", "fused"])
@pytest.mark.parametrize("schedule", ["constant", "dvfs"])
def test_simulate_fast_matches_reference(backend, schedule):
    jtr = JAX_BENCHMARKS["trace_example"](n=60, gap=9)
    jcfg = JaxConfig(queue_size=32, resp_queue_size=16)
    params, jparams = None, None
    if schedule == "dvfs":
        jparams = dvfs(jcfg)
        params = interop.schedule_from_numpy(*[np.asarray(x)
                                               for x in jparams.pack()])
    jt, tt = {}, {}
    ref = jax_simulate_fast(jcfg, jtr, CYCLES, queue_size=8,
                            resp_queue_size=12, params=jparams, timings=jt)
    got = simulate_fast(
        MemSimConfig(queue_size=32, resp_queue_size=16, fsm_backend=backend),
        port_trace(jtr), CYCLES, queue_size=8, resp_queue_size=12,
        params=params, timings=tt, device="cpu")
    assert_same(ref, got, f"{backend}/{schedule}")
    assert tt["steps"] == jt["steps"] < CYCLES
    assert tt["compile_s"] >= 0 and tt["run_s"] > 0


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_two_tier_topology_matches_reference(backend):
    kw = dict(channels=2, tiers=2, cxl_channels=1, queue_size=16)
    jtr = JAX_BENCHMARKS["vector_similarity"](num_vectors=40, burst_gap=12)
    jp = jax_tiered(JaxRP(), JaxRP(tRCDRD=30, tCL=24, tRFC=300, tREFI=5000))
    tp = tiered_params(RuntimeParams(), RuntimeParams(
        tRCDRD=30, tCL=24, tRFC=300, tREFI=5000))
    jt, tt = {}, {}
    ref = jax_simulate_fast(JaxConfig(**kw), jtr, 1_500, params=jp,
                            timings=jt)
    got = simulate_fast(MemSimConfig(fsm_backend=backend, **kw),
                        port_trace(jtr), 1_500, params=tp, timings=tt,
                        device="cpu")
    assert_same(ref, got, f"tiers/{backend}")
    assert tt["steps"] == jt["steps"]


def test_cycle_skip_false_is_the_per_cycle_loop():
    jtr = JAX_BENCHMARKS["multihead_attention"](seq=4, dim=4, heads=1,
                                                burst_gap=20)
    ref = jax_simulate_fast(JaxConfig(queue_size=16), jtr, 700,
                            queue_size=4, cycle_skip=False)
    tt = {}
    got = simulate_fast(MemSimConfig(queue_size=16), port_trace(jtr), 700,
                        queue_size=4, cycle_skip=False, timings=tt,
                        device="cpu")
    assert_same(ref, got, "scan")
    assert tt["steps"] == 700


def test_padded_and_sentinel_traces_are_inert():
    from repro_torch.core.engine import _pad_trace, _sentinel_trace

    tr = port_trace(JAX_BENCHMARKS["trace_example"](n=10, gap=5))
    padded = _pad_trace(tr, 30)
    assert padded.t.shape == (30,) and int(padded.t[-1]) == 0x3FFFFFFF
    a = simulate_fast(MemSimConfig(queue_size=8), tr, 400, device="cpu")
    b = simulate_fast(MemSimConfig(queue_size=8), padded, 400, device="cpu")
    np.testing.assert_array_equal(a.t_complete, b.t_complete[:20])
    assert (b.t_complete[20:] == -1).all()
    s = simulate_fast(MemSimConfig(queue_size=8), _sentinel_trace(5), 300,
                      device="cpu")
    assert (s.t_admit == -1).all()
    bad = tr._replace(t=torch.full_like(tr.t, 0x3FFFFFFF))
    with pytest.raises(ValueError, match="padding sentinel"):
        _pad_trace(bad, 30)


def test_entry_points_default_to_the_card():
    """device=None means CUDA; without a card it raises, never falling
    back to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    tr = port_trace(JAX_BENCHMARKS["trace_example"](n=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_fast(MemSimConfig(), tr, 10)


class _ReplayByRerun:
    """Stand-in for a captured CUDA graph: a replay reruns the step on the
    live state, copies the registers back and advances the device clock,
    which is what the captured graph does on the card."""

    def __init__(self, owner, fn, skip):
        self.owner, self.fn = owner, fn
        self.delta = torch.zeros((), dtype=torch.int32) if skip else None

    def replay(self):
        from repro_torch.core.graphs import copy_into

        o = self.owner
        new, delta = self.fn(o.state, o.cycle.clone())
        copy_into(o.state, new)
        if delta is None:
            o.cycle.add_(1)
        else:
            self.delta.copy_(delta)
            o.cycle.add_(delta + 1)


@pytest.mark.parametrize("backend", ["plain", "split", "fused"])
def test_graph_replay_loop_matches_reference(backend, monkeypatch):
    """The card's loop (one replayed step per segment, eager steps before
    a boundary, registers copied back into the live state, the clock kept
    on the device) driven on the CPU through a stand-in graph: equal to
    the reference across a 3-segment schedule, for both engines."""
    from repro.core import simulate as jax_simulate
    from repro_torch.core import graphs, simulate

    class CpuGraphs(graphs.StepGraphs):
        def _capture(self, fn):
            _, delta = fn(graphs._clone(self.state), self.cycle.clone())
            g = _ReplayByRerun(self, fn, delta is not None)
            return g, g.delta, {}

    monkeypatch.setattr(graphs, "graphs_for", CpuGraphs)
    jtr = JAX_BENCHMARKS["trace_example"](n=60, gap=9)
    jcfg = JaxConfig(queue_size=32, resp_queue_size=16)
    jparams = dvfs(jcfg)
    params = interop.schedule_from_numpy(*[np.asarray(x)
                                           for x in jparams.pack()])
    cfg = MemSimConfig(queue_size=32, resp_queue_size=16, fsm_backend=backend)
    jt, tt = {}, {}
    ref = jax_simulate_fast(jcfg, jtr, 1_400, queue_size=8, params=jparams,
                            timings=jt)
    got = simulate_fast(cfg, port_trace(jtr), 1_400, queue_size=8,
                        params=params, timings=tt, device="cpu")
    assert_same(ref, got, f"graph loop/{backend}")
    assert tt["steps"] == jt["steps"]
    ref = jax_simulate(JaxConfig(queue_size=8), jtr, 1_400, params=jparams)
    got = simulate(MemSimConfig(queue_size=8, fsm_backend=backend),
                   port_trace(jtr), 1_400, params=params, device="cpu")
    assert_same(ref, got, f"graph per-cycle/{backend}")
