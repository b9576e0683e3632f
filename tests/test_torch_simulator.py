"""The port's per-cycle engine (repro_torch.core.simulate) against the JAX
reference (repro.core.simulate), field for field, on the four paper
traces (scaled down) under both page and both scheduling policies; the
three FSM backends against each other; a mid-run start carried across
with repro_torch.core.interop; and the ideal model and Table-2 stats."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate as jax_simulate  # noqa: E402
from repro.core import simulate_ideal as jax_simulate_ideal  # noqa: E402
from repro.core import stats as jax_stats  # noqa: E402
from repro.core.simulator import cycle_step as jax_cycle_step  # noqa: E402
from repro.core.simulator import init_state as jax_init_state  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import MemSimConfig, simulate, simulate_ideal  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.core import interop  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    ScheduleView,
    run_cycles,
    state_to_result,
)

CYCLES = 800


def small(name, pkg_benchmarks):
    gen = pkg_benchmarks[name]
    if name == "conv2d":
        return gen(h=10, w=10, burst_gap=24)
    if name == "multihead_attention":
        return gen(seq=6, dim=4, heads=1, burst_gap=30)
    if name == "trace_example":
        return gen(n=80, gap=5)
    return gen(num_vectors=60, burst_gap=18)


def port_trace(jax_trace):
    return interop.trace_from_numpy(*[np.asarray(x) for x in jax_trace])


def assert_results_equal(ref, got, label=""):
    for f in ("t_intended", "is_write", "t_admit", "t_dispatch", "t_start",
              "t_complete", "rdata"):
        a, b = getattr(ref, f), getattr(got, f)
        assert b.dtype == np.int32, f"{label}: {f} dtype {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{label}: {f}")
    assert set(ref.counters) == set(got.counters), label
    for k in ref.counters:
        np.testing.assert_array_equal(np.asarray(ref.counters[k]),
                                      got.counters[k],
                                      err_msg=f"{label}: counter {k}")
    assert ref.blocked_arrival == got.blocked_arrival, label
    assert ref.blocked_dispatch == got.blocked_dispatch, label


@pytest.mark.parametrize("bench", sorted(JAX_BENCHMARKS))
@pytest.mark.parametrize("page_policy", ["closed", "open"])
@pytest.mark.parametrize("sched_policy", ["fcfs", "frfcfs"])
def test_simulate_matches_reference(bench, page_policy, sched_policy):
    kw = dict(queue_size=16, page_policy=page_policy,
              sched_policy=sched_policy)
    jtr = small(bench, JAX_BENCHMARKS)
    ref = jax_simulate(JaxConfig(**kw), jtr, num_cycles=CYCLES)
    got = simulate(MemSimConfig(fsm_backend="plain", **kw), port_trace(jtr),
                   num_cycles=CYCLES, device="cpu")
    assert_results_equal(ref, got, f"{bench}/{page_policy}/{sched_policy}")


@pytest.mark.parametrize("backend", ["split", "fused"])
@pytest.mark.parametrize("page_policy", ["closed", "open"])
def test_kernel_backends_match_plain(backend, page_policy):
    """split (K1 plain version) and fused (K3 plain version) == plain."""
    kw = dict(queue_size=8, page_policy=page_policy, sched_policy="frfcfs",
              channels=2, ranks=1, bankgroups=2, banks_per_group=2)
    tr = port_trace(JAX_BENCHMARKS["trace_example"](n=40, gap=6))
    ref = simulate(MemSimConfig(fsm_backend="plain", **kw), tr, 600,
                   device="cpu")
    got = simulate(MemSimConfig(fsm_backend=backend, **kw), tr, 600,
                   device="cpu")
    assert_results_equal(ref, got, backend)


def test_mid_run_state_carried_across():
    """Run the reference to cycle 300, carry its whole SimState into the
    port (interop.state_from_numpy), step both to cycle 700, and compare
    every leaf of the two states (interop.state_to_numpy)."""
    jcfg = JaxConfig(queue_size=8, page_policy="open", sched_policy="frfcfs")
    cfg = MemSimConfig(queue_size=8, page_policy="open",
                       sched_policy="frfcfs")
    jtr = JAX_BENCHMARKS["vector_similarity"](num_vectors=30, burst_gap=10)
    jtopo = jcfg.topology()
    rp = jcfg.runtime()

    @jax.jit
    def advance(state, start):
        def step(s, c):
            return jax_cycle_step(jtopo, rp, jtr, s, c), None
        return jax.lax.scan(step, state,
                            start + jnp.arange(400, dtype=jnp.int32))[0]

    js = jax_init_state(jtopo, rp, jtr.num_requests)
    js = advance(js, jnp.int32(0))
    flat = interop.flatten(js)
    ts = interop.state_from_numpy(flat, device="cpu")
    assert set(interop.state_to_numpy(ts)) == set(flat)
    for k, v in interop.state_to_numpy(ts).items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    js2 = advance(js, jnp.int32(400))
    for backend in ("plain", "fused"):
        topo = MemSimConfig(queue_size=8, page_policy="open",
                            sched_policy="frfcfs",
                            fsm_backend=backend).topology()
        view = ScheduleView(topo, cfg.runtime(), "cpu")
        tr = port_trace(jtr)
        ts2 = run_cycles(topo, view, tr,
                         interop.state_from_numpy(flat, device="cpu"),
                         400, 800)
        got = interop.state_to_numpy(ts2)
        want = interop.flatten(js2)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k],
                                          err_msg=f"{backend}: {k}")
        res = state_to_result(cfg, tr, ts2, 800)
        assert res.t_complete.shape == (jtr.num_requests,)


@pytest.mark.parametrize("bench", sorted(JAX_BENCHMARKS))
def test_ideal_and_stats_match_reference(bench):
    jtr = JAX_BENCHMARKS[bench]()
    tr = port_trace(jtr)
    jcfg, cfg = JaxConfig(queue_size=16), MemSimConfig(queue_size=16)
    ji = jax_simulate_ideal(jcfg, jtr)
    ti = simulate_ideal(cfg, tr, device="cpu")
    for f in ("t_complete", "rdata"):
        a, b = np.asarray(getattr(ji, f)), getattr(ti, f).numpy()
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f)
    small_j = small(bench, JAX_BENCHMARKS)
    ref = jax_simulate(jcfg, small_j, num_cycles=600)
    got = simulate(MemSimConfig(queue_size=16, fsm_backend="plain"),
                   port_trace(small_j), 600, device="cpu")
    ideal = np.asarray(jax_simulate_ideal(jcfg, small_j).t_complete)
    assert dataclasses.asdict(stats.cycle_diffs(got, ideal)) == \
        dataclasses.asdict(jax_stats.cycle_diffs(ref, ideal))
    assert stats.latency_summary(got) == jax_stats.latency_summary(ref)
    assert stats.latency_breakdown(got) == jax_stats.latency_breakdown(ref)
    assert stats.format_table2([(bench, stats.cycle_diffs(got, ideal))]) == \
        jax_stats.format_table2([(bench, jax_stats.cycle_diffs(ref, ideal))])
    cut_j = jax_stats.records_at_horizon(ref, 300)
    cut_t = stats.records_at_horizon(got, 300)
    np.testing.assert_array_equal(cut_j.t_complete, cut_t.t_complete)


def test_traces_and_trace_files_match_reference(tmp_path):
    from repro.traces import io as jio
    from repro_torch.traces import BENCHMARKS, io

    for name in sorted(BENCHMARKS):
        for x, y in zip(JAX_BENCHMARKS[name](), BENCHMARKS[name]()):
            assert y.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    path = str(tmp_path / "t.trc")
    io.save_trace(path, BENCHMARKS["vector_similarity"](num_vectors=20))
    for x, y in zip(jio.load_trace(path), io.load_trace(path)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
