"""The per-cycle form of the persistent K3 (``fused_run(...,
cycle_skip=False)``) on the CPU, where it runs its plain version
``fused_run_plain``: the eager step of the fused backend with horizon
``t + 1`` (delta 0), no skip, the clock up by one. It is what the port's
``simulate`` and ``simulate_fast(cycle_skip=False)`` run on the fused
backend.

* the port's ``simulate`` (fused) against JAX ``repro.core.simulate``,
  every ``SimResult`` field, the counters and the blocked totals: a
  constant point, a 3-segment DVFS schedule with an FR-FCFS segment, a
  two-tier DRAM + CXL topology, small queues that block, a lane of 2048
  banks and queues of 8192 (the cases of ``test_torch_fused_run``, at
  per-cycle horizons, the DVFS boundaries moved inside them);
* ``simulate_fast(cycle_skip=False)`` against JAX's, with runtime queue
  limits below capacity: one launch, steps == cycles;
* a per-cycle run cut into launches of 1 and 7 steps is the same run;
* the kernel's per-bank-thread stage order with the skip compiled out
  (``_run_step_mirror`` with ``cycle_skip=False``, k banks a thread)
  against JAX ``cycle_step`` (fused), and the port's plain step with it;
* a trace with no request raises ``IndexError``, as the reference does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate as jax_simulate  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.core.engine import lane_schedule  # noqa: E402
from repro.core.params import RuntimeParams as JaxRP  # noqa: E402
from repro.core.params import as_schedule as jax_as_schedule  # noqa: E402
from repro.core.params import tiered_params as jax_tiered  # noqa: E402
from repro.core.simulator import Trace as JaxTrace  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import MemSimConfig, interop, simulate  # noqa: E402
from repro_torch.core import simulate_fast  # noqa: E402
from repro_torch.core.simulator import Trace  # noqa: E402
from test_torch_engine import assert_same, dvfs, port_trace  # noqa: E402
from test_torch_fused_run import (  # noqa: E402
    _LAYOUTS, _SLOW_CXL, _TIERED, _case, _check_step_order,
    _run_in_launches)

# per-cycle horizons: each case's events (the DVFS boundaries, the
# blocking burst, the 2048-bank trace) lie inside its horizon
_CYCLES = {"constant": 300, "dvfs_frfcfs": 400, "two_tier": 300,
           "small_queues": 300, "banks_2048": 200, "queues_8192": 300}


def _early_dvfs(cfg):
    """``test_torch_engine.dvfs`` with its boundaries at 150 and 300: open
    pages, then open-page FR-FCFS with a short tREFI."""
    return lane_schedule(cfg, [
        (0, {}),
        (150, {"tCL": cfg.tCL + 4, "tRCDRD": cfg.tRCDRD + 2,
               "page_policy": "open"}),
        (300, {"tRP": cfg.tRP + 3, "tCL": cfg.tCL + 2, "tREFI": 900,
               "sched_policy": "frfcfs"}),
    ])


def _per_cycle_case(name):
    """``_case`` of ``test_torch_fused_run`` with the per-cycle horizon and
    the early DVFS schedule."""
    jcfg, cfg, jtr, jp, tp, q, rq, _ = _case(name)
    if name == "dvfs_frfcfs":
        jp = _early_dvfs(jcfg)
        tp = interop.schedule_from_numpy(*[np.asarray(x)
                                           for x in jp.pack()])
    return jcfg, cfg, jtr, jp, tp, q, rq, _CYCLES[name]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loop's ops are tiny: one intra-op thread runs them faster
    than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(_CYCLES))
def test_simulate_matches_reference(name):
    """``simulate`` has no runtime queue limits: a case that sets them runs
    at those capacities instead."""
    jcfg, cfg, jtr, jp, tp, q, rq, cycles = _per_cycle_case(name)
    if q is not None:
        jcfg, cfg = (dataclasses.replace(c, queue_size=q, resp_queue_size=rq)
                     for c in (jcfg, cfg))
    ref = jax_simulate(jcfg, jtr, cycles, params=jp)
    got = simulate(cfg, port_trace(jtr), cycles, params=tp, device="cpu")
    assert_same(ref, got, name)
    if name == "small_queues":
        assert got.blocked_arrival > 0 and got.blocked_dispatch > 0


@pytest.mark.parametrize("name", ["dvfs_frfcfs", "small_queues"])
def test_simulate_fast_per_cycle_matches_reference(name):
    jcfg, cfg, jtr, jp, tp, q, rq, cycles = _per_cycle_case(name)
    ref = jax_simulate_fast(jcfg, jtr, cycles, queue_size=q,
                            resp_queue_size=rq, params=jp, cycle_skip=False)
    tt = {}
    got = simulate_fast(cfg, port_trace(jtr), cycles, queue_size=q,
                        resp_queue_size=rq, params=tp, cycle_skip=False,
                        timings=tt, device="cpu")
    assert_same(ref, got, name)
    assert tt["steps"] == cycles and tt["launches"] == 1


def test_budgets_cut_the_same_per_cycle_run():
    jcfg = JaxConfig(queue_size=32, resp_queue_size=16)
    cfg = MemSimConfig(queue_size=32, resp_queue_size=16)
    jp = _early_dvfs(jcfg)
    params = interop.schedule_from_numpy(*[np.asarray(x) for x in jp.pack()])
    jtr = JAX_BENCHMARKS["trace_example"](n=30, gap=9)
    cycles = 320
    whole, steps, launches = _run_in_launches(cfg, jtr, params, cycles, None,
                                              cycle_skip=False)
    assert launches == 1 and steps == cycles
    for budget in (1, 7):
        cut, n, k = _run_in_launches(cfg, jtr, params, cycles, budget,
                                     cycle_skip=False)
        assert n == cycles and k == -(-cycles // budget)
        assert cut.keys() == whole.keys()
        for key in whole:
            np.testing.assert_array_equal(cut[key], whole[key],
                                          err_msg=f"budget {budget}: {key}")


@pytest.mark.parametrize("tiered", [False, True], ids=["table1", "two_tier"])
def test_kernel_step_order_per_cycle(tiered):
    rng = np.random.default_rng(25 + tiered)
    kw = dict(queue_size=8, resp_queue_size=8, **(_TIERED if tiered else {}))
    if tiered:
        open_fr = dict(page_policy=1, sched_policy=1)
        jsched = jax_as_schedule(jax_tiered(JaxRP(**open_fr),
                                            JaxRP(**_SLOW_CXL, **open_fr)))
    else:
        jsched = dvfs(JaxConfig(**kw))
    _check_step_order(rng, kw, jsched, cycle_skip=False)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("banks_per_thread", [2, 4])
def test_kernel_step_order_per_cycle_with_banks_per_thread(banks_per_thread,
                                                           layout):
    rng = np.random.default_rng(27 + banks_per_thread)
    kw = dict(queue_size=8, resp_queue_size=8, **_LAYOUTS[layout])
    _check_step_order(rng, kw, dvfs(JaxConfig(**kw)), banks_per_thread,
                      cycle_skip=False)


def test_empty_trace_raises_like_reference():
    """The reference's first read of an empty trace is out of bounds."""
    jtr = JaxTrace(*[jnp.zeros((0,), jnp.int32) for _ in range(4)])
    with pytest.raises(IndexError):
        jax_simulate(JaxConfig(), jtr, 50)
    tr = Trace(*[torch.zeros((0,), dtype=torch.int32) for _ in range(4)])
    with pytest.raises(IndexError):
        simulate(MemSimConfig(), tr, 50, device="cpu")
    for skip in (True, False):
        with pytest.raises(IndexError):
            simulate_fast(MemSimConfig(), tr, 50, cycle_skip=skip,
                          device="cpu")
