"""The closed-loop serving co-simulation of the port (``repro_torch.serving``
and ``repro_torch.traces.llm_workload``) on the CPU, against the JAX
reference's ``repro.serving`` and ``repro.traces.llm_workload``.

Cases: the request streams of every arrival process and length mixture
(and of ``spawn_seeds`` / ``generate_request_batch``); the KV pager's
address sequences, flat and tiered; every ``llm_workload`` generator,
element for element; ``run_serving`` and ``run_serving_batched`` against
the reference, every ``ServingResult`` field and the session records, at a
small size (two chat requests over 1000 cycles, a pager of 2 words a
token, windows of 50); the DRAM-against-CXL backpressure contrast on the
same scenario; the batched lanes against sequential runs; and
``save_session_trace`` of a ``SimSession`` and of a ``SessionLane``,
replayed open loop.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.perfmodel.effective_bw import \
    cxl_tier_point as jax_cxl_tier_point  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.traces import llm_workload as jax_llm  # noqa: E402
from repro_torch import golden  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import MemSimConfig, SessionLane, SimSession, \
    simulate_fast  # noqa: E402
from repro_torch.core.params import RuntimeParams  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    KVPager,
    PageState,
    Request,
    ServingResult,
    generate_request_batch,
    generate_requests,
    spawn_seeds,
)
from repro_torch.serving.workload import ARRIVAL_PROCESSES, MIXTURES  # noqa: E402
from repro_torch.traces import llm_workload  # noqa: E402
from repro_torch.traces.io import load_trace, save_session_trace  # noqa: E402

RECORDS = ("t_admit", "t_dispatch", "t_start", "t_complete", "rdata")


def as_tuples(reqs):
    return [dataclasses.astuple(r) for r in reqs]


def trace_np(tr):
    return [np.asarray(x) for x in tr]


def assert_traces(ref, got, label):
    for f, a, b in zip(("t", "addr", "is_write", "wdata"), trace_np(ref),
                       trace_np(got)):
        np.testing.assert_array_equal(a, b, err_msg=f"{label}: {f}")


# --------------------------------------------------------------------------
# workload scenarios


@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
@pytest.mark.parametrize("mixture", MIXTURES)
def test_request_streams_equal_jax(process, mixture):
    kw = dict(process=process, mixture=mixture, rate_per_kcycle=2.0,
              horizon=30_000, seed=7)
    got = generate_requests(**kw)
    assert len(got) > 0 and all(isinstance(r, Request) for r in got)
    assert as_tuples(got) == as_tuples(jax_serving.generate_requests(**kw))


def test_seeded_batches_and_axes_equal_jax():
    assert spawn_seeds(11, 4) == jax_serving.spawn_seeds(11, 4)
    scen = [dict(rate_per_kcycle=r, horizon=5_000, mixture=m)
            for r, m in ((0.5, "chat"), (4.0, "mixed"))]
    for independent in (True, False):
        got = generate_request_batch(scen, seed=3,
                                     independent_streams=independent)
        ref = jax_serving.generate_request_batch(
            scen, seed=3, independent_streams=independent)
        assert [as_tuples(x) for x in got] == [as_tuples(x) for x in ref]
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    from repro_torch.serving.workload import arrival_times, sample_lengths
    np.testing.assert_array_equal(
        arrival_times("diurnal", 3.0, 40_000, rng, period=7_000),
        jax_workload.arrival_times("diurnal", 3.0, 40_000, jrng,
                                   period=7_000))
    for a, b in zip(sample_lengths("mixed", 50, rng),
                    jax_workload.sample_lengths("mixed", 50, jrng)):
        np.testing.assert_array_equal(a, b)
    assert ARRIVAL_PROCESSES == jax_workload.ARRIVAL_PROCESSES
    assert MIXTURES == jax_workload.MIXTURES
    with pytest.raises(ValueError, match="unknown arrival process"):
        generate_requests(process="adversarial")
    with pytest.raises(ValueError, match="unknown mixture"):
        generate_requests(mixture="novel")


# --------------------------------------------------------------------------
# paged KV cache


def pager_script(cls, tiered):
    """One admit / append / gather / evict sequence; returns every address
    array and page state it produced, and the exhaustion error text."""
    p = cls(num_blocks=12, block_words=64, words_per_token=16, hot_blocks=1,
            tiered=tiered, interleave_log2=6, cxl_frac_log2=1)
    rng = np.random.default_rng(1)
    out = []
    p.admit(0)
    p.admit(1)
    for tokens in (3, 8, 1, 5):
        out.append(p.append_addrs(0, tokens))
        out.append(p.append_addrs(1, 2))
        out.append(p.gather_addrs(0, 40, rng))
        out.append(p.gather_addrs(1, 7, rng))
    states = [dataclasses.astuple(p.page_state())]
    p.free_seq(0)
    states.append(dataclasses.astuple(p.page_state()))
    out.append(p.append_addrs(1, 9))
    states.append((p.can_admit(4), p.can_admit(40),
                   p.page_state().occupancy))
    try:
        p.append_addrs(1, 400)
        err = None
    except RuntimeError as e:
        err = str(e)
    return out, states, err


@pytest.mark.parametrize("tiered", [False, True])
def test_pager_address_sequences_equal_jax(tiered):
    got, got_states, got_err = pager_script(KVPager, tiered)
    ref, ref_states, ref_err = pager_script(jax_serving.KVPager, tiered)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert got_states == ref_states
    assert got_err == ref_err and "exhausted" in got_err
    assert isinstance(KVPager().page_state(), PageState)


# --------------------------------------------------------------------------
# llm_workload


def test_llm_workload_generators_equal_jax():
    for fn, kw in (("decode_serving_trace", dict(tokens=12, seed=3)),
                   ("tiered_decode_trace", dict(tokens=10, seed=4)),
                   ("tiered_decode_trace",
                    dict(tokens=6, interleave_log2=8, cxl_frac_log2=2)),
                   ("tiered_prefill_trace", dict(chunks=9)),
                   ("tiered_prefill_trace",
                    dict(chunks=5, hot_frac=0.25, interleave_log2=7))):
        assert_traces(getattr(jax_llm, fn)(**kw),
                      getattr(llm_workload, fn)(**kw), f"{fn} {kw}")
    idx = np.arange(0, 5000, 7)
    for il, k in ((6, 1), (8, 2)):
        np.testing.assert_array_equal(llm_workload.dram_words(idx, il, k),
                                      jax_llm.dram_words(idx, il, k))
        np.testing.assert_array_equal(llm_workload.cxl_words(idx, il, k),
                                      jax_llm.cxl_words(idx, il, k))
    steps = (("decode_step_traffic", (2e9, 5e8)),
             ("train_step_traffic", (2e9, 1e9)),
             ("prefill_step_traffic", (2e9, 1e9, 3e8)))
    for fn, args in steps:
        got = getattr(llm_workload, fn)("m", *args)
        ref = getattr(jax_llm, fn)("m", *args)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
        assert got.total == ref.total
        tr, bpr = llm_workload.synthesize(got, target_requests=900, seed=2)
        jtr, jbpr = jax_llm.synthesize(ref, target_requests=900, seed=2)
        assert bpr == jbpr
        assert_traces(jtr, tr, f"synthesize {fn}")
    cost = llm_workload.traffic_from_cost("c", 1e9, 0.5, 0.7)
    assert dataclasses.astuple(cost) == dataclasses.astuple(
        jax_llm.traffic_from_cost("c", 1e9, 0.5, 0.7))
    with pytest.raises(ValueError, match="empty traffic"):
        llm_workload.synthesize(llm_workload.WorkloadTraffic(
            "z", 0, 0, 0, 0, 0))
    for kw in (dict(), dict(boost_frac=0.1, throttle_scale=2.0)):
        got = llm_workload.thermal_throttle_schedule(20_000, **kw)
        assert got == jax_llm.thermal_throttle_schedule(20_000, **kw)
    base = RuntimeParams(tCL=20, tRP=16)
    assert llm_workload.thermal_throttle_schedule(9_000, base=base) == \
        jax_llm.thermal_throttle_schedule(
            9_000, base=jax_llm_rp(tCL=20, tRP=16))
    assert llm_workload.thermal_throttle_schedule(
        9_000, base=MemSimConfig(tCL=18)) == \
        jax_llm.thermal_throttle_schedule(9_000, base=JaxConfig(tCL=18))
    with pytest.raises(ValueError, match="fractions"):
        llm_workload.thermal_throttle_schedule(100, boost_frac=0.9)


def jax_llm_rp(**kw):
    from repro.core.params import RuntimeParams as JaxRP

    return JaxRP(**kw)


# --------------------------------------------------------------------------
# the closed loop


#: a small closed loop: short windows and a pager of 2 words a token keep
#: the CPU run short while the CXL device still pushes back
SMALL = dict(window_cycles=50, capacity=4096)
SCENARIO = dict(rate_per_kcycle=2.0, horizon=1_000, seed=1)
SECOND = dict(rate_per_kcycle=1.0, horizon=1_000, seed=8)


def small_serving(cls):
    return cls(max_batch=4, weight_reads_per_token=4, kv_reads_per_token=2,
               prefill_tokens_per_step=4)


def small_pager(cls, cfg):
    return cls(num_blocks=64, block_words=64, words_per_token=2,
               tiered=cfg.tiers > 1, interleave_log2=cfg.tier_interleave_log2,
               cxl_frac_log2=cfg.tier_cxl_frac_log2)


def topology(name, jax_side):
    """A study topology of either package (``golden.serving_topologies``
    on the port's side, the reference's ``cxl_tier_point`` on JAX's)."""
    if not jax_side:
        return {n: (c, p) for n, c, p in golden.serving_topologies()}[name]
    if name == "dram":
        return JaxConfig(channels=2), None
    cfg = JaxConfig(channels=2, tiers=2, cxl_channels=1)
    return cfg, jax_cxl_tier_point(cfg, cfg.tier_interleave_log2,
                                   cfg.tier_cxl_frac_log2,
                                   **golden.SERVING_CXL)


@functools.lru_cache(maxsize=None)
def closed_loop(name, jax_side):
    """``run_serving`` of :data:`SCENARIO` on topology ``name``."""
    cfg, params = topology(name, jax_side)
    pkg = jax_serving if jax_side else serving
    kw = {} if jax_side else {"device": "cpu"}
    tm = {}
    res = pkg.run_serving(cfg, pkg.generate_requests(**SCENARIO),
                          small_serving(pkg.ServingConfig), params=params,
                          pager=small_pager(pkg.KVPager, cfg), timings=tm,
                          **SMALL, **kw)
    return res, tm


@functools.lru_cache(maxsize=None)
def batched(jax_side):
    """``run_serving_batched`` of :data:`SCENARIO` and :data:`SECOND` on
    the DRAM topology."""
    cfg, _ = topology("dram", jax_side)
    pkg = jax_serving if jax_side else serving
    kw = {} if jax_side else {"device": "cpu"}
    tm = {}
    res = pkg.run_serving_batched(
        cfg, [pkg.generate_requests(**SCENARIO),
              pkg.generate_requests(**SECOND)],
        small_serving(pkg.ServingConfig),
        pagers=[small_pager(pkg.KVPager, cfg) for _ in range(2)],
        timings=tm, **SMALL, **kw)
    return res, tm


def assert_serving(ref, got, label, counters=True):
    assert isinstance(got, ServingResult)
    for f in ("offered", "completed", "tokens", "cycles", "admitted_batch",
              "batch_target", "tokens_per_kcycle"):
        assert getattr(ref, f) == getattr(got, f), (label, f)
    np.testing.assert_array_equal(ref.queueing, got.queueing)
    np.testing.assert_array_equal(ref.service, got.service)
    assert ref.session.cycle == got.session.cycle, label
    assert ref.session.arrivals_total == got.session.arrivals_total, label
    assert_traces(ref.session.trace(), got.session.trace(), label)
    ra, rb = ref.session.result(), got.session.result()
    for f in RECORDS:
        np.testing.assert_array_equal(np.asarray(getattr(ra, f)),
                                      getattr(rb, f),
                                      err_msg=f"{label}: {f}")
    if counters:
        for k in ra.counters:
            np.testing.assert_array_equal(np.asarray(ra.counters[k]),
                                          rb.counters[k],
                                          err_msg=f"{label}: {k}")
        assert (ra.blocked_arrival, ra.blocked_dispatch) == \
            (rb.blocked_arrival, rb.blocked_dispatch), label


def test_study_topologies_equal_jax():
    for name in golden.SERVING_TOPOLOGIES:
        (pc, pp), (jc, jp) = topology(name, False), topology(name, True)
        for f in ("channels", "ranks", "bankgroups", "banks_per_group",
                  "tiers", "cxl_channels", "queue_size", "resp_queue_size",
                  "tier_interleave_log2", "tier_cxl_frac_log2"):
            assert getattr(pc, f) == getattr(jc, f), (name, f)
        if jp is None:
            assert pp is None
            continue
        for f in RuntimeParams._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pp, f)), np.asarray(getattr(jp, f)),
                err_msg=f"{name}: {f}")


@pytest.mark.parametrize("name", ["dram", "cxl"])
def test_run_serving_equals_jax(name):
    ref, _ = closed_loop(name, True)
    got, tm = closed_loop(name, False)
    assert isinstance(got.session, SimSession)
    assert_serving(ref, got, name)
    assert tm["windows"] == tm["launches"] == len(got.admitted_batch)


def test_backpressure_contrast():
    """The same offered work on the slower (CXL) device: every request
    still drains, but fewer tokens a kilocycle and a smaller AIMD target
    trajectory — the closed loop's response to memory pressure."""
    dram, _ = closed_loop("dram", False)
    cxl, _ = closed_loop("cxl", False)
    assert dram.completed == cxl.completed == dram.offered > 0
    assert cxl.tokens == dram.tokens
    assert cxl.tokens_per_kcycle < dram.tokens_per_kcycle
    assert np.mean(cxl.batch_target) < np.mean(dram.batch_target)
    assert min(cxl.batch_target) < 4


def test_run_serving_batched_equals_jax_and_sequential():
    ref, _ = batched(True)
    got, tm = batched(False)
    assert len(got) == 2
    for i, (a, b) in enumerate(zip(ref, got)):
        assert isinstance(b.session, SessionLane)
        assert_serving(a, b, f"lane {i}")
    assert tm["windows"] == tm["launches"] == max(len(r.admitted_batch)
                                                  for r in got)
    # lane 0 is the sequential DRAM run, its records and results
    seq, _ = closed_loop("dram", False)
    assert_serving(seq, got[0], "lane 0 vs run_serving", counters=False)


def test_save_session_trace_round_trip(tmp_path):
    """A session's and a batch lane's realized stream written as a
    DRAMSim3 trace, read back, and replayed open loop to the closed
    loop's records."""
    seq, _ = closed_loop("dram", False)
    lane = batched(False)[0][1]
    for label, res in (("session", seq), ("lane", lane)):
        path = str(tmp_path / f"{label}.trace")
        written = save_session_trace(path, res.session)
        loaded = load_trace(path)
        for f in ("t", "addr", "is_write"):
            np.testing.assert_array_equal(getattr(written, f).numpy(),
                                          getattr(loaded, f).numpy())
        assert loaded.num_requests == res.session.arrivals_total
    cfg, _ = topology("dram", False)
    replay = simulate_fast(cfg, load_trace(str(tmp_path / "session.trace")),
                           seq.session.cycle, device="cpu")
    closed = seq.session.result()
    for f in ("t_admit", "t_dispatch", "t_start", "t_complete"):
        np.testing.assert_array_equal(getattr(replay, f), getattr(closed, f),
                                      err_msg=f"replay: {f}")
