"""Per-function parity of the port's RTL building blocks with the JAX
reference, on random states: queues and arbiters (with ties), the DRAM
timing model, the bank FSM and its event bound, and the power counters.
Mirrors the guards of tests/test_rtl_guards.py on the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.bank_fsm as jbf  # noqa: E402
import repro.core.dram_model as jdm  # noqa: E402
import repro.core.params as jp  # noqa: E402
import repro.core.power as jpw  # noqa: E402
import repro.core.queues as jq  # noqa: E402
import repro_torch.core.bank_fsm as tbf  # noqa: E402
import repro_torch.core.dram_model as tdm  # noqa: E402
import repro_torch.core.params as tp  # noqa: E402
import repro_torch.core.power as tpw  # noqa: E402
import repro_torch.core.queues as tq  # noqa: E402
from repro_torch.core.interop import flatten  # noqa: E402


def J(x, dtype=jnp.int32):
    return jnp.asarray(np.asarray(x), dtype)


def T(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def assert_same(j, t, msg=""):
    fj, ft = flatten(j), flatten(t)
    assert set(fj) == set(ft), msg
    for k in fj:
        a, b = np.asarray(fj[k]), np.asarray(ft[k])
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")
        if a.dtype == np.int32:
            assert b.dtype == np.int32, f"{msg} {k}: {b.dtype}"


# ------------------------------------------------------------- queues ----

@pytest.mark.parametrize("seed", range(6))
def test_fifo_ops(seed):
    rng = np.random.default_rng(seed)
    q = 8
    buf = rng.integers(0, 100, (q, 4))
    head, count = int(rng.integers(0, q)), int(rng.integers(0, q + 1))
    limit = int(rng.integers(1, q + 1))
    item = rng.integers(0, 100, 4)
    for en in (True, False):
        jf = jq.Fifo(J(buf), J(head), J(count), J(limit))
        tf = tq.Fifo(T(buf), T(head), T(count), T(limit))
        assert_same(jf.peek_valid(), tf.peek_valid(), "peek")
        assert_same(jf.full(), tf.full(), "full")
        assert_same(jf.push(J(item), J(en, bool)),
                    tf.push(T(item), T(en, torch.bool)), "push")
        jf = jq.Fifo(J(buf), J(head), J(count), J(limit))
        tf = tq.Fifo(T(buf), T(head), T(count), T(limit))
        assert_same(jf.pop(J(en, bool)), tf.pop(T(en, torch.bool)), "pop")


def test_fifo_push_into_full_queue_does_not_commit():
    tf = tq.Fifo.make(4, limit=2)
    for i in range(3):
        tf = tf.push(T([i, 0, i, i]), T(True, torch.bool))
    assert int(tf.count) == 2
    assert tf.buf[:, 0].tolist() == [0, 1, 0, 0]


@pytest.mark.parametrize("seed", range(6))
def test_banked_fifo_ops(seed):
    rng = np.random.default_rng(seed)
    b, q = 8, 6
    buf = rng.integers(0, 50, (b, q, 4))
    head = rng.integers(0, q, b)
    count = rng.integers(0, q + 1, b)
    limit = int(rng.integers(1, q + 1))
    bank = int(rng.integers(0, b))
    item = rng.integers(0, 50, 4)
    en = rng.integers(0, 2, b).astype(bool)

    def mk():
        return (jq.BankedFifo(J(buf), J(head), J(count), J(limit)),
                tq.BankedFifo(T(buf), T(head), T(count), T(limit)))

    jf, tf = mk()
    assert_same(jf.peek_valid(), tf.peek_valid(), "peek")
    assert_same(jf.full(), tf.full(), "full")
    for e in (True, False):
        jf, tf = mk()
        assert_same(jf.push_at(J(bank), J(item), J(e, bool)),
                    tf.push_at(T(bank), T(item), T(e, torch.bool)), "push")
    jf, tf = mk()
    assert_same(jf.pop_mask(J(en, bool)), tf.pop_mask(T(en, torch.bool)),
                "pop_mask")


@pytest.mark.parametrize("seed", range(8))
def test_promote_rowhit_first_hit_and_dependency_guard(seed):
    """Few distinct addresses and rows, so several slots hit the open row
    (argmax must take the oldest) and same-address conflicts occur."""
    rng = np.random.default_rng(seed)
    b, q = 8, 8
    buf = rng.integers(0, 6, (b, q, 4))
    head = rng.integers(0, q, b)
    count = rng.integers(0, q + 1, b)
    rows = rng.integers(0, 3, (b, q))
    open_row = rng.integers(-1, 3, b)
    jf = jq.BankedFifo(J(buf), J(head), J(count), J(q))
    tf = tq.BankedFifo(T(buf), T(head), T(count), T(q))
    assert_same(jf.promote_rowhit(J(open_row), J(rows)),
                tf.promote_rowhit(T(open_row), T(rows)), "promote")


@pytest.mark.parametrize("seed", range(6))
def test_rr_arbiters_with_ties_and_no_bids(seed):
    rng = np.random.default_rng(seed)
    n = 16
    for density in (0.0, 0.2, 1.0):
        bids = rng.random(n) < density
        ptr = int(rng.integers(0, n))
        assert_same(jq.rr_arbiter(J(bids, bool), J(ptr)),
                    tq.rr_arbiter(T(bids, torch.bool), T(ptr)), "rr")
        ptrs = rng.integers(0, n // 4, 4)
        assert_same(
            jq.rr_arbiter_grouped(J(bids, bool), J(ptrs), 4),
            tq.rr_arbiter_grouped(T(bids, torch.bool), T(ptrs), 4),
            "grouped")


def test_rr_arbiter_grouped_error_text():
    with pytest.raises(ValueError) as je:
        jq.rr_arbiter_grouped(jnp.ones((10,), bool),
                              jnp.zeros((4,), jnp.int32), 4)
    with pytest.raises(ValueError) as te:
        tq.rr_arbiter_grouped(torch.ones(10, dtype=torch.bool),
                              torch.zeros(4, dtype=torch.int32), 4)
    assert str(te.value) == str(je.value)


# --------------------------------------------------------- dram model ----

def rand_timing(rng, r, cycle):
    return (cycle - rng.integers(0, 40, r), cycle - rng.integers(0, 6, (r, 4)),
            cycle - rng.integers(0, 40, r), cycle - rng.integers(0, 40, r))


@pytest.mark.parametrize("seed", range(6))
def test_timing_model(seed):
    """legal_issue_cycle, record_issue (act_win drawn from a narrow range,
    so the oldest slot ties and the first one must be replaced),
    wait_duration."""
    rng = np.random.default_rng(seed)
    cfg_j, cfg_t = jp.MemSimConfig(channels=2), tp.MemSimConfig(channels=2)
    r, b = cfg_j.num_ranks, cfg_j.num_banks
    cycle = 500
    tm = rand_timing(rng, r, cycle)
    jt, tt = jdm.TimingState(*map(J, tm)), tdm.TimingState(*map(T, tm))
    cmd = rng.integers(0, 8, b)
    rob = np.arange(b) // cfg_j.banks_per_rank
    rp_j, rp_t = jp.RuntimeParams(tRRDL=4, tCCDL=3), \
        tp.RuntimeParams(tRRDL=4, tCCDL=3)
    assert_same(jdm.legal_issue_cycle(rp_j, jt, J(cmd), J(rob)),
                tdm.legal_issue_cycle(rp_t, tt, T(cmd), T(rob)), "legal")
    for c in range(8):
        for granted in (True, False):
            rank = int(rng.integers(0, r))
            assert_same(
                jdm.record_issue(jt, J(cycle), J(c), J(rank),
                                 J(granted, bool)),
                tdm.record_issue(tt, cycle, T(c), T(rank),
                                 T(granted, torch.bool)), f"record {c}")
    wr = rng.integers(0, 2, b)
    assert_same(jdm.wait_duration(rp_j, J(cmd), J(wr)),
                tdm.wait_duration(rp_t, T(cmd), T(wr)), "wait_duration")


@pytest.mark.parametrize("topology", [
    dict(), dict(channels=2), dict(channels=2, tiers=2, cxl_channels=1),
    dict(channels=4, tiers=2, cxl_channels=2, tier_cxl_frac_log2=2),
])
def test_decode_address(topology):
    rng = np.random.default_rng(0)
    addr = rng.integers(0, 1 << 24, 500)
    jc, tc = jp.MemSimConfig(**topology), tp.MemSimConfig(**topology)
    assert_same(jdm.decode_address(jc, J(addr), jc.runtime()),
                tdm.decode_address(tc, T(addr), tc.runtime()), "decode")
    assert_same(jdm.tier_select(jc, J(addr), jc.runtime()),
                tdm.tier_select(tc, T(addr), tc.runtime()), "tier")


# ----------------------------------------------------------- bank FSM ----

def rand_bank(rng, b):
    return [rng.integers(0, 14, b), rng.integers(0, 30, b),
            rng.integers(0, 1200, b), rng.integers(0, 8000, b),
            rng.integers(0, 1 << 20, b), rng.integers(0, 2, b),
            rng.integers(0, 1 << 30, b), rng.integers(-1, 500, b),
            rng.integers(-1, 8, b), rng.integers(0, 4, b)]


@pytest.mark.parametrize("page_policy", ["closed", "open"])
@pytest.mark.parametrize("seed", range(4))
def test_fsm_update_and_event_bound(page_policy, seed):
    rng = np.random.default_rng(seed)
    kw = dict(page_policy=page_policy, tRP=5, tRCDRD=7, tRCDWR=11, tCL=13,
              tXS=17, tRFC=50, tREFI=900, sref_idle_cycles=333)
    jc, tc = jp.MemSimConfig(**kw), tp.MemSimConfig(**kw)
    b = jc.num_banks
    regs = rand_bank(rng, b)
    jb, tb = jbf.BankState(*map(J, regs)), tbf.BankState(*map(T, regs))
    flags = rng.integers(0, 2, (3, b)).astype(bool)
    # pop rows near the open rows so row hits and conflicts both occur
    pop = rng.integers(0, 1 << 14, (b, 4))
    cycle = int(rng.integers(0, 5000))
    assert_same(
        jbf.fsm_update(jc, jc.runtime(), jb, *[J(f, bool) for f in flags],
                       J(pop), J(cycle)),
        tbf.fsm_update(tc, tc.runtime(), tb,
                       *[T(f, torch.bool) for f in flags], T(pop), cycle),
        "fsm_update")
    assert_same(jbf.cycles_until_actionable(jc.runtime(), jb, J(cycle)),
                tbf.cycles_until_actionable(tc.runtime(), tb, cycle),
                "bound")
    assert_same(jbf.compute_bids(jb.st, jb.cur_write),
                tbf.compute_bids(tb.st, tb.cur_write), "bids")
    assert_same(jbf.wait_mask(jb.st), tbf.wait_mask(tb.st), "wait_mask")
    assert_same(jbf.BankState.make(jc, jc.runtime()),
                tbf.BankState.make(tc, tc.runtime()), "make")


# ----------------------------------------------------------- counters ----

@pytest.mark.parametrize("tiers", [1, 2])
def test_counters(tiers):
    rng = np.random.default_rng(tiers)
    kw = dict(channels=2, tiers=tiers, cxl_channels=tiers - 1)
    jc, tc = jp.MemSimConfig(**kw), tp.MemSimConfig(**kw)
    b = jc.num_banks
    tier_np = jp.tier_of_bank(jc) if tiers > 1 else None
    jcnt = jpw.make_counters(b, 3, tiers)
    tcnt = tpw.make_counters(b, 3, tiers)
    for step in range(5):
        st = rng.integers(0, 14, b)
        issued = rng.integers(0, 8, 2)
        seg = int(rng.integers(0, 3))
        jcnt = jpw.update_counters(jcnt, J(issued), J(st), J(seg),
                                   tier_idx=tier_np)
        tcnt = tpw.update_counters(
            tcnt, T(issued), T(st), seg,
            tier_idx=None if tier_np is None else T(tier_np))
        delta = int(rng.integers(0, 40))
        jcnt = jpw.skip_counters(jcnt, J(st), J(delta), 2, J(seg),
                                 tier_idx=tier_np)
        tcnt = tpw.skip_counters(
            tcnt, T(st), delta, 2, seg,
            tier_idx=None if tier_np is None else T(tier_np))
        assert_same(jcnt, tcnt, f"step {step}")
    assert jpw.energy_report(jcnt, jpw.PowerConfig()) == \
        tpw.energy_report(tcnt, tpw.PowerConfig())


# ------------------------------------------------ params= validation ----

@pytest.mark.parametrize("bad", [
    dict(tRP=0), dict(tREFI=10, tRFC=260), dict(page_policy=5),
    dict(sched_policy=-1), dict(tFAW=2)])
def test_params_override_error_texts_match(bad):
    from repro.core import simulate_fast as jsf
    from repro.traces import BENCHMARKS as JB
    from repro_torch.core import simulate_fast as tsf
    from repro_torch.traces import BENCHMARKS as TB

    with pytest.raises(ValueError) as je:
        jsf(jp.MemSimConfig(), JB["trace_example"](n=4), 10,
            params=jp.RuntimeParams(**bad))
    with pytest.raises(ValueError) as te:
        tsf(tp.MemSimConfig(), TB["trace_example"](n=4), 10,
            params=tp.RuntimeParams(**bad), device="cpu")
    assert str(te.value) == str(je.value)


def test_queue_size_error_texts_match():
    from repro.core import simulate_fast as jsf
    from repro.traces import BENCHMARKS as JB
    from repro_torch.core import simulate_fast as tsf
    from repro_torch.traces import BENCHMARKS as TB

    for kw in (dict(queue_size=0), dict(queue_size=200),
               dict(resp_queue_size=65)):
        with pytest.raises(ValueError) as je:
            jsf(jp.MemSimConfig(), JB["trace_example"](n=4), 10, **kw)
        with pytest.raises(ValueError) as te:
            tsf(tp.MemSimConfig(), TB["trace_example"](n=4), 10,
                device="cpu", **kw)
        assert str(te.value) == str(je.value)
