"""The persistent event-horizon loop of K3 (``fused_run``) on the CPU, where
it runs its plain version ``fused_run_plain``:

* the port's ``simulate_fast`` on the fused backend against JAX
  ``repro.core.simulate_fast``, every ``SimResult`` field, the counters,
  the blocked totals and the executed steps: a constant point, the
  3-segment DVFS schedule with an FR-FCFS segment, a two-tier DRAM + CXL
  topology, runtime queue limits below capacity with a respQueue small
  enough to block, a lane of 2048 banks (two banks a kernel thread on the
  card) and queues of 8192 (rings in device memory on the card);
* a run cut into launches of 1 and 7 steps is the same run: the final
  ``SimState`` equals the one-launch run's, every leaf;
* ``_run_step_mirror``, the CUDA kernel's step written per bank thread in
  the kernel's stage order, against JAX ``fused_cycle_step`` +
  ``engine._apply_skip`` (and against ``fused_run_plain`` with a budget of
  one step) on random states, so that an ordering slip in the kernel's
  design shows on the CPU; with k banks a thread (k in {1, 2, 4}) its
  cross-bank reductions run as the kernel's do, over each thread's k
  slots first and then over the threads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import simulate_fast as jax_simulate_fast  # noqa: E402
from repro.core.engine import _apply_skip  # noqa: E402
from repro.core.fused_step import fused_cycle_step  # noqa: E402
from repro.core.params import RuntimeParams as JaxRP  # noqa: E402
from repro.core.params import as_schedule as jax_as_schedule  # noqa: E402
from repro.core.params import tiered_params as jax_tiered  # noqa: E402
from repro.core.simulator import Trace as JaxTrace  # noqa: E402
from repro.core.simulator import cycle_step as jax_cycle_step  # noqa: E402
from repro.core.simulator import init_state as jax_init_state  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.core import MemSimConfig, simulate_fast  # noqa: E402
from repro_torch.core import interop  # noqa: E402
from repro_torch.core.params import RuntimeParams, tiered_params  # noqa: E402
from repro_torch.core.simulator import ScheduleView, init_state  # noqa: E402
from repro_torch.core.engine import fused_run  # noqa: E402
from test_torch_engine import assert_same, dvfs, port_trace  # noqa: E402

# the reference's step, compiled once per topology (eager dispatch of its
# ops takes seconds a call)
jax_fused = jax.jit(fused_cycle_step, static_argnums=0)
jax_apply_skip = jax.jit(_apply_skip, static_argnums=0)
jax_cycle = jax.jit(jax_cycle_step, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loop's ops are tiny: one intra-op thread runs them faster
    than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TIERED = dict(channels=2, tiers=2, cxl_channels=1)
_SLOW_CXL = dict(tRCDRD=30, tCL=24, tRFC=300, tREFI=5000)


def _case(name):
    """(JAX config, port config, JAX trace, JAX params, port params,
    queue_size, resp_queue_size, cycles) of one parity case."""
    jtr = JAX_BENCHMARKS["trace_example"](n=60, gap=9)
    if name == "constant":
        kw = dict(queue_size=32, resp_queue_size=16)
        return JaxConfig(**kw), MemSimConfig(**kw), jtr, None, None, None, \
            None, 1_500
    if name == "dvfs_frfcfs":
        kw = dict(queue_size=32, resp_queue_size=16)
        jp = dvfs(JaxConfig(**kw))
        tp = interop.schedule_from_numpy(*[np.asarray(x) for x in jp.pack()])
        return JaxConfig(**kw), MemSimConfig(**kw), jtr, jp, tp, 8, 12, 1_500
    if name == "two_tier":
        kw = dict(queue_size=16, **_TIERED)
        jtr = JAX_BENCHMARKS["vector_similarity"](num_vectors=16,
                                                  burst_gap=12)
        jp = jax_tiered(JaxRP(), JaxRP(**_SLOW_CXL))
        tp = tiered_params(RuntimeParams(), RuntimeParams(**_SLOW_CXL))
        return JaxConfig(**kw), MemSimConfig(**kw), jtr, jp, tp, None, \
            None, 800
    if name == "banks_2048":
        # 2 channels x 2 ranks x 16 bank groups x 32 banks, a random trace
        # over every bank; the card runs it two banks a thread
        kw = dict(queue_size=4, resp_queue_size=16, channels=2, ranks=2,
                  bankgroups=16, banks_per_group=32)
        topo = MemSimConfig(**kw).topology()
        rng = np.random.default_rng(16)
        n = 48
        bank = rng.integers(0, topo.num_banks, n)
        addr = ((rng.integers(0, 4, n) << topo.row_shift)
                | (rng.integers(0, 3, n) << topo.addr_low_bits) | bank)
        jtr = JaxTrace(*[jnp.asarray(v, jnp.int32) for v in (
            np.sort(rng.integers(0, 150, n)), addr, rng.integers(0, 3, n) == 0,
            rng.integers(0, 1 << 20, n))])
        return JaxConfig(**kw), MemSimConfig(**kw), jtr, None, None, None, \
            None, 400
    if name == "queues_8192":
        # bank queues and respQueue of 8192: past the shared memory of one
        # CTA, so the card keeps the rings in device memory
        kw = dict(queue_size=8192, resp_queue_size=8192)
        return JaxConfig(**kw), MemSimConfig(**kw), jtr, None, None, None, \
            None, 1_500
    # runtime limits below capacity (queues of 3, a respQueue of 2) under
    # two arrivals a cycle aimed at four banks: admission and dispatch stall
    i = np.arange(64)
    rows = np.random.default_rng(3).integers(0, 8, i.size)
    jtr = JaxTrace(*[jnp.asarray(v, jnp.int32) for v in (
        i // 2, (rows << 11) | (i % 4), i % 3 == 0, i * 7)])
    kw = dict(queue_size=16, resp_queue_size=8)
    return JaxConfig(**kw), MemSimConfig(**kw), jtr, None, None, 3, 2, 900


@pytest.mark.parametrize("name", ["constant", "dvfs_frfcfs", "two_tier",
                                  "small_queues", "banks_2048",
                                  "queues_8192"])
def test_fused_run_matches_reference(name):
    jcfg, cfg, jtr, jp, tp, q, rq, cycles = _case(name)
    jt, tt = {}, {}
    ref = jax_simulate_fast(jcfg, jtr, cycles, queue_size=q,
                            resp_queue_size=rq, params=jp, timings=jt)
    got = simulate_fast(cfg, port_trace(jtr), cycles, queue_size=q,
                        resp_queue_size=rq, params=tp, timings=tt,
                        device="cpu")
    assert_same(ref, got, name)
    assert tt["steps"] == jt["steps"] < cycles
    assert tt["launches"] == 1
    if name == "small_queues":
        # the case reaches the limits it is meant to exercise
        assert got.blocked_arrival > 0 and got.blocked_dispatch > 0


def _run_in_launches(cfg, jtr, params, cycles, budget, cycle_skip=True):
    topo = cfg.topology()
    view = ScheduleView(topo, params, "cpu")
    trace = port_trace(jtr)
    state = init_state(topo, view, trace.num_requests, 8, 12, device="cpu")
    t, steps, launches = 0, 0, 0
    while t < cycles:
        t, n = fused_run(topo, view, trace, state, t, cycles, budget=budget,
                         cycle_skip=cycle_skip)
        assert n == budget or t == cycles
        steps += n
        launches += 1
    assert t == cycles
    return interop.flatten(state), steps, launches


def test_budgets_cut_the_same_run():
    jcfg = JaxConfig(queue_size=32, resp_queue_size=16)
    cfg = MemSimConfig(queue_size=32, resp_queue_size=16)
    jp = dvfs(jcfg)
    params = interop.schedule_from_numpy(*[np.asarray(x) for x in jp.pack()])
    jtr = JAX_BENCHMARKS["trace_example"](n=30, gap=9)
    whole, steps, launches = _run_in_launches(cfg, jtr, params, 600, None)
    assert launches == 1 and steps > 100
    for budget in (1, 7):
        cut, n, k = _run_in_launches(cfg, jtr, params, 600, budget)
        assert n == steps and k == -(-steps // budget)
        assert cut.keys() == whole.keys()
        for key in whole:
            np.testing.assert_array_equal(cut[key], whole[key],
                                          err_msg=f"budget {budget}: {key}")


# --------------------------------------------------------------------------
# the kernel's step, per bank thread

_WAIT = (2, 6, 8, 10, 12)  # REF_WAIT, SREF_EXIT_WAIT, ACT/RW/PRE_WAIT
_INF = 0x3FFFFFFF
_INT_MAX = (1 << 31) - 1
_NEG = -(1 << 20)


def w32(x):
    """An int wrapped to int32, as the kernel's wadd/wsub/wmul do."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def fmod(a, n):
    return int(a) % n  # Python's % floors, like fmod_floor


def compute_cmd(st, cur_write):
    return {7: 1, 9: 3 if cur_write == 1 else 2, 11: 4, 1: 5, 3: 6,
            5: 7}.get(st, 0)


def legal_at(r, cmd, la, aw, lr, lw):
    if cmd == 1:
        return max(w32(la + r["tRRDL"]), w32(min(aw) + r["tFAW"]))
    if cmd == 2:
        return max(w32(lr + r["tCCDL"]), w32(lw + r["tWTR"]))
    if cmd == 3:
        return max(w32(lw + r["tCCDL"]), w32(lr + r["tRTW"]))
    return _NEG


def fsm_edge(r, cycle, row_shift, s, grant, accept, nonempty, pop):
    """bank_fsm.cuh fsm_edge() on one bank's registers (a dict)."""
    is_open = r["page_policy"] == 1
    st, o = s["st"], dict(s)
    refresh_needed = cycle >= w32(s["refresh_due"] - r["tRFC"])
    in_wait = st in _WAIT
    timer = max(w32(s["timer"] - 1), 0) if in_wait else s["timer"]
    expired = in_wait and timer == 0
    nxt = st
    if expired and st == 8:
        nxt, o["open_row"] = 9, s["cur_addr"] >> row_shift
    if expired and st == 10:
        nxt = 13 if is_open else 11
    pre_done = expired and st == 12
    if pre_done:
        if not is_open:
            nxt = 13
        else:
            nxt = {1: 7, 2: 1, 3: 3}.get(o["pending"], nxt)
        o["open_row"], o["pending"] = -1, 0
    if expired and st in (2, 6):
        nxt = 0
    rw_done = expired and st == 10
    ref_done = expired and st == 2
    if grant:
        act_dur = r["tRCDWR"] if s["cur_write"] == 1 else r["tRCDRD"]
        nxt, timer = {7: (8, act_dur), 9: (10, r["tCL"]), 11: (12, r["tRP"]),
                      1: (2, r["tRFC"]), 3: (4, timer),
                      5: (6, r["tXS"])}.get(st, (nxt, timer))
    completed = accept and st == 13
    if completed:
        nxt = 0
    idle = st == 0
    row_open = o["open_row"] >= 0
    if idle and refresh_needed:
        nxt = 11 if is_open and row_open else 1
        if is_open and row_open:
            o["pending"] = 2
    want_pop = idle and not refresh_needed and nonempty
    if want_pop:
        nxt = 7
        if is_open and row_open:
            if o["open_row"] == pop[0] >> row_shift:
                nxt = 9
            else:
                nxt, o["pending"] = 11, 1
    truly_idle = idle and not refresh_needed and not nonempty
    o["idle_ctr"] = w32(s["idle_ctr"] + 1) if truly_idle else 0
    if truly_idle and o["idle_ctr"] >= r["sref_idle_cycles"]:
        nxt = 11 if is_open and row_open else 3
        if is_open and row_open:
            o["pending"] = 3
    if st == 4 and nonempty:
        nxt = 5
    if ref_done:
        o["refresh_due"] = w32(s["refresh_due"] + r["tREFI"])
    if expired and st == 6:
        o["refresh_due"] = w32(cycle + r["tREFI"])
    o["st"], o["timer"] = nxt, timer
    if want_pop:
        o["cur_addr"], o["cur_write"], o["cur_data"], o["cur_id"] = pop
    return o, want_pop, rw_done


def event_bound(r, cycle, o):
    if o["st"] in _WAIT:
        return w32(o["timer"] - 1)
    if o["st"] == 0:
        return min(w32(w32(o["refresh_due"] - r["tRFC"]) - cycle),
                   w32(w32(r["sref_idle_cycles"] - 1) - o["idle_ctr"]))
    return _INF if o["st"] == 4 else 0


_REGS = ("st", "timer", "idle_ctr", "refresh_due", "cur_addr", "cur_write",
         "cur_data", "cur_id", "open_row", "pending")
_RP = ("tRP", "tFAW", "tRRDL", "tRCDRD", "tRCDWR", "tCCDL", "tWTR", "tRFC",
       "tREFI", "tCL", "tXS", "tRTW", "sref_idle_cycles", "page_policy",
       "sched_policy", "tier_interleave_log2", "tier_cxl_frac_log2")


def _group_min_k(v, k, g):
    """csrc/fused.cu ``group_min_k`` over a lane whose threads hold k
    consecutive banks each: v[b] becomes the min over b's aligned group of
    g banks, first over each thread's slots (a running min within each
    group, then the group's last slot copied back), then over the g / k
    threads of a group wider than k."""
    v = list(v)
    for t0 in range(0, len(v), k):
        s = v[t0:t0 + k]
        for j in range(1, k):
            if j & (g - 1):
                s[j] = min(s[j], s[j - 1])
        for j in range(k - 2, -1, -1):
            if (j + 1) & (g - 1):
                s[j] = s[j + 1]
        v[t0:t0 + k] = s
    if g > k:
        for g0 in range(0, len(v), g):
            r = min(v[g0:g0 + g:k])
            v[g0:g0 + g] = [r] * g
    return v


def _run_step_mirror(topo, rp, bnd, tr, flat, t, t_end, banks_per_thread=1,
                     cycle_skip=True):
    """One step of fused_run_kernel (csrc/fused.cu) on a flat state (the
    keys of ``interop.flatten`` of a reference state), stage by stage as
    its threads run it, each thread holding ``banks_per_thread``
    consecutive banks; ``cycle_skip=False`` is its per-cycle form, the
    event bound compiled out (delta 0). Returns (new flat state, delta)."""
    x = {k: np.array(v, dtype=np.int64) for k, v in flat.items()}
    B, C, T = topo.num_banks, topo.channels, topo.tiers
    per, bpr, rs = topo.banks_per_channel, topo.banks_per_rank, topo.row_shift
    S = len(bnd)
    n = len(tr[0])
    split = topo.tier_split_bank if T > 1 else B
    Q, Qc, Qr = (x["bank_q.buf"].shape[1], x["req_q.buf"].shape[0],
                 x["resp_q.buf"].shape[0])
    nxt = t + 1

    def seg_at(c):
        return 0 if S == 1 else int((bnd <= c).sum()) - 1

    def params(tier, c):
        s = seg_at(c)
        row = rp[tier * S + s] if s >= 0 else np.zeros(len(_RP), np.int64)
        return dict(zip(_RP, (int(v) for v in row)))

    p0 = params(0, t)
    # ---- 1: admission and dispatch (thread 0) ----------------------------
    na, rh, rc = (int(x["next_arrival"]), int(x["req_q.head"]),
                  int(x["req_q.count"]))
    idx = min(na, n - 1)
    due = na < n and tr[0][idx] <= t
    admit = due and not rc >= int(x["req_q.limit"])
    if admit:
        x["req_q.buf"][fmod(rh + rc, Qc)] = [tr[1][idx], tr[2][idx],
                                             tr[3][idx], idx]
        rc += 1
        x["t_admit"][idx] = t
    na += admit
    x["blocked_arrival"] = w32(x["blocked_arrival"] + (due and not admit))
    head = x["req_q.buf"][rh].copy()
    a = int(head[0])
    ch = (a >> (topo.bank_bits + topo.bankgroup_bits + topo.rank_bits)) \
        & (C - 1)
    if T > 1:
        frac = (1 << p0["tier_cxl_frac_log2"]) - 1
        cxl = ((a >> p0["tier_interleave_log2"]) & frac) == frac
        ch = topo.dram_channels + (ch & (topo.cxl_channels - 1)) if cxl \
            else ch & (topo.dram_channels - 1)
    rk = (a >> (topo.bank_bits + topo.bankgroup_bits)) & (topo.ranks - 1)
    tgt = (((ch * topo.ranks + rk) * topo.bankgroups
            + ((a >> topo.bank_bits) & (topo.bankgroups - 1)))
           * topo.banks_per_group + (a & (topo.banks_per_group - 1)))
    qh, qc = x["bank_q.head"], x["bank_q.count"]
    have, full = rc != 0, qc[tgt] >= int(x["bank_q.limit"])
    if have and not full:
        x["bank_q.buf"][tgt, fmod(qh[tgt] + qc[tgt], Q)] = head
        qc[tgt] += 1
        x["t_dispatch"][head[3]] = t
        rh, rc = fmod(rh + 1, Qc), rc - 1
    x["blocked_dispatch"] = w32(x["blocked_dispatch"] + (have and full))
    x["next_arrival"], x["req_q.head"], x["req_q.count"] = na, rh, rc
    arrival_rel = w32(tr[0][min(na, n - 1)] - nxt) if na < n else _INF

    # ---- 2: FR-FCFS, each bank its own queue ------------------------------
    regs = [{f: int(x[f"bank.{f}"][b]) for f in _REGS} for b in range(B)]
    for b in range(B):
        q, h, cnt, orow = x["bank_q.buf"][b], int(qh[b]), int(qc[b]), \
            regs[b]["open_row"]
        if p0["sched_policy"] != 1 or orow < 0:
            continue
        hits = [k for k in range(cnt) if q[fmod(h + k, Q), 0] >> rs == orow]
        if not hits or hits[0] == 0:
            continue
        pos = fmod(h + hits[0], Q)
        if any(q[fmod(h + k, Q), 0] == q[pos, 0] for k in range(hits[0])):
            continue
        q[[h, pos]] = q[[pos, h]]

    # ---- 3: cycle_core, each reduction over every thread's k slots first --
    k = banks_per_thread
    rob = [b // bpr for b in range(B)]
    tm = [dict(la=int(x["timing.last_act"][r]),
               aw=[int(v) for v in x["timing.act_win"][r]],
               lr=int(x["timing.last_rd"][r]), lw=int(x["timing.last_wr"][r]))
          for r in rob]
    tier = [1 if T > 1 and b >= split else 0 for b in range(B)]
    pr = [params(tier[b], t) for b in range(B)]
    pr2 = [params(tier[b], nxt) for b in range(B)]
    cmds = [compute_cmd(regs[b]["st"], regs[b]["cur_write"])
            for b in range(B)]
    elig = [cmds[b] != 0 and t >= legal_at(pr[b], cmds[b], tm[b]["la"],
                                            tm[b]["aw"], tm[b]["lr"],
                                            tm[b]["lw"]) for b in range(B)]
    ptr = [int(x["cmd_rr"][b // per]) for b in range(B)]
    rot = [fmod(b % per - ptr[b], per) for b in range(B)]
    rank_in = [(b % per) // bpr for b in range(B)]
    m = _group_min_k([rot[b] if elig[b] else per for b in range(B)], k, per)
    grant = [elig[b] and rot[b] == m[b] for b in range(B)]
    if k == 1:  # the winner's thread broadcasts (rank << 3 | cmd)
        win = [b - b % per + fmod(ptr[b] + m[b], per) for b in range(B)]
        won = [rank_in[w] << 3 | cmds[w] for w in win]
    else:  # the same min-reduction over the winner alone
        won = _group_min_k([rank_in[b] << 3 | cmds[b] if grant[b]
                            else _INT_MAX for b in range(B)], k, per)
    issued = [0] * C
    for b in range(B):
        any_g = m[b] < per
        cmd_w, rank_w = (won[b] & 7, won[b] >> 3) if any_g else (0, 0)
        if any_g and rank_in[b] == rank_w:
            r = tm[b]
            if cmd_w == 1:
                r["aw"][r["aw"].index(min(r["aw"]))] = t
                r["la"] = t
            r["lr"] = t if cmd_w == 2 else r["lr"]
            r["lw"] = t if cmd_w == 3 else r["lw"]
        if b % per == 0:
            issued[b // per] = cmd_w
            x["cmd_rr"][b // per] = fmod(ptr[b] + m[b] + 1, per) if any_g \
                else ptr[b]
    rr, rhd, rcnt = int(x["resp_rr"]), int(x["resp_q.head"]), \
        int(x["resp_q.count"])
    bids = [regs[b]["st"] == 13 and not rcnt >= int(x["resp_q.limit"])
            for b in range(B)]
    key_r = [fmod(b - rr, B) if bids[b] else B for b in range(B)]
    m_r = _group_min_k(key_r, k, B)[0]
    acc = [bids[b] and key_r[b] == m_r for b in range(B)]
    new = []
    for b in range(B):
        pop = [int(v) for v in x["bank_q.buf"][b, qh[b]]]
        new.append(fsm_edge(pr[b], t, rs, regs[b], grant[b], acc[b],
                            qc[b] > 0, pop))
    for b in range(B):
        wp = new[b][1]
        qh[b], qc[b] = fmod(qh[b] + wp, Q), qc[b] - wp
    any_resp = m_r < B
    widx = fmod(rhd + rcnt, Qr)
    rcnt += any_resp
    ack = rcnt > 0
    delta = 0
    if cycle_skip:
        inert, bounds = True, []
        for b in range(B):
            o = new[b][0]
            cmd_n = compute_cmd(o["st"], o["cur_write"])
            legal_n = legal_at(pr2[b], cmd_n, tm[b]["la"], tm[b]["aw"],
                               tm[b]["lr"], tm[b]["lw"])
            blocked = cmd_n != 0 and not nxt >= legal_n
            inert &= (o["st"] in _WAIT or blocked
                      or (o["st"] in (0, 4) and not qc[b] > 0))
            bounds.append(w32(legal_n - nxt) if blocked
                          else event_bound(pr2[b], nxt, o))
        per_bank = _group_min_k(bounds, k, B)[0]
        nb = min([int(v) for v in bnd if v > nxt], default=_INF)
        b_val = min(per_bank, arrival_rel, w32(t_end - nxt), w32(nb - nxt))
        maybe = rc == 0 and rcnt - ack == 0
        delta = max(b_val, 0) if maybe and inert else 0

    # ---- 4: memory phase on the pre-edge registers -------------------------
    words = topo.mem_words
    for b in range(B):
        s = regs[b]
        if new[b][2] and s["cur_write"] == 1:
            x["mem"][s["cur_addr"] & (words - 1)] = s["cur_data"]
    for b in range(B):
        s = regs[b]
        if new[b][2] and s["cur_write"] != 1:
            x["rdata"][s["cur_id"]] = x["mem"][s["cur_addr"] & (words - 1)]

    # ---- 5: records, respQueue, counters ------------------------------------
    for b in range(B):
        if new[b][1]:
            x["t_start"][new[b][0]["cur_id"]] = t
    if any_resp:
        win = acc.index(True)
        x["resp_q.buf"][widx] = [regs[win][f] for f in
                                 ("cur_addr", "cur_write", "cur_data",
                                  "cur_id")]
    if ack:
        x["t_complete"][x["resp_q.buf"][rhd, 3]] = t
    x["resp_rr"] = fmod(rr + m_r + 1, B) if any_resp else rr
    x["resp_q.head"], x["resp_q.count"] = fmod(rhd + ack, Qr), rcnt - ack

    def count(states, k, segment, cmds=()):
        for c in cmds:
            x["counters.cmd_counts"][c] = w32(x["counters.cmd_counts"][c] + 1)
        sref = sum(st == 4 for st in states)
        idle = sum(st == 0 for st in states)
        for key, v in (("sref_cycles", sref), ("idle_cycles", idle),
                       ("active_cycles", B - sref - idle)):
            x[f"counters.{key}"] = w32(x[f"counters.{key}"] + k * v)
        x["counters.seg_cycles"][segment] = w32(
            x["counters.seg_cycles"][segment] + k)
        for ti in range(T):
            sts = [st for b, st in enumerate(states) if tier[b] == ti]
            sref = sum(st == 4 for st in sts)
            idle = sum(st == 0 for st in sts)
            for key, v in (("tier_sref_cycles", sref),
                           ("tier_idle_cycles", idle),
                           ("tier_active_cycles", len(sts) - sref - idle)):
                x[f"counters.{key}"][ti] = w32(x[f"counters.{key}"][ti]
                                               + k * v)

    count([s["st"] for s in regs], 1, seg_at(t), issued)

    # ---- 6: the skip --------------------------------------------------------
    outs = [o for o, _, _ in new]
    if delta > 0:
        for o in outs:
            if o["st"] in _WAIT:
                o["timer"] = w32(o["timer"] - delta)
            o["idle_ctr"] = w32(o["idle_ctr"] + delta) if o["st"] == 0 else 0
        x["counters.cmd_counts"][0] = w32(x["counters.cmd_counts"][0]
                                          + delta * C)
        count([o["st"] for o in outs], delta, seg_at(nxt))
    for f in _REGS:
        x[f"bank.{f}"] = np.array([o[f] for o in outs])
    for r in range(topo.num_ranks):
        tr_ = tm[r * bpr]
        x["timing.last_act"][r], x["timing.act_win"][r] = tr_["la"], tr_["aw"]
        x["timing.last_rd"][r], x["timing.last_wr"][r] = tr_["lr"], tr_["lw"]
    return x, delta


def _random_state(rng, topo, n, t, quiet):
    """A random register file of a lane at clock t whose record writes
    never collide (distinct request ids, each bank's words its own);
    ``quiet``: no queued or arriving work and every bank idle, in self
    refresh or waiting, so that the step may skip."""
    B, Q = topo.num_banks, 8
    lo = topo.addr_low_bits

    def addr(b, size):
        row = rng.integers(0, 4, size)
        col = rng.integers(0, 3, size)
        return (row << topo.row_shift) | (col << lo) | b

    ids = iter(rng.permutation(n))
    x = {"next_arrival": np.int32(rng.integers(0, n + 1))}
    lim = rng.integers(1, Q + 1)
    x["req_q.buf"] = np.stack([addr(rng.integers(0, B), Q),
                               rng.integers(0, 2, Q),
                               rng.integers(0, 1 << 20, Q),
                               [next(ids) for _ in range(Q)]], 1)
    x["req_q.head"] = rng.integers(0, Q)
    x["req_q.count"] = rng.integers(0, lim + 1) * rng.integers(0, 2)
    x["req_q.limit"] = lim
    lim = rng.integers(1, Q + 1)
    bq = np.zeros((B, Q, 4), np.int64)
    for b in range(B):
        bq[b] = np.stack([addr(b, Q), rng.integers(0, 2, Q),
                          rng.integers(0, 1 << 20, Q),
                          [next(ids) for _ in range(Q)]], 1)
    x["bank_q.buf"], x["bank_q.limit"] = bq, lim
    x["bank_q.head"] = rng.integers(0, Q, B)
    x["bank_q.count"] = rng.integers(0, lim + 1, B) * rng.integers(0, 2, B)
    x["bank.st"] = rng.integers(0, 14, B)
    x["bank.timer"] = rng.integers(0, 30, B)
    x["bank.idle_ctr"] = rng.integers(0, 1200, B)
    x["bank.refresh_due"] = t + rng.integers(-40, 3000, B)
    x["bank.cur_addr"] = np.array([addr(b, 1)[0] for b in range(B)])
    x["bank.cur_write"] = rng.integers(0, 2, B)
    x["bank.cur_data"] = rng.integers(0, 1 << 30, B)
    x["bank.cur_id"] = np.array([next(ids) for _ in range(B)])
    x["bank.open_row"] = rng.integers(-1, 4, B)
    x["bank.pending"] = rng.integers(0, 4, B)
    r = topo.num_ranks
    x["timing.last_act"] = t - rng.integers(0, 60, r)
    x["timing.act_win"] = t - rng.integers(0, 60, (r, 4))
    x["timing.last_rd"] = t - rng.integers(0, 20, r)
    x["timing.last_wr"] = t - rng.integers(0, 20, r)
    x["cmd_rr"] = rng.integers(0, topo.banks_per_channel, topo.channels)
    x["resp_rr"] = rng.integers(0, B)
    qr = 8
    lim = rng.integers(1, qr + 1)
    x["resp_q.buf"] = np.stack([addr(0, qr), rng.integers(0, 2, qr),
                                rng.integers(0, 1 << 20, qr),
                                [next(ids) for _ in range(qr)]], 1)
    x["resp_q.head"] = rng.integers(0, qr)
    x["resp_q.count"] = rng.integers(0, lim + 1) * rng.integers(0, 2)
    x["resp_q.limit"] = lim
    x["mem"] = rng.integers(0, 1 << 30, topo.mem_words)
    for f in ("t_admit", "t_dispatch", "t_start", "t_complete"):
        x[f] = rng.integers(-1, t, n)
    x["rdata"] = rng.integers(0, 1 << 30, n)
    x["blocked_arrival"] = rng.integers(0, 100)
    x["blocked_dispatch"] = rng.integers(0, 100)
    if quiet:
        x["next_arrival"] = n
        x["req_q.count"] = x["resp_q.count"] = 0
        x["bank_q.count"][:] = 0
        x["bank.st"] = rng.choice([0, 2, 4, 6, 8, 10, 12], B)
        # refresh and self-refresh exits may end this cycle (to IDLE,
        # still inert); the other waits outlast it
        x["bank.timer"] = np.where(np.isin(x["bank.st"], (2, 6)),
                                   rng.choice([1, 3, 4], B),
                                   rng.integers(3, 30, B))
        x["bank.refresh_due"] = t + rng.integers(2000, 5000, B)
        x["bank.idle_ctr"] = rng.integers(0, 100, B)
    return {k: np.asarray(v, np.int32) for k, v in x.items()}


def _unflatten(template, flat, prefix=""):
    if hasattr(template, "_fields"):
        return type(template)(*[_unflatten(getattr(template, f), flat,
                                           f"{prefix}{f}.")
                                for f in template._fields])
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.")
                for k, v in template.items()}
    return jnp.asarray(flat[prefix[:-1]], jnp.int32)


def _check_step_order(rng, kw, jsched, banks_per_thread=1, cycle_skip=True):
    """Six random states (every other one quiet, so that it may skip) of
    the topology ``kw``: the mirror's step against JAX's, and the port's
    plain loop with a budget of one step against both. ``cycle_skip=False``
    holds the per-cycle form against JAX ``cycle_step`` (fused): the step
    of ``fused_cycle_step`` with horizon ``t + 1``, no skip."""
    jcfg = JaxConfig(**kw)
    topo = MemSimConfig(**kw).topology()
    bounds, rp_mat = (np.asarray(v, np.int64) for v in jsched.pack())
    view = ScheduleView(topo, interop.schedule_from_numpy(bounds, rp_mat),
                        "cpu")
    n = 1024
    tr = [np.sort(rng.integers(0, 1500, n)), rng.integers(0, 1 << 16, n),
          rng.integers(0, 2, n), rng.integers(0, 1 << 20, n)]
    tr = [np.asarray(v, np.int32) for v in tr]
    jtrace = JaxTrace(*[jnp.asarray(v) for v in tr])
    template = jax_init_state(jcfg.topology(), jsched, n)
    delta_pos = 0
    for case in range(6):
        t = int(rng.choice([450, 499, 500, 1299, 1300, 2000]))
        t_end = t + int(rng.integers(1, 2500))
        flat = _random_state(rng, topo, n, t, quiet=case % 2 == 1)
        counters = interop.flatten(template.counters, "counters.")
        flat.update({k: rng.integers(0, 1000, np.shape(v)).astype(np.int32)
                     for k, v in counters.items()})
        if cycle_skip:
            want_state, delta = jax_fused(jcfg.topology(), jsched, jtrace,
                                          _unflatten(template, flat), t,
                                          t_end)
            want = interop.flatten(jax_apply_skip(jcfg.topology(), jsched,
                                                  want_state, delta, t + 1))
        else:
            delta = 0
            want = interop.flatten(jax_cycle(jcfg.topology(), jsched, jtrace,
                                             _unflatten(template, flat), t))
        got, got_delta = _run_step_mirror(topo, rp_mat, bounds.reshape(-1),
                                          tr, flat, t, t_end,
                                          banks_per_thread, cycle_skip)
        assert got_delta == int(delta), case
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"case {case}: {key}")
        # the port's plain loop with a budget of one step: the same step
        state = interop.state_from_numpy(flat)
        t2, steps = fused_run(topo, view, interop.trace_from_numpy(*tr),
                              state, t, t_end, budget=1,
                              cycle_skip=cycle_skip)
        assert (t2, steps) == (t + 1 + got_delta, 1)
        port = interop.state_to_numpy(state)
        for key in want:
            np.testing.assert_array_equal(port[key], want[key],
                                          err_msg=f"port, case {case}: {key}")
        delta_pos += got_delta > 0
    assert (delta_pos > 0) == cycle_skip  # some cases take the skip


@pytest.mark.parametrize("tiered", [False, True], ids=["table1", "two_tier"])
def test_kernel_step_order_matches_reference(tiered):
    rng = np.random.default_rng(15 + tiered)
    kw = dict(queue_size=8, resp_queue_size=8, **(_TIERED if tiered else {}))
    if tiered:
        open_fr = dict(page_policy=1, sched_policy=1)
        jsched = jax_as_schedule(jax_tiered(JaxRP(**open_fr),
                                            JaxRP(**_SLOW_CXL, **open_fr)))
    else:
        jsched = dvfs(JaxConfig(**kw))
    _check_step_order(rng, kw, jsched)


# channels of 32 banks (a thread's banks inside one channel, a channel
# across threads) and of 2 banks (a thread holding whole channels)
_LAYOUTS = {"table1": {}, "narrow_channels": dict(
    channels=8, ranks=1, bankgroups=2, banks_per_group=1)}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("banks_per_thread", [2, 4])
def test_kernel_step_order_with_banks_per_thread(banks_per_thread, layout):
    """The kernel's form for lanes above 1024 banks (k banks a thread), at
    small topologies: its reductions over slots, then threads, name the
    same winners and bounds as JAX."""
    rng = np.random.default_rng(17 + banks_per_thread)
    kw = dict(queue_size=8, resp_queue_size=8, **_LAYOUTS[layout])
    _check_step_order(rng, kw, dvfs(JaxConfig(**kw)), banks_per_thread)


@pytest.mark.parametrize("tiered", [False, True], ids=["table1", "two_tier"])
def test_schedule_slices_resolve_like_the_schedule(tiered):
    """A schedule longer than a persistent launch holds goes to the kernel
    in slices (``_schedule_slice``): from the segment of the launch's clock
    t to its stop, every cycle up to stop + 1 resolves in the slice to the
    row the whole schedule gives it, the first boundary after stop + 1 is
    the schedule's, and the slice's segment counters are the run's."""
    from repro_torch.core.params import NUM_RUNTIME_PARAMS, ParamSchedule
    from repro_torch.kernels.bank_fsm.fused import _schedule_slice

    kw = dict(queue_size=16, **(_TIERED if tiered else {}))
    cfg = MemSimConfig(**kw)
    topo = cfg.topology()
    rng = np.random.default_rng(5)
    s = 3000
    base = cfg.runtime() if not tiered else tiered_params(
        RuntimeParams(), RuntimeParams(**_SLOW_CXL))
    vals = [torch.as_tensor(v) for v in base]
    leaves = [v.reshape(1, *v.shape).repeat(s, *[1] * v.dim())
              + torch.as_tensor(rng.integers(0, 4, (s, *v.shape)),
                                dtype=v.dtype) for v in vals]
    bounds = np.concatenate([[0], np.cumsum(rng.integers(1, 4, s - 1))])
    sched = ParamSchedule(boundaries=torch.as_tensor(bounds, dtype=torch.int32),
                          values=RuntimeParams(*leaves))
    view = ScheduleView(topo, sched, "cpu")
    state = init_state(topo, view, 4, device="cpu")
    full_b, full_rp = view.packed
    tiers = topo.tiers
    seen_stops = 0
    for t in [0, 1, int(bounds[700]) + 1, int(bounds[1500]), int(bounds[-3])]:
        sb, rows, seg, stop = _schedule_slice(topo, view, state, t)
        n = sb.shape[0]
        assert n < s and rows.shape == (tiers * n, NUM_RUNTIME_PARAMS)
        s0 = view.segment_at(t)
        assert seg.data_ptr() == state.counters["seg_cycles"][s0:].data_ptr()
        last = (stop if stop is not None else t + 50) + 1
        seen_stops += stop is not None
        for c in range(t, last + 1):
            local = int((sb.reshape(-1) <= c).sum()) - 1
            glob = view.segment_at(c)
            assert local + s0 == glob
            for tier in range(tiers):
                assert torch.equal(rows[tier * n + local],
                                   full_rp[tier * s + glob])
        after = [int(b) for b in sb.reshape(-1) if b > last]
        want = [b for b in view.bounds if b > last]
        assert (after[:1] or [None]) == (want[:1] or [None])
    assert seen_stops >= 3
