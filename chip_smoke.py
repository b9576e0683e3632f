#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port of MemorySim (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failed check exits non-zero):

1. device: the card's name and power limit, then the build of the CUDA
   kernels from ``src/repro_torch/csrc`` (seconds printed);
2. every kernel against its plain PyTorch version on the card, bit for bit:
   K1/K2 at B in {32, 128}, S in {1, 3}, T in {1, 2}; K3 at lanes in
   {1, 4}, channels in {1, 2}, S in {1, 3}, T in {1, 2}, and channels of
   4, 16, 32 and 64 banks (both arbiter reduction paths); two 500-cycle K3
   rollouts that feed the kernel's outputs back in;
3. the main path at the paper's Table-1 size: ``simulate_fast`` (fused
   backend, K3) on the four benchmark traces at queue 128 over 100k
   cycles, each held against the JAX reference's golden digest, with the
   Table-2 rows, executed steps, wall seconds and K3 launches;
4. the per-cycle reference on the card: ``simulate`` with the split
   backend (K1) and ``simulate_fast`` split (K1 + K2) on conv2d at 20k
   cycles against the golden digest, and ``simulate`` with the plain
   backend, which must agree bit for bit;
5. kernel times at the main path's shapes: device time per launch (200
   launches replayed from CUDA graphs, timed with CUDA events) beside the
   plain version's and the bandwidth bound, and the eager call time with
   its host launch (median of 200 calls);
6. where a main-path step's time goes: a torch.profiler device trace of
   conv2d over 5000 cycles (kernels and device time per executed step)
   and the count of host synchronisations per executed step.

The second-to-last lines are the kernel JSON object and the card line of
``nvidia-smi``; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 bandwidth


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- operands --

def rand_int(gen, lo, hi, shape):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)


def rand_point(gen, page=None, sched=None):
    from repro_torch.core.params import RuntimeParams

    def r(lo, hi):
        return int(rand_int(gen, lo, hi, (1,))[0])

    trfc = r(20, 300)
    return RuntimeParams(
        tRP=r(1, 30), tFAW=r(20, 40), tRRDL=r(1, 20), tRCDRD=r(1, 30),
        tRCDWR=r(1, 30), tCCDL=r(1, 8), tWTR=r(1, 12), tRFC=trfc,
        tREFI=trfc + r(100, 4000), tCL=r(1, 30), tXS=r(1, 20),
        tRTW=r(1, 8), sref_idle_cycles=r(5, 1500),
        page_policy=r(0, 2) if page is None else page,
        sched_policy=r(0, 2) if sched is None else sched)


def rand_schedule(gen, segments, tiers):
    """A valid random ParamSchedule (CPU) of S segments and T tiers."""
    import torch
    from repro_torch.core.params import (
        ParamSchedule, RuntimeParams, tiered_params)

    points = []
    for _ in range(segments):
        page = int(rand_int(gen, 0, 2, (1,))[0])
        sched = int(rand_int(gen, 0, 2, (1,))[0])
        pts = [rand_point(gen, page, sched) for _ in range(tiers)]
        points.append(pts[0] if tiers == 1 else tiered_params(*pts))
    bounds = torch.tensor([0, 100, 400][:segments], dtype=torch.int32)
    return ParamSchedule(boundaries=bounds,
                         values=RuntimeParams.stack(points)).validate()


def rand_state(gen, b, row_shift):
    import torch

    s = torch.stack([
        rand_int(gen, 0, 14, (b,)),                 # st
        rand_int(gen, 0, 40, (b,)),                 # timer
        rand_int(gen, 0, 1200, (b,)),               # idle_ctr
        rand_int(gen, 0, 8000, (b,)),               # refresh_due
        rand_int(gen, 0, 64 << row_shift, (b,)),    # cur_addr
        rand_int(gen, 0, 2, (b,)),                  # cur_write
        rand_int(gen, 0, 1 << 30, (b,)),            # cur_data
        rand_int(gen, -1, 1000, (b,)),              # cur_id
        rand_int(gen, -1, 64, (b,)),                # open_row
        rand_int(gen, 0, 4, (b,)),                  # pending
    ])
    return s


def rand_pop(gen, b, row_shift):
    import torch

    return torch.stack([rand_int(gen, 0, 64 << row_shift, (b,)),
                        rand_int(gen, 0, 2, (b,)),
                        rand_int(gen, 0, 1 << 30, (b,)),
                        rand_int(gen, 0, 1000, (b,))])


def k3_operands(gen, topo, lanes, segments, cycle):
    """Random K3 operands (CPU) of the ABI in repro_torch.kernels.bank_fsm
    .fused, at ``lanes`` lanes of ``topo``."""
    import torch

    b = topo.num_banks
    total = lanes * b
    qr = topo.resp_queue_size
    rs = topo.row_shift
    state = rand_state(gen, total, rs)
    qhead = rand_int(gen, 0, topo.queue_size, (total,))
    qcount = rand_int(gen, 0, 4, (total,)) * rand_int(gen, 0, 2, (total,))
    timing = cycle - rand_int(gen, 0, 80, (7, total))
    bank_rows = torch.cat([state, qhead[None], qcount[None], timing,
                           rand_pop(gen, total, rs)])
    resp = rand_int(gen, 0, 1 << 20, (lanes * qr, 4))
    packs = [rand_schedule(gen, segments, topo.tiers).pack()
             for _ in range(lanes)]
    bounds = torch.cat([p[0] for p in packs])
    rp = torch.cat([p[1] for p in packs])
    inf = 0x3FFFFFFF
    arrival = rand_int(gen, -3, 200, (lanes,))
    arrival = torch.where(rand_int(gen, 0, 4, (lanes,)) == 0, inf, arrival)
    scal = torch.stack([
        torch.full((lanes,), cycle, dtype=torch.int32),
        arrival,
        cycle + rand_int(gen, 1, 5000, (lanes,)),
        rand_int(gen, 0, 3, (lanes,)) * (rand_int(gen, 0, 3, (lanes,)) == 0),
        rand_int(gen, 0, qr, (lanes,)),
        rand_int(gen, 0, qr + 1, (lanes,)) * rand_int(gen, 0, 2, (lanes,)),
        rand_int(gen, 1, qr + 1, (lanes,)),
        rand_int(gen, 0, b, (lanes,)),
    ] + [rand_int(gen, 0, topo.banks_per_channel, (lanes,))
         for _ in range(topo.channels)], dim=1).to(torch.int32)
    return [bank_rows.contiguous(), resp, rp.contiguous(),
            bounds.contiguous(), scal.contiguous()]


def max_err(a, b):
    import torch

    if a.shape != b.shape:
        return float("inf")
    return (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() \
        if a.numel() else 0


# ------------------------------------------------------------------ phases --

def phase_device():
    import torch
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.load()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds():.1f} s) from {build.CSRC}")
    return card


def topo_for(channels, tiers, ranks=2, **kw):
    from repro_torch.core.params import MemSimConfig

    cfg = MemSimConfig(channels=channels, ranks=ranks, tiers=tiers,
                       cxl_channels=1 if tiers == 2 else 0, **kw)
    return cfg.validate().topology()


def phase_kernels():
    import torch
    from repro_torch.kernels.bank_fsm.bank_fsm import (
        bank_event_bound_cuda, bank_fsm_step_cuda)
    from repro_torch.kernels.bank_fsm.fused import (
        fused_step_cuda, fused_step_plain)
    from repro_torch.kernels.bank_fsm.ref import (
        bank_event_bound_plain, bank_fsm_step_plain)

    gen = torch.Generator().manual_seed(2024)
    errs = {"k1": 0, "k2": 0, "k3": 0}
    # K1/K2: (B, T) -> topology
    k12 = {(32, 1): topo_for(1, 1), (32, 2): topo_for(2, 2, ranks=1),
           (128, 1): topo_for(2, 1, ranks=4), (128, 2): topo_for(2, 2,
                                                                  ranks=4)}
    n12 = 0
    for (b, t), topo in k12.items():
        check(topo.num_banks == b, f"topology for B={b} has "
              f"{topo.num_banks} banks")
        for s in (1, 3):
            for cycle in (0, 99, 100, 101, 399, 400, 4321):
                sched = rand_schedule(gen, s, t)
                bounds, rp = (x.to(DEVICE) for x in sched.pack())
                state = rand_state(gen, b, topo.row_shift).to(DEVICE)
                inputs = rand_int(gen, 0, 2, (3, b)).to(DEVICE)
                pop = rand_pop(gen, b, topo.row_shift).to(DEVICE)
                cyc = torch.full((1, 1), cycle, dtype=torch.int32,
                                 device=DEVICE)
                ks, kf = bank_fsm_step_cuda(topo, state, inputs, pop, rp,
                                            bounds, cyc)
                ps, pf = bank_fsm_step_plain(topo, state, inputs, pop, rp,
                                             bounds, cyc)
                e1 = max(max_err(ks, ps), max_err(kf, pf))
                split = topo.tier_split_bank if t > 1 else 0
                kb = bank_event_bound_cuda(state, rp, bounds, cyc, tiers=t,
                                           tier_split=split)
                pb = bank_event_bound_plain(state, rp, bounds, cyc,
                                            topo=topo if t > 1 else None)
                e2 = max_err(kb, pb)
                check(e1 == 0, f"K1 != plain at B={b} S={s} T={t} "
                      f"cycle={cycle} (max abs err {e1})")
                check(e2 == 0, f"K2 != plain at B={b} S={s} T={t} "
                      f"cycle={cycle} (max abs err {e2})")
                errs["k1"] = max(errs["k1"], e1)
                errs["k2"] = max(errs["k2"], e2)
                n12 += 1
    log(f"[2] K1, K2 == plain on {n12} random cases each "
        f"(B in {{32,128}}, S in {{1,3}}, T in {{1,2}})")

    # K3: (channels, T, ranks)
    # banks per channel 32, 32, 32, 64 (shared-memory arbiter), 16 and 4
    # (narrow and partial-warp shuffles)
    k3_topos = [topo_for(1, 1), topo_for(2, 1), topo_for(2, 2),
                topo_for(2, 1, ranks=4), topo_for(2, 1, ranks=1),
                topo_for(1, 1, ranks=1, bankgroups=2, banks_per_group=2)]
    n3 = 0
    for topo in k3_topos:
        for lanes in (1, 4):
            for s in (1, 3):
                for cycle in (0, 99, 100, 399, 2500):
                    ops = k3_operands(gen, topo, lanes, s, cycle)
                    cu = [x.to(DEVICE) for x in ops]
                    k = fused_step_cuda(topo, *cu, lanes=lanes)
                    p = fused_step_plain(topo, *cu, lanes=lanes)
                    e = max(max_err(a, b) for a, b in zip(k, p))
                    check(e == 0, f"K3 != plain at C={topo.channels} "
                          f"T={topo.tiers} per={topo.banks_per_channel} "
                          f"L={lanes} S={s} cycle={cycle} (err {e})")
                    errs["k3"] = max(errs["k3"], e)
                    n3 += 1
    log(f"[2] K3 == plain on {n3} random cases (L in {{1,4}}, C in {{1,2}}, "
        f"S in {{1,3}}, T in {{1,2}}, banks/channel in {{4,16,32,64}})")

    for topo, lanes, s in ((topo_for(1, 1), 1, 1), (topo_for(2, 2), 4, 3)):
        e, delta_pos = k3_rollout(gen, topo, lanes, s, 500)
        errs["k3"] = max(errs["k3"], e)
        log(f"[2] K3 rollout 500 cycles C={topo.channels} T={topo.tiers} "
            f"L={lanes} S={s}: == plain every cycle ({delta_pos} "
            f"lane-cycles with a skip > 0)")
    return errs


def k3_rollout(gen, topo, lanes, segments, cycles):
    """Run K3 for ``cycles`` cycles feeding its outputs back in (new pops
    and queue arrivals drawn at random), holding every cycle against the
    plain version on the same inputs."""
    import torch
    from repro_torch.kernels.bank_fsm.fused import (
        NUM_SCAL_OUT, fused_step_cuda, fused_step_plain)

    b = topo.num_banks
    total = lanes * b
    c = topo.channels
    ops = [x.to(DEVICE) for x in k3_operands(gen, topo, lanes, segments, 0)]
    bank_rows, resp, rp, bounds, scal = ops
    # start from reset-like registers: idle banks, empty queues
    bank_rows[0:3] = 0
    bank_rows[3] = torch.randint(200, 4000, (total,), generator=gen,
                                 dtype=torch.int32).to(DEVICE)
    bank_rows[8] = -1
    bank_rows[9] = 0
    bank_rows[11] = 0
    bank_rows[12:19] = -(1 << 20)
    scal[:, 3:6] = 0
    delta_pos = 0
    for cycle in range(cycles):
        scal[:, 0] = cycle
        scal[:, 2] = cycles * 10
        k = fused_step_cuda(topo, bank_rows, resp, rp, bounds, scal,
                            lanes=lanes)
        p = fused_step_plain(topo, bank_rows, resp, rp, bounds, scal,
                             lanes=lanes)
        e = max(max_err(x, y) for x, y in zip(k, p))
        check(e == 0, f"K3 rollout diverged from plain at cycle {cycle}")
        bank2, resp, scal2 = k
        delta_pos += int((scal2[:, 0] > 0).sum())
        arrive = (torch.randint(0, 4, (total,), generator=gen) == 0).to(DEVICE)
        qcount = bank2[14] + (arrive & (bank2[14] < 8)).to(torch.int32)
        pop = rand_pop(gen, total, topo.row_shift).to(DEVICE)
        bank_rows = torch.cat([bank2[0:10], bank2[13:14], qcount[None],
                               bank2[15:22], pop]).contiguous()
        nxt = torch.empty_like(scal)
        nxt[:, 0] = cycle + 1
        nxt[:, 1] = torch.randint(-2, 30, (lanes,), generator=gen,
                                  dtype=torch.int32).to(DEVICE)
        nxt[:, 2] = cycles * 10
        nxt[:, 3] = (torch.randint(0, 5, (lanes,), generator=gen) == 0).to(
            torch.int32).to(DEVICE)
        nxt[:, 4] = scal2[:, 2]
        nxt[:, 5] = scal2[:, 3]
        nxt[:, 6] = scal[:, 6]
        nxt[:, 7] = scal2[:, 1]
        nxt[:, 8:8 + c] = scal2[:, NUM_SCAL_OUT:NUM_SCAL_OUT + c]
        scal = nxt.contiguous()
        resp = resp.contiguous()
    return 0, delta_pos


def phase_main_path():
    import numpy as np
    from repro_torch import golden
    from repro_torch.core import MemSimConfig, simulate_fast, simulate_ideal
    from repro_torch.core.stats import cycle_diffs, format_table2
    from repro_torch.kernels import build
    from repro_torch.traces import BENCHMARKS

    expected = golden.load()
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    rows, total_steps, total_wall = [], 0, 0.0
    build.reset_launches()
    for name in sorted(BENCHMARKS):
        trace = BENCHMARKS[name]()
        tm = {}
        t0 = time.perf_counter()
        res = simulate_fast(cfg, trace, 100_000, timings=tm, device=DEVICE)
        wall = time.perf_counter() - t0
        ideal = simulate_ideal(cfg, trace,
                               device=DEVICE).t_complete.cpu().numpy()
        got = golden.result_digest(res, ideal, tm["steps"])
        bad = golden.mismatches(expected[golden.case_key(name, 100_000)],
                                got)
        check(not bad, f"{name}@100000 differs from the JAX golden digest "
              f"in {bad}")
        rows.append((name, cycle_diffs(res, np.asarray(ideal))))
        total_steps += tm["steps"]
        total_wall += wall
        log(f"[3] {name}: {trace.num_requests} requests, 100000 cycles, "
            f"{tm['steps']} executed steps, {wall:.2f} s wall "
            f"(run {tm['run_s']:.2f} s), {tm['steps'] / tm['run_s']:.0f} "
            f"steps/s, matches golden digest")
    launches = dict(build.LAUNCHES)
    check(launches["k3"] > 0, "K3 was never launched on the main path")
    check(launches["k3"] == total_steps,
          f"K3 launches {launches['k3']} != executed steps {total_steps}")
    check(launches["k1"] == 0 and launches["k2"] == 0,
          f"the fused path launched split kernels: {launches}")
    log(f"[3] K3 launches {launches['k3']} = executed steps {total_steps} "
        f"(1.00 per executed step); four traces in {total_wall:.1f} s, "
        f"{total_steps / total_wall:.0f} steps/s")
    log("[3] Table 2 (MemorySim - ideal, cycles):\n" + format_table2(rows))
    return launches["k3"]


def phase_per_cycle():
    from repro_torch import golden
    from repro_torch.core import (
        MemSimConfig, simulate, simulate_fast, simulate_ideal)
    from repro_torch.kernels import build
    from repro_torch.traces import conv2d

    expected = golden.load()[golden.case_key("conv2d", 20_000)]
    trace = conv2d()
    q = golden.QUEUE_SIZE
    ideal = simulate_ideal(MemSimConfig(queue_size=q), trace,
                           device=DEVICE).t_complete.cpu().numpy()
    build.reset_launches()
    t0 = time.perf_counter()
    split = simulate(MemSimConfig(queue_size=q, fsm_backend="split"),
                     trace, 20_000, device=DEVICE)
    t_split = time.perf_counter() - t0
    got = golden.result_digest(split, ideal)
    bad = golden.mismatches({k: v for k, v in expected.items()
                             if k != "steps"}, got)
    check(not bad, f"simulate(split) conv2d@20000 differs from golden in "
          f"{bad}")
    tm = {}
    t0 = time.perf_counter()
    fast = simulate_fast(MemSimConfig(queue_size=q, fsm_backend="split"),
                         trace, 20_000, timings=tm, device=DEVICE)
    t_fast = time.perf_counter() - t0
    bad = golden.mismatches(expected,
                            golden.result_digest(fast, ideal, tm["steps"]))
    check(not bad, f"simulate_fast(split) conv2d@20000 differs from golden "
          f"in {bad}")
    launches = dict(build.LAUNCHES)
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"split path did not launch K1 and K2: {launches}")
    check(launches["k3"] == 0, f"split path launched K3: {launches}")
    t0 = time.perf_counter()
    plain = simulate(MemSimConfig(queue_size=q, fsm_backend="plain"),
                     trace, 20_000, device=DEVICE)
    t_plain = time.perf_counter() - t0
    check(golden.result_digest(plain, ideal) == got,
          "simulate(plain) on the card != simulate(split)")
    log(f"[4] conv2d@20000: simulate split {t_split:.1f} s, simulate plain "
        f"{t_plain:.1f} s (bit-identical), simulate_fast split {t_fast:.1f} "
        f"s ({tm['steps']} steps); all match the golden digest; "
        f"K1 launches {launches['k1']}, K2 launches {launches['k2']}")
    return launches


def median_ms(fn, n=200, warm=20):
    """Median wall time of one call on the card, host launch included:
    CUDA events around each of ``n`` calls after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def device_ms(fn, per_graph=20, replays=10):
    """Device time of one call: ``per_graph`` calls captured in a CUDA
    graph, each replay timed with CUDA events, the median replay divided
    by ``per_graph`` (``per_graph * replays`` >= 200 calls). Host launch
    cost is excluded; a graph is how the simulator's loop replays them.
    Launch counters are restored: timing launches are not main-path
    launches."""
    import torch
    from repro_torch.kernels import build

    counted = dict(build.LAUNCHES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    times = []
    for _ in range(replays + 2):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    build.LAUNCHES.update(counted)
    return statistics.median(times[2:])


def phase_times():
    import torch
    from repro_torch.core import MemSimConfig
    from repro_torch.core.params import ParamSchedule
    from repro_torch.kernels.bank_fsm.bank_fsm import (
        bank_event_bound_cuda, bank_fsm_step_cuda)
    from repro_torch.kernels.bank_fsm.fused import (
        NUM_BANK_ROWS_IN, NUM_BANK_ROWS_OUT, NUM_SCAL_IN, NUM_SCAL_OUT,
        fused_step_cuda, fused_step_plain)
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.ref import (
        bank_event_bound_plain, bank_fsm_step_plain)

    gen = torch.Generator().manual_seed(7)
    cfg = MemSimConfig(queue_size=128)
    topo = cfg.topology()
    b, qr, c = topo.num_banks, topo.resp_queue_size, topo.channels
    bounds, rp = (x.to(DEVICE) for x in ParamSchedule.constant(
        cfg.runtime()).pack())
    state = rand_state(gen, b, topo.row_shift).to(DEVICE)
    inputs = rand_int(gen, 0, 2, (3, b)).to(DEVICE)
    pop = rand_pop(gen, b, topo.row_shift).to(DEVICE)
    cyc = torch.full((1, 1), 1234, dtype=torch.int32, device=DEVICE)
    ops = [x.to(DEVICE) for x in k3_operands(gen, topo, 1, 1, 1234)]
    ops[2], ops[3] = rp, bounds

    rp_bytes = rp.numel() * 4 + bounds.numel() * 4
    work = {
        "k1": (lambda: bank_fsm_step_cuda(topo, state, inputs, pop, rp,
                                          bounds, cyc),
               lambda: bank_fsm_step_plain(topo, state, inputs, pop, rp,
                                           bounds, cyc),
               (10 + 3 + 4) * b * 4 + rp_bytes + 4 + (10 + 3) * b * 4),
        "k2": (lambda: bank_event_bound_cuda(state, rp, bounds, cyc),
               lambda: bank_event_bound_plain(state, rp, bounds, cyc),
               4 * b * 4 + rp_bytes + 4 + b * 4),
        "k3": (lambda: fused_step_cuda(topo, *ops),
               lambda: fused_step_plain(topo, *ops),
               (NUM_BANK_ROWS_IN + NUM_BANK_ROWS_OUT) * b * 4
               + 2 * qr * 4 * 4 + rp_bytes
               + (NUM_SCAL_IN + c + NUM_SCAL_OUT + 2 * c) * 4),
    }
    out = {}
    counted = dict(build.LAUNCHES)
    for k, (kern, plain, nbytes) in work.items():
        ms = device_ms(kern)
        plain_ms = device_ms(plain)
        call_ms = median_ms(kern)
        plain_call_ms = median_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (ms, plain_ms, bound_ms, nbytes)
        log(f"[5] {k}: device {ms * 1e3:.2f} us/launch (plain version "
            f"{plain_ms * 1e3:.2f} us); eager call incl. host launch "
            f"{call_ms * 1e3:.2f} us (plain {plain_call_ms * 1e3:.2f} us); "
            f"bound {bound_ms * 1e6:.2f} ns ({nbytes} B at 3.35 TB/s); "
            f"main-path shape B={b} S=1 T=1")
    build.LAUNCHES.update(counted)
    return out


def phase_trace():
    """Where a main-path step's time goes: a device trace of conv2d over
    5000 cycles (kernels and device time per executed step, device busy
    share), and the host synchronisations per executed step."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import MemSimConfig, simulate_fast
    from repro_torch.traces import conv2d

    cfg = MemSimConfig(queue_size=128)
    trace = conv2d()
    tm = {}
    simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    t0 = time.perf_counter()
    simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate_fast(cfg, trace, 5_000, device=DEVICE)
    dev = [e for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    steps = tm["steps"]
    if dev:
        kernels = sum(e.count for e in dev)
        dev_us = sum(e.self_device_time_total for e in dev)
        log(f"[6] conv2d@5000 ({steps} executed steps): {wall:.2f} s wall "
            f"untraced = {wall / steps * 1e6:.0f} us/step; traced: "
            f"{kernels / steps:.0f} device kernels/step, "
            f"{dev_us / steps:.0f} us device time/step, device busy "
            f"{dev_us * 1e-6 / wall:.0%} of the untraced wall time")
    else:
        log("[6] device trace: no device events recorded (not measured)")
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    check(syncs <= steps + 64, f"{syncs} host synchronisations for "
          f"{steps} executed steps")
    log(f"[6] host synchronisations: {syncs} for {steps} executed steps "
        f"(one per step reads the skip; the rest are set-up)")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: src/repro_torch not found under {ROOT}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = phase_device()
        errs = phase_kernels()
        k3_launches = phase_main_path()
        split_launches = phase_per_cycle()
        times = phase_times()
        phase_trace()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    src = "src/repro_torch/csrc/"
    ref = "src/repro/kernels/bank_fsm/"
    meta = {
        "k1": ("bank_fsm_step", src + "bank_fsm.cu", ref + "bank_fsm.py:332",
               split_launches["k1"]),
        "k2": ("bank_event_bound", src + "bank_fsm.cu",
               ref + "bank_fsm.py:300", split_launches["k2"]),
        "k3": ("fused_step", src + "fused.cu", ref + "fused.py:397",
               k3_launches),
    }
    kernels = []
    for k, (name, source, replaces, launches) in meta.items():
        ms, plain_ms, bound_ms, _ = times[k]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
