"""The plain PyTorch versions of the CUDA kernels K1, K2, K3 against the
JAX Pallas kernels they replace (interpret mode), on random packed-ABI
inputs over the grid chip_smoke.py runs on the card: K1/K2 at B in
{32, 128}, S in {1, 3}, T in {1, 2}; K3 at lanes in {1, 4}, channels in
{1, 2}, S in {1, 3}, T in {1, 2} and a 64-bank channel; plus a 200-cycle
K3 rollout that feeds the outputs back in. Bit-identical everywhere."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.params as jp  # noqa: E402
from repro.kernels.bank_fsm.bank_fsm import (  # noqa: E402
    bank_event_bound_pallas,
    bank_fsm_step_pallas,
)
from repro.kernels.bank_fsm.fused import fused_step_pallas  # noqa: E402
import repro_torch.core.params as tp  # noqa: E402
from repro_torch.kernels.bank_fsm import ops  # noqa: E402
from repro_torch.kernels.bank_fsm.fused import (  # noqa: E402
    NUM_SCAL_OUT,
    fused_step,
    fused_step_plain,
)
from repro_torch.kernels.bank_fsm.ref import (  # noqa: E402
    bank_event_bound_plain,
    bank_fsm_step_plain,
)

NP_ = jp.NUM_RUNTIME_PARAMS


@functools.lru_cache(maxsize=None)
def jit_k1(topo, block):
    return jax.jit(functools.partial(bank_fsm_step_pallas, topo,
                                     block_b=block, interpret=True))


@functools.lru_cache(maxsize=None)
def jit_k2(block, tiers, split):
    return jax.jit(functools.partial(bank_event_bound_pallas, block_b=block,
                                     interpret=True, tiers=tiers,
                                     tier_split=split))


@functools.lru_cache(maxsize=None)
def jit_k3(topo, lanes):
    return jax.jit(functools.partial(fused_step_pallas, topo,
                                     interpret=True, lanes=lanes))


def topo_pair(channels, tiers, ranks=2, **extra):
    kw = dict(channels=channels, ranks=ranks, tiers=tiers,
              cxl_channels=1 if tiers == 2 else 0, **extra)
    return (jp.MemSimConfig(**kw).validate().topology(),
            tp.MemSimConfig(**kw).validate().topology())


def rand_point(rng):
    trfc = int(rng.integers(20, 300))
    return [int(rng.integers(1, 30)), int(rng.integers(20, 40)),
            int(rng.integers(1, 20)), int(rng.integers(1, 30)),
            int(rng.integers(1, 30)), int(rng.integers(1, 8)),
            int(rng.integers(1, 12)), trfc, trfc + int(rng.integers(100, 4000)),
            int(rng.integers(1, 30)), int(rng.integers(1, 20)),
            int(rng.integers(1, 8)), int(rng.integers(5, 1500)),
            int(rng.integers(0, 2)), int(rng.integers(0, 2)), 6, 1]


def rand_packed(rng, s, t):
    """Packed (bounds [S, 1], rp [T*S, NP]) of a valid random schedule."""
    rows = np.zeros((t, s, NP_), np.int64)
    for si in range(s):
        base = rand_point(rng)
        for ti in range(t):
            p = rand_point(rng)
            for f in jp.TIER_UNIFORM_FIELDS:
                p[jp.RP_INDEX[f]] = base[jp.RP_INDEX[f]]
            rows[ti, si] = p
    bounds = np.asarray([0, 100, 400][:s]).reshape(s, 1)
    return bounds, rows.reshape(t * s, NP_)


def rand_state(rng, b, row_shift):
    return np.stack([
        rng.integers(0, 14, b), rng.integers(0, 40, b),
        rng.integers(0, 1200, b), rng.integers(0, 8000, b),
        rng.integers(0, 64 << row_shift, b), rng.integers(0, 2, b),
        rng.integers(0, 1 << 30, b), rng.integers(-1, 1000, b),
        rng.integers(-1, 64, b), rng.integers(0, 4, b)])


def rand_pop(rng, b, row_shift):
    return np.stack([rng.integers(0, 64 << row_shift, b),
                     rng.integers(0, 2, b), rng.integers(0, 1 << 30, b),
                     rng.integers(0, 1000, b)])


def J(x):
    return jnp.asarray(np.asarray(x), jnp.int32)


def T(x):
    return torch.as_tensor(np.asarray(x).astype(np.int32))


def same(j, t, msg):
    a, b = np.asarray(j), t.numpy()
    assert b.dtype == np.int32, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


K12 = {(32, 1): (1, 1, 2), (32, 2): (2, 2, 1), (128, 1): (2, 1, 4),
       (128, 2): (2, 2, 4)}


@pytest.mark.parametrize("b,t", sorted(K12))
@pytest.mark.parametrize("s", [1, 3])
def test_k1_k2_plain_match_pallas(b, t, s):
    c, tiers, ranks = K12[(b, t)]
    jt, tt = topo_pair(c, tiers, ranks)
    assert tt.num_banks == b
    rng = np.random.default_rng(b * 10 + t + s)
    for cycle in (0, 99, 100, 101, 399, 400, 4321):
        bounds, rp = rand_packed(rng, s, t)
        state = rand_state(rng, b, tt.row_shift)
        inputs = rng.integers(0, 2, (3, b))
        pop = rand_pop(rng, b, tt.row_shift)
        block = min(128, b)
        js, jf = jit_k1(jt, block)(J(state), J(inputs), J(pop), J(rp),
                                   J(bounds), J([[cycle]]))
        ps, pf = bank_fsm_step_plain(tt, T(state), T(inputs), T(pop), T(rp),
                                     T(bounds), T([[cycle]]))
        same(js, ps, f"K1 state cycle {cycle}")
        same(jf, pf, f"K1 flags cycle {cycle}")
        split = jt.tier_split_bank if t > 1 else 0
        jb = jit_k2(block, t, split)(J(state), J(rp), J(bounds),
                                     J([[cycle]]))
        pb = bank_event_bound_plain(T(state), T(rp), T(bounds), T([[cycle]]),
                                    topo=tt if t > 1 else None)
        same(jb, pb, f"K2 cycle {cycle}")


def test_ops_dispatch_cpu_runs_plain_with_padding_free_shapes():
    """The CPU entry points run the plain versions and keep [B] shapes."""
    jt, tt = topo_pair(1, 1)
    rng = np.random.default_rng(5)
    state = T(rand_state(rng, 32, tt.row_shift))
    new_state, flags = ops.bank_fsm_step(tt, state, T(rng.integers(0, 2, (3, 32))),
                                         T(rand_pop(rng, 32, tt.row_shift)),
                                         77, tp.RuntimeParams())
    assert new_state.shape == (10, 32) and flags.shape == (3, 32)
    bound = ops.bank_event_bound(state, 77, tp.RuntimeParams())
    assert bound.shape == (32,) and bound.dtype == torch.int32
    padded = ops._pad_banks(state, torch.zeros((3, 32), dtype=torch.int32),
                            torch.zeros((4, 32), dtype=torch.int32), 40)[0]
    assert padded[:, 32:].tolist() == [[0] * 8, [0] * 8, [0] * 8,
                                       [0x3FFFFFFF] * 8, [0] * 8, [0] * 8,
                                       [0] * 8, [-1] * 8, [-1] * 8, [0] * 8]


def k3_operands(rng, topo, lanes, s, cycle):
    b = topo.num_banks
    total = lanes * b
    qr = topo.resp_queue_size
    state = rand_state(rng, total, topo.row_shift)
    qhead = rng.integers(0, topo.queue_size, total)
    qcount = rng.integers(0, 4, total) * rng.integers(0, 2, total)
    timing = cycle - rng.integers(0, 80, (7, total))
    bank_rows = np.concatenate([state, qhead[None], qcount[None], timing,
                                rand_pop(rng, total, topo.row_shift)])
    resp = rng.integers(0, 1 << 20, (lanes * qr, 4))
    packs = [rand_packed(rng, s, topo.tiers) for _ in range(lanes)]
    bounds = np.concatenate([p[0] for p in packs])
    rp = np.concatenate([p[1] for p in packs])
    arrival = np.where(rng.integers(0, 4, lanes) == 0, 0x3FFFFFFF,
                       rng.integers(-3, 200, lanes))
    scal = np.stack([np.full(lanes, cycle), arrival,
                     cycle + rng.integers(1, 5000, lanes),
                     rng.integers(0, 3, lanes) * (rng.integers(0, 3, lanes)
                                                  == 0),
                     rng.integers(0, qr, lanes),
                     rng.integers(0, qr + 1, lanes) * rng.integers(0, 2,
                                                                   lanes),
                     rng.integers(1, qr + 1, lanes),
                     rng.integers(0, b, lanes)]
                    + [rng.integers(0, topo.banks_per_channel, lanes)
                       for _ in range(topo.channels)], axis=1)
    return [bank_rows, resp, rp, bounds, scal]


# (channels, tiers, ranks, extra): banks per channel 32, 32, 32, 64 (the
# CUDA kernel's shared-memory arbiter), 16 and 4 (narrow warp shuffles)
K3_TOPOS = [(1, 1, 2, {}), (2, 1, 2, {}), (2, 2, 2, {}), (2, 1, 4, {}),
            (2, 1, 1, {}), (1, 1, 1, dict(bankgroups=2, banks_per_group=2))]


@pytest.mark.parametrize("c,t,ranks,extra", K3_TOPOS)
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("s", [1, 3])
def test_k3_plain_matches_pallas(c, t, ranks, extra, lanes, s):
    jt, tt = topo_pair(c, t, ranks, **extra)
    rng = np.random.default_rng(c * 100 + t * 10 + ranks + lanes + s)
    for cycle in (0, 99, 100, 399, 2500):
        ops_np = k3_operands(rng, tt, lanes, s, cycle)
        jo = jit_k3(jt, lanes)(*map(J, ops_np))
        to = fused_step_plain(tt, *map(T, ops_np), lanes=lanes)
        for name, a, b in zip(("bank", "resp", "scal"), jo, to):
            same(a, b, f"K3 {name} cycle {cycle}")


def test_k3_rollout_200_cycles():
    """Feed K3's outputs back in for 200 cycles (random queue arrivals and
    pops) on a 2-channel, 2-tier, 2-lane, 3-segment machine; the plain
    version must equal the Pallas kernel at every cycle."""
    jt, tt = topo_pair(2, 2, 1)
    lanes, c = 2, tt.channels
    rng = np.random.default_rng(11)
    bank_rows, resp, rp, bounds, scal = k3_operands(rng, tt, lanes, 3, 0)
    total = lanes * tt.num_banks
    bank_rows[0:3] = 0
    bank_rows[3] = rng.integers(200, 4000, total)
    bank_rows[8], bank_rows[9], bank_rows[11] = -1, 0, 0
    bank_rows[12:19] = -(1 << 20)
    scal[:, 3:6] = 0
    skipped = 0
    for cycle in range(200):
        scal[:, 0], scal[:, 2] = cycle, 2000
        jo = jit_k3(jt, lanes)(J(bank_rows), J(resp), J(rp), J(bounds),
                               J(scal))
        to = fused_step(tt, T(bank_rows), T(resp), T(rp), T(bounds),
                        T(scal), lanes=lanes)
        for name, a, b in zip(("bank", "resp", "scal"), jo, to):
            same(a, b, f"rollout {name} cycle {cycle}")
        bank2, resp, scal2 = (x.numpy() for x in to)
        skipped += int((scal2[:, 0] > 0).sum())
        qcount = bank2[14] + ((rng.integers(0, 4, total) == 0)
                              & (bank2[14] < 8))
        bank_rows = np.concatenate([bank2[0:10], bank2[13:14], qcount[None],
                                    bank2[15:22],
                                    rand_pop(rng, total, tt.row_shift)])
        nxt = scal.copy()
        nxt[:, 1] = rng.integers(-2, 30, lanes)
        nxt[:, 3] = rng.integers(0, 5, lanes) == 0
        nxt[:, 4], nxt[:, 5] = scal2[:, 2], scal2[:, 3]
        nxt[:, 7] = scal2[:, 1]
        nxt[:, 8:8 + c] = scal2[:, NUM_SCAL_OUT:NUM_SCAL_OUT + c]
        scal = nxt
    assert skipped > 0, "rollout never produced a skip"
