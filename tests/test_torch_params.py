"""Parity of the port's parameter model (repro_torch.core.params) with the
JAX reference: packed ABI, schedule resolution, error texts, and the
constants of the CUDA header (src/repro_torch/csrc/rp_index.h)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.params as jp  # noqa: E402
import repro.core.bank_fsm as jbf  # noqa: E402
import repro_torch.core.params as tp  # noqa: E402
import repro_torch.core.bank_fsm as tbf  # noqa: E402

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "rp_index.h")


def rand_vals(rng):
    trfc = int(rng.integers(20, 300))
    return dict(
        tRP=int(rng.integers(1, 30)), tFAW=int(rng.integers(20, 40)),
        tRRDL=int(rng.integers(1, 20)), tRCDRD=int(rng.integers(1, 30)),
        tRCDWR=int(rng.integers(1, 30)), tCCDL=int(rng.integers(1, 8)),
        tWTR=int(rng.integers(1, 12)), tRFC=trfc,
        tREFI=trfc + int(rng.integers(100, 4000)),
        tCL=int(rng.integers(1, 30)), tXS=int(rng.integers(1, 20)),
        tRTW=int(rng.integers(1, 8)),
        sref_idle_cycles=int(rng.integers(5, 1500)),
        page_policy=int(rng.integers(0, 2)),
        sched_policy=int(rng.integers(0, 2)))


def both_schedules(rng, s, t):
    """The same random schedule built in both packages."""
    bounds = [0, 120, 700][:s]
    j_pts, t_pts = [], []
    for _ in range(s):
        tier_vals = [rand_vals(rng) for _ in range(t)]
        for v in tier_vals[1:]:
            for f in jp.TIER_UNIFORM_FIELDS:
                if f in tier_vals[0]:
                    v[f] = tier_vals[0][f]
        jr = [jp.RuntimeParams(**v) for v in tier_vals]
        tr = [tp.RuntimeParams(**v) for v in tier_vals]
        j_pts.append(jr[0] if t == 1 else jp.tiered_params(*jr))
        t_pts.append(tr[0] if t == 1 else tp.tiered_params(*tr))
    import jax.numpy as jnp

    js = jp.ParamSchedule(boundaries=jnp.asarray(bounds, jnp.int32),
                          values=jp.RuntimeParams.stack(j_pts))
    ts = tp.ParamSchedule(boundaries=torch.tensor(bounds, dtype=torch.int32),
                          values=tp.RuntimeParams.stack(t_pts))
    return js, ts


def same(a, b, msg=""):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)
    assert np.asarray(b).dtype == np.int32, msg


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_and_resolution(s, t, seed):
    rng = np.random.default_rng(seed)
    js, ts = both_schedules(rng, s, t)
    assert ts.num_segments == js.num_segments == s
    assert ts.num_tiers == js.num_tiers == t
    jb, jv = js.pack()
    tb, tv = ts.pack()
    same(jb, tb, "bounds")
    same(jv, tv, "values")
    back = tp.ParamSchedule.unpack(tb, tv)
    for f in tp.RuntimeParams._fields:
        same(np.asarray(getattr(js.values, f)), getattr(back.values, f), f)
    for cycle in (0, 1, 119, 120, 121, 699, 700, 701, 5000):
        same(js.segment_at(cycle), ts.segment_at(cycle), f"seg {cycle}")
        same(js.next_boundary(cycle), ts.next_boundary(cycle),
             f"next boundary {cycle}")
        jpt, tpt = js.params_at(cycle), ts.params_at(cycle)
        for f in tp.RuntimeParams._fields:
            same(getattr(jpt, f), getattr(tpt, f), f"{f}@{cycle}")
    jpad, tpad = js.pad_to(5).pack(), ts.pad_to(5).pack()
    same(jpad[0], tpad[0], "padded bounds")
    same(jpad[1], tpad[1], "padded values")
    jst = jp.ParamSchedule.stack([js, js.pad_to(4)])
    tst = tp.ParamSchedule.stack([ts, ts.pad_to(4)])
    same(jst.boundaries, tst.boundaries, "stacked bounds")
    for f in tp.RuntimeParams._fields:
        same(getattr(jst.values, f), getattr(tst.values, f), f"stack {f}")


@pytest.mark.parametrize("topology", [
    dict(), dict(channels=2, tiers=2, cxl_channels=1),
    dict(channels=4, ranks=1, tiers=2, cxl_channels=2),
])
def test_topology_derived_fields_and_tier_maps(topology):
    jc = jp.MemSimConfig(**topology).validate()
    tc = tp.MemSimConfig(**topology).validate()
    for f in ("banks_per_rank", "banks_per_channel", "num_banks",
              "num_ranks", "addr_low_bits", "dram_channels",
              "tier_split_bank", "tier_split_rank"):
        assert getattr(jc, f) == getattr(tc, f), f
    np.testing.assert_array_equal(jp.tier_of_bank(jc), tp.tier_of_bank(tc))
    rps = [tp.RuntimeParams(tRP=5), tp.RuntimeParams(tRP=9)]
    jrps = [jp.RuntimeParams(tRP=5), jp.RuntimeParams(tRP=9)]
    if jc.tiers > 1:
        jb = jp.rp_for_banks(jc, jp.tiered_params(*jrps))
        tb = tp.rp_for_banks(tc, tp.tiered_params(*rps))
        for f in tp.RuntimeParams._fields:
            same(getattr(jb, f), getattr(tb, f), f)
    assert tp.RuntimeParams.from_config(tc) == tuple(
        jp.RuntimeParams.from_config(jc))


BAD_CONFIGS = [
    dict(channels=3), dict(ranks=0), dict(queue_size=0),
    dict(resp_queue_size=0), dict(tiers=3), dict(cxl_channels=1),
    dict(channels=4, tiers=2, cxl_channels=3),
    dict(tRP=0), dict(tREFI=100, tRFC=260), dict(tFAW=3, tRRDL=6),
    dict(tier_interleave_log2=30), dict(tier_cxl_frac_log2=0),
    dict(tCL=-1, tXS=0),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_config_error_texts_match(kw):
    with pytest.raises(ValueError) as je:
        jp.MemSimConfig(**kw).validate()
    with pytest.raises(ValueError) as te:
        tp.MemSimConfig(**kw).validate()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [dict(page_policy="half"),
                                dict(sched_policy="lifo")])
def test_policy_error_texts_match(kw):
    with pytest.raises(ValueError) as je:
        jp.MemSimConfig(**kw)
    with pytest.raises(ValueError) as te:
        tp.MemSimConfig(**kw)
    assert str(te.value) == str(je.value)


def test_fsm_backend_values():
    for b in ("plain", "split", "fused"):
        assert tp.Topology(fsm_backend=b).fsm_backend == b
    assert tp.Topology().fsm_backend == "fused"
    with pytest.raises(ValueError, match="not in"):
        tp.Topology(fsm_backend="jnp")


@pytest.mark.parametrize("case", ["unsorted", "nonzero_start", "bad_point",
                                  "pad_not_suffix", "tier_nonuniform"])
def test_schedule_error_texts_match(case):
    import jax.numpy as jnp

    def mk(pkg, xp, bounds, pts):
        return pkg.ParamSchedule(
            boundaries=xp(bounds), values=pkg.RuntimeParams.stack(pts))

    jx = lambda b: jnp.asarray(b, jnp.int32)  # noqa: E731
    tx = lambda b: torch.tensor(b, dtype=torch.int32)  # noqa: E731
    inf = tp.SCHEDULE_INF
    if case == "tier_nonuniform":
        def pts(pkg):
            return [pkg.RuntimeParams.stack([pkg.RuntimeParams(),
                                             pkg.RuntimeParams(
                                                 page_policy=1)])]
        bounds = [0]
    else:
        bounds = {"unsorted": [0, 50, 20], "nonzero_start": [5, 10, 20],
                  "bad_point": [0, 10, 20],
                  "pad_not_suffix": [0, inf, 20]}[case]

        def pts(pkg):
            bad = pkg.RuntimeParams(tREFI=10) if case == "bad_point" \
                else pkg.RuntimeParams()
            return [pkg.RuntimeParams(), bad, pkg.RuntimeParams(tCL=3)]
    with pytest.raises(ValueError) as je:
        mk(jp, jx, bounds, pts(jp)).validate()
    with pytest.raises(ValueError) as te:
        mk(tp, tx, bounds, pts(tp)).validate()
    assert str(te.value) == str(je.value)


def test_tiered_params_error_texts_match():
    for args in ((jp.RuntimeParams(),), ):
        with pytest.raises(ValueError) as je:
            jp.tiered_params(*args)
        with pytest.raises(ValueError) as te:
            tp.tiered_params(tp.RuntimeParams())
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jp.tiered_params(jp.RuntimeParams(), jp.RuntimeParams(page_policy=1))
    with pytest.raises(ValueError) as te:
        tp.tiered_params(tp.RuntimeParams(), tp.RuntimeParams(page_policy=1))
    assert str(te.value) == str(je.value)


def test_codes_match_reference():
    assert tp.RP_INDEX == jp.RP_INDEX
    assert tp.NUM_RUNTIME_PARAMS == jp.NUM_RUNTIME_PARAMS == 17
    names = [n for n in dir(jp) if n.startswith(("S_", "CMD_", "PAGE_",
                                                  "SCHED_"))]
    assert len(names) > 20
    for n in names + ["NUM_STATES", "NUM_CMDS", "SCHEDULE_INF"]:
        assert getattr(tp, n) == getattr(jp, n), n
    for n in ("P_NONE", "P_RW", "P_REF", "P_SREF", "EVENT_INF"):
        assert getattr(tbf, n) == getattr(jbf, n), n
    assert tp.DEFAULT_CONFIG.runtime() == tuple(jp.DEFAULT_CONFIG.runtime())


def test_cuda_header_matches_reference():
    defs = dict(re.findall(r"^#define (\w+) (\S+)", HEADER.read_text(),
                           re.M))
    for name, idx in jp.RP_INDEX.items():
        assert int(defs[f"RP_{name}"]) == idx, name
    assert int(defs["NUM_RUNTIME_PARAMS"]) == jp.NUM_RUNTIME_PARAMS
    codes = [n for n in dir(jp) if n.startswith(("S_", "CMD_"))
             and not n.startswith("SCHED")]
    for n in codes:
        assert int(defs[n]) == getattr(jp, n), n
    for n in ("P_NONE", "P_RW", "P_REF", "P_SREF"):
        assert int(defs[n]) == getattr(jbf, n), n
    assert int(defs["PAGE_OPEN"]) == jp.PAGE_OPEN
    assert int(defs["SCHED_FRFCFS"]) == jp.SCHED_FRFCFS
    assert int(defs["EVENT_INF"], 16) == jbf.EVENT_INF
    assert int(defs["SCHEDULE_INF"], 16) == jp.SCHEDULE_INF


@pytest.mark.parametrize("case", ["dvfs", "one", "empty", "unsorted",
                                  "nonzero_start", "bad_point"])
def test_schedule_from_segments_matches(case):
    """``ParamSchedule.from_segments``: the same packed schedule, or the
    same ValueError text, as the reference's."""
    segs = {"dvfs": [(0, {}), (150, dict(tCL=18, page_policy=1)),
                     (300, dict(tRP=17, tREFI=900, sched_policy=1))],
            "one": [(0, dict(tRCDRD=20))],
            "empty": [],
            "unsorted": [(0, {}), (50, {}), (20, {})],
            "nonzero_start": [(5, {})],
            "bad_point": [(0, {}), (10, dict(tREFI=10))]}[case]

    def build(pkg):
        return pkg.ParamSchedule.from_segments(
            [(s, pkg.RuntimeParams(**kw)) for s, kw in segs])

    if case in ("dvfs", "one"):
        want = [np.asarray(x) for x in build(jp).pack()]
        got = [x.numpy() for x in build(tp).pack()]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        return
    with pytest.raises(ValueError) as je:
        build(jp)
    with pytest.raises(ValueError) as te:
        build(tp)
    assert str(te.value) == str(je.value)
