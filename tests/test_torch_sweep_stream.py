"""The port's streaming sweep executor (``core/sweep_stream``), its chunk
and training checkpoint stores (``checkpoint/store``) and the persistent
kernel cache (``core/exec_cache``) on the CPU, against the JAX reference.

On the CPU each chunk runs the lane-batched K3's plain version. Cases (at
most 16 requests a lane and 600 cycles): the reference test's 8-point
grid streamed in chunks of 3 + 3 + 2 against the port's materialising run
and the reference's streamed run, field by field; a multi-topology stream
against ``sweep_topologies``; the threshold's routing;
``lane_footprint_bytes``, ``_resolve_chunk_lanes``, ``sweep_fingerprint``
and ``_chunk_digest`` against the reference's; a full restore, the
mismatch refusal (the reference's text), ``resume=False`` and a corrupt
chunk; ``SweepCheckpoint`` and ``CheckpointStore`` files crossing between
the packages; a child SIGKILLed mid-sweep and resumed, on the fused and
plain backends; and the kernel cache's key, switch and corrupt-library
rule (with no nvcc here, a rebuild raises and nothing is served).
"""

import dataclasses
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import CheckpointStore as JaxCheckpointStore  # noqa: E402
from repro.checkpoint.store import SweepCheckpoint as JaxSweepCheckpoint  # noqa: E402
from repro.core import MemSimConfig as JaxConfig  # noqa: E402
from repro.core import sweep_grid as jax_sweep_grid  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import exec_cache as jax_exec_cache  # noqa: E402
from repro.core import sweep_stream as jax_stream  # noqa: E402
from repro.traces import BENCHMARKS as JAX_BENCHMARKS  # noqa: E402
from repro_torch.checkpoint.store import (  # noqa: E402
    CheckpointStore,
    SweepCheckpoint,
)
from repro_torch.core import (  # noqa: E402
    MemSimConfig,
    aot_cache_stats,
    stream_sweep,
    sweep_grid,
    sweep_topologies,
)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import exec_cache, sweep_stream  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from test_torch_batch import FIELDS  # noqa: E402
from test_torch_engine import port_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CYCLES = 600
SMALL = dict(queue_size=8, mem_words=1 << 12)
#: the reference test's 8 runtime points; chunk_lanes=3 -> 3 + 3 + 2
GRID = {"tCL": [14, 18], "page_policy": ["closed", "open"],
        "queue_size": [4, 8]}
#: 4 points; chunk_lanes=2 -> 2 chunks
GRID4 = {"tCL": [14, 18], "queue_size": [4, 8]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loop's ops are tiny: one intra-op thread runs them faster
    than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_trace(n=16):
    return JAX_BENCHMARKS["trace_example"](n=n, gap=5)


def assert_port_same(a, b, label):
    """Two port results: every field with its type and dtype, the counters
    in one order, the blocked totals and the label."""
    assert a.cfg == b.cfg and a.num_cycles == b.num_cycles, label
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert type(x) is type(y) and x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {f}")
    assert list(a.counters) == list(b.counters), label
    for k in a.counters:
        x, y = a.counters[k], b.counters[k]
        assert type(x) is type(y) and x.dtype == y.dtype, (label, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {k}")
    assert (a.blocked_arrival, a.blocked_dispatch) == \
        (b.blocked_arrival, b.blocked_dispatch), label


def assert_ref_same(ref, got, label):
    """A reference result against a port one (labels but the backend)."""
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f),
                                      err_msg=f"{label}: {f}")
    assert sorted(ref.counters) == sorted(got.counters), label
    for k in ref.counters:
        np.testing.assert_array_equal(np.asarray(ref.counters[k]),
                                      got.counters[k],
                                      err_msg=f"{label}: counter {k}")
    assert (ref.blocked_arrival, ref.blocked_dispatch, ref.num_cycles) == \
        (got.blocked_arrival, got.blocked_dispatch, got.num_cycles), label
    d_ref, d_got = dataclasses.asdict(ref.cfg), dataclasses.asdict(got.cfg)
    del d_ref["fsm_backend"], d_got["fsm_backend"]
    assert d_ref == d_got, label


def digest(results):
    """The reference test's digest of a result table."""
    h = hashlib.sha256()
    for r in results:
        for f in ("t_admit", "t_dispatch", "t_start", "t_complete",
                  "rdata"):
            h.update(np.ascontiguousarray(
                np.asarray(getattr(r, f), np.int32)).tobytes())
        for k in sorted(r.counters):
            h.update(np.ascontiguousarray(
                np.asarray(r.counters[k], np.int64)).tobytes())
        h.update(np.int64(r.blocked_arrival).tobytes())
        h.update(np.int64(r.blocked_dispatch).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def grid8():
    """The 8-point grid through the port's materialising path."""
    tr = port_trace(jax_trace())
    return tr, sweep_grid(MemSimConfig(**SMALL), tr, GRID, CYCLES,
                          stream=False, device="cpu")


@pytest.fixture(scope="module")
def grid4_ckpt(tmp_path_factory):
    """The 4-point grid streamed in 2 chunks into a checkpoint."""
    d = tmp_path_factory.mktemp("grid4") / "ck"
    tr = port_trace(jax_trace())
    tm = {}
    res = sweep_grid(MemSimConfig(**SMALL), tr, GRID4, CYCLES, stream=True,
                     chunk_lanes=2, checkpoint_dir=str(d), timings=tm,
                     device="cpu")
    assert tm["chunks"] == 2 and tm["chunks_resumed"] == 0
    assert tm["launches"] == 2 and tm["checkpoint_s"] > 0
    return tr, res, d


# --------------------------------------------------------------------------
# streamed against materialising and against the reference


def test_stream_matches_materialising_and_reference(grid8):
    tr, mat = grid8
    tm = {}
    got = sweep_grid(MemSimConfig(**SMALL), tr, GRID, CYCLES, stream=True,
                     chunk_lanes=3, timings=tm, device="cpu")
    jt = {}
    ref = jax_sweep_grid(JaxConfig(**SMALL), jax_trace(), GRID, CYCLES,
                         stream=True, chunk_lanes=3, timings=jt)
    assert tm["streamed"] is True and tm["chunks"] == 3
    assert tm["launches"] == 3 and tm["chunks_resumed"] == 0
    assert [c["lanes"] for c in tm["per_chunk"]] == [3, 3, 2]
    for k in ("chunk_lanes", "chunks", "lane_bytes", "peak_chunk_bytes",
              "topologies"):
        assert tm[k] == jt[k], k
    assert tm["steps"] == max(c["steps"] for c in tm["per_chunk"])
    assert len(got) == len(mat) == len(ref) == 8
    for i, (m, g, r) in enumerate(zip(mat, got, ref)):
        assert_port_same(m, g, f"lane {i}")
        assert_ref_same(r, g, f"lane {i} vs reference")


def test_stream_multi_topology_matches_sweep_topologies():
    tr = port_trace(jax_trace())
    grid = {"ranks": [1, 2], "tCL": [14, 18]}
    mat = sweep_topologies(MemSimConfig(**SMALL), tr, grid, CYCLES,
                           stream=False, device="cpu")
    tm = {}
    got = stream_sweep(MemSimConfig(**SMALL), tr, grid, CYCLES,
                       chunk_lanes=3, timings=tm, device="cpu")
    assert got.timings["streamed"] is True and tm["topologies"] == 2
    # topology-major: each topology's 2 lanes one chunk
    assert [(c["topology"], c["lanes"]) for c in tm["per_chunk"]] == \
        [(0, 2), (1, 2)]
    assert got.points == mat.points
    assert got.topologies == mat.topologies
    assert got.topo_of_point == mat.topo_of_point
    for i, (a, b) in enumerate(zip(mat, got)):
        assert_port_same(a, b, f"point {got.points[i]}")


def test_stream_threshold_routes(monkeypatch):
    tr = port_trace(jax_trace())
    cfg = MemSimConfig(**SMALL)
    monkeypatch.setenv("MEMSIM_STREAM_THRESHOLD", "4")
    t_auto = {}
    auto = sweep_grid(cfg, tr, GRID4, CYCLES, chunk_lanes=3,
                      timings=t_auto, device="cpu")
    assert t_auto["streamed"] is True and t_auto["chunks"] == 2
    monkeypatch.setenv("MEMSIM_STREAM_THRESHOLD", "100")
    t_mat = {}
    mat = sweep_grid(cfg, tr, GRID4, CYCLES, timings=t_mat, device="cpu")
    assert "streamed" not in t_mat and t_mat["launches"] == 1
    for i, (a, b) in enumerate(zip(mat, auto)):
        assert_port_same(a, b, f"lane {i}")


# --------------------------------------------------------------------------
# the chunk plan and the digests against the reference's

SHAPES = [  # (config kwargs, n_max, s_max)
    ({}, 64, 1),
    (SMALL, 10_528, 1),
    (dict(tiers=2, cxl_channels=1), 100, 3),
    (dict(banks_per_group=16, queue_size=32), 257, 2),
]


@pytest.mark.parametrize("kw,n_max,s_max", SHAPES,
                         ids=["table1", "small-conv2d", "tiers2-s3",
                              "64banks-s2"])
def test_footprint_and_chunk_lanes_match_reference(kw, n_max, s_max):
    lane_b = sweep_stream.lane_footprint_bytes(
        MemSimConfig(**kw).topology(), n_max, s_max)
    assert lane_b == jax_stream.lane_footprint_bytes(
        JaxConfig(**kw).topology(), n_max, s_max)
    for args in ((None, None, 5), (None, None, 10_000), (7, None, 1000),
                 (7, None, 3), (None, 10 * 2 * lane_b, 1000),
                 (None, lane_b, 1000), (None, 10 ** 12, 100_000),
                 (None, 10 ** 12, 50)):
        a = (args[0], args[1], lane_b, args[2])
        assert sweep_stream._resolve_chunk_lanes(*a) == \
            jax_stream._resolve_chunk_lanes(*a), args
    for bad in ((0, None), (None, lane_b - 1), (None, 1)):
        with pytest.raises(ValueError) as ref:
            jax_stream._resolve_chunk_lanes(*bad, lane_b, 1000)
        with pytest.raises(ValueError) as got:
            sweep_stream._resolve_chunk_lanes(*bad, lane_b, 1000)
        assert str(got.value) == str(ref.value)


def test_fingerprint_and_chunk_digest_match_reference():
    """Equal to the reference's on fused configs, and moved by every input
    the reference test moves it with (plus a schedule and a tier)."""
    def inputs(pkg_cfg, eng, n=10, cfg_kw=None, sched=None, **kw):
        cfg = pkg_cfg(fsm_backend="fused", **SMALL, **(cfg_kw or {}))
        sc = eng._sched_i32(eng.lane_schedule(cfg, sched))
        tr = jax_trace(n) if eng is jax_engine else port_trace(jax_trace(n))
        args = dict(lane_cfgs=[cfg], scheds=[sc], trace_list=[tr], qs=[8],
                    rs=[8], num_cycles=1000, cap=8, rcap=8, cycle_skip=True,
                    chunk_lanes=2)
        args.update(kw)
        return args

    dvfs = [(0, {}), (300, {"tCL": 18, "tRP": 16})]
    variants = [{}, dict(num_cycles=1001), dict(chunk_lanes=3),
                dict(qs=[4]), dict(cfg_kw={"tCL": 15}), dict(n=11),
                dict(sched=dvfs), dict(cycle_skip=False),
                dict(cfg_kw={"tiers": 2, "cxl_channels": 1})]
    seen = set()
    for v in variants:
        got = sweep_stream.sweep_fingerprint(
            **inputs(MemSimConfig, engine, **v))
        want = jax_stream.sweep_fingerprint(
            **inputs(JaxConfig, jax_engine, **v))
        assert got == want, v
        seen.add(got)
        for ci, lanes in ((0, [0, 1]), (3, [7])):
            assert sweep_stream._chunk_digest(got, ci, lanes) == \
                jax_stream._chunk_digest(got, ci, lanes)
    assert len(seen) == len(variants)  # every input moves it


# --------------------------------------------------------------------------
# restore, refusal, resume=False, a corrupt chunk


def test_full_restore_refusal_and_resume_false(grid4_ckpt, tmp_path):
    tr, first, src = grid4_ckpt
    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    cfg = MemSimConfig(**SMALL)
    tm = {}
    again = sweep_grid(cfg, tr, GRID4, CYCLES, stream=True, chunk_lanes=2,
                       checkpoint_dir=d, timings=tm, device="cpu")
    assert tm["chunks_resumed"] == tm["chunks"] == 2
    assert tm["run_s"] == 0.0 and tm["compiles"] == 0
    assert tm["launches"] == 0 and tm["per_chunk"] == []
    for i, (a, b) in enumerate(zip(first, again)):
        assert_port_same(a, b, f"restored lane {i}")
    # any bit-relevant change refuses, with the reference's text (the
    # reference refuses the port's manifest before it compiles anything)
    jcfg = JaxConfig(fsm_backend="fused", **SMALL)
    for cycles, chunk, grid in ((CYCLES + 1, 2, GRID4), (CYCLES, 3, GRID4),
                                (CYCLES, 2, dict(GRID4, tCL=[14, 20]))):
        with pytest.raises(ValueError, match="different sweep") as got:
            sweep_grid(cfg, tr, grid, cycles, stream=True,
                       chunk_lanes=chunk, checkpoint_dir=d, device="cpu")
        with pytest.raises(ValueError) as ref:
            jax_sweep_grid(jcfg, jax_trace(), grid, cycles, stream=True,
                           chunk_lanes=chunk, checkpoint_dir=d)
        assert str(got.value) == str(ref.value)
    # ...unless resume=False, which clears and starts over
    tm2 = {}
    redo = sweep_grid(cfg, tr, GRID4, CYCLES, stream=True, chunk_lanes=2,
                      checkpoint_dir=d, resume=False, timings=tm2,
                      device="cpu")
    assert tm2["chunks_resumed"] == 0 and tm2["launches"] == 2
    for i, (a, b) in enumerate(zip(first, redo)):
        assert_port_same(a, b, f"resume=False lane {i}")


def test_corrupt_chunk_is_recomputed(grid4_ckpt, tmp_path):
    tr, first, src = grid4_ckpt
    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    with open(SweepCheckpoint(d)._chunk_path(1), "wb") as f:
        f.write(b"not an npz")
    tm = {}
    again = sweep_grid(MemSimConfig(**SMALL), tr, GRID4, CYCLES,
                       stream=True, chunk_lanes=2, checkpoint_dir=d,
                       timings=tm, device="cpu")
    assert tm["chunks_resumed"] == 1 and tm["launches"] == 1
    assert [c["chunk"] for c in tm["per_chunk"]] == [1]
    for i, (a, b) in enumerate(zip(first, again)):
        assert_port_same(a, b, f"recomputed lane {i}")


# --------------------------------------------------------------------------
# the stores' files cross between the packages


def test_sweep_checkpoint_roundtrip_and_crosses_packages(tmp_path):
    ck = SweepCheckpoint(str(tmp_path / "s"))
    assert ck.read_manifest() is None
    ck.write_manifest({"fingerprint": "abc", "n_chunks": 2})
    assert ck.read_manifest()["fingerprint"] == "abc"
    arrays = {"t_complete": np.arange(6, dtype=np.int32).reshape(2, 3),
              "c_cmd_counts": np.ones((2, 8), np.int32)}
    meta = {"digest": "d0", "lanes": [0, 1], "counters_keys": ["cmd_counts"]}
    ck.save_chunk(0, arrays, meta)
    assert ck.done_chunks() == [0]
    loaded, m = ck.load_chunk(0)
    assert m == meta and sorted(loaded) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])
    assert ck.load_chunk(1) is None
    # the same manifest is the same bytes from either package, and each
    # package reads the other's chunk
    man = {"version": 1, "fingerprint": "f" * 64, "chunks": [
        {"topology": 0, "lanes": [0, 1], "digest": "x"}]}
    jck = JaxSweepCheckpoint(str(tmp_path / "j"))
    jck.write_manifest(man)
    ck.write_manifest(man)
    assert (Path(jck.dir) / "manifest.json").read_bytes() == \
        (Path(ck.dir) / "manifest.json").read_bytes()
    assert jck.read_manifest() == man
    jck.save_chunk(3, arrays, meta)
    shutil.copy(jck._chunk_path(3), ck._chunk_path(3))
    loaded, m = ck.load_chunk(3)
    assert m == meta
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])
    shutil.copy(ck._chunk_path(0), jck._chunk_path(0))
    loaded, m = jck.load_chunk(0)
    assert m == meta
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])
    assert ck.done_chunks() == [0, 3]
    ck.clear()
    assert ck.read_manifest() is None and ck.done_chunks() == []


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "blocks": [{"b": torch.arange(5, dtype=torch.int32),
                        "a": torch.randn(2, generator=g).bfloat16()},
                       (torch.zeros(2, 2, dtype=torch.float64), None)],
            "emb": torch.randn(6, generator=g)}


def _assert_trees_same(a, b):
    from repro_torch.checkpoint.store import _flatten

    la, sa = _flatten(a)
    lb, sb = _flatten(b)
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_checkpoint_store_roundtrip_async_and_shape_mismatch(tmp_path):
    params, opt = _torch_tree(), {"m": [torch.ones(3)], "count": torch.tensor(7)}
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() is None
    store.save(3, params, opt, extra={"lr": 0.1})
    assert store.latest_step() == 3
    p2, o2, step, extra = store.restore(params, opt)
    assert step == 3 and extra == {"lr": 0.1}
    _assert_trees_same(params, p2)
    _assert_trees_same(opt, o2)
    # async saves commit atomically; the previous one stays restorable
    store.save_async(4, params, opt)
    store.wait()
    assert store.latest_step() == 4
    bumped = {"m": [torch.full((3,), 2.0)], "count": torch.tensor(8)}
    store.save_async(5, params, bumped)
    store.wait()
    assert store.latest_step() == 5
    _, o4, s4, _ = store.restore(params, opt, step=4)
    assert s4 == 4
    _assert_trees_same(opt, o4)
    _, o5, _, _ = store.restore(params, opt)
    _assert_trees_same(bumped, o5)
    other = dict(params, w=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="checkpoint shape"):
        store.restore(other, opt)


def test_checkpoint_store_files_cross_packages(tmp_path):
    """The reference's store, written from numpy trees, restores in the
    port onto torch templates, and the reverse; the npz keys agree."""
    params, opt = _torch_tree(), {"m": [torch.ones(3)]}
    params["blocks"][0]["a"] = params["blocks"][0]["a"].float()  # numpy

    def np_tree(x):
        if isinstance(x, dict):
            return {k: np_tree(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(np_tree(v) for v in x)
        return None if x is None else x.numpy()

    JaxCheckpointStore(str(tmp_path / "j")).save(
        2, np_tree(params), np_tree(opt))
    p2, o2, step, _ = CheckpointStore(str(tmp_path / "j")).restore(
        params, opt)
    assert step == 2
    _assert_trees_same(params, p2)
    _assert_trees_same(opt, o2)
    CheckpointStore(str(tmp_path / "p")).save(2, params, opt)
    jp, jo, _, _ = JaxCheckpointStore(str(tmp_path / "p")).restore(
        np_tree(params), np_tree(opt))
    _assert_trees_same(params, jax_to_torch(jp))
    for d in ("j", "p"):
        assert (tmp_path / d / "LATEST").read_text() == "step_000000002"
    with np.load(tmp_path / "j" / "step_000000002" / "shard_h000.npz") as a, \
            np.load(tmp_path / "p" / "step_000000002" / "shard_h000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def jax_to_torch(tree):
    if isinstance(tree, dict):
        return {k: jax_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


# --------------------------------------------------------------------------
# SIGKILL mid-sweep, then resume: both port backends on the CPU

_KILL_CHILD = textwrap.dedent("""
    import hashlib, json, os, signal, sys
    import numpy as np
    import torch
    from repro_torch.core import MemSimConfig, sweep_grid
    from repro_torch.core import sweep_stream
    from repro_torch.traces import trace_example

    mode, backend, ckdir = sys.argv[1], sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    tr = trace_example(n=8, gap=5)
    cfg = MemSimConfig(queue_size=8, mem_words=1 << 12,
                       fsm_backend=backend)
    if mode == "kill":
        def _hook(ci):
            if ci >= 1:   # chunk 0 committed; die before committing 1
                os.kill(os.getpid(), signal.SIGKILL)
        sweep_stream._pre_commit_hook = _hook
    timings = {}
    res = sweep_grid(cfg, tr, {"tCL": [14, 18], "queue_size": [4, 8]},
                     num_cycles=300, stream=True, chunk_lanes=2,
                     checkpoint_dir=ckdir, timings=timings, device="cpu")
    h = hashlib.sha256()
    for r in res:
        for f in ("t_admit", "t_dispatch", "t_start", "t_complete",
                  "rdata"):
            h.update(np.ascontiguousarray(
                np.asarray(getattr(r, f), np.int32)).tobytes())
        for k in sorted(r.counters):
            h.update(np.ascontiguousarray(
                np.asarray(r.counters[k], np.int64)).tobytes())
        h.update(np.int64(r.blocked_arrival).tobytes())
        h.update(np.int64(r.blocked_dispatch).tobytes())
    print("RESULT " + json.dumps(
        {"digest": h.hexdigest(),
         "chunks_resumed": timings["chunks_resumed"],
         "chunks": timings["chunks"], "launches": timings["launches"]}))
""")


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT / "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.pop("MEMSIM_EXEC_CACHE_DIR", None)
    return env


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_sigkill_mid_sweep_then_resume_bit_identical(backend, tmp_path):
    from repro_torch.traces import trace_example

    ckdir = str(tmp_path / "ck")
    kill = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, "kill", backend, ckdir],
        env=_child_env(), capture_output=True, text=True, cwd=ROOT)
    assert kill.returncode == -signal.SIGKILL, (
        f"expected SIGKILL death, rc={kill.returncode}\n"
        f"{kill.stderr[-2000:]}")
    assert SweepCheckpoint(ckdir).done_chunks() == [0]
    resume = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, "resume", backend, ckdir],
        env=_child_env(), capture_output=True, text=True, cwd=ROOT)
    assert resume.returncode == 0, resume.stderr[-4000:]
    out = json.loads([ln for ln in resume.stdout.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert out["chunks"] == 2 and out["chunks_resumed"] == 1
    assert out["launches"] == (1 if backend == "fused" else 0)
    # uninterrupted, in this process
    cfg = MemSimConfig(queue_size=8, mem_words=1 << 12, fsm_backend=backend)
    res = sweep_grid(cfg, trace_example(n=8, gap=5), GRID4, 300,
                     stream=True, chunk_lanes=2, device="cpu")
    assert out["digest"] == digest(res), \
        "killed-then-resumed sweep is not bit-identical"


# --------------------------------------------------------------------------
# the persistent kernel cache


def test_exec_cache_disabled_without_env(monkeypatch):
    monkeypatch.delenv("MEMSIM_EXEC_CACHE_DIR", raising=False)
    assert exec_cache.cache_dir() is None
    assert exec_cache.stats()["enabled"] is False
    assert exec_cache.clear() == 0
    assert build.build_dir() == build.BUILD_ROOT / build.source_hash()
    assert exec_cache.ENGINE_ABI_VERSION == jax_exec_cache.ENGINE_ABI_VERSION
    stats = aot_cache_stats()
    assert set(stats) == {"memory", "disk"}
    assert {"hits", "misses", "entries"} <= set(stats["memory"])
    assert {"hits", "misses", "writes", "errors", "load_s",
            "enabled"} <= set(stats["disk"])


def test_exec_cache_key_stability(monkeypatch, tmp_path):
    k1 = exec_cache.make_key("kernels")
    assert k1 == exec_cache.make_key("kernels")
    assert k1 != exec_cache.make_key("other")
    assert k1 != exec_cache.make_key("kernels", ("topo", 1))
    assert k1 != exec_cache.make_key("kernels", (), ((4, 8), "int32"))
    # the disabled() guard wins over the variable
    monkeypatch.setenv("MEMSIM_EXEC_CACHE_DIR", str(tmp_path))
    assert exec_cache.cache_dir() == str(tmp_path)
    assert build.build_dir() == tmp_path / k1
    with exec_cache.disabled():
        assert exec_cache.cache_dir() is None
        assert build.build_dir() == build.BUILD_ROOT / build.source_hash()
    assert exec_cache.cache_dir() == str(tmp_path)


def test_exec_cache_corrupt_library_is_deleted_not_served(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("MEMSIM_EXEC_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    # no nvcc anywhere: a rebuild raises
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    d = build.build_dir()
    d.mkdir(parents=True)
    bad = d / "libfused.so"
    bad.write_bytes(b"\x7fELF not a library")
    before = exec_cache.stats()
    assert before["enabled"] and before["entries"] == 1
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    after = exec_cache.stats()
    assert after["errors"] == before["errors"] + 1
    assert after["hits"] == before["hits"]
    assert after["misses"] == before["misses"] + len(build._ENTRY_POINTS)
    assert not bad.exists() and after["entries"] == 0
    assert build._libs == {}
    (d / "libfused.so").write_bytes(b"x")
    assert exec_cache.clear() == 1 and not d.exists()
