"""The port's sharding layer against the JAX reference.

``repro_torch.distributed.partition`` (the parameter and optimizer specs),
the sharding side of ``repro_torch.launch.specs`` (cache specs, the pod
expansion, the divisibility rule), ``repro_torch.distributed.shard``
(placements, ``named``, ``constrain``, ``round_robin_devices``),
``repro_torch.launch.mesh`` and ``optim.compression.compressed_psum``,
held against ``repro.distributed``, ``repro.launch`` and
``repro.optim.compression``. The reference's specs carry a leading
``None`` for its stacked layer axis; it is dropped here, where this
package keeps one tree a layer.

The 16 x 16 and 2 x 16 x 16 meshes stand on the ``fake`` process group
(512 ranks in one process) in a child process, so no process group leaks
into the test worker; ``compressed_psum`` runs on one gloo rank here and
on two gloo ranks in child processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import partition, shard  # noqa: E402
from repro_torch.distributed.shard import P  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.compression import compressed_psum  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(ARCHS)

# (config, cell) whose trees the mesh child and the reference both take
MESH_CASES = (("minicpm-2b", None), ("jamba-v0.1-52b", "decode_32k"),
              ("jamba-v0.1-52b", "long_500k"), ("xlstm-1.3b", "long_500k"),
              ("seamless-m4t-medium", "decode_32k"))


def norm(spec, drop=0):
    """A spec (a port ``P``, a reference ``PartitionSpec``) or a shape as
    a JSON string, its first ``drop`` entries dropped."""
    return json.dumps([list(e) if isinstance(e, (tuple, list)) else e
                       for e in list(spec)[drop:]])


def flat(tree, prefix="", is_leaf=lambda x: False):
    if is_leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}.", is_leaf))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}.", is_leaf))
        return out
    return {prefix[:-1]: tree}


def port_flat(spec_tree):
    return {k: norm(v) for k, v in
            flat(spec_tree, is_leaf=lambda x: isinstance(x, P)).items()}


# ---- what the child processes run (they import no JAX) ------------------------

RESOLVE_SPECS = (P("data", "model"), P(("data", "model"), None),
                 P(None, ("model",)), P("model", None, "data"), P(),
                 P(None, ("data", "model"), None), P("data"))


def _child_mesh():
    """Runs in a child process: the production meshes on the fake group,
    every case's specs resolved and sanitised on both, minicpm-2b's
    parameters distributed on ``meta`` on the 16 x 16 mesh, and the
    placements ``named`` and ``constrain`` give; prints one JSON line."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as mesh_lib

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    meshes = {"m2": mesh_lib.make_production_mesh(device_type="cpu"),
              "m3": mesh_lib.make_production_mesh(multi_pod=True,
                                                  device_type="cpu")}
    out = {"axes": {k: [norm(m.mesh_dim_names), norm(m.shape),
                        norm(mesh_lib.mesh_data_axes(m))]
                    for k, m in meshes.items()},
           "resolve": {k: [norm(specs._resolve(m, s)) for s in
                           RESOLVE_SPECS] for k, m in meshes.items()},
           "cases": {}, "local": {}}
    for name, shape in MESH_CASES:
        cfg = ARCHS[name]
        if shape is None:
            tree = specs.param_shapes(cfg)
            spec_tree = partition.param_specs(tree)
        else:
            tree = specs.batch_specs(cfg, shape)["caches"]
            spec_tree = specs.cache_specs(
                cfg, tree, specs.SHAPES[shape]["batch"] >= 16)
        rec = {}
        for k, m in meshes.items():
            named = specs.to_named(m, spec_tree, tree)
            rec[k] = {p: norm(n.spec) for p, n in flat(
                named, is_leaf=lambda x: isinstance(
                    x, shard.NamedSharding)).items()}
        out["cases"][f"{name}/{shape}"] = rec
    # minicpm-2b on the 16 x 16 mesh: each leaf's local shard
    cfg = ARCHS["minicpm-2b"]
    params = specs.param_shapes(cfg)
    named = specs.to_named(meshes["m2"], partition.param_specs(params),
                           params)
    leaves = flat(params)
    for p, n in flat(named, is_leaf=lambda x: isinstance(
            x, shard.NamedSharding)).items():
        d = distribute_tensor(leaves[p], n.mesh, list(n.placements))
        out["local"][p] = norm(d.to_local().shape)
    m2, m3 = meshes["m2"], meshes["m3"]
    out["named"] = {
        "m2 (data,model)": repr(shard.named(m2, ("data", "model"),
                                            None).placements),
        "m2 data,model": repr(shard.named(m2, "data", "model").placements),
    }
    with shard.use_mesh(m3, mesh_lib.mesh_data_axes(m3)):
        out["named"]["m3 data,model"] = repr(
            shard.named(m3, "data", "model").placements)
        out["named"]["m3 resolve"] = norm(shard.resolve("data", None,
                                                        "model"))
    x = torch.empty((64, 32), device="meta")
    with shard.use_mesh(m2):
        same = shard.constrain(x, "data", "model") is x
        d = distribute_tensor(x, m2, list(shard.named(
            m2, None, None).placements))
        c = shard.constrain(d, "data", "model")
        out["constrain"] = [same, isinstance(c, DTensor),
                            repr(c.placements), norm(c.to_local().shape)]
    out["constrain_outside"] = shard.constrain(d, "model") is d
    dist.destroy_process_group()
    print(json.dumps(out))


def _psum_input(rank):
    return np.random.default_rng(100 + rank).normal(
        0.0, 1.0 + rank, (257, 33)).astype(np.float32)


def _child_psum(rank, world, store, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    got = compressed_psum(torch.from_numpy(_psum_input(rank)))
    np.save(out, got.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":   # a child process: no JAX to import
    if sys.argv[1] == "mesh":
        _child_mesh()
    else:
        _child_psum(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5])
    sys.exit(0)

# ---- the tests (against the reference) -----------------------------------------

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.distributed import partition as ref_partition  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import compression as ref_compression  # noqa: E402


def is_pspec(x):
    return isinstance(x, PartitionSpec)


def ref_spec_layers(cfg, tree, stacked, is_leaf=is_pspec):
    """A reference spec tree (or a tree of shapes as tuples) in this
    package's layout, the stacked axis's entry dropped: ``stacked`` names
    the keys whose subtrees carry it (``body`` of an LM's tree,
    ``enc``/``dec`` of an encoder-decoder's)."""
    def drop(t):
        return jax.tree.map(lambda s: norm(s, 1), t, is_leaf=is_leaf)

    def keep(t):
        return jax.tree.map(norm, t, is_leaf=is_leaf)

    if cfg.is_encdec:
        out = {k: keep(v) for k, v in tree.items() if k not in stacked}
        for k, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
            if k in tree:
                out[k] = [drop(tree[k])] * n
        return out
    out = {k: keep(v) for k, v in tree.items()
           if k not in ("prefix", "body")}
    layers = [keep(t) for t in tree.get("prefix", [])]
    for _ in range(cfg.groups):
        for slot in range(len(cfg.period)):
            layers.append(drop(tree["body"][str(slot)]))
    out["layers"] = layers
    return out


def ref_flat(tree):
    return flat(tree)


# ---- parameter and optimizer specs --------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_param_and_opt_state_specs_match_the_reference(name):
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    params = specs.param_shapes(cfg)
    rparams = ref_specs.param_shapes(rcfg)
    got = port_flat(partition.param_specs(params))
    want = ref_flat(ref_spec_layers(
        rcfg, ref_partition.param_specs(rparams), ("enc", "dec")))
    assert got == want
    assert any(json.loads(s)[:1] == ["model"] and len(json.loads(s)) == 3
               for s in got.values()) == cfg.is_moe
    opt = partition.opt_state_specs(adamw_init(params))
    ropt = ref_partition.opt_state_specs(
        jax.eval_shape(lambda: ref_adamw_init(rparams)))
    assert norm(opt["count"]) == norm(ropt["count"]) == "[]"
    for k in ("m", "v"):
        assert port_flat(opt[k]) == ref_flat(ref_spec_layers(
            rcfg, ropt[k], ("enc", "dec"))) == want


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_the_reference(name):
    """Every decode cell's cache specs, batched (decode_32k) and unbatched
    (long_500k, where the config takes it)."""
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    cells = [s for s in ("decode_32k", "long_500k")
             if specs.shape_skips(cfg, s) is None]
    for shape in cells:
        batched = specs.SHAPES[shape]["batch"] >= 16
        caches = specs.batch_specs(cfg, shape)["caches"]
        rcaches = ref_specs.batch_specs(rcfg, shape)["caches"]
        got = port_flat(specs.cache_specs(cfg, caches, batched))
        rspecs = ref_specs.cache_specs(rcfg, rcaches, batched)
        if cfg.is_encdec:   # {k, v: [L, ...]} -> one {k, v} a layer
            want = ref_flat([{k: norm(s, 1) for k, s in rspecs.items()}]
                            * cfg.n_layers)
        else:
            want = ref_flat(ref_spec_layers(rcfg, rspecs, ("body",))
                            ["layers"])
        assert got == want, shape
        assert got


def test_batch_data_specs_match_the_reference():
    for name in ("minicpm-2b", "seamless-m4t-medium", "llava-next-34b"):
        for shape in ("train_4k", "prefill_32k"):
            got = specs._batch_data_specs(
                specs.batch_specs(ARCHS[name], shape))
            want = ref_specs._batch_data_specs(
                ref_specs.batch_specs(REF_ARCHS[name], shape))
            assert {k: norm(v) for k, v in got.items()} == \
                {k: norm(v) for k, v in want.items()}


# ---- the meshes (fake process group, in a child) -------------------------------

def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def mesh_child():
    r = subprocess.run([sys.executable, __file__, "mesh"], env=_child_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


ABSTRACT = {"m2": AbstractMesh((16, 16), ("data", "model")),
            "m3": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def test_production_meshes_have_the_reference_axes(mesh_child):
    assert mesh_child["axes"] == {
        "m2": [norm(("data", "model")), "[16, 16]", '["data"]'],
        "m3": [norm(("pod", "data", "model")), "[2, 16, 16]",
               norm(("pod", "data"))]}


def test_resolve_matches_the_reference(mesh_child):
    for k, m in ABSTRACT.items():
        want = [norm(ref_specs._resolve(m, PartitionSpec(*s)))
                for s in RESOLVE_SPECS]
        assert mesh_child["resolve"][k] == want, k


def _ref_case(name, shape):
    rcfg = REF_ARCHS[name]
    if shape is None:
        tree = ref_specs.param_shapes(rcfg)
        return tree, ref_partition.param_specs(tree), ("enc", "dec")
    tree = ref_specs.batch_specs(rcfg, shape)["caches"]
    return tree, ref_specs.cache_specs(
        rcfg, tree, ref_specs.SHAPES[shape]["batch"] >= 16), ("body",)


@pytest.mark.parametrize("name,shape", MESH_CASES)
def test_sanitized_specs_match_the_reference(mesh_child, name, shape):
    """``to_named(mesh, specs, shapes)``: the pod expansion, then each axis
    that does not divide its dimension dropped (minicpm-2b's vocab of
    122753 on a 16-way axis), leaf by leaf on both meshes."""
    rcfg = REF_ARCHS[name]
    tree, rspecs, stacked = _ref_case(name, shape)
    for k, m in ABSTRACT.items():
        sanitized = jax.tree.map(
            lambda s, leaf: ref_specs._sanitize(
                m, ref_specs._resolve(m, s), leaf.shape),
            rspecs, tree, is_leaf=is_pspec)
        if rcfg.is_encdec and shape is not None:
            want = ref_flat([{kk: norm(s, 1) for kk, s in
                             sanitized.items()}] * rcfg.n_layers)
        else:
            want = ref_spec_layers(rcfg, sanitized, stacked)
            want = ref_flat(want["layers"] if shape is not None else want)
        assert mesh_child["cases"][f"{name}/{shape}"][k] == want, k
    if name == "minicpm-2b":
        got = mesh_child["cases"]["minicpm-2b/None"]["m2"]
        assert got["embed.table"] == "[null, null]"   # 122753 % 16 != 0
        assert got["layers.0.mixer.wq"] == '["data", "model"]'


def test_minicpm_local_shards_match_the_reference(mesh_child):
    """minicpm-2b's parameters distributed on ``meta`` over the fake 16 x
    16 mesh: every leaf's local shard is the shard shape the reference's
    sanitised sharding gives."""
    rcfg = REF_ARCHS["minicpm-2b"]
    tree = ref_specs.param_shapes(rcfg)
    m = ABSTRACT["m2"]
    shards = jax.tree.map(
        lambda s, leaf: NamedSharding(m, ref_specs._sanitize(
            m, ref_specs._resolve(m, s), leaf.shape)).shard_shape(
                leaf.shape),
        ref_partition.param_specs(tree), tree, is_leaf=is_pspec)
    # the stacked axis is never sharded: drop it from the body's shapes
    want = ref_flat(ref_spec_layers(rcfg, shards, ("enc", "dec"),
                                    is_leaf=lambda x: isinstance(x, tuple)))
    got = mesh_child["local"]
    assert got == want
    assert got["layers.0.mixer.wq"] == norm((2304 // 16, 2304 // 16))


def test_named_and_constrain_give_dtensor_placements(mesh_child):
    assert mesh_child["named"] == {
        "m2 (data,model)": "(Shard(dim=0), Shard(dim=0))",
        "m2 data,model": "(Shard(dim=0), Shard(dim=1))",
        "m3 data,model": "(Shard(dim=0), Shard(dim=0), Shard(dim=1))",
        "m3 resolve": '[["pod", "data"], null, "model"]'}
    same, is_dtensor, placements, local = mesh_child["constrain"]
    assert same and is_dtensor
    assert placements == "(Shard(dim=0), Shard(dim=1))"
    assert local == "[4, 2]"
    assert mesh_child["constrain_outside"]


def test_placements_refuse_what_dtensor_cannot_hold():
    class Mesh:
        mesh_dim_names = ("data", "model")

    with pytest.raises(ValueError, match="mesh's order"):
        shard.placements(Mesh, P(("model", "data")))
    with pytest.raises(ValueError, match="shards two"):
        shard.placements(Mesh, P("data", "data"))
    assert repr(shard.placements(Mesh, P(None, "model"))) == \
        "(Replicate(), Shard(dim=1))"


def test_resolve_and_constrain_outside_a_mesh():
    assert shard.current_mesh() is None
    assert shard.resolve("data", None, ("data", "model")) == \
        P("data", None, ("data", "model"))
    x = torch.ones(3)
    assert shard.constrain(x, "data") is x
    with shard.use_mesh("mesh", ("pod", "data")):
        assert shard.current_mesh() == "mesh"
        assert shard.data_axes() == ("pod", "data")
        assert shard.resolve("data", "model") == P(("pod", "data"), "model")
    assert shard.current_mesh() is None and shard.data_axes() == ("data",)


def test_round_robin_devices(monkeypatch):
    assert shard.round_robin_devices(5, ["a", "b"]) == \
        ["a", "b", "a", "b", "a"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shard.round_robin_devices(8) == [torch.device("cuda", 0)] * 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no devices"):
        shard.round_robin_devices(2)


# ---- compressed_psum -------------------------------------------------------------

def test_compressed_psum_raises_without_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        compressed_psum(torch.ones(4))


def test_compressed_psum_on_one_rank_matches_the_reference():
    """One gloo rank against the reference's ``compressed_psum`` under
    ``shard_map`` on a one-device mesh, bit for bit."""
    import torch.distributed as dist

    x = _psum_input(0)
    mesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda a: ref_compression.compressed_psum(a, "data"), mesh=mesh,
        in_specs=PartitionSpec(), out_specs=PartitionSpec()))(
            jnp.asarray(x)))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = compressed_psum(torch.from_numpy(x)).numpy()
    finally:
        dist.destroy_process_group()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_compressed_psum_on_two_ranks_matches_the_formula(tmp_path):
    """Two gloo ranks in child processes against the numpy formula: the
    largest scale of the two, each rank's input requantised against it,
    the int32 sum dequantised."""
    procs = [subprocess.Popen(
        [sys.executable, __file__, "psum", str(r), "2",
         str(tmp_path / "store"), str(tmp_path / f"out{r}.npy")],
        env=_child_env()) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    xs = [_psum_input(r) for r in range(2)]
    scales = [(np.max(np.abs(x)) + np.float32(1e-12)) / np.float32(127.0)
              for x in xs]
    smax = np.float32(max(scales))
    q = sum(np.clip(np.round(x / smax), -127, 127).astype(np.int32)
            for x in xs)
    want = q.astype(np.float32) * smax
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want)

