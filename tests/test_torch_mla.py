"""MLA (DeepSeek-V3's multi-head latent attention) and tiny deepseek-v3 of
the PyTorch port against the reference package: ``mla_full``'s output
and latent cache, ``mla_decode`` steps against the latent cache (with
per-slot positions and a clamped write past the end), tiny deepseek's
forward, prefill logits and caches and decode steps (MLA + dense prefix +
MoE), and its ``serve_loop`` (tokens, join steps and step count). The
reference's weights cross through the parameter bridge, its norm scales
perturbed so that they are not trivially ones.

Tolerances: float32 1e-5 for the layer, 2e-4 for logits (as
tests/test_torch_models.py); serve tokens exact.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa: E402
from repro.launch.steps import make_prefill as jax_make_prefill  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    lm_caches_from_numpy,
    lm_caches_to_numpy,
    lm_params_from_numpy,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill,
)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)
DEEPSEEK = "deepseek-v3-671b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed):
    """The tree with norm scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        if getattr(path[-1], "key", None) == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(bump, np_tree(tree))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32)


def tiny_pair(**changes):
    jcfg = dataclasses.replace(JAX_ARCHS[DEEPSEEK].tiny(), **changes)
    tcfg = dataclasses.replace(get_config(DEEPSEEK).tiny(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def assert_tree_close(got, want, tol):
    for path, w in jax.tree_util.tree_leaves_with_path(np_tree(want)):
        g = got
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(as_np(g), w, err_msg=str(path), **tol)


@pytest.fixture(scope="module")
def mla_layer():
    jcfg, tcfg = tiny_pair()
    tree = perturbed(jmla.init_mla(jax.random.PRNGKey(3), jcfg), 3)
    return jcfg, tcfg, tree


def test_mla_full_matches_reference(mla_layer):
    """Output and latent cache over 2 x 24 tokens, at default and at
    shifted positions."""
    jcfg, tcfg, tree = mla_layer
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    for positions in (None, np.arange(24, dtype=np.int32)[None] + [[0], [5]]):
        wo, wc = jmla.mla_full(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), jcfg,
                               None if positions is None
                               else jnp.asarray(positions))
        go, gc = tmla.mla_full(to_torch(tree), torch.from_numpy(x), tcfg,
                               None if positions is None
                               else torch.from_numpy(positions))
        np.testing.assert_allclose(as_np(go), np.asarray(wo), **F32)
        assert set(gc) == {"ckv", "k_rope"}
        assert_tree_close(gc, wc, F32)


def test_mla_decode_matches_reference(mla_layer):
    """Six absorbed decode steps against a latent cache of 8 slots, slot 1
    ahead of slot 0 and written past the end on the last steps (clamped to
    the last slot, as dynamic_update_slice); the port writes in place."""
    jcfg, tcfg, tree = mla_layer
    rng = np.random.default_rng(5)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = to_torch(tree)
    jc = {"ckv": jnp.zeros((2, 8, jcfg.mla_kv_lora)),
          "k_rope": jnp.zeros((2, 8, jcfg.mla_rope_dim))}
    tc = {"ckv": torch.zeros((2, 8, tcfg.mla_kv_lora)),
          "k_rope": torch.zeros((2, 8, tcfg.mla_rope_dim))}
    ckv = tc["ckv"]
    for t in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pos = np.array([t, t + 4], np.int32)
        wo, jc = jmla.mla_decode(jp, jnp.asarray(x), jc, jcfg,
                                 jnp.asarray(pos))
        go, tc = tmla.mla_decode(tp, torch.from_numpy(x), tc, tcfg,
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(as_np(go), np.asarray(wo), **F32)
        assert_tree_close(tc, jc, F32)
    assert tc["ckv"] is ckv


@pytest.fixture(scope="module")
def deepseek_tiny():
    jcfg, tcfg = tiny_pair()
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    return jcfg, tcfg, tree


def test_deepseek_matches_reference(deepseek_tiny):
    """forward (hidden and MoE aux), make_prefill (last-token logits, every
    layer's latent cache) and six decode steps with per-slot positions,
    logits and greedy tokens, then every cache leaf."""
    jcfg, tcfg, tree = deepseek_tiny
    assert [m for m, _ in tlm.layer_kinds(tcfg)] == ["attn", "attn"]
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tcfg, tree)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, size=(2, 12)).astype(np.int32)

    wx, _, waux = jlm.forward(jcfg, jp, jnp.asarray(toks))
    gx, _, gaux = tlm.forward(tcfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(gx), as_np(wx), **F32)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)

    wl, wc = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(toks)})
    gl, gc = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        params, {"tokens": toks})
    np.testing.assert_allclose(as_np(gl), as_np(wl), **LOGITS)
    assert_tree_close(lm_caches_to_numpy(tcfg, gc), wc, F32)

    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    tstep = make_decode_step(tcfg, dtype=torch.float32, device="cpu")
    jc = jlm.init_caches(jcfg, 2, 16)
    tc = tregistry.init_caches(tcfg, 2, 16, device="cpu")
    for t in range(6):
        pos = np.array([t, t + 4], np.int32)
        wl, jc = jstep(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        nxt, gl, tc = tstep(params, tc, toks[:, t], pos)
        np.testing.assert_allclose(as_np(gl), as_np(wl), **LOGITS)
        np.testing.assert_array_equal(as_np(nxt),
                                      np.argmax(np.asarray(wl), -1))
    assert_tree_close(lm_caches_to_numpy(tcfg, tc), jc, F32)


def test_deepseek_caches_cross_the_bridge(deepseek_tiny):
    """The reference's latent caches round-trip through the cache bridge,
    in the shapes and dtypes init_caches gives."""
    jcfg, tcfg, _ = deepseek_tiny
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), np_tree(jlm.init_caches(jcfg, 2, 8)))
    caches = lm_caches_from_numpy(tcfg, tree)
    fresh = tregistry.init_caches(tcfg, 2, 8, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in fresh] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in caches]
    assert_tree_close(lm_caches_to_numpy(tcfg, caches), tree,
                      dict(atol=0, rtol=0))


def test_deepseek_serve_loop_matches_reference(deepseek_tiny):
    """7 requests of mixed lengths through 3 slots: identical generated
    tokens, join steps and step count."""
    jcfg, tcfg, tree = deepseek_tiny
    batch, max_seq = 3, 48
    prompts, news = serve.make_requests(2, tcfg.vocab, 7, 10, 12)
    want = jserve.serve_loop(
        jax.jit(jax_decode(jcfg, dtype=jnp.float32)),
        jax.tree.map(jnp.asarray, tree), jlm.init_caches(jcfg, batch, max_seq),
        prompts, news, batch, max_seq=max_seq)
    got = serve.serve_loop(
        make_decode_step(tcfg, dtype=torch.float32, device="cpu"),
        lm_params_from_numpy(tcfg, tree),
        tregistry.init_caches(tcfg, batch, max_seq, device="cpu"),
        prompts, news, batch, max_seq=max_seq)
    assert got[2] == want[2]
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert sum(j > 0 for j in got[1]) == len(prompts) - batch


def test_serve_main_runs_deepseek_on_the_cpu(capsys):
    serve.main(["--arch", DEEPSEEK, "--tiny", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 reqs through 2 slots" in out and "on cpu" in out
