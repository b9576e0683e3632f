"""The LLM stack of the PyTorch port against the reference package.

Layers on random inputs; GQA attention (full sequence and one-token decode
over both cache forms) with the reference's weights carried across; and
whole tiny models (qwen3-14b with qk-norm, qwen2-72b with QKV bias,
minicpm-2b with a tied head, starcoder2-7b, qwen3-14b with the int8 KV
cache, llava-next-34b through embeds): forward, prefill logits and caches,
and decode steps. The reference's norm scales and biases are perturbed
before they are carried across, so that they are not trivially ones and
zeros. The reference runs its default (jnp) attention path, which is the
one its LM runs.

Tolerances: float32 layers and attention 1e-5; logits 2e-4, as the
reference's own decode test (tests/test_models.py); bfloat16 2e-2; int8
cache values within one step of the rounding.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch.steps import make_prefill as jax_make_prefill  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    lm_caches_to_numpy,
    lm_params_from_numpy,
)
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
DENSE = ["qwen3-14b", "qwen2-72b", "minicpm-2b", "starcoder2-7b"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed):
    """The tree with norm scales 1 + N(0, 0.1) and biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key = getattr(path[-1], "key", None)
        if key == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("bq", "bk", "bv"):
            return (0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(bump, np_tree(tree))


def to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max(initial=0) <= 1, path
        elif w.dtype == np.float16:
            np.testing.assert_allclose(g, w, rtol=2e-3, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, err_msg=str(path), **tol)


# ------------------------------------------------------------------ layers --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)

    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(as_np(got), as_np(want).astype(np.float32),
                               **tol)

    xr = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(2, 1, 7)).astype(np.int32)
    got = tlayers.apply_rope(torch.from_numpy(xr).to(tdt),
                             torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(xr, jdt), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(as_np(got), as_np(want).astype(np.float32),
                               **tol)

    ffn = np_tree(jlayers.init_swiglu(jax.random.PRNGKey(1), 64, 128))
    got = tlayers.swiglu(to_torch(ffn, tdt), tx)
    want = jlayers.swiglu(jax.tree.map(lambda a: jnp.asarray(a, jdt), ffn),
                          jx)
    np.testing.assert_allclose(as_np(got), as_np(want).astype(np.float32),
                               **tol)

    ln = {"scale": scale, "bias": (0.1 * rng.standard_normal(64)).astype(
        np.float32)}
    got = tlayers.layernorm(to_torch(ln), tx, 1e-5)
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, ln), jx, 1e-5)
    np.testing.assert_allclose(as_np(got), as_np(want).astype(np.float32),
                               **tol)

    table = np_tree(jlayers.init_embedding(jax.random.PRNGKey(2), 50, 64))
    toks = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    got = tlayers.embed(to_torch(table), torch.from_numpy(toks), tdt)
    want = jlayers.embed(table, jnp.asarray(toks), jdt)
    np.testing.assert_array_equal(as_np(got),
                                  as_np(want).astype(np.float32))


# --------------------------------------------------------------- attention --

ATTN = dict(n_heads=4, n_kv_heads=2, d_head=16, rope_theta=1e6, eps=1e-6)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(True, False), (False, True)])
def test_attn_full_matches_reference(qk_norm, qkv_bias):
    p = perturbed(jattn.init_attention(jax.random.PRNGKey(0), 64, 4, 2, 16,
                                       qk_norm, qkv_bias), 0)
    x = np.random.default_rng(1).standard_normal((2, 12, 64)).astype(
        np.float32)
    want, (wk, wv) = jattn.attn_full(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), qk_norm=qk_norm, **ATTN)
    tp = to_torch(p)
    got, (gk, gv) = tattn.attn_full(tp, torch.from_numpy(x),
                                    qk_norm=qk_norm, **ATTN)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(as_np(g), as_np(w), **F32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_attn_decode_matches_reference(quant):
    """Both cache forms, with one slot writing past the end of the cache
    (the write is clamped to the last slot, as dynamic_update_slice
    clamps it)."""
    b, s = 3, 16
    p = perturbed(jattn.init_attention(jax.random.PRNGKey(3), 64, 4, 2, 16,
                                       True, True), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    pos = np.array([0, 9, s + 2], np.int32)
    shape = (b, 2, s, 16)
    if quant:
        cache = {
            "k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": (0.01 * rng.random(shape[:3] + (1,))).astype(
                np.float16),
            "v_scale": (0.01 * rng.random(shape[:3] + (1,))).astype(
                np.float16),
        }
    else:
        cache = {"k": rng.standard_normal(shape).astype(np.float32),
                 "v": rng.standard_normal(shape).astype(np.float32)}
    want, wc = jattn.attn_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), qk_norm=True, pos=jnp.asarray(pos),
        **ATTN)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gc = tattn.attn_decode(to_torch(p), torch.from_numpy(x), tc,
                                qk_norm=True, pos=torch.from_numpy(pos),
                                **ATTN)
    assert gc is tc  # updated in place
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)
    assert_trees_close({k: as_np(v) for k, v in gc.items()}, np_tree(wc),
                       **F32)
    # the clamped write landed in the last slot of slot 2's cache
    assert not np.array_equal(as_np(gc["k"])[2, :, s - 1],
                              cache["k"][2, :, s - 1])
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    plain, _ = tattn.attn_decode(to_torch(p), torch.from_numpy(x), tc,
                                 qk_norm=True, pos=torch.from_numpy(pos),
                                 backend="plain", **ATTN)
    assert torch.equal(plain, got)
    with pytest.raises(ValueError, match="backend"):
        tattn.attn_decode(to_torch(p), torch.from_numpy(x), tc,
                          pos=torch.from_numpy(pos), backend="pallas", **ATTN)


# ------------------------------------------------------------------ models --

def tiny_pair(arch, **changes):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].tiny(), **changes)
    tcfg = dataclasses.replace(get_config(arch).tiny(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("arch,quant", [(a, False) for a in DENSE]
                         + [("qwen3-14b", True)])
def test_model_matches_reference(arch, quant):
    """forward, make_prefill (last-token logits and caches) and six decode
    steps with per-slot positions, against the reference, on two layers
    (two groups of the reference's stacked body)."""
    jcfg, tcfg = tiny_pair(arch, kv_quant=quant, n_layers=2)
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tcfg, tree)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)

    wx, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks))
    gx, _, _ = tlm.forward(tcfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(gx), as_np(wx), **F32)

    wl, wc = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(toks)})
    gl, gc = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        params, {"tokens": toks})
    assert gl.dtype == torch.float32 and gl.shape == (2, tcfg.vocab)
    np.testing.assert_allclose(as_np(gl), as_np(wl), **LOGITS)
    assert_trees_close(lm_caches_to_numpy(tcfg, gc), np_tree(wc), **F32)

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
    assert_trees_close(lm_caches_to_numpy(tcfg, tc), np_tree(jc), **F32)


def test_embeds_path_matches_reference():
    """llava-next-34b's backbone fed precomputed embeddings."""
    jcfg, tcfg = tiny_pair("llava-next-34b")
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(2)), 2)
    emb = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(
        np.float32)
    wl, _ = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jax.tree.map(jnp.asarray, tree), {"embeds": jnp.asarray(emb)})
    gl, _ = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        lm_params_from_numpy(tcfg, tree), {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(as_np(gl), as_np(wl), **LOGITS)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch):
    """The port's own KV-cache decode reproduces its full-forward logits
    (tests/test_models.py's invariant, on the port's random init)."""
    cfg = ARCHS[arch].tiny()
    assert tregistry.decode_entry(cfg) is tlm.decode_step
    params = tregistry.init_params(cfg, 0, device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    x, _, _ = tlm.forward(cfg, params, toks)
    full = tlm.logits_of(cfg, params, x)
    step = make_decode_step(cfg, dtype=torch.float32, device="cpu")
    caches = tregistry.init_caches(cfg, b, 16, device="cpu")
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.int32)
        _, logits, caches = step(params, caches, toks[:, t], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **LOGITS)


def test_init_params_shapes_and_dtypes():
    cfg = ARCHS["qwen3-14b"].tiny()
    params = tregistry.init_params(cfg, 0, device="cpu",
                                   dtype=torch.bfloat16)
    want = jax.eval_shape(
        lambda: jregistry.init_params(cfg, jax.random.PRNGKey(0)))
    layer = params["layers"][0]
    assert len(params["layers"]) == cfg.n_layers
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert layer["mixer"]["q_norm"]["scale"].dtype == torch.float32
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["body"]["0"]):
        node = layer
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape[1:], path
    w = layer["ffn"]["w_gate"].float()
    assert w.abs().max() <= 0.0401 and 0.015 < w.std() < 0.02
    again = tregistry.init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(again["layers"][0]["mixer"]["wq"], layer["mixer"]["wq"])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_unported_families_raise(arch):
    """Every family builds, makes caches and decodes a step on the CPU
    (phi3.5-moe, jamba, deepseek-v3's MLA, xlstm's mLSTM/sLSTM and
    seamless's encoder-decoder), and every one trains: a step of
    ``make_train_step`` on a tiny synthetic batch gives a finite loss and
    a non-zero gradient norm, and moves the parameters."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves as _leaves

    cfg = ARCHS[arch].tiny()
    train = tregistry.init_params(cfg, 0, device="cpu")
    before = [t.clone() for t in _leaves(train)]
    train, _, m = make_train_step(cfg, dtype=torch.float32, device="cpu")(
        train, adamw_init(train), SyntheticLM(cfg, 2, 8).batch_at(0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     _leaves(train)))
    params = tregistry.init_params(cfg, 0, device="cpu")
    caches = tregistry.init_caches(cfg, 2, 8, device="cpu")
    tok = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    if cfg.is_encdec:
        assert tregistry.decode_entry(cfg) is tencdec.decode_step
        assert len(params["dec"]) == len(caches) == cfg.n_layers
        enc, cross = make_prefill(cfg, dtype=torch.float32, device="cpu")(
            params, torch.zeros((2, 5, cfg.d_model)))
        nxt, logits, _ = make_decode_step(cfg, dtype=torch.float32,
                                          device="cpu")(params, caches,
                                                        cross, tok, pos)
    else:
        assert tregistry.decode_entry(cfg) is tlm.decode_step
        assert len(params["layers"]) == len(caches)
        nxt, logits, _ = make_decode_step(cfg, dtype=torch.float32,
                                          device="cpu")(params, caches, tok,
                                                        pos)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(
        logits).all())
    assert nxt.dtype == torch.int32 and nxt.shape == (2,)


@pytest.mark.parametrize("entry", ["init_params", "init_caches",
                                   "make_prefill", "make_decode_step",
                                   "serve_main"])
def test_entry_points_raise_without_a_card(entry):
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg = ARCHS["qwen3-14b"].tiny()
    call = {"init_params": lambda: tregistry.init_params(cfg),
            "init_caches": lambda: tregistry.init_caches(cfg, 1, 8),
            "make_prefill": lambda: make_prefill(cfg),
            "make_decode_step": lambda: make_decode_step(cfg),
            "serve_main": lambda: serve.main(["--arch", "qwen3-14b",
                                              "--tiny"])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_new_families_need_a_card_or_the_cpu(arch):
    """The entry points of the MLA, xLSTM and encoder-decoder families run
    on the card by default and raise without one (the CPU needs
    ``device="cpu"``), as every other family's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    cfg = ARCHS[arch].tiny()
    for call in (lambda: tregistry.init_params(cfg),
                 lambda: tregistry.init_caches(cfg, 1, 8),
                 lambda: make_prefill(cfg),
                 lambda: make_decode_step(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
