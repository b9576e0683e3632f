"""The encoder-decoder backbone (tiny seamless-m4t-medium) of the PyTorch
port against the reference package: ``encode`` (bidirectional
self-attention over frame embeddings), ``precompute_cross_kv``, decode
steps with per-slot positions (self-attention over the cache, then
cross-attention over the whole source: one query row, K5's plain version
on the CPU), the enc-dec branches of ``make_prefill`` and
``make_decode_step``, the teacher-forced ``decode_train`` (cross-attention
over many rows through ``blocked_attention``), ``seq2seq_loss`` and its
gradients, two train steps against the reference's jitted step, the
training CLI on it, and the parameter and cache bridges, which round-trip
every leaf. The reference's norm scales are perturbed before they cross.

Tolerances: float32 1e-5 for hidden states and K/V, 2e-4 for logits and
the loss (as tests/test_torch_models.py); gradients 2e-4 x a leaf's max
|g| and train steps as tests/test_torch_train.py's; bridges exact.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa: E402
from repro.launch.steps import make_prefill as jax_make_prefill  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    encdec_caches_from_numpy,
    encdec_caches_to_numpy,
    encdec_params_from_numpy,
    encdec_params_to_numpy,
)
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill,
)
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)
SEAMLESS = "seamless-m4t-medium"


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


def stacked(pairs):
    """The port's per-layer (k, v) pairs as the reference's ([L, ...],
    [L, ...])."""
    return tuple(np.stack([as_np(p[i]) for p in pairs]) for i in (0, 1))


@pytest.fixture(scope="module")
def seamless_tiny():
    jcfg = JAX_ARCHS[SEAMLESS].tiny()
    tcfg = get_config(SEAMLESS).tiny()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    rng = np.random.default_rng(1)
    src = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, tree, src


def test_encode_and_cross_kv_match_reference(seamless_tiny):
    jcfg, tcfg, tree, src = seamless_tiny
    jp = jax.tree.map(jnp.asarray, tree)
    params = encdec_params_from_numpy(tcfg, tree)
    want = jencdec.encode(jcfg, jp, jnp.asarray(src))
    got = tencdec.encode(tcfg, params, torch.from_numpy(src))
    np.testing.assert_allclose(as_np(got), np.asarray(want), **F32)
    wk, wv = jencdec.precompute_cross_kv(jcfg, jp, want)
    cross = tencdec.precompute_cross_kv(tcfg, params, got)
    assert len(cross) == tcfg.n_layers
    assert all(k.is_contiguous() and v.is_contiguous() for k, v in cross)
    gk, gv = stacked(cross)
    np.testing.assert_allclose(gk, np.asarray(wk), **F32)
    np.testing.assert_allclose(gv, np.asarray(wv), **F32)


def test_prefill_and_decode_steps_match_reference(seamless_tiny):
    """make_prefill's enc-dec branch (the encoder's output and every
    layer's cross K/V), then eight steps of make_decode_step's, slot 1
    three positions ahead of slot 0: logits, greedy tokens, and every
    cache leaf at the end."""
    jcfg, tcfg, tree, src = seamless_tiny
    jp = jax.tree.map(jnp.asarray, tree)
    params = encdec_params_from_numpy(tcfg, tree)
    w_enc, w_cross = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jp, jnp.asarray(src))
    g_enc, g_cross = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        params, torch.from_numpy(src))
    np.testing.assert_allclose(as_np(g_enc), np.asarray(w_enc), **F32)
    for g, w in zip(stacked(g_cross), w_cross):
        np.testing.assert_allclose(g, np.asarray(w), **F32)

    jstep = jax.jit(jax_decode(jcfg, dtype=jnp.float32))
    tstep = make_decode_step(tcfg, dtype=torch.float32, device="cpu")
    jc = jencdec.init_dec_caches(jcfg, 2, 16)
    tc = tregistry.init_caches(tcfg, 2, 16, device="cpu")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, size=(2, 8))
    for t in range(8):
        pos = np.array([t, t + 3], np.int32)
        tok = toks[:, t].astype(np.int32)
        wn, wl, jc = jstep(jp, jc, w_cross, jnp.asarray(tok),
                           jnp.asarray(pos))
        gn, gl, tc = tstep(params, tc, g_cross, tok, pos)
        np.testing.assert_allclose(as_np(gl), np.asarray(wl), **LOGITS)
        np.testing.assert_array_equal(as_np(gn), np.asarray(wn))
    back = encdec_caches_to_numpy(tcfg, tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(back[key], np.asarray(jc[key]), **F32)


def test_decode_step_entry_and_plain_backend(seamless_tiny):
    """registry.decode_entry is encdec.decode_step; on the CPU the kernel
    and plain backends are the same function."""
    jcfg, tcfg, tree, src = seamless_tiny
    assert tregistry.decode_entry(tcfg) is tencdec.decode_step
    params = encdec_params_from_numpy(tcfg, tree)
    cross = tencdec.precompute_cross_kv(
        tcfg, params, tencdec.encode(tcfg, params, torch.from_numpy(src)))
    tok, pos = torch.tensor([3, 4], dtype=torch.int32), torch.tensor(
        [0, 2], dtype=torch.int32)
    out = {}
    for backend in ("kernel", "plain"):
        caches = tencdec.init_dec_caches(tcfg, 2, 8)
        out[backend], _ = tencdec.decode_step(tcfg, params, caches, cross,
                                              tok, pos, backend=backend)
    assert torch.equal(out["kernel"], out["plain"])


def test_decode_train_and_loss_match_reference(seamless_tiny):
    """The teacher-forced decoder (cross-attention over 12 target rows
    against 20 source rows) and the sequence-to-sequence loss, forward
    only, on the CPU."""
    jcfg, tcfg, tree, src = seamless_tiny
    jp = jax.tree.map(jnp.asarray, tree)
    params = encdec_params_from_numpy(tcfg, tree)
    rng = np.random.default_rng(3)
    tgt = rng.integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    labels[0, :3] = -100
    enc = jencdec.encode(jcfg, jp, jnp.asarray(src))
    want = jencdec.decode_train(jcfg, jp, enc, jnp.asarray(tgt))
    got = tencdec.decode_train(tcfg, params,
                               torch.from_numpy(np.array(enc)),
                               torch.from_numpy(tgt))
    np.testing.assert_allclose(as_np(got), np.asarray(want), **F32)
    wl, wm = jencdec.seq2seq_loss(jcfg, jp, jnp.asarray(src),
                                  jnp.asarray(tgt), jnp.asarray(labels))
    gl, gm = tencdec.seq2seq_loss(tcfg, params, torch.from_numpy(src),
                                  torch.from_numpy(tgt),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(float(gl), float(wl), **LOGITS)
    assert int(gm["tokens"]) == int(wm["tokens"]) == 21


def test_param_bridge_round_trips_every_leaf(seamless_tiny):
    jcfg, tcfg, tree, _ = seamless_tiny
    params = encdec_params_from_numpy(tcfg, tree, dtype=torch.bfloat16)
    assert len(params["enc"]) == tcfg.n_enc_layers
    assert len(params["dec"]) == tcfg.n_layers
    assert params["dec"][0]["cross_attn"]["wq"].dtype == torch.bfloat16
    assert params["dec"][0]["norm_x"]["scale"].dtype == torch.float32
    back = encdec_params_to_numpy(tcfg, encdec_params_from_numpy(tcfg, tree))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_back] == [p for p, _ in flat]
    for (path, a), (_, b) in zip(flat_back, flat):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    fresh = tregistry.init_params(tcfg, 0, device="cpu")
    assert jax.tree.map(np.shape, encdec_params_to_numpy(tcfg, fresh)) \
        == jax.tree.map(np.shape, tree)


def test_cache_bridge_round_trips_every_leaf(seamless_tiny):
    jcfg, tcfg, _, _ = seamless_tiny
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), np_tree(jencdec.init_dec_caches(jcfg, 2, 8)))
    caches = encdec_caches_from_numpy(tcfg, tree)
    fresh = tregistry.init_caches(tcfg, 2, 8, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in fresh] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in caches]
    back = encdec_caches_to_numpy(tcfg, caches)
    assert set(back) == {"k", "v"}
    for key in ("k", "v"):
        assert back[key].dtype == tree[key].dtype
        np.testing.assert_array_equal(back[key], tree[key])


def test_training_refused_and_serve_main_exits(seamless_tiny):
    """Its training is no longer refused: ``registry.loss_fn`` is the
    sequence-to-sequence loss on a ``src_embeds``/``tgt_tokens``/
    ``labels`` batch, equal to ``seq2seq_loss``, and ``make_train_step``
    builds; the serve CLI still exits for an encoder-decoder config, as the
    reference's does."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_train_step

    _, tcfg, tree, src = seamless_tiny
    params = encdec_params_from_numpy(tcfg, tree)
    tgt = np.arange(24, dtype=np.int32).reshape(2, 12) % tcfg.vocab
    batch = {"src_embeds": torch.from_numpy(src),
             "tgt_tokens": torch.from_numpy(tgt),
             "labels": torch.from_numpy((tgt + 1) % tcfg.vocab)}
    loss, metrics = tregistry.loss_fn(tcfg)(params, batch, torch.float32)
    want, _ = tencdec.seq2seq_loss(tcfg, params, *batch.values())
    assert float(loss) == float(want) and int(metrics["tokens"]) == 24
    assert callable(make_train_step(tcfg, device="cpu"))
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", SEAMLESS, "--tiny", "--device", "cpu"])


def seq2seq_batch(tcfg, src, seed=3, s_tgt=12):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, tcfg.vocab, size=(src.shape[0], s_tgt)).astype(
        np.int32)
    labels = rng.integers(0, tcfg.vocab, size=tgt.shape).astype(np.int32)
    labels[0, :3] = -100
    return {"src_embeds": src, "tgt_tokens": tgt, "labels": labels}


def assert_leaves_close(got, want, rel):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=str(path))


def test_seq2seq_loss_and_grads_match_reference(seamless_tiny):
    """``registry.loss_fn`` of the encoder-decoder config through
    ``loss_and_grads`` against ``jax.value_and_grad`` of the reference's
    ``seq2seq_loss``, S_src 20 against S_tgt 12: the loss within 1e-5
    relative, every gradient leaf (the port's per-layer lists stacked as
    the reference's [L, ...]) within 2e-4 x its max |g|, float32."""
    from repro_torch.launch.steps import loss_and_grads

    jcfg, tcfg, tree, src = seamless_tiny
    batch = seq2seq_batch(tcfg, src)
    (wl, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: jencdec.seq2seq_loss(
            jcfg, p, *(jnp.asarray(batch[k]) for k in
                       ("src_embeds", "tgt_tokens", "labels"))),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    params = encdec_params_from_numpy(tcfg, tree)
    gl, gm, gg = loss_and_grads(
        tregistry.loss_fn(tcfg), params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.float32)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    assert int(gm["tokens"]) == int(wm["tokens"]) == 21
    assert_leaves_close(encdec_params_to_numpy(tcfg, gg), np_tree(wg), 2e-4)


def test_train_steps_match_reference(seamless_tiny):
    """Two steps of ``make_train_step`` (cosine schedule with warm-up,
    float32) against the reference's jitted step on tiny seamless: every
    metric within 1e-5 relative, parameters within 1e-6, both AdamW
    moments within 1e-5 x their leaf's max |value|. The reference decays
    every leaf of ndim >= 2 of its stacked tree, so every leaf of an
    encoder or decoder layer (``encdec.weight_decay_mask``), and the step
    here runs with weight decay 0.1 so that the mask shows."""
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jsched
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw as tadamw
    from repro_torch.optim import schedules as tsched

    jcfg, tcfg, tree, src = seamless_tiny
    jopt = jadamw.AdamWConfig(weight_decay=0.1)
    topt = tadamw.AdamWConfig(weight_decay=0.1)
    jstep = jax.jit(jax_make_train_step(
        jcfg, schedule=jsched.make("cosine", 1e-3, 10, warmup=1),
        opt_cfg=jopt, dtype=jnp.float32))
    tstep = make_train_step(
        tcfg, schedule=tsched.make("cosine", 1e-3, 10, warmup=1),
        opt_cfg=topt, dtype=torch.float32, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.init(jp)
    tp = encdec_params_from_numpy(tcfg, tree)
    to = tadamw.init(tp)
    mask = tencdec.weight_decay_mask(tcfg, tp)
    assert all(all(tadamw.tree_leaves(layer)) for layer in mask["dec"])
    assert mask["embed"]["table"] and not mask["final_norm"]["scale"]
    for step in range(2):
        batch = seq2seq_batch(tcfg, src, seed=10 + step)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-7), k
    assert int(to["count"]) == int(jo["count"]) == 2
    np.testing.assert_allclose(
        np.concatenate([a.ravel() for a in jax.tree.leaves(
            encdec_params_to_numpy(tcfg, tp))]),
        np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jp)]),
        rtol=0, atol=1e-6)
    for key in ("m", "v"):
        assert_leaves_close(encdec_params_to_numpy(tcfg, to[key]),
                            np_tree(jo[key]), 1e-5)


def test_train_cli_runs_seamless_as_a_direct_loop(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch seamless-m4t-medium
    --tiny --steps 2 --device cpu`` runs, and the losses it checkpoints
    each step (at full precision) equal those of a direct loop of
    ``make_train_step`` over the same seed, schedule and batches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, schedules

    ckpt = tmp_path / "ckpt"
    train.main(["--arch", SEAMLESS, "--tiny", "--steps", "2", "--device",
                "cpu", "--batch", "2", "--seq", "16", "--log-every", "1",
                "--checkpoint-every", "1", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    cli = []
    for step in (1, 2):
        with open(ckpt / f"step_{step:09d}" / "manifest.json") as f:
            import json
            cli.append(json.load(f)["extra"]["loss"])
    cfg = get_config(SEAMLESS).tiny()
    params = tregistry.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, schedule=schedules.make("cosine", 3e-4, 2),
                              opt_cfg=AdamWConfig(), dtype=torch.float32,
                              device="cpu")
    source = SyntheticLM(cfg, 2, 16, seed=0)
    direct = []
    for i in range(2):
        params, opt, m = step_fn(params, opt, source.batch_at(i))
        direct.append(float(m["loss"]))
    assert cli == direct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_entries_match_reference_in_each_dtype(seamless_tiny, dtype):
    """Each registry's decode entry called directly, three steps in the
    compute dtype: float32 logits within 2e-4, bfloat16 within 2e-2."""
    jcfg, tcfg, tree, src = seamless_tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = LOGITS if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    jp = jax.tree.map(jnp.asarray, tree)
    params = encdec_params_from_numpy(tcfg, tree, dtype=tdt)
    enc = jencdec.encode(jcfg, jp, jnp.asarray(src, jdt))
    w_cross = jencdec.precompute_cross_kv(jcfg, jp, enc)
    g_cross = make_prefill(tcfg, dtype=tdt, device="cpu")(
        params, torch.from_numpy(src))[1]
    jstep = jax.jit(functools.partial(jregistry.decode_entry(jcfg), jcfg,
                                      dtype=jdt))
    jc = jencdec.init_dec_caches(jcfg, 2, 8, jdt)
    tc = tregistry.init_caches(tcfg, 2, 8, dtype=tdt, device="cpu")
    for t in range(3):
        tok = np.array([5 + t, 9], np.int32)
        pos = np.array([t, t], np.int32)
        wl, jc = jstep(jp, jc, w_cross, jnp.asarray(tok), jnp.asarray(pos))
        gl, tc = tregistry.decode_entry(tcfg)(
            tcfg, params, tc, g_cross, torch.from_numpy(tok),
            torch.from_numpy(pos), tdt)
        np.testing.assert_allclose(as_np(gl), np.asarray(wl), **tol)
