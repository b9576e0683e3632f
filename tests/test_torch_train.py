"""The training path of the PyTorch port against the reference package.

The same seeded numpy inputs go through both packages on the CPU, in
float32: the LR schedules, AdamW and the int8 error-feedback compression
on a small tree, the synthetic data pipeline, the chunked cross entropy
and its gradients, ``lm_loss`` and its gradients on six tiny models
(minicpm-2b with a tied head, qwen3-14b with GQA and qk-norm,
phi3.5-moe with the MoE aux loss, jamba's Mamba layers, deepseek-v3's
MLA, xlstm's mLSTM/sLSTM, also across its remat chunk) and under each
activation checkpointing form, every config's loss and train step built, two steps of ``make_train_step`` against the
reference's jitted step, and the training CLI's crash and resume.

Tolerances: schedules and the optimizer on a small tree 1e-6 relative
(the same float32 formulas, summed in another order); the cross entropy
and ``lm_loss`` 1e-5 relative, every gradient leaf within 2e-4 x that
leaf's max |g|; after two train steps, parameters within 1e-6 absolute
(an AdamW step moves a parameter by at most about lr = 1e-3 here) and
each moment leaf within 1e-5 x its max |value|; the error buffer of the
compression within 1e-3 x its max |value| (it is gf - dequant(gf), a
difference of two float32 values about 254 times its size). With
compression, an
element whose value sits within float32 noise of an int8 rounding
boundary may round to the neighbouring step in one package: there at most
1 element in 1000 (of the parameters, moments and error buffer together)
may differ by more than the tolerance above, and no parameter by more
than two AdamW steps (2 x lr). Data batches are equal element for
element.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.pipeline import Prefetcher as JPrefetcher  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    loss_and_grads,
    make_train_step,
)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5        # losses
GRAD = 2e-4       # gradients, x the leaf's max |g|
OPT = 1e-6        # schedules and the optimizer on a small tree
TRAIN_ARCHS = ["minicpm-2b", "qwen3-14b", "phi3.5-moe-42b-a6.6b",
               "jamba-v0.1-52b", "deepseek-v3-671b", "xlstm-1.3b"]


def leaves_with_path(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def assert_grads_close(got, want):
    got, want = leaves_with_path(got), leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= GRAD * scale, f"{path}: {err} > {GRAD} x {scale}"


# --------------------------------------------------------------- optim ----

def test_schedules_match_reference():
    steps = [0, 1, 5, 99, 100, 101, 400, 799, 800, 801, 900, 999, 1000,
             1500]
    js = jnp.asarray(steps, jnp.int32)
    ts = torch.tensor(steps, dtype=torch.int32)
    pairs = [
        (jsched.wsd(js, 3e-4, 100, 700, 200),
         tsched.wsd(ts, 3e-4, 100, 700, 200)),
        (jsched.wsd(js, 1e-3, 0, 5, 50, floor=0.2),
         tsched.wsd(ts, 1e-3, 0, 5, 50, floor=0.2)),
        (jsched.cosine(js, 3e-4, 100, 1000), tsched.cosine(ts, 3e-4, 100,
                                                           1000)),
        (jsched.constant(js, 3e-4), tsched.constant(ts, 3e-4)),
        (jsched.constant(js, 3e-4, 10), tsched.constant(ts, 3e-4, 10)),
    ]
    for name in ("wsd", "cosine", "const"):
        pairs.append((jsched.make(name, 2e-4, 1000)(js),
                      tsched.make(name, 2e-4, 1000)(ts)))
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OPT,
                                   atol=0)
    # a 0-d count, as the train step passes it
    assert float(tsched.make("wsd", 1e-3, 10, 2)(torch.tensor(1))) == \
        pytest.approx(float(jsched.make("wsd", 1e-3, 10, 2)(jnp.int32(1))),
                      rel=OPT)


def small_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32),
                        "m": rng.standard_normal((3, 4, 2)).astype(
                            np.float32)} for _ in range(2)]}


def to_t(tree):
    return tadamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_tree_close(got, want, rtol=OPT, atol=0.0):
    want_l = jax.tree.leaves(want)
    got_l = tadamw.tree_leaves(got)
    assert len(got_l) == len(want_l)
    # tree_leaves and jax.tree.leaves both take dict keys sorted
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol + rtol * np.abs(w).max())


def test_adamw_and_compress_tree_match_reference():
    rng = np.random.default_rng(3)
    params = small_tree(rng)
    cfg = tadamw.AdamWConfig(weight_decay=0.05, clip_norm=2.0)
    jcfg = jadamw.AdamWConfig(weight_decay=0.05, clip_norm=2.0)
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = jadamw.init(jp)
    tp = to_t(params)
    tst = tadamw.init(tp)
    jerr, terr = jcomp.init_error(jp), tcomp.init_error(tp)
    for step, grad_scale in enumerate((5.0, 0.3, 1.0)):  # clipped, not
        grads = jax.tree.map(lambda a: grad_scale * a, small_tree(rng))
        np.testing.assert_allclose(
            float(tadamw.global_norm(to_t(grads))),
            float(jadamw.global_norm(grads)), rtol=OPT)
        # the compressed gradients and the error feedback
        jg, jerr = jcomp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                       jerr)
        tg, terr = tcomp.compress_tree(to_t(grads), terr)
        assert_tree_close(tg, jg)
        assert_tree_close(terr, jerr, atol=1e-7)
        lr = 1e-2 * (step + 1)
        jp, jst, jm = jadamw.update(jp, jg, jst, jnp.float32(lr), jcfg)
        tp, tst, tm = tadamw.update(tp, tg, tst, lr, cfg)
        assert_tree_close(tp, jp)
        assert_tree_close(tst["m"], jst["m"])
        assert_tree_close(tst["v"], jst["v"])
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT)
        assert float(tm["lr"]) == pytest.approx(lr, rel=OPT)


# ---------------------------------------------------------------- data ----

@pytest.mark.parametrize("arch", ["qwen3-14b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_synthetic_lm_batches_equal_reference(arch):
    """Tokens and labels (embeds for the vision stub, source embeds for
    the encoder-decoder) element for element, for several steps, seeds
    and hosts."""
    for seed, hosts in ((0, 1), (7, 2), (3, 4)):
        for host in range(hosts):
            want = JSyntheticLM(JAX_ARCHS[arch].tiny(), 8, 16, seed=seed,
                                host_id=host, num_hosts=hosts)
            got = SyntheticLM(ARCHS[arch].tiny(), 8, 16, seed=seed,
                              host_id=host, num_hosts=hosts)
            assert got.local_batch == want.local_batch == 8 // hosts
            for step in (0, 1, 17, 1000):
                a, b = got.batch_at(step), want.batch_at(step)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError):
        SyntheticLM(ARCHS[arch].tiny(), 6, 16, num_hosts=4)


def test_prefetcher_orders_steps_as_reference():
    cfg = ARCHS["qwen3-14b"].tiny()
    got, want = Prefetcher(SyntheticLM(cfg, 2, 16, seed=5), start_step=3,
                           prefetch=2), \
        JPrefetcher(JSyntheticLM(JAX_ARCHS["qwen3-14b"].tiny(), 2, 16,
                                 seed=5), start_step=3, prefetch=2)
    try:
        for expect in range(3, 8):
            (s, a), (t, b) = next(got), next(want)
            assert s == t == expect
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        got.close()
        want.close()
    assert not got._thread.is_alive()


# ---------------------------------------------------------------- loss ----

@pytest.mark.parametrize("s, chunk", [(37, 16), (32, 16), (5, 64)])
def test_chunked_softmax_xent_matches_reference(s, chunk):
    """Loss, count and the gradients with respect to x and the head, with
    a ragged tail (37 = 2 x 16 + 5; 5 < 64) and ignored labels."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 24, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, ::3] = -100
    labels[1, -2:] = -100

    def jf(x, head):
        return jlayers.chunked_softmax_xent(x, head, jnp.asarray(labels),
                                            chunk)
    (jl, jc), (jgx, jgh) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    tl, tc = tlayers.chunked_softmax_xent(tx, th, torch.from_numpy(labels),
                                          chunk)
    tl.backward()
    assert int(tc) == int(jc) == int((labels >= 0).sum())
    assert tl.item() == pytest.approx(float(jl), rel=REL)
    assert_grads_close({"x": tx.grad.numpy(), "head": th.grad.numpy()},
                       {"x": np.asarray(jgx), "head": np.asarray(jgh)})
    with torch.no_grad():  # the same loss without the checkpoints
        nl, nc = tlayers.chunked_softmax_xent(tx, th,
                                              torch.from_numpy(labels), chunk)
    assert nl.item() == tl.item() and int(nc) == int(tc)


def lm_inputs(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    return toks, labels


def perturbed_params(jcfg, seed):
    """The reference's initial tree with norm scales 1 + N(0, 0.1), so
    that they are not trivially ones."""
    tree = jax.tree.map(np.asarray,
                        jregistry.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def bump(path, a):
        if getattr(path[-1], "key", None) == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(bump, tree)


def check_lm_loss(arch, remat="none", s=24):
    import dataclasses

    jcfg = dataclasses.replace(JAX_ARCHS[arch].tiny(), remat=remat)
    tcfg = dataclasses.replace(ARCHS[arch].tiny(), remat=remat)
    tree = perturbed_params(jcfg, 1)
    toks, labels = lm_inputs(jcfg, 2, s=s)

    def jf(p):
        return jlm.lm_loss(jcfg, p, jnp.asarray(toks), jnp.asarray(labels))
    # jitted: the same gradients, compiled once instead of op by op
    (jl, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    params = lm_params_from_numpy(tcfg, tree, device="cpu")
    tl, tm, tg = loss_and_grads(
        tregistry.loss_fn(tcfg), params,
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
        torch.float32)
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    for k in ("ce_loss", "aux_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=REL, abs=1e-7)
    assert int(tm["tokens"]) == int(jm["tokens"]) == int((labels >= 0).sum())
    assert_grads_close(lm_params_to_numpy(tcfg, tg), jax.tree.map(
        np.asarray, jg))
    return tm


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """Every decoder-only family: dense GQA (minicpm, qwen3), MoE
    (phi3.5-moe), Mamba + MoE (jamba: on the card K7's backward), MLA +
    MoE (deepseek-v3: K6's general backward) and mLSTM/sLSTM (xlstm); the
    MoE aux loss is > 0 exactly where a layer has an MoE FFN."""
    tm = check_lm_loss(arch)
    moe = any(f == "moe" for _, f in tlm.layer_kinds(ARCHS[arch].tiny()))
    assert (float(tm["aux_loss"]) > 0) == moe


def test_xlstm_lm_loss_crosses_the_remat_chunk():
    """xlstm at S = 70: its mLSTM layers scan a chunk of 64 under
    checkpoint and a tail of 6 (``scan_utils.chunked_scan``), the loss
    and every gradient against the reference's own chunked scan."""
    check_lm_loss("xlstm-1.3b", s=70)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_activation_checkpointing_keeps_loss_and_grads(remat):
    """``remat`` "full" (recompute each group) and "dots" (save the matrix
    products) against the reference's ``jax.checkpoint`` forms."""
    check_lm_loss("minicpm-2b", remat)


def test_lm_loss_and_train_step_refuse_untrainable_families():
    """No family is refused any more: every registry config builds its
    ``loss_fn`` (``seq2seq_loss`` for the encoder-decoder, ``lm_loss`` for
    the others) and its ``make_train_step``, as the reference's do; and
    ``lm_loss`` still refuses the encoder-decoder config, which is
    ``models.encdec``'s."""
    for arch in ARCHS:
        cfg = ARCHS[arch].tiny()
        assert callable(tregistry.loss_fn(cfg)), arch
        assert callable(make_train_step(cfg, device="cpu")), arch
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tlm.lm_loss(ARCHS["seamless-m4t-medium"].tiny(), None, None, None)


# ------------------------------------------------------------- the step ----

def opt_leaves(cfg, state):
    return {k: lm_params_to_numpy(cfg, state[k]) for k in ("m", "v")}


@pytest.mark.parametrize("microbatches, compression",
                         [(1, False), (2, False), (1, True)])
def test_train_step_matches_reference(microbatches, compression):
    """Two steps of ``make_train_step`` (WSD schedule, float32) against
    the reference's jitted step: parameters, both moments, the count, the
    error buffer and every metric."""
    arch = "minicpm-2b"
    jcfg, tcfg = JAX_ARCHS[arch].tiny(), ARCHS[arch].tiny()
    tree = perturbed_params(jcfg, 4)
    jstep = jax.jit(jax_make_train_step(
        jcfg, schedule=jsched.make("wsd", 1e-3, 10, warmup=2),
        dtype=jnp.float32, num_microbatches=microbatches,
        grad_compression=compression))
    tstep = make_train_step(
        tcfg, schedule=tsched.make("wsd", 1e-3, 10, warmup=2),
        dtype=torch.float32, num_microbatches=microbatches,
        grad_compression=compression, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.init(jp)
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    to = tadamw.init(tp)
    if compression:
        jo["err"] = jcomp.init_error(jp)
        to["err"] = tcomp.init_error(tp)
    rng = np.random.default_rng(5)
    for _ in range(2):
        bt = rng.integers(1, jcfg.vocab, (4, 25)).astype(np.int32)
        batch = {"tokens": bt[:, :-1], "labels": bt[:, 1:]}
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=REL,
                                                 abs=1e-7), k
    assert int(to["count"]) == int(jo["count"]) == 2
    got = {"params": lm_params_to_numpy(tcfg, tp), **opt_leaves(tcfg, to)}
    want = jax.tree.map(np.asarray, {"params": jp, "m": jo["m"],
                                     "v": jo["v"]})
    if compression:
        got["err"] = lm_params_to_numpy(tcfg, to["err"])
        want["err"] = jax.tree.map(np.asarray, jo["err"])
    off = total = 0
    for name in got:
        g_l, w_l = leaves_with_path(got[name]), leaves_with_path(want[name])
        assert [p for p, _ in g_l] == [p for p, _ in w_l], name
        for (path, g), (_, w) in zip(g_l, w_l):
            tol = {"params": 1e-6, "err": 1e-3}.get(name, 1e-5)
            if name != "params":
                tol *= float(np.abs(w).max())
            err = np.abs(g - w)
            total += w.size
            if not compression:
                assert err.max() <= tol, f"{name}{path}: {err.max()} > {tol}"
                continue
            off += int((err > tol).sum())
            if name == "params":  # two AdamW steps of at most ~lr each
                assert err.max() <= 2e-3, f"{name}{path}: {err.max()}"
    assert off <= total // 1000, f"{off} of {total} elements differ"


# ----------------------------------------------------------------- CLI ----

def test_train_cli_crash_resume_matches_uninterrupted(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a run crashes
    at the injected step, a resumed run prints ``resumed from step`` and
    ``done: 8 steps``, and its losses (the printed ones and the last
    checkpoint's, at full precision) equal an uninterrupted run's."""
    import json

    args = ["--arch", "minicpm-2b", "--tiny", "--device", "cpu", "--steps",
            "8", "--batch", "2", "--seq", "32", "--checkpoint-every", "2",
            "--log-every", "1"]
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
           "--ckpt-dir", ckpt, "--resume"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r1 = subprocess.run(cmd + ["--fail-at-step", "5"], env=env, cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
    assert r1.returncode != 0
    assert "injected failure at step 5" in r1.stderr
    r2 = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                        text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[train] resumed from step 6" in r2.stdout
    assert "done: 8 steps" in r2.stdout

    straight = str(tmp_path / "straight")
    ttrain.main(args + ["--ckpt-dir", straight])
    out = capsys.readouterr().out
    assert "done: 8 steps" in out

    def losses(text):
        return {line.split()[2]: line.split()[3] for line in
                text.splitlines() if line.startswith("[train] step")}
    crashed, resumed, whole = (losses(r1.stdout), losses(r2.stdout),
                               losses(out))
    assert sorted(resumed) == ["6", "7"] and len(whole) == 8
    assert {**crashed, **resumed} == whole

    def last_loss(d):
        with open(Path(d) / "step_000000008" / "manifest.json") as f:
            return json.load(f)["extra"]["loss"]
    np.testing.assert_allclose(last_loss(ckpt), last_loss(straight),
                               rtol=1e-6)
