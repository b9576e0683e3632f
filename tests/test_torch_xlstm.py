"""The xLSTM mixers and tiny xlstm-1.3b of the PyTorch port against the
reference package: the port's scan against the reference's
``chunked_scan`` with T = 150 in chunks of 64 (two chunks and a tail) and
short of one chunk, the port's own ``chunked_scan`` (its remat) against
its one loop ``scan``, values and gradients, ``mlstm_full`` and
``slstm_full`` (output and final float32 state), their one-token decodes
from a carried state (updated in place), tiny xlstm's forward, prefill
logits and states and decode steps, and its ``serve_loop`` (tokens, join
steps and step count; a reused or idle slot keeps moving its recurrent
state, as the reference's does); and at the published depth of 48
layers, the port's float32 decode-against-prefill gap beside the
reference's own. The reference's weights cross through the parameter
bridge.

Tolerances: float32 1e-5 for layers and states (3e-5 after 150 recurrent
steps), 2e-4 for logits (as tests/test_torch_models.py); the scan exact;
serve tokens exact; the 48-layer gap at most 2x the reference's + 1e-6 x
max |logit|.
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
from repro.models import registry as jregistry  # noqa: E402
from repro.models import scan_utils as jscan  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
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
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import scan_utils as tscan  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
LONG = dict(atol=3e-5, rtol=3e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)
XLSTM = "xlstm-1.3b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed):
    """Norm scales 1 + N(0, 0.1); gate biases + N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key = getattr(path[-1], "key", None)
        if key == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("b_if", "b_gates"):
            return (a + 0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(bump, np_tree(tree))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def tiny_pair(**changes):
    jcfg = dataclasses.replace(JAX_ARCHS[XLSTM].tiny(), **changes)
    tcfg = dataclasses.replace(get_config(XLSTM).tiny(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def assert_tree_close(got, want, tol):
    for path, w in jax.tree_util.tree_leaves_with_path(np_tree(want)):
        g = got
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(as_np(g), w, err_msg=str(path), **tol)


@pytest.mark.parametrize("t", [150, 40], ids=["two_chunks_and_a_tail",
                                              "one_short_chunk"])
def test_chunked_scan_matches_reference(t):
    """The port's one loop over time against the reference's
    ``chunked_scan``: a carry and a stacked output through a step that
    mixes them, with T = 150 over the reference's chunks of 64 (64 + 64 +
    a tail of 22) and T = 40. The values are small integers, so every sum
    is exact and the two scans must agree bit for bit whatever order the
    compilers pick."""
    rng = np.random.default_rng(t)
    xs = rng.integers(-5, 6, (t, 3)).astype(np.float32)
    ws = rng.integers(-5, 6, (t, 3)).astype(np.float32)
    init = np.ones((3,), np.float32)

    def jstep(c, inp):
        x, w = inp
        c = c + x
        return c, (c * w).sum()

    tstep = jstep

    wc, wy = jscan.chunked_scan(jstep, jnp.asarray(init),
                                (jnp.asarray(xs), jnp.asarray(ws)), chunk=64)
    gc, gy = tscan.scan(tstep, torch.from_numpy(init),
                        (torch.from_numpy(xs), torch.from_numpy(ws)))
    assert gy.shape == (t,)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


@pytest.mark.parametrize("t", [40, 64, 150], ids=["below_a_chunk",
                                                  "one_chunk",
                                                  "two_chunks_and_a_tail"])
def test_chunked_remat_scan_matches_scan(t):
    """``chunked_scan`` (chunks of 64 under checkpoint, then a plain tail)
    against the one loop ``scan`` through the mLSTM step: under
    ``torch.no_grad()`` (serving) the carry and ys bit for bit, the carry
    updated in place as ``scan`` updates it; with grad, the same values
    bit for bit and every input's gradient, the initial carry's included,
    within 1e-6 x its max |g| (the backward recomputes each chunk's steps,
    the same operations, and adds them in the same order)."""
    rng = np.random.default_rng(t)
    b, h, dh = 2, 2, 4
    xs = [rng.standard_normal((t, b, h, dh)).astype(np.float32)
          for _ in range(3)]
    xs += [rng.standard_normal((t, b, h)).astype(np.float32),
           np.log(1 / (1 + np.exp(-rng.standard_normal((t, b, h)) - 2)))
           .astype(np.float32)]
    init = [rng.standard_normal((b, h, dh, dh)).astype(np.float32),
            rng.standard_normal((b, h, dh)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32)]
    weight = torch.from_numpy(rng.standard_normal((t, b, h, dh)).astype(
        np.float32))

    def run(scan, grad):
        ins = [torch.from_numpy(a.copy()).requires_grad_(grad)
               for a in xs + init]
        carry, ys = scan(txlstm._mlstm_step, tuple(ins[5:]), tuple(ins[:5]))
        if not grad:
            return carry, ys, ins[5:]
        loss = (ys * weight).sum() + sum(c.sum() for c in carry)
        return carry, ys, torch.autograd.grad(loss, ins)

    chunked = functools.partial(tscan.chunked_scan, chunk=64)
    with torch.no_grad():
        wc, wy, _ = run(tscan.scan, False)
        gc, gy, given = run(chunked, False)
    assert torch.equal(gy, wy) and all(map(torch.equal, gc, wc))
    assert all(c is g for c, g in zip(gc, given))  # updated in place
    wc, wy, wg = run(tscan.scan, True)
    gc, gy, gg = run(chunked, True)
    assert gy.shape == (t, b, h, dh)
    assert torch.equal(gy, wy) and all(map(torch.equal, gc, wc))
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.fixture(scope="module")
def layers():
    jcfg, tcfg = tiny_pair()
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    m = perturbed(jxlstm.init_mlstm(k1, jcfg), 1)
    s = perturbed(jxlstm.init_slstm(k2, jcfg), 2)
    return jcfg, tcfg, {"mlstm": m, "slstm": s}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_full_and_decode_match_reference(layers, kind):
    """The full-sequence form over 2 x 150 tokens (the mLSTM scan: two
    chunks of 64 and a tail), output and final state; then four decode
    steps from that state, in place."""
    jcfg, tcfg, trees = layers
    tree = trees[kind]
    jfull, jdec = {"mlstm": (jxlstm.mlstm_full, jxlstm.mlstm_decode),
                   "slstm": (jxlstm.slstm_full, jxlstm.slstm_decode)}[kind]
    tfull, tdec = {"mlstm": (txlstm.mlstm_full, txlstm.mlstm_decode),
                   "slstm": (txlstm.slstm_full, txlstm.slstm_decode)}[kind]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 150, 64)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, tree), to_torch(tree)
    wo, ws = jfull(jp, jnp.asarray(x), jcfg)
    go, gs = tfull(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(as_np(go), np.asarray(wo), **F32)
    assert all(v.dtype == torch.float32 for v in gs.values())
    assert_tree_close(gs, ws, LONG)
    c = gs["c"]
    for _ in range(4):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        wo, ws = jdec(jp, jnp.asarray(x1), ws, jcfg)
        go, gs = tdec(tp, torch.from_numpy(x1), gs, tcfg)
        np.testing.assert_allclose(as_np(go), np.asarray(wo), **F32)
        assert_tree_close(gs, ws, LONG)
    assert gs["c"] is c


@pytest.fixture(scope="module")
def xlstm_tiny():
    jcfg, tcfg = tiny_pair()
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    return jcfg, tcfg, tree


def test_xlstm_matches_reference(xlstm_tiny):
    """forward, make_prefill (last-token logits, every layer's state) and
    six decode steps with per-slot positions, logits and greedy tokens,
    then every state leaf."""
    jcfg, tcfg, tree = xlstm_tiny
    assert [m for m, _ in tlm.layer_kinds(tcfg)] \
        == ["mlstm"] * 7 + ["slstm"]
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tcfg, tree)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, size=(2, 12)).astype(np.int32)
    wx, _, _ = jlm.forward(jcfg, jp, jnp.asarray(toks))
    gx, _, _ = tlm.forward(tcfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(gx), as_np(wx), **F32)

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


def test_xlstm_states_cross_the_bridge(xlstm_tiny):
    jcfg, tcfg, _ = xlstm_tiny
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), np_tree(jlm.init_caches(jcfg, 2, 8)))
    caches = lm_caches_from_numpy(tcfg, tree)
    fresh = tregistry.init_caches(tcfg, 2, 8, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in fresh] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in caches]
    assert all(v.dtype == torch.float32 for c in fresh for v in c.values())
    assert bool((fresh[0]["m"] == -1e30).all())
    assert_tree_close(lm_caches_to_numpy(tcfg, caches), tree,
                      dict(atol=0, rtol=0))


def test_xlstm_serve_loop_matches_reference(xlstm_tiny):
    """7 requests through 3 slots: a reused slot starts from the previous
    request's state and an idle slot's state moves under token 0, in both
    servers; tokens, join steps and step count agree."""
    jcfg, tcfg, tree = xlstm_tiny
    batch, max_seq = 3, 48
    prompts, news = serve.make_requests(3, tcfg.vocab, 7, 10, 12)
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


def test_serve_main_runs_xlstm_on_the_cpu(capsys):
    serve.main(["--arch", XLSTM, "--tiny", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 reqs through 2 slots" in out and "on cpu" in out


def test_xlstm_48_layers_decode_gap_is_the_references():
    """Tiny xlstm at the published depth, 48 layers (42 mLSTM + 6 sLSTM):
    in float32, the gap between the last logits of a teacher-forced decode
    and of a prefill of the same 2 x 8 tokens is measured in both
    packages. The port's logits hold the reference's at ``LOGITS``, and
    its gap is at most 2x the reference's own + 1e-6 x max |logit|: the
    gap that ``chip_smoke.py`` holds to ``DEEP_F32_TOL`` at full width is
    the reference's rounding, not a fault of the port's recurrence."""
    jcfg, tcfg = tiny_pair(n_layers=48)
    kinds = [m for m, _ in tlm.layer_kinds(tcfg)]
    assert kinds.count("mlstm") == 42 and kinds.count("slstm") == 6
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(48)), 48)
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tcfg, tree)
    b, t = 2, 8
    toks = np.random.default_rng(48).integers(
        0, tcfg.vocab, size=(b, t)).astype(np.int32)

    wpre, _ = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(toks)})
    gpre, _ = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        params, {"tokens": toks})
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    tstep = make_decode_step(tcfg, dtype=torch.float32, device="cpu")
    jc = jlm.init_caches(jcfg, b, t)
    tc = tregistry.init_caches(tcfg, b, t, device="cpu")
    for i in range(t):
        pos = np.full((b,), i, np.int32)
        wdec, jc = jstep(jp, jc, jnp.asarray(toks[:, i]), jnp.asarray(pos))
        _, gdec, tc = tstep(params, tc, toks[:, i], pos)
    np.testing.assert_allclose(as_np(gpre), as_np(wpre), **LOGITS)
    np.testing.assert_allclose(as_np(gdec), as_np(wdec), **LOGITS)
    ref_gap = float(np.abs(as_np(wdec) - as_np(wpre)).max())
    port_gap = float(np.abs(as_np(gdec) - as_np(gpre)).max())
    top = float(np.abs(as_np(wpre)).max())
    assert port_gap <= 2 * ref_gap + 1e-6 * top, (port_gap, ref_gap, top)
