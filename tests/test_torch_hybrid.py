"""The hybrid (Mamba + MoE) LLM stack of the PyTorch port against the
reference package: the Mamba mixer (full sequence through K7's plain
version, and the one-token decode step), the MoE FFN (routing with ties,
capacity drops, a shared expert, the token-chunked dispatch), the
float32 matrices the parameter bridge must keep, and whole tiny jamba
(one and two groups) and phi3.5-moe models. The reference's norm scales,
biases and Mamba vectors are perturbed before they cross, so that they
are not trivially ones and zeros.

Tolerances: float32 1e-5 for layers, 2e-4 for logits (as
tests/test_torch_models.py), bfloat16 2e-2; MoE drop fractions and
routing exact.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    lm_caches_from_numpy,
    lm_caches_to_numpy,
    lm_params_from_numpy,
)
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill,
)
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
JAMBA = "jamba-v0.1-52b"
PHI = "phi3.5-moe-42b-a6.6b"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed):
    """Norm scales 1 + N(0, 0.1); Mamba's conv_b N(0, 0.1), D 1 + N(0,
    0.1), dt_bias + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key = getattr(path[-1], "key", None)
        if key in ("scale", "D", "dt_bias"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key == "conv_b":
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(bump, np_tree(tree))


def to_torch(tree, dtype=torch.float32):
    """A reference subtree as torch tensors, cast like the bridge casts."""
    return lm_params_from_numpy(
        dataclasses.replace(JAX_ARCHS["qwen3-14b"].tiny(), n_layers=1),
        {"embed": {"table": np.zeros((1, 1), np.float32)},
         "final_norm": {"scale": np.ones(1, np.float32)},
         "body": {"0": jax.tree.map(lambda a: np.asarray(a)[None], tree)}},
        dtype=dtype)["layers"][0]


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32)


def tiny_pair(arch, **changes):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].tiny(), **changes)
    tcfg = dataclasses.replace(get_config(arch).tiny(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


# ------------------------------------------------------------------ mamba --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_matches_reference(dtype):
    """mamba_full (a 24-token prompt) and then three mamba_decode steps
    from its state, against repro.models.ssm."""
    jcfg, tcfg = tiny_pair(JAMBA)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32 if dtype == "float32" else BF16
    p = perturbed(jssm.init_mamba(jax.random.PRNGKey(0), jcfg), 0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = to_torch(p, tdt)
    assert tp["A_log"].dtype == torch.float32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    want, wstate = jssm.mamba_full(jp, jnp.asarray(x, jdt), jcfg)
    got, gstate = tssm.mamba_full(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt and gstate["h"].dtype == torch.float32
    assert gstate["conv"].dtype == tdt
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    for k in ("h", "conv"):
        np.testing.assert_allclose(as_np(gstate[k]), as_np(wstate[k]),
                                   **tol)
    for t in range(3):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, wstate = jssm.mamba_decode(jp, jnp.asarray(xt, jdt), wstate,
                                         jcfg)
        got, same = tssm.mamba_decode(tp, torch.from_numpy(xt).to(tdt),
                                      gstate, tcfg)
        assert same is gstate  # the state dict is updated in place
        np.testing.assert_allclose(as_np(got), as_np(want), **tol)
        for k in ("h", "conv"):
            np.testing.assert_allclose(as_np(gstate[k]), as_np(wstate[k]),
                                       **tol)


def test_mamba_decode_from_zero_state_is_prefill_of_one():
    _, tcfg = tiny_pair(JAMBA)
    p = tssm.init_mamba(torch.Generator().manual_seed(0), tcfg)
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(1))
    full, state = tssm.mamba_full(p, x, tcfg)
    dec = tlm._zero_cache(tcfg, "mamba", 2, 16, torch.float32)
    for t in range(5):
        out, dec = tssm.mamba_decode(p, x[:, t:t + 1], dec, tcfg)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **F32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(dec[k].numpy(), state[k].numpy(), **F32)


# -------------------------------------------------------------------- moe --

def _moe_case(seed, **changes):
    jcfg, tcfg = tiny_pair(PHI, **changes)
    p = np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal((2, 16, 64)).astype(
        np.float32)
    return jcfg, tcfg, p, x


def _moe_compare(jcfg, tcfg, p, x, dtype="float32"):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want, wm = jmoe.moe_forward(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x, jdt), jcfg)
    tp = to_torch(p, tdt)
    assert tp["router"].dtype == torch.float32
    got, gm = tmoe.moe_forward(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt
    np.testing.assert_allclose(as_np(got), as_np(want),
                               **(F32 if dtype == "float32" else BF16))
    assert float(gm["drop_frac"]) == float(wm["drop_frac"])
    np.testing.assert_allclose(float(gm["aux_loss"]), float(wm["aux_loss"]),
                               rtol=1e-6)
    return gm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(dtype):
    gm = _moe_compare(*_moe_case(0), dtype=dtype)
    assert float(gm["drop_frac"]) == 0.0


def test_moe_capacity_drops_match_reference():
    """capacity_factor 0.5: 32 tokens x top-2 over 4 experts leave 8
    slots an expert, so some assignments drop; the same ones as JAX's."""
    jcfg, tcfg, p, x = _moe_case(1, capacity_factor=0.5)
    assert tmoe._capacity(tcfg, 32) == jmoe._capacity(jcfg, 32) == 8
    gm = _moe_compare(jcfg, tcfg, p, x)
    assert float(gm["drop_frac"]) > 0.0


def test_moe_shared_expert_matches_reference():
    jcfg, tcfg, p, x = _moe_case(2, n_shared_experts=1)
    assert "shared" in p
    _moe_compare(jcfg, tcfg, p, x)


def test_moe_routing_ties_go_to_the_lower_expert():
    """A zero router makes every probability equal: jax.lax.top_k takes
    experts 0 and 1 for every token, and so must the port, dropping the
    same assignments past their capacity."""
    jcfg, tcfg, p, x = _moe_case(3)
    p = dict(p, router=np.zeros_like(p["router"]))
    gm = _moe_compare(jcfg, tcfg, p, x)
    assert float(gm["drop_frac"]) > 0.0


def test_moe_chunked_dispatch_matches_reference(monkeypatch):
    """Above MOE_CHUNK_TOKENS tokens (a multiple of it) the dispatch runs
    per chunk, with per-chunk capacity and the metrics averaged."""
    monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", 8)
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", 8)
    _moe_compare(*_moe_case(4, capacity_factor=0.5))


# ----------------------------------------------------------------- bridge --

def test_bridge_and_init_keep_the_reference_f32_matrices():
    """Router and A_log stay float32 through lm_params_from_numpy and the
    host draw at bfloat16; every other matrix is cast, vectors stay
    float32."""
    jcfg, tcfg = tiny_pair(JAMBA)
    tree = np_tree(jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    for params in (lm_params_from_numpy(tcfg, tree, dtype=torch.bfloat16),
                   tregistry.init_params(tcfg, 0, device="cpu",
                                         dtype=torch.bfloat16)):
        kinds = tlm.layer_kinds(tcfg)
        for layer, (mixer, ffn) in zip(params["layers"], kinds):
            if mixer == "mamba":
                assert layer["mixer"]["A_log"].dtype == torch.float32
                assert layer["mixer"]["w_in"].dtype == torch.bfloat16
                assert layer["mixer"]["conv_w"].dtype == torch.bfloat16
                assert layer["mixer"]["D"].dtype == torch.float32
            if ffn == "moe":
                assert layer["ffn"]["router"].dtype == torch.float32
                assert layer["ffn"]["w_gate"].dtype == torch.bfloat16
    layer = lm_params_from_numpy(tcfg, tree)["layers"][0]["mixer"]
    np.testing.assert_array_equal(layer["A_log"].numpy(),
                                  tree["body"]["0"]["mixer"]["A_log"][0])


def test_init_params_shapes_match_reference():
    jcfg, tcfg = tiny_pair(JAMBA)
    want = jax.eval_shape(
        lambda: jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    params = tregistry.init_params(tcfg, 0, device="cpu")
    for slot, layer in enumerate(params["layers"]):
        ref = want["body"][str(slot)]
        flat = jax.tree_util.tree_leaves_with_path(ref)
        got = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, layer))
        assert [p for p, _ in got] == [p for p, _ in flat], slot
        for (path, g), (_, w) in zip(got, flat):
            assert g.shape == w.shape[1:], (slot, path)


# ----------------------------------------------------------------- models --

@pytest.mark.parametrize("groups", [1, 2])
def test_jamba_matches_reference(groups):
    """forward (hidden and MoE aux), make_prefill (last-token logits and
    every layer's cache) and six decode steps with per-slot positions, at
    one and two groups of the period (two exercise the bridge's layer
    order)."""
    jcfg, tcfg = tiny_pair(JAMBA, n_layers=8 * groups)
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(tcfg, tree)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, size=(2, 12)).astype(np.int32)

    wx, _, waux = jlm.forward(jcfg, jp, jnp.asarray(toks))
    gx, _, gaux = tlm.forward(tcfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(gx), as_np(wx), **F32)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)

    wl, wc = jax_make_prefill(jcfg, dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(toks)})
    gl, gc = make_prefill(tcfg, dtype=torch.float32, device="cpu")(
        params, {"tokens": toks})
    np.testing.assert_allclose(as_np(gl), as_np(wl), **LOGITS)
    got_c = lm_caches_to_numpy(tcfg, gc)
    for path, w in jax.tree_util.tree_leaves_with_path(np_tree(wc)):
        g = got_c
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(g, w, err_msg=str(path), **F32)

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
    back = lm_caches_to_numpy(tcfg, tc)
    for path, w in jax.tree_util.tree_leaves_with_path(np_tree(jc)):
        g = back
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(g, w, err_msg=str(path), **F32)


def test_jamba_caches_cross_the_bridge():
    """The reference's Mamba caches (h float32, conv in the compute dtype)
    round-trip through lm_caches_from_numpy / lm_caches_to_numpy, in the
    shapes init_caches gives."""
    jcfg, tcfg = tiny_pair(JAMBA, n_layers=16)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        np_tree(jlm.init_caches(jcfg, 2, 8)))
    caches = lm_caches_from_numpy(tcfg, tree)
    fresh = tregistry.init_caches(tcfg, 2, 8, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in fresh] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in caches]
    back = lm_caches_to_numpy(tcfg, caches)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(tree)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_phi35_moe_forward_matches_reference():
    jcfg, tcfg = tiny_pair(PHI, n_layers=2)
    tree = perturbed(jregistry.init_params(jcfg, jax.random.PRNGKey(5)), 5)
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab, size=(2, 10)).astype(np.int32)
    wx, _, waux = jlm.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(toks))
    gx, _, gaux = tlm.forward(tcfg, lm_params_from_numpy(tcfg, tree),
                              torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(gx), as_np(wx), **F32)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
