"""The PyTorch port's serve path against the reference package's: the
continuous-batching loop on tiny qwen3-14b and tiny jamba with the
reference's weights carried across (same tokens, join steps and step
count), the request generator, and the round trips of the parameter and
cache bridges."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.interop import (  # noqa: E402
    lm_caches_from_numpy,
    lm_caches_to_numpy,
    lm_params_from_numpy,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.models import registry  # noqa: E402


def reference_requests(seed, vocab, requests, prompt_len, max_new):
    """The request draw of the reference server's ``main``
    (src/repro/launch/serve.py), as written there."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(max(2, prompt_len // 2), prompt_len + 1,
                         size=requests)
    news = rng.integers(max(2, max_new // 2), max_new + 1, size=requests)
    prompts = [rng.integers(1, vocab, size=(int(p),)).astype(np.int32)
               for p in plens]
    return prompts, [int(n) for n in news]


def test_requests_match_the_reference_draw():
    got = serve.make_requests(3, 256, 8, 16, 12)
    want = reference_requests(3, 256, 8, 16, 12)
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def qwen3_tiny():
    jcfg = JAX_ARCHS["qwen3-14b"].tiny()
    tcfg = get_config("qwen3-14b").tiny()
    tree = jax.tree.map(np.asarray,
                        jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


def test_serve_loop_matches_reference(qwen3_tiny):
    """8 requests of mixed lengths through 3 slots: identical generated
    tokens, join steps and step count."""
    jcfg, tcfg, tree = qwen3_tiny
    batch, max_seq = 3, 64
    prompts, news = serve.make_requests(0, tcfg.vocab, 8, 16, 20)
    want = jserve.serve_loop(
        jax.jit(jax_decode(jcfg, dtype=jnp.float32)),
        jax.tree.map(jnp.asarray, tree), jlm.init_caches(jcfg, batch, max_seq),
        prompts, news, batch, max_seq=max_seq)
    got = serve.serve_loop(
        make_decode_step(tcfg, dtype=torch.float32, device="cpu"),
        lm_params_from_numpy(tcfg, tree),
        registry.init_caches(tcfg, batch, max_seq, device="cpu"),
        prompts, news, batch, max_seq=max_seq)
    outputs, joined, steps = got
    assert steps == want[2]
    assert joined == want[1]
    assert outputs == want[0]
    assert len(set(joined)) > 2  # requests joined mid-run


@pytest.fixture(scope="module")
def jamba_tiny():
    jcfg = JAX_ARCHS["jamba-v0.1-52b"].tiny()
    tcfg = get_config("jamba-v0.1-52b").tiny()
    tree = jax.tree.map(np.asarray,
                        jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


def test_serve_loop_matches_reference_on_jamba(jamba_tiny):
    """Tiny jamba (Mamba + attention, dense + MoE): 7 requests through 3
    slots, so slots are reused; a reused slot carries the previous
    request's Mamba state in both servers (the reference resets only the
    position), and the tokens, join steps and step count agree."""
    jcfg, tcfg, tree = jamba_tiny
    batch, max_seq = 3, 64
    prompts, news = serve.make_requests(1, tcfg.vocab, 7, 12, 16)
    want = jserve.serve_loop(
        jax.jit(jax_decode(jcfg, dtype=jnp.float32)),
        jax.tree.map(jnp.asarray, tree), jlm.init_caches(jcfg, batch, max_seq),
        prompts, news, batch, max_seq=max_seq)
    got = serve.serve_loop(
        make_decode_step(tcfg, dtype=torch.float32, device="cpu"),
        lm_params_from_numpy(tcfg, tree),
        registry.init_caches(tcfg, batch, max_seq, device="cpu"),
        prompts, news, batch, max_seq=max_seq)
    outputs, joined, steps = got
    assert steps == want[2]
    assert joined == want[1]
    assert outputs == want[0]
    assert sum(j > 0 for j in joined) == len(prompts) - batch  # reuses


def test_serve_main_runs_jamba_on_the_cpu(capsys):
    serve.main(["--arch", "jamba-v0.1-52b", "--tiny", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 reqs through 2 slots" in out and "on cpu" in out


def test_serve_loop_guards_max_seq(qwen3_tiny):
    _, tcfg, tree = qwen3_tiny
    prompts, news = serve.make_requests(1, tcfg.vocab, 2, 8, 8)
    with pytest.raises(ValueError, match="overflows max_seq"):
        serve.serve_loop(
            make_decode_step(tcfg, dtype=torch.float32, device="cpu"),
            lm_params_from_numpy(tcfg, tree),
            registry.init_caches(tcfg, 2, 4, device="cpu"),
            prompts, news, 2, max_seq=4)


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "qwen3-14b", "--tiny", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 reqs through 2 slots" in out and "on cpu" in out


def test_param_bridge_keeps_every_leaf(qwen3_tiny):
    """Every reference leaf of a three-group model lands in the port's
    layer of its group: matrices cast to the compute dtype, norm scales
    kept float32."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=3) for c in qwen3_tiny[:2])
    tree = jax.tree.map(np.asarray,
                        jregistry.init_params(jcfg, jax.random.PRNGKey(1)))
    params = lm_params_from_numpy(tcfg, tree, dtype=torch.bfloat16)
    assert params["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["final_norm"]["scale"].numpy(),
                                  tree["final_norm"]["scale"])
    body = tree["body"]["0"]
    assert len(params["layers"]) == 3
    for g, layer in enumerate(params["layers"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(body):
            node = layer
            for k in path:
                node = node[k.key]
            want = np.asarray(leaf)[g]
            if want.ndim >= 2:
                assert node.dtype == torch.bfloat16, path
                want = torch.from_numpy(np.array(want)).to(torch.bfloat16)
                assert torch.equal(node, want), path
            else:
                assert node.dtype == torch.float32, path
                np.testing.assert_array_equal(node.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_cache_bridge_round_trip(qwen3_tiny, quant):
    jcfg, tcfg, _ = qwen3_tiny
    jcfg = dataclasses.replace(jcfg, kv_quant=quant, n_layers=3)
    tcfg = dataclasses.replace(tcfg, kv_quant=quant, n_layers=3)
    rng = np.random.default_rng(9)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 50).astype(a.dtype),
        jax.tree.map(np.asarray, jlm.init_caches(jcfg, 2, 8)))
    caches = lm_caches_from_numpy(tcfg, tree)
    assert len(caches) == tcfg.n_layers
    back = lm_caches_to_numpy(tcfg, caches)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_back] == [p for p, _ in flat]
    for (path, a), (_, b) in zip(flat_back, flat):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    fresh = registry.init_caches(tcfg, 2, 8, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in fresh] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in caches]
