"""K5 (decode attention) and K6 (flash attention) of the PyTorch port: the
plain versions against the reference package's jnp oracles and its Pallas
kernels in interpret mode, on the shapes of tests/test_kernels.py plus one
GQA group of 5 at D = 128 (qwen3-14b's heads), in float32 and bfloat16;
and the dispatch rules (a CPU tensor takes the plain version, the CUDA
wrappers take CUDA tensors only).

Tolerances: float32 1e-5 (the orders of summation differ), bfloat16 2e-2
(both sides round the float32 result to bfloat16 once).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode_attention,
)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    attention as jax_attention,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as k5_mod,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    gqa_attention_ref,
)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}

FLASH_SHAPES = [
    (1, 4, 128, 64, 4),    # b, hq, s, d, hkv: MHA
    (2, 8, 256, 64, 2),    # GQA group 4
    (1, 8, 256, 128, 8),
    (1, 10, 256, 128, 2),  # group 5, D 128 (qwen3-14b's heads)
]
DECODE_SHAPES = [
    (2, 8, 2, 512, 64),    # b, hq, hkv, s, d
    (1, 4, 4, 1024, 128),
    (4, 16, 2, 2048, 64),
    (3, 10, 2, 512, 128),  # group 5, D 128
]


def _both(x, dtype):
    """The same values as a torch and a jnp array of ``dtype``."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_reference(shape, causal, dtype):
    b, hq, s, d, hkv = shape
    rng = np.random.default_rng(42)
    q, jq = _both(rng.standard_normal((b, hq, s, d)).astype(np.float32),
                  dtype)
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    tol = DTYPES[dtype][2]
    got = attention(q, k, v, causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    ref = jax_attention(jq, jk, jv, causal, False)
    pal = jax_attention(jq, jk, jv, causal, True, True)
    for want in (ref, pal):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _kv_lens(rng, b, s):
    """Random lengths in [1, S] with 1 and S both present (over the two
    draws when B = 1)."""
    lens = rng.integers(1, s + 1, size=(2, b)).astype(np.int32)
    lens[0, 0] = 1
    lens[1, -1] = s
    return lens


@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_reference(shape, dtype):
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(7)
    q, jq = _both(rng.standard_normal((b, hq, d)).astype(np.float32), dtype)
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    tol = DTYPES[dtype][2]
    for lens in _kv_lens(rng, b, s):
        got = decode_attention(q, k, v, torch.from_numpy(lens))
        assert got.dtype == q.dtype and got.shape == q.shape
        jl = jnp.asarray(lens)
        ref = jax_decode_attention(jq, jk, jv, jl, False)
        pal = jax_decode_attention(jq, jk, jv, jl, True, True)
        for want in (ref, pal):
            np.testing.assert_allclose(_np(got), _np(want), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_lengths_match_the_reference(dtype):
    """A sequence or cache length that is no multiple of a block (the
    Pallas wrappers refuse it, their jnp oracles and the port take it)."""
    rng = np.random.default_rng(11)
    tol = DTYPES[dtype][2]
    b, hq, s, d, hkv = 1, 10, 200, 128, 2
    q, jq = _both(rng.standard_normal((b, hq, s, d)).astype(np.float32),
                  dtype)
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    got = attention(q, k, k, True)
    np.testing.assert_allclose(_np(got), _np(jax_attention(jq, jk, jk, True,
                                                           False)),
                               atol=tol, rtol=tol)
    b, hq, hkv, s, d = 2, 10, 2, 600, 128
    q, jq = _both(rng.standard_normal((b, hq, d)).astype(np.float32), dtype)
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    lens = np.array([1, s], np.int32)
    got = decode_attention(q, k, k, torch.from_numpy(lens))
    want = jax_decode_attention(jq, jk, jk, jnp.asarray(lens), False)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_decode_full_cache_when_no_length():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 64, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 64, 16)).astype(
        np.float32))
    full = torch.full((2,), 64, dtype=torch.int32)
    np.testing.assert_array_equal(decode_attention(q, k, v).numpy(),
                                  decode_attention(q, k, v, full).numpy())


def test_masks_follow_the_reference_constants():
    """The flash oracle masks with -inf and the decode oracle with -1e30;
    neither gives NaN on a row whose only key is its own position."""
    q = torch.ones((1, 1, 1, 16))
    k = torch.ones((1, 1, 1, 16))
    v = torch.full((1, 1, 1, 16), 3.0)
    out = gqa_attention_ref(q, k, v, causal=True)
    assert torch.equal(out, v)
    qd = torch.ones((1, 2, 16))
    kd = torch.zeros((1, 1, 8, 16))
    vd = torch.arange(8, dtype=torch.float32)[None, None, :, None].expand(
        1, 1, 8, 16).contiguous()
    one = torch.tensor([1], dtype=torch.int32)
    out = decode_attention_ref(qd, kd, vd, one)
    assert torch.equal(out, torch.zeros((1, 2, 16)))


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype(
        np.float32))
    before = dict(build.LAUNCHES)
    assert torch.equal(attention(q, k, k, True),
                       gqa_attention_ref(q, k, k, True))
    lens = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, :, 0], k, k, lens),
                       decode_attention_ref(q[:, :, 0], k, k, lens))
    assert build.LAUNCHES == before


def test_cuda_wrappers_reject_cpu_tensors():
    q = torch.zeros((1, 4, 64, 16))
    k = torch.zeros((1, 2, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, k, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k5_mod.decode_attention_cuda(q[:, :, 0], k, k,
                                     torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="not supported"):
        flash_attention_cuda(q.double(), k.double(), k.double())


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        attention(torch.zeros((1, 4, 64, 16), device="cuda"),
                  torch.zeros((1, 2, 64, 16), device="cuda"),
                  torch.zeros((1, 2, 64, 16), device="cuda"))


@pytest.mark.parametrize("pairs,s,chunk", [
    (32, 256, 32),      # the serving shape: B = 4 slots x 8 kv heads
    (32, 4096, 256),    # a long cache: 16 splits
    (1, 64, 32),
    (2, 100_000, 256),
])
def test_split_chunk_fills_the_card(pairs, s, chunk):
    got = k5_mod.split_chunk(pairs, s)
    assert got == chunk and got % k5_mod.TILE == 0
