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
    (32, 256, 256),      # the serving shape: B = 4 slots x 8 kv heads
    (32, 4096, 1024),    # a long cache: 4 splits, 128 CTAs
    (1, 64, 64),         # never longer than the cache
    (2, 100_000, 1536),  # 66 splits, 132 CTAs
])
def test_split_chunk_fills_the_card(pairs, s, chunk):
    got = k5_mod.split_chunk(pairs, s)
    assert got == chunk and got % k5_mod.TILE == 0


@pytest.mark.parametrize("b,hkv,g,s,plan", [
    (4, 8, 5, 256, (2, 256)),    # qwen3 served: 1 split, 3 CTAs per group
    (4, 8, 5, 4096, (5, 1024)),  # qwen3 at a long cache: the whole group
    (4, 8, 4, 256, (2, 256)),    # jamba served: 2 CTAs per group
    (4, 8, 5, 512, (4, 256)),    # 2 splits: 2 CTAs per group reach 128
])
def test_split_plan_fills_the_card(b, hkv, g, s, plan):
    gc, chunk = k5_mod.split_plan(b, hkv, g, s)
    assert (gc, chunk) == plan and gc in k5_mod.HEAD_SLOTS
    # at least 96 CTAs, unless a CTA is down to 2 heads already
    assert b * hkv * -(-g // gc) * -(-s // chunk) >= 96 or gc == 2


# ------------------------------------------------------------------------
# The redesigned kernels' rounding points, mirrored in plain PyTorch and
# held to the Pallas kernels in interpret mode (the kernels themselves run
# only on the card; chip_smoke.py holds them to their plain versions).

LOG2E = 1.4426950408889634


def _tc_flash_mirror(q, k, v, causal, block_q=128, block_n=128):
    """K6's tensor-core path (bfloat16, D in {64, 128}): bf16 Q and K
    multiplied with float32 accumulation, the scale (times log2 e) applied
    to the float32 scores, an online softmax in float32 over 128-row KV
    tiles (tiles above the causal diagonal skipped, -1e30 masks), P rounded
    to bf16 before P V, l summing the unrounded P, float32 accumulation and
    one final rounding to bf16."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d) * LOG2E)
    kx = k.repeat_interleave(g, dim=1).float()
    vx = v.repeat_interleave(g, dim=1).float()
    out = torch.empty((b, hq, s, d), dtype=torch.float32)
    for q0 in range(0, s, block_q):
        qt = q[:, :, q0:q0 + block_q].float()
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        o = torch.zeros(qt.shape)
        kv_end = min(s, q0 + block_q) if causal else s
        for k0 in range(0, kv_end, block_n):
            kt, vt = kx[:, :, k0:k0 + block_n], vx[:, :, k0:k0 + block_n]
            x = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            if causal:
                x = x.masked_fill(cols > rows, -1e30)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt)
            m = mx
        out[:, :, q0:q0 + block_q] = o / l.clamp_min(1e-30)[..., None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_flash_rounding_matches_pallas(shape, causal):
    b, hq, s, d, hkv = shape
    rng = np.random.default_rng(42)
    q, jq = _both(rng.standard_normal((b, hq, s, d)).astype(np.float32),
                  "bfloat16")
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  "bfloat16")
    v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  "bfloat16")
    got = _tc_flash_mirror(q, k, v, causal)
    pal = jax_attention(jq, jk, jv, causal, True, True)
    np.testing.assert_allclose(_np(got), _np(pal), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_flash_rounding_peaked_logits(causal):
    """q scaled so the logits span about +-30: P is near one-hot, where a
    bf16 P rounds its largest entries."""
    b, hq, s, d, hkv = 1, 10, 256, 128, 2
    rng = np.random.default_rng(8)
    qn = 8 * rng.standard_normal((b, hq, s, d)).astype(np.float32)
    q, jq = _both(qn, "bfloat16")
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  "bfloat16")
    v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  "bfloat16")
    logits = torch.einsum("bhsd,bhtd->bhst", q[:, ::hq // hkv].float(),
                          k.float()) / np.sqrt(d)
    assert 20 < float(logits.abs().max()) < 60
    got = _tc_flash_mirror(q, k, v, causal)
    pal = jax_attention(jq, jk, jv, causal, True, True)
    np.testing.assert_allclose(_np(got), _np(pal), atol=2e-2, rtol=2e-2)


def test_tensor_core_flash_rounding_ragged():
    """S = 200: a ragged last q block and KV tile (the Pallas wrapper
    refuses it; its jnp oracle takes it)."""
    b, hq, s, d, hkv = 1, 10, 200, 128, 2
    rng = np.random.default_rng(11)
    q, jq = _both(rng.standard_normal((b, hq, s, d)).astype(np.float32),
                  "bfloat16")
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  "bfloat16")
    got = _tc_flash_mirror(q, k, k, True)
    want = jax_attention(jq, jk, jk, True, False)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def _k5_mirror(q, k, v, kv_len, chunk, tile=32, threads=128):
    """K5's arithmetic: the cache cut into splits of ``chunk`` positions;
    inside a split, teams of D * size / 16 lanes (at most 32) each take
    every n_teams-th position of a 32-position tile and run their own
    float32 online softmax in the log2 domain (q scaled by log2 e / sqrt(D),
    p = 2^(s - m), p = 0 on masked positions); the teams' partials merge,
    then the splits' (2^(m_i - M) weights), then one rounding to q's dtype.
    kv_len = 0 gives 0."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    chunks = d * q.element_size() // 16
    n_teams = threads // min(chunks, 32)
    scale = np.float32(1.0 / np.sqrt(d) * LOG2E)  # the softmax runs on 2^x
    qf = q.float().reshape(b, hkv, g, d) * scale
    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        n = max(0, min(int(kv_len[bi]), s))
        parts = []
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            m = torch.full((hkv, g, n_teams), -1e30)
            l = torch.zeros((hkv, g, n_teams))
            acc = torch.zeros((hkv, g, n_teams, d))
            for t0 in range(start, end, tile):
                pos = t0 + torch.arange(tile)
                ok = pos < end
                rows = torch.where(ok, pos, 0)
                kt = k[bi, :, rows].float()  # [hkv, tile, d]
                vt = v[bi, :, rows].float() * ok[None, :, None]
                x = torch.einsum("hgd,htd->hgt", qf[bi], kt)
                x = torch.where(ok, x, torch.tensor(-1e30))
                team = torch.arange(tile) % n_teams
                for tm in range(min(n_teams, tile)):
                    sel = team == tm
                    mx = torch.maximum(m[..., tm], x[..., sel].amax(-1))
                    alpha = torch.exp2(m[..., tm] - mx)
                    p = torch.where(ok[sel], torch.exp2(x[..., sel]
                                                        - mx[..., None]), 0.)
                    l[..., tm] = l[..., tm] * alpha + p.sum(-1)
                    acc[..., tm, :] = acc[..., tm, :] * alpha[..., None] \
                        + torch.einsum("hgt,htd->hgd", p, vt[:, sel])
                    m[..., tm] = mx
            mt = m.amax(-1)
            w = torch.exp2(m - mt[..., None])
            parts.append((mt, (l * w).sum(-1),
                          (acc * w[..., None]).sum(-2)))
        if parts:
            mm = torch.stack([p[0] for p in parts])
            w = torch.exp2(mm - mm.amax(0))
            lsum = (torch.stack([p[1] for p in parts]) * w).sum(0)
            asum = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0)
            out[bi] = asum / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_split_merge_matches_pallas(shape, dtype):
    """Several splits of 32 or 64 positions, kv_len 1 and S among the
    lengths."""
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(7)
    q, jq = _both(rng.standard_normal((b, hq, d)).astype(np.float32), dtype)
    k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(np.float32),
                  dtype)
    tol = DTYPES[dtype][2]
    for lens, chunk in zip(_kv_lens(rng, b, s), (32, 64)):
        got = _k5_mirror(q, k, v, lens, chunk)
        pal = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), True, True)
        np.testing.assert_allclose(_np(got), _np(pal), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_split_merge_ragged_and_peaked(dtype):
    """A ragged S = 600 (no multiple of a tile or a split), lengths 1, S
    and a split boundary plus one, and q scaled so the logits span about
    +-30."""
    b, hq, hkv, s, d = 3, 10, 2, 600, 128
    rng = np.random.default_rng(13)
    tol = DTYPES[dtype][2]
    for qscale in (1.0, 8.0):
        qn = qscale * rng.standard_normal((b, hq, d)).astype(np.float32)
        q, jq = _both(qn, dtype)
        k, jk = _both(rng.standard_normal((b, hkv, s, d)).astype(
            np.float32), dtype)
        v, jv = _both(rng.standard_normal((b, hkv, s, d)).astype(
            np.float32), dtype)
        lens = np.array([1, s, 97], np.int32)
        got = _k5_mirror(q, k, v, lens, 96)
        want = jax_decode_attention(jq, jk, jv, jnp.asarray(lens), False)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_decode_mirror_gives_zero_without_a_cache():
    q = torch.ones((2, 4, 16))
    k = torch.ones((2, 2, 64, 16))
    got = _k5_mirror(q, k, k, np.array([0, 3], np.int32), 32)
    assert torch.equal(got[0], torch.zeros((4, 16)))
    assert torch.equal(got[1], torch.ones((4, 16)))


@pytest.mark.parametrize("g,gc,ctas", [
    (1, 1, 1), (4, 4, 1),  # MHA; jamba's 32/8
    (5, 5, 1),             # qwen3-14b's 40/8
    (9, 8, 2),             # starcoder2's 36/4: two CTAs per split
])
def test_heads_per_cta(g, gc, ctas):
    assert k5_mod.heads_per_cta(g) == gc
    assert -(-g // gc) == ctas
