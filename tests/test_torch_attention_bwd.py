"""K6's backward, tensor-core form (bfloat16 at the base forms' D 64 or
128, and at the general form's (Dqk, Dv) in (64, 64), (128, 128), (192,
128) with Sq != Sk and the caller's scale): its rounding points mirrored
in plain PyTorch and held to ``jax.vjp`` of the reference's
``blocked_attention`` on the same numpy-seeded inputs.

The kernel itself runs only on the card (``chip_smoke.py`` phase 17(a)
holds it to autograd through its plain version); this file pins down that
its arithmetic order -- S and dP in float32 from bf16 operands, P from the
forward's LSE in the log2 domain, P^T and dS^T rounded to bf16 before the
three gradient products, float32 accumulation over 64-row tiles, one
final rounding -- stays within the card's bf16 gate: 2e-2 x max
|reference| (bf16 P and dS carry 8 bits; the rest is float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.blocked_attention import blocked_attention  # noqa: E402

LOG2E = 1.4426950408889634
TILE = 64  # rows of every tile of the tensor-core backward
TOL = 2e-2
BF16 = torch.bfloat16


def _bf16(x):
    return x.to(BF16).float()


def _probs(s, dp, lse2, dl, scale_log2, live):
    """P and dS of one tile in float32 from S, dP and the rows' log2 LSE
    and Dl (broadcast along the tile's query axis); zero where not live."""
    p = torch.where(live, torch.exp2(s * scale_log2 - lse2), 0.0)
    return p, p * (dp - dl)


def _tc_backward_mirror(q, k, v, o, lse, do, causal, scale=None):
    """(dq, dk, dv) in bf16 as the tensor-core backward computes them, at
    (Dqk, Dv) with Sq and Sk apart and the forward's scale (1/sqrt(Dqk) by
    default): Dl = rowsum(dO O) and LSE log2 e in float32; dK/dV one 64-key
    block at a time over the group's q heads and the query tiles from the
    diagonal on (S^T = K Q^T, dP^T = V dO^T, dV += bf16(P^T) dO, dK +=
    bf16(dS^T) Q); dQ one 64-row block at a time over the key tiles up to
    the diagonal (dQ += bf16(dS) K); dK and dQ scaled once, every output
    rounded once. Splitting dK's columns over two warpgroups and dQ's
    128-row blocks into two 64-row halves, as the kernels do at (192, 128),
    changes no sum."""
    b, hq, sq, dqk = q.shape
    hkv, sk, dvw = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = np.float32(1.0 / np.sqrt(dqk) if scale is None else scale)
    scale_log2 = np.float32(scale * LOG2E)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dl = (dof * o.float()).sum(-1)                  # [b, hq, sq]
    lse2 = lse * np.float32(LOG2E)
    qpos, kpos = torch.arange(sq), torch.arange(sk)

    dk = torch.zeros((b, hkv, sk, dqk))
    dv = torch.zeros((b, hkv, sk, dvw))
    qg = qf.reshape(b, hkv, g, sq, dqk)
    dog = dof.reshape(b, hkv, g, sq, dvw)
    dlg = dl.reshape(b, hkv, g, sq)
    lseg = lse2.reshape(b, hkv, g, sq)
    for k0 in range(0, sk, TILE):
        kt, vt = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        keys = kpos[k0:k0 + TILE][:, None]
        acc_k = torch.zeros(kt.shape)
        acc_v = torch.zeros(vt.shape)
        for gi in range(g):
            for q0 in range(k0 if causal else 0, sq, TILE):
                qt = qg[:, :, gi, q0:q0 + TILE]
                dot = dog[:, :, gi, q0:q0 + TILE]
                rows = qpos[q0:q0 + TILE][None, :]
                live = ~(keys > rows) if causal else torch.ones(
                    keys.shape[0], rows.shape[1], dtype=torch.bool)
                st = torch.einsum("bhkd,bhqd->bhkq", kt, qt)
                dpt = torch.einsum("bhkd,bhqd->bhkq", vt, dot)
                pt, dst = _probs(st, dpt,
                                 lseg[:, :, gi, None, q0:q0 + TILE],
                                 dlg[:, :, gi, None, q0:q0 + TILE],
                                 scale_log2, live)
                acc_v += torch.einsum("bhkq,bhqd->bhkd", _bf16(pt), dot)
                acc_k += torch.einsum("bhkq,bhqd->bhkd", _bf16(dst), qt)
        dk[:, :, k0:k0 + TILE] = acc_k * scale
        dv[:, :, k0:k0 + TILE] = acc_v

    dq = torch.zeros((b, hq, sq, dqk))
    kx = kf.repeat_interleave(g, dim=1)
    vx = vf.repeat_interleave(g, dim=1)
    for q0 in range(0, sq, TILE):
        qt, dot = qf[:, :, q0:q0 + TILE], dof[:, :, q0:q0 + TILE]
        rows = qpos[q0:q0 + TILE][:, None]
        acc = torch.zeros(qt.shape)
        kv_end = min(sk, q0 + TILE) if causal else sk
        for k0 in range(0, kv_end, TILE):
            kt, vt = kx[:, :, k0:k0 + TILE], vx[:, :, k0:k0 + TILE]
            keys = kpos[k0:k0 + TILE][None, :]
            live = ~(keys > rows) if causal else torch.ones(
                rows.shape[0], keys.shape[1], dtype=torch.bool)
            sc = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
            dp = torch.einsum("bhqd,bhkd->bhqk", dot, vt)
            _, ds = _probs(sc, dp, lse2[:, :, q0:q0 + TILE, None],
                           dl[:, :, q0:q0 + TILE, None], scale_log2, live)
            acc += torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), kt)
        dq[:, :, q0:q0 + TILE] = acc * scale
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _forward(q, k, v, causal, scale=None):
    """What K6's forward hands the backward: the output rounded to bf16
    and each row's float32 log-sum-exp of its logits times ``scale``
    (1/sqrt(Dqk) by default)."""
    sq, dqk = q.shape[2:]
    sk = k.shape[2]
    g = q.shape[1] // k.shape[1]
    scale = 1.0 / np.sqrt(dqk) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float().repeat_interleave(g, dim=1)) * scale
    if causal:
        logits = logits.masked_fill(
            ~torch.ones((sq, sk), dtype=torch.bool).tril(), float("-inf"))
    lse = torch.logsumexp(logits, -1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p,
                     v.float().repeat_interleave(g, dim=1))
    return o.to(BF16), lse


def _reference_grads(q, k, v, do, causal, scale=None):
    """jax.vjp of the reference's blocked attention at the bf16 inputs'
    values, in float32, with the same ``scale``."""
    qj, kj, vj, doj = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: blocked_attention(
        a, b_, c, causal=causal, scale=scale), qj, kj, vj)
    return [np.asarray(x) for x in vjp(doj)]


CASES = [  # b, hq, hkv, s, d, causal, q scale
    (1, 2, 2, 200, 64, True, 1.0),    # G 1, ragged S
    (1, 2, 2, 200, 64, False, 1.0),
    (1, 5, 1, 200, 128, True, 1.0),   # G 5 (qwen3-14b's group), D 128
    (1, 5, 1, 200, 128, False, 1.0),
    (2, 10, 2, 128, 64, True, 1.0),   # G 5, D 64, S a multiple of 64
    (1, 5, 1, 130, 128, True, 8.0),   # peaked logits: bf16 P rounds its
    (1, 2, 2, 130, 64, False, 8.0),   # largest entries
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "b{}h{}kv{}s{}d{}{}x{:g}".format(
                             c[0], c[1], c[2], c[3], c[4],
                             "c" if c[5] else "n", c[6]))
def test_tensor_core_backward_rounding_matches_reference(case):
    b, hq, hkv, s, d, causal, qscale = case
    rng = np.random.default_rng(24)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((b, h, s, d)).astype(np.float32)).to(BF16)
        for h in (hq, hkv, hkv, hq))
    q = (q.float() * qscale).to(BF16)
    if qscale > 1:
        logits = torch.einsum("bhsd,bhtd->bhst", q[:, ::hq // hkv].float(),
                              k.float()) / np.sqrt(d)
        assert 20 < float(logits.abs().max()) < 80
    o, lse = _forward(q, k, v, causal)
    got = _tc_backward_mirror(q, k, v, o, lse, do, causal)
    want = _reference_grads(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float(np.abs(g.float().numpy() - w).max())
        gate = TOL * float(np.abs(w).max())
        assert err <= gate, f"{name}: max abs err {err} > {gate}"


#: the general form's tensor-core backward (bf16 at a pair of ``TC_DIMS``,
#: Sq and Sk apart, the caller's scale): b, hq, hkv, sq, sk, dqk, dv,
#: causal, scale (None: 1/sqrt(dqk)). MLA's widths causal over a ragged
#: length (two warpgroups split dK's columns; dQ's 128-row blocks), equal
#: widths across Sq != Sk, and MLA's widths in a group of 4 across Sq != Sk
#: with a scale of its own. Lengths stay under the reference's 512-row
#: blocks (it needs Sk % min(512, Sk) == 0).
GEN_CASES = [
    (1, 2, 2, 130, 130, 192, 128, True, None),
    (1, 2, 2, 40, 97, 64, 64, False, None),
    (1, 4, 1, 70, 133, 192, 128, False, 0.3),
]


@pytest.mark.parametrize("case", GEN_CASES,
                         ids=lambda c: "b{}h{}kv{}q{}k{}d{}-{}{}s{}".format(
                             *c[:7], "c" if c[7] else "n",
                             "def" if c[8] is None else c[8]))
def test_general_tensor_core_backward_rounding_matches_reference(case):
    """The general form's tensor-core backward's rounding points, mirrored
    at (Dqk, Dv) with Sq != Sk and an explicit scale, against ``jax.vjp``
    of the reference's ``blocked_attention`` called with the same scale;
    gate 2e-2 x max |reference| (``TOL``), as the card's bf16 gate."""
    b, hq, hkv, sq, sk, dqk, dv, causal, scale = case
    rng = np.random.default_rng(28)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(BF16)
        for shape in ((b, hq, sq, dqk), (b, hkv, sk, dqk), (b, hkv, sk, dv),
                      (b, hq, sq, dv)))
    o, lse = _forward(q, k, v, causal, scale)
    got = _tc_backward_mirror(q, k, v, o, lse, do, causal, scale)
    want = _reference_grads(q, k, v, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g.float().numpy() - w).max())
        gate = TOL * float(np.abs(w).max())
        assert err <= gate, f"{name}: max abs err {err} > {gate}"
