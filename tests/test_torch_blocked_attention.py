"""The port's ``blocked_attention`` and K6's general-shape plain version
(``gqa_attention_ref``) against the reference's jnp ``blocked_attention``:
GQA, a query/key width apart from the value width (MLA), a key length
apart from the query length (cross-attention, not causal), causal, an
explicit scale, the reference in blocks smaller than the sequence (its
online-softmax recurrence over several blocks), and lengths that are no
multiple of a block (which the port takes in one call); the general
form's gradients (autograd through the plain version against ``jax.vjp``
of the reference's); then the shape rules of K6's wrapper, the kernel the
wrapper picks for each shape and dtype (the tensor-core or the FMA general
form, or a base form) with the lengths, widths and scale it passes on, and
the backward entry point of each form that ``FlashAttention`` calls.

Tolerance: float32 1e-5 (the same softmax in another summation order);
bfloat16 2e-2, as K6's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.blocked_attention import (  # noqa: E402
    blocked_attention as jax_blocked,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as k6,
)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    gqa_attention_ref,
)
from repro_torch.models.blocked_attention import (  # noqa: E402
    blocked_attention,
)

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)

#: (B, Hq, Hkv, Sq, Sk, Dqk, Dv, causal, scale, the reference's blocks,
#: seed). The "blocks" cases run the reference in blocks of 16 queries and
#: 32 keys over S = 64, so its recurrence carries (m, l, acc) across key
#: blocks; the "ragged" ones have lengths no block of 16 or 32 divides.
CASES = {
    "gqa_causal": (2, 4, 2, 64, 64, 16, 16, True, None, {}, 0),
    "gqa_full": (2, 4, 2, 48, 48, 32, 32, False, None, {}, 0),
    "mla_causal": (2, 4, 4, 32, 32, 24, 16, True, 24 ** -0.5, {}, 0),
    "mla_wide": (1, 2, 2, 64, 64, 192, 128, True, 192 ** -0.5, {}, 0),
    "cross": (2, 4, 2, 8, 96, 16, 16, False, None, {}, 0),
    "cross_mla_widths": (1, 4, 1, 16, 40, 24, 16, False, None, {}, 0),
    "scale": (1, 4, 4, 32, 32, 16, 16, True, 0.3, {}, 0),
    "blocks_causal": (2, 4, 2, 64, 64, 24, 16, True, None,
                      dict(block_q=16, block_k=32), 1),
    "blocks_full": (2, 4, 2, 64, 64, 24, 16, False, None,
                    dict(block_q=16, block_k=32), 1),
    "ragged_cross": (1, 4, 2, 50, 70, 16, 16, False, None, {}, 2),
    "ragged_causal": (1, 4, 2, 50, 50, 24, 16, True, None, {}, 3),
}


def inputs(b, hq, hkv, sq, sk, dqk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dqk)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dqk)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, dv)).astype(np.float32))


def jax_out(q, k, v, causal, scale, **blocks):
    return np.asarray(jax_blocked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  scale=scale, **blocks))


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_attention_matches_reference(case):
    b, hq, hkv, sq, sk, dqk, dv, causal, scale, blocks, seed = CASES[case]
    q, k, v = inputs(b, hq, hkv, sq, sk, dqk, dv, seed)
    want = jax_out(q, k, v, causal, scale, **blocks)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = blocked_attention(tq, tk, tv, causal=causal, scale=scale)
    assert got.shape == (b, hq, sq, dv)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # K6's plain version and its entry point (a CPU tensor) agree too
    np.testing.assert_allclose(
        gqa_attention_ref(tq, tk, tv, causal, scale).numpy(), want, **F32)
    np.testing.assert_allclose(attention(tq, tk, tv, causal, scale).numpy(),
                               want, **F32)


#: the general form's gradients: (B, Hq, Hkv, Sq, Sk, Dqk, Dv, causal,
#: scale): MLA's tiny widths causal, a GQA cross-attention (Sq != Sk), MLA's
#: widths across Sq != Sk, another scale
GRAD_CASES = {
    "mla_causal": (2, 4, 4, 24, 24, 24, 16, True, None),
    "cross": (2, 4, 2, 8, 40, 16, 16, False, None),
    "cross_mla_widths": (1, 4, 1, 16, 40, 24, 16, False, None),
    "scale": (1, 4, 4, 32, 32, 16, 16, True, 0.3),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_general_form_gradients_match_reference(case):
    """Autograd through ``gqa_attention_ref`` (the plain version of K6's
    general backward, which the card's kernels are held to) against
    ``jax.vjp`` of the reference's ``blocked_attention`` (in blocks of 8
    queries and 8 keys, so its recurrence crosses blocks), dq, dk and dv
    within 1e-5 x the gradient's max |value|, float32."""
    import jax

    b, hq, hkv, sq, sk, dqk, dv, causal, scale = GRAD_CASES[case]
    q, k, v = inputs(b, hq, hkv, sq, sk, dqk, dv, seed=5)
    do = np.random.default_rng(6).standard_normal(
        (b, hq, sq, dv)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_blocked(
        q, k, v, causal=causal, scale=scale, block_q=8, block_k=8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(gqa_attention_ref(tq, tk, tv, causal, scale),
                              (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_bfloat16_matches_reference():
    q, k, v = inputs(2, 4, 4, 32, 32, 24, 16, seed=4)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jax_out(*(np.asarray(t.float()) for t in tb), True, None)
    got = blocked_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_causal_needs_equal_lengths():
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 2, 2, 8, 16, 16, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        gqa_attention_ref(q, k, v, True)


class _Recorder:
    """Stands in for K6's loaded library: records each entry point called
    with its arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("flash_attention"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def test_k6_wrapper_refuses_shapes_no_form_takes(monkeypatch):
    """With the device check bypassed, the wrapper's shape rules raise
    before anything is built: a (Dqk, Dv) pair with no form, causal with
    Sq != Sk. Then, with the library replaced by a recorder, the backward
    of ``FlashAttention`` on each general shape (MLA's tiny widths, Sq !=
    Sk, another scale) calls the general backward entry point once with
    (Sq, Sk, Dqk, Dv) and the forward's scale, and counts it under
    ``k6bwd_gen``."""
    monkeypatch.setattr(build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(build, "load", lambda: pytest.fail("built"))
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 2, 2, 8, 8, 48, 32))
    with pytest.raises(ValueError, match="not one of K6's forms"):
        k6.flash_attention_cuda(q, k, v, False)
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 2, 2, 8, 16, 16, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        k6.flash_attention_cuda(q, k, v, True)
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda: {
        "flash_attention": lib, "flash_attention_bwd": lib})
    monkeypatch.setattr(build, "stream_of", lambda t: 7)
    for shapes, causal, scale in (((1, 2, 2, 8, 8, 24, 16), True, None),
                                  ((1, 4, 2, 8, 16, 16, 16), False, None),
                                  ((1, 2, 2, 8, 8, 16, 16), False, 0.5)):
        monkeypatch.setattr(build, "LAUNCHES",
                            dict.fromkeys(build.LAUNCHES, 0))
        lib.calls.clear()
        b, hq, hkv, sq, sk, dqk, dv = shapes
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in inputs(*shapes))
        out = k6.FlashAttention.apply(q, k, v, causal, scale)
        out.sum().backward()
        assert [c[0] for c in lib.calls] == [
            "flash_attention_gen_launch", "flash_attention_bwd_gen_launch"]
        assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0),
                                  "k6gen": 1, "k6bwd_gen": 1}
        assert q.grad.shape == q.shape and k.grad.shape == k.shape \
            and v.grad.shape == v.shape
        args = lib.calls[1][1]
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[10:19] == (b, hq, hkv, sq, sk, dqk, dv, int(causal), 0)
        want = 1.0 / math.sqrt(dqk) if scale is None else scale
        assert args[19] == want and args[20] == 7


#: (dtype, shapes as in ``inputs``, causal, scale) -> (entry point, the
#: LAUNCHES key it bumps)
FORMS = {
    "tc_mla_causal": ("bfloat16", (1, 2, 2, 256, 256, 192, 128), True,
                      192 ** -0.5, "tc"),
    "tc_cross_64": ("bfloat16", (1, 2, 2, 256, 1000, 64, 64), False, None,
                    "tc"),
    "tc_cross_128": ("bfloat16", (1, 4, 2, 40, 97, 128, 128), False, 0.3,
                     "tc"),
    "fma_mla_causal": ("float32", (1, 2, 2, 256, 256, 192, 128), True,
                       192 ** -0.5, "fma"),
    "fma_cross_64": ("float32", (1, 2, 2, 256, 1000, 64, 64), False, None,
                     "fma"),
    "fma_cross_128": ("float32", (1, 4, 2, 40, 97, 128, 128), False, 0.3,
                      "fma"),
    "fma_tiny_mla_bf16": ("bfloat16", (1, 2, 2, 24, 24, 24, 16), True, None,
                          "fma"),
    "base_bf16": ("bfloat16", (1, 4, 2, 64, 64, 64, 64), True, None, "base"),
}
ENTRY = {"tc": ("flash_attention_gen_tc_launch", "k6gen_tc"),
         "fma": ("flash_attention_gen_launch", "k6gen"),
         "base": ("flash_attention_launch", "k6")}


@pytest.mark.parametrize("case", list(FORMS))
def test_k6_wrapper_picks_the_form(monkeypatch, case):
    """With the device check bypassed and the library replaced by a
    recorder, the wrapper calls the kernel :func:`general_form` names for
    the dtype and (Dqk, Dv) (a base shape the base entry point), passes
    Sq, Sk, the widths and the caller's scale on unchanged, and bumps that
    kernel's count and no other."""
    name, shapes, causal, scale, form = FORMS[case]
    dt = getattr(torch, name)
    b, hq, hkv, sq, sk, dqk, dv = shapes
    lib = _Recorder()
    monkeypatch.setattr(build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(build, "load", lambda: {"flash_attention": lib})
    monkeypatch.setattr(build, "stream_of", lambda t: 7)
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    q, k, v = (torch.from_numpy(a).to(dt) for a in inputs(*shapes))
    out = k6.flash_attention_cuda(q, k, v, causal, scale=scale)
    entry, key = ENTRY[form]
    assert [c[0] for c in lib.calls] == [entry]
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0), key: 1}
    assert out.shape == (b, hq, sq, dv) and out.dtype == dt
    args = lib.calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr()) and args[4] is None and args[-1] == 7
    if form == "base":
        assert args[5:12] == (b, hq, hkv, sq, dqk, int(causal), 1)
        return
    assert args[5:13] == (b, hq, hkv, sq, sk, dqk, dv, int(causal))
    assert k6.general_form(dt, dqk, dv) == form
    want = 1.0 / math.sqrt(dqk) if scale is None else scale
    assert args[-2] == want
    if form == "fma":
        assert args[13] == k6.DTYPES[dt]


#: the backward's entry point and LAUNCHES key for each form of ``FORMS``
BWD_ENTRY = {"tc": ("flash_attention_bwd_gen_tc_launch", "k6bwd_gen_tc"),
             "fma": ("flash_attention_bwd_gen_launch", "k6bwd_gen"),
             "base": ("flash_attention_bwd_launch", "k6bwd")}


@pytest.mark.parametrize("case", list(FORMS))
def test_k6_backward_picks_the_form(monkeypatch, case):
    """With the device check bypassed and the library replaced by a
    recorder, the backward of ``FlashAttention`` calls the backward entry
    point of the forward's form once: the general tensor-core one for bf16
    at a pair of ``TC_DIMS``, the general FMA one for float32 and the small
    widths, the base one for a base shape; it passes (Sq, Sk, Dqk, Dv,
    causal) and the forward's scale on unchanged and bumps that kernel's
    count and no other backward's."""
    name, shapes, causal, scale, form = FORMS[case]
    dt = getattr(torch, name)
    b, hq, hkv, sq, sk, dqk, dv = shapes
    lib = _Recorder()
    monkeypatch.setattr(build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(build, "load", lambda: {
        "flash_attention": lib, "flash_attention_bwd": lib})
    monkeypatch.setattr(build, "stream_of", lambda t: 7)
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    q, k, v = (torch.from_numpy(a).to(dt).requires_grad_()
               for a in inputs(*shapes))
    k6.FlashAttention.apply(q, k, v, causal, scale).sum().backward()
    entry, key = BWD_ENTRY[form]
    assert [c[0] for c in lib.calls] == [ENTRY[form][0], entry]
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0),
                              ENTRY[form][1]: 1, key: 1}
    assert q.grad.shape == q.shape and k.grad.shape == k.shape \
        and v.grad.shape == v.shape and q.grad.dtype == dt
    args = lib.calls[1][1]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[-1] == 7
    if form == "base":
        assert args[10:17] == (b, hq, hkv, sq, dqk, int(causal), 1)
        return
    assert args[10:18] == (b, hq, hkv, sq, sk, dqk, dv, int(causal))
    want = 1.0 / math.sqrt(dqk) if scale is None else scale
    assert args[-2] == want
    if form == "fma":
        assert args[18] == k6.DTYPES[dt] and len(args) == 21
    else:
        assert len(args) == 20


def test_base_forms():
    """The base forms, which keep today's kernels: one length, one head
    width in HEAD_DIMS, the default scale."""
    def form(*shape, scale=None):
        q, k, v = (torch.zeros(s) for s in shape)
        return k6.is_base_form(q, k, v, scale)

    assert form((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64))
    assert form((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64), scale=0.125)
    assert not form((1, 4, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64), scale=0.1)
    assert not form((1, 4, 8, 64), (1, 2, 9, 64), (1, 2, 9, 64))
    assert not form((1, 4, 8, 192), (1, 4, 8, 192), (1, 4, 8, 128))
    assert not form((1, 4, 8, 24), (1, 4, 8, 24), (1, 4, 8, 24))
