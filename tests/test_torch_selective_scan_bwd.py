"""K7's backward in the PyTorch port: the plain version of its gradients
(autograd through ``selective_scan_ref``, which ``chip_smoke.py`` holds
the CUDA kernel to on the card) against ``jax.vjp`` of the reference's
jnp oracle (``src/repro/kernels/selective_scan/ref.py``): dx, ddt, dB, dC
and dA, with the gradient of h_final given and not, at T = 1, a ragged
T and both d_state sizes; the CUDA kernel's order of arithmetic
(``_k7_bwd_mirror``: checkpoints from the forward, each chunk recomputed,
the reverse step, the sums over lanes, channels, warps and blocks)
against the same vjp at ragged T and D; then the argument and scratch
layout that ``SelectiveScan`` hands K7's entry points (the saving forward,
then the backward with its checkpoints), with a recording stand-in for
the library.

Tolerance: float32, each gradient within 2e-5 x its max |value| (the
same recurrence differentiated by two frameworks, summed in other
orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as jax_scan,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan as k7,
)
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref,
)

REL = 2e-5


def scan_inputs(b, t, d, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, d)) - 1.0)).astype(
        np.float32)
    bc = rng.standard_normal((b, t, s)).astype(np.float32)
    cc = rng.standard_normal((b, t, s)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d, s))).astype(np.float32)
    dy = rng.standard_normal((b, t, d)).astype(np.float32)
    dh = rng.standard_normal((b, d, s)).astype(np.float32)
    return (x, dt, bc, cc, a), dy, dh


#: (B, T, D, S, with the gradient of h_final)
CASES = {
    "dh": (2, 24, 12, 8, True),
    "no_dh": (2, 24, 12, 8, False),
    "one_step": (1, 1, 5, 8, True),
    "ragged_s16": (2, 37, 9, 16, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    b, t, d, s, with_dh = CASES[case]
    args, dy, dh = scan_inputs(b, t, d, s, seed=t + d)
    (_, _), vjp = jax.vjp(jax_scan, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(
        dh if with_dh else np.zeros_like(dh))))
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = selective_scan_ref(*ta)
    outs, grads = [y], [torch.from_numpy(dy)]
    if with_dh:
        outs.append(h)
        grads.append(torch.from_numpy(dh))
    got = torch.autograd.grad(outs, ta, grads)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * np.abs(w).max(), err_msg=name)


class _Recorder:
    """Stands in for K7's two loaded libraries: records each entry point
    called with its arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("selective_scan"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_function_launches_forward_then_backward(
        monkeypatch, dtype):
    """``SelectiveScan`` with the device checks bypassed and the library
    replaced by a recorder: its forward calls K7's saving form once, with
    the inputs, y, h_final, the float32 checkpoints ``hs`` [B, ceil(T /
    BWD_CHUNK), D, S] and (B, T, D, S, BWD_CHUNK, dtype); its backward K7's
    backward once (``k7`` and ``k7bwd`` counted) with the saved inputs, the
    gradient of y, that of h_final (null where the loss does not reach
    it), the forward's ``hs``, the float32 scratch ``part`` [B, ceil(D /
    BWD_CHANNELS), T, 2 S] and ``pa`` [B, D, S], the outputs in the
    inputs' dtype (dA float32) and (B, T, D, S, BWD_CHANNELS, BWD_CHUNK,
    dtype)."""
    dt_ = getattr(torch, dtype)
    b, t, d, s = 2, 37, 70, 16
    lib, made = _record(monkeypatch)
    args, _, _ = scan_inputs(b, t, d, s, seed=1)
    ta = [torch.from_numpy(a).to(dt_ if i < 4 else torch.float32)
          .requires_grad_() for i, a in enumerate(args)]
    f32 = torch.float32
    for reach_h in (True, False):
        lib.calls.clear()
        y, h = k7.SelectiveScan.apply(*ta)
        assert y.shape == (b, t, d) and y.dtype == dt_
        assert h.shape == (b, d, s) and h.dtype == torch.float32
        loss = y.float().sum() + (h.sum() if reach_h else 0.0)
        grads = torch.autograd.grad(loss, ta)
        assert [c[0] for c in lib.calls] == ["selective_scan_save_launch",
                                             "selective_scan_bwd_launch"]
        fwd, bwd = lib.calls[0][1], lib.calls[1][1]
        assert fwd[:5] == tuple(x.data_ptr() for x in ta)
        assert made[fwd[7]] == ((b, -(-t // k7.BWD_CHUNK), d, s), f32)
        assert fwd[8:] == (b, t, d, s, k7.BWD_CHUNK, k7.DTYPES[dt_], 7)
        assert bwd[:5] == tuple(x.data_ptr() for x in ta)
        assert isinstance(bwd[5], int)                    # dy
        assert (bwd[6] is None) == (not reach_h)          # dh
        assert bwd[7] == fwd[7]                           # the checkpoints
        assert made[bwd[8]] == ((b, -(-d // k7.BWD_CHANNELS), t, 2 * s), f32)
        assert made[bwd[9]] == ((b, d, s), f32)
        assert [g.data_ptr() for g in grads] == list(bwd[10:15])
        assert [(tuple(g.shape), g.dtype) for g in grads] == [
            ((b, t, d), dt_), ((b, t, d), dt_), ((b, t, s), dt_),
            ((b, t, s), dt_), ((d, s), torch.float32)]
        assert bwd[15:] == (b, t, d, s, k7.BWD_CHANNELS, k7.BWD_CHUNK,
                            k7.DTYPES[dt_], 7)
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0), "k7": 2,
                              "k7bwd": 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_from_the_inputs_alone_saves_checkpoints_first(
        monkeypatch, dtype):
    """``selective_scan_bwd_cuda`` given no checkpoints launches K7's
    saving form first and hands its ``hs`` to the backward launch; given
    them, it launches the backward alone; checkpoints of another shape
    raise."""
    dt_ = getattr(torch, dtype)
    b, t, d, s = 1, 33, 24, 8
    lib, made = _record(monkeypatch)
    args, dy, _ = scan_inputs(b, t, d, s, seed=2)
    ta = [torch.from_numpy(v).to(dt_ if i < 4 else torch.float32)
          for i, v in enumerate(args)]
    dy = torch.from_numpy(dy).to(dt_)
    k7.selective_scan_bwd_cuda(*ta, dy)
    assert [c[0] for c in lib.calls] == ["selective_scan_save_launch",
                                         "selective_scan_bwd_launch"]
    hs = lib.calls[0][1][7]
    assert made[hs] == ((b, -(-t // k7.BWD_CHUNK), d, s), torch.float32)
    assert lib.calls[1][1][7] == hs
    lib.calls.clear()
    given = torch.zeros((b, -(-t // k7.BWD_CHUNK), d, s))
    k7.selective_scan_bwd_cuda(*ta, dy, None, given)
    assert [c[0] for c in lib.calls] == ["selective_scan_bwd_launch"]
    assert lib.calls[0][1][7] == given.data_ptr()
    with pytest.raises(ValueError, match="hs"):
        k7.selective_scan_bwd_cuda(*ta, dy, None, given[:, :1])
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0), "k7": 1,
                              "k7bwd": 2}


def _record(monkeypatch):
    """The device checks bypassed, the libraries replaced by one recorder,
    the launch counts zeroed, and ``torch.empty`` recording each tensor's
    (shape, dtype) by its pointer: returns (recorder, that record)."""
    lib = _Recorder()
    made = {}
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        made[out.data_ptr()] = (tuple(out.shape), out.dtype)
        return out

    monkeypatch.setattr(build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(build, "load", lambda: {
        "selective_scan": lib, "selective_scan_bwd": lib})
    monkeypatch.setattr(build, "stream_of", lambda x: 7)
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    monkeypatch.setattr(torch, "empty", recording_empty)
    return lib, made


# --------------------------------------------------------------------------
# the CUDA kernel's order of arithmetic (csrc/selective_scan_bwd.cu)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the kernel's fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def _halves(v, axis):
    """The sum over ``axis`` (a power of two long) by halving: the second
    half added onto the first until one is left, the order of the
    kernel's xor shuffles, its reduce-scatter and its pairwise tree."""
    while v.shape[axis] > 1:
        first, second = v.chunk(2, dim=axis)
        v = first + second
    return v.squeeze(axis)


def _k7_bwd_mirror(x, dt, bc, cc, a, dy, dh, lanes, channels, chunk):
    """K7's backward's arithmetic on the CPU for float32 inputs: T padded
    to whole chunks with x = dt = dy = B = C = 0 and D to whole channel
    blocks with A = 0; the checkpoints as K7's saving forward writes them
    (h before every ``chunk``-th step, h by fmaf); each chunk, last to
    first, recomputed from its checkpoint; the reverse step with the
    carried G (g = dy C + G, G = e g, h e g as G h); du = sum_s g B and dd = sum_s g h e A over a lane's P
    states by fmaf from 0, then du and du x + dd over the channel's lanes
    by halving (dx = that du times dt, ddt the other); dB and dC's terms over a
    warp's 32 / lanes channels by halving (the reduce-scatter), over the
    block's warps by halving (the producer's tree), then over the blocks
    in order; dA per thread over t, then over B in order."""
    f32 = torch.float32
    b, t, d = x.shape
    s = bc.shape[-1]
    tp = -(-t // chunk) * chunk
    dp = -(-d // channels) * channels
    nblk, lc = dp // channels, 32 // lanes
    warps, p_ = channels * lanes // 32, s // lanes

    def padded(v, shape):
        out = torch.zeros(shape, dtype=f32)
        out[tuple(slice(0, n) for n in v.shape)] = v.to(f32)
        return out

    xf, dtf, dyf = (padded(v, (b, tp, dp)) for v in (x, dt, dy))
    bf, cf = padded(bc, (b, tp, s)), padded(cc, (b, tp, s))
    af = padded(a, (dp, s))
    u = dtf * xf                                           # [b, tp, dp]
    e = torch.exp(dtf[..., None] * af)                     # [b, tp, dp, s]
    # the saving forward's checkpoints
    h = torch.zeros((b, dp, s), dtype=f32)
    ckpt = []
    for i in range(tp):
        if i % chunk == 0:
            ckpt.append(h)
        h = _fma(e[:, i], h, u[:, i, :, None] * bf[:, i, None, :])

    def lane_terms(terms, weight):
        """[b, dp, lanes]: sum_s terms * weight over each lane's P states,
        by fmaf from 0."""
        tr = terms.reshape(b, dp, lanes, p_)
        wr = weight.reshape(*weight.shape[:-1], lanes, p_)
        acc = torch.zeros((b, dp, lanes), dtype=f32)
        for q in range(p_):
            acc = _fma(tr[..., q], wr[..., q], acc)
        return acc

    def block_sum(terms):
        """[b, dp, s] -> [b, nblk, s]: over the warp's channels, then the
        block's warps, by halving."""
        tr = terms.reshape(b, nblk, warps, lc, s)
        return _halves(_halves(tr, 3), 2)

    G = torch.zeros((b, dp, s), dtype=f32)
    if dh is not None:
        G[:, :d] = dh.to(f32)
    dA = torch.zeros((b, dp, s), dtype=f32)
    dx = torch.zeros((b, tp, dp), dtype=f32)
    ddt = torch.zeros((b, tp, dp), dtype=f32)
    part = torch.zeros((b, nblk, tp, 2, s), dtype=f32)
    for c in reversed(range(tp // chunk)):
        hh = [ckpt[c]]
        for tt in range(chunk):
            i = c * chunk + tt
            hh.append(_fma(e[:, i], hh[-1], u[:, i, :, None]
                           * bf[:, i, None, :]))
        for tt in reversed(range(chunk)):
            i = c * chunk + tt
            dtv, dyv = dtf[:, i, :, None], dyf[:, i, :, None]
            g = _fma(dyv, cf[:, i, None, :], G)
            G = e[:, i] * g
            ge = G * hh[tt]
            du = lane_terms(g, bf[:, i, None, :])
            dd = lane_terms(ge, af[None])
            dA = _fma(ge, dtv, dA)
            part[:, :, i, 0] = block_sum(g * u[:, i, :, None])
            part[:, :, i, 1] = block_sum(dyv * hh[tt + 1])
            dx[:, i] = _halves(du, 2) * dtf[:, i]
            ddt[:, i] = _halves(_fma(du, xf[:, i, :, None], dd), 2)
    dbc = torch.zeros((b, tp, s), dtype=f32)
    dcc = torch.zeros((b, tp, s), dtype=f32)
    for k in range(nblk):
        dbc = dbc + part[:, k, :, 0]
        dcc = dcc + part[:, k, :, 1]
    da = torch.zeros((dp, s), dtype=f32)
    for r in range(b):
        da = da + dA[r]
    return (dx[:, :t, :d], ddt[:, :t, :d], dbc[:, :t], dcc[:, :t],
            da[:d])


#: (T against the production chunk, S, with the gradient of h_final)
MIRROR_CASES = {
    "chunk-1": (-1, 16, True), "chunk-1_no_dh": (-1, 16, False),
    "chunk+1": (1, 16, True), "chunk+1_no_dh": (1, 16, False),
    "3chunk+1": (2 * k7.BWD_CHUNK + 1, 16, True),
    "3chunk+1_no_dh": (2 * k7.BWD_CHUNK + 1, 16, False),
    "3chunk+1_s8": (2 * k7.BWD_CHUNK + 1, 8, True),
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_kernel_order_matches_reference_vjp(case):
    """The production shape's order of arithmetic (lanes 4, the module's
    BWD_CHANNELS and BWD_CHUNK) at T = chunk - 1, chunk + 1 and 3 chunk +
    1, D = 72 (a ragged second channel block), with and without the
    gradient of h_final, and S = 8 (2 states a thread, lanes paired in
    the reduce-scatter): within 2e-5 x max |value| of ``jax.vjp`` of the
    reference's oracle."""
    extra, s, with_dh = MIRROR_CASES[case]
    b, t, d = 2, k7.BWD_CHUNK + extra, 72
    args, dy, dh = scan_inputs(b, t, d, s, seed=t + s)
    (_, _), vjp = jax.vjp(jax_scan, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(
        dh if with_dh else np.zeros_like(dh))))
    got = _k7_bwd_mirror(*map(torch.from_numpy, args), torch.from_numpy(dy),
                         torch.from_numpy(dh) if with_dh else None, 4,
                         k7.BWD_CHANNELS, k7.BWD_CHUNK)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("chunk", [32, 8])
def test_saving_forward_takes_chunks_of_16_or_32(monkeypatch, chunk):
    """K7's saving form at another stride than the backward's (the sweep's
    chunk of 32) lays its checkpoints out at that stride; a stride the
    kernel is not built for raises before any launch."""
    b, t, d, s = 1, 33, 24, 8
    lib, made = _record(monkeypatch)
    args, _, _ = scan_inputs(b, t, d, s, seed=3)
    ta = [torch.from_numpy(v) for v in args]
    if chunk not in (16, 32):
        with pytest.raises(ValueError, match="chunk"):
            k7.selective_scan_save_cuda(*ta, chunk)
        assert lib.calls == []
        return
    y, h, hs = k7.selective_scan_save_cuda(*ta, chunk)
    assert [c[0] for c in lib.calls] == ["selective_scan_save_launch"]
    assert made[hs.data_ptr()] == ((b, -(-t // chunk), d, s), torch.float32)
    assert lib.calls[0][1][8:] == (b, t, d, s, chunk, 0, 7)
    assert build.LAUNCHES["k7"] == 1


@pytest.mark.parametrize("wrapper", ["selective_scan_save_cuda",
                                     "selective_scan_bwd_cuda"])
def test_cuda_wrappers_reject_cpu_tensors(wrapper):
    """The saving forward and the backward take CUDA tensors only: CPU
    tensors take the plain version through ``ops.py``, never these."""
    args, dy, _ = scan_inputs(1, 16, 8, 8, seed=4)
    ta = [torch.from_numpy(v) for v in args]
    extra = [torch.from_numpy(dy)] if wrapper == "selective_scan_bwd_cuda" \
        else []
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(k7, wrapper)(*ta, *extra)
