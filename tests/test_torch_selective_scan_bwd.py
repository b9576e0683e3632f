"""K7's backward in the PyTorch port: the plain version of its gradients
(autograd through ``selective_scan_ref``, which ``chip_smoke.py`` holds
the CUDA kernel to on the card) against ``jax.vjp`` of the reference's
jnp oracle (``src/repro/kernels/selective_scan/ref.py``): dx, ddt, dB, dC
and dA, with the gradient of h_final given and not, at T = 1, a ragged
T and both d_state sizes; then the argument and scratch layout that
``SelectiveScan`` hands K7's two entry points, with a recording stand-in
for the library.

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
    replaced by a recorder: its forward calls K7 once, its backward K7's
    backward once (``k7`` and ``k7bwd`` counted) with the saved inputs, the
    gradient of y, that of h_final (null where the loss does not reach
    it), the float32 scratch ``hs`` [B, ceil(T /
    8), D, S], ``part`` [B, ceil(D / 64), T, 2 S] and ``pa`` [B, D, S], the
    outputs in the inputs' dtype (dA float32) and (B, T, D, S, 64, 8,
    dtype)."""
    dt_ = getattr(torch, dtype)
    b, t, d, s = 2, 37, 70, 16
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
    args, _, _ = scan_inputs(b, t, d, s, seed=1)
    ta = [torch.from_numpy(a).to(dt_ if i < 4 else torch.float32)
          .requires_grad_() for i, a in enumerate(args)]
    for reach_h in (True, False):
        lib.calls.clear()
        y, h = k7.SelectiveScan.apply(*ta)
        assert y.shape == (b, t, d) and y.dtype == dt_
        assert h.shape == (b, d, s) and h.dtype == torch.float32
        loss = y.float().sum() + (h.sum() if reach_h else 0.0)
        grads = torch.autograd.grad(loss, ta)
        assert [c[0] for c in lib.calls] == ["selective_scan_launch",
                                             "selective_scan_bwd_launch"]
        fwd, bwd = lib.calls[0][1], lib.calls[1][1]
        assert fwd[:5] == tuple(x.data_ptr() for x in ta)
        assert bwd[:5] == tuple(x.data_ptr() for x in ta)
        assert isinstance(bwd[5], int)                    # dy
        assert (bwd[6] is None) == (not reach_h)          # dh
        assert made[bwd[7]] == ((b, -(-t // 8), d, s), torch.float32)
        assert made[bwd[8]] == ((b, -(-d // 64), t, 2 * s), torch.float32)
        assert made[bwd[9]] == ((b, d, s), torch.float32)
        assert [g.data_ptr() for g in grads] == list(bwd[10:15])
        assert [(tuple(g.shape), g.dtype) for g in grads] == [
            ((b, t, d), dt_), ((b, t, d), dt_), ((b, t, s), dt_),
            ((b, t, s), dt_), ((d, s), torch.float32)]
        assert bwd[15:] == (b, t, d, s, k7.BWD_CHANNELS, k7.BWD_CHUNK,
                            k7.DTYPES[dt_], 7)
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0), "k7": 2,
                              "k7bwd": 2}
