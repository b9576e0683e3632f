"""K7 (selective scan) of the PyTorch port: the plain version against the
reference package's jnp oracle and its Pallas kernel in interpret mode,
on the shapes of tests/test_kernels.py and a ragged one, in float32 and
bfloat16; the CUDA kernel's order of arithmetic (``_k7_mirror``) against
the jnp oracle at ragged shapes within chip_smoke.py's SCAN_TOL; and the
dispatch rules (a CPU tensor takes the plain version, the CUDA wrapper
takes CUDA tensors only).

Tolerances are tests/test_kernels.py's: float32 3e-6 (the orders of the
d_state sums differ), bfloat16 5e-2 (y is rounded to bfloat16 at every
step, and the Pallas body multiplies dt * x in float32 where the oracle
and the port's plain version multiply in bfloat16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ops import (  # noqa: E402
    selective_scan as jax_selective_scan,
)
from repro.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref as jax_selective_scan_ref,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.selective_scan.ops import (  # noqa: E402
    selective_scan,
)
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_ref,
)
from repro_torch.kernels.selective_scan.selective_scan import (  # noqa: E402
    selective_scan_cuda,
)

DTYPES = {"float32": (torch.float32, jnp.float32, 3e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
SHAPES = [
    (2, 64, 32, 8),      # B, T, D, S: unaligned small
    (1, 512, 512, 16),   # the Pallas wrapper's aligned chunking
    (3, 128, 64, 16),
    (2, 37, 48, 8),      # ragged: T and D no multiple of a block
]


def _inputs(shape, dtype, seed=11):
    """tests/test_kernels.py's draw, as (torch, jnp) pairs; a float32."""
    b, t, d, s = shape
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, d)) * 0.5,
            np.abs(rng.standard_normal((b, t, d))) * 0.1,
            rng.standard_normal((b, t, s)),
            rng.standard_normal((b, t, s))]
    a = (-np.abs(rng.standard_normal((d, s))) - 0.1).astype(np.float32)
    tor = [torch.from_numpy(x.astype(np.float32)).to(tdt) for x in arrs]
    jx = [jnp.asarray(x.astype(np.float32), jdt) for x in arrs]
    return tor + [torch.from_numpy(a)], jx + [jnp.asarray(a)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scan_plain_matches_reference(shape, dtype):
    ins, jins = _inputs(shape, dtype)
    tol = DTYPES[dtype][2]
    y, h = selective_scan(*ins)
    b, t, d, s = shape
    assert y.dtype == ins[0].dtype and y.shape == (b, t, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, s)
    ref = jax_selective_scan(*jins, False)
    pal = jax_selective_scan(*jins, True, True)
    for want_y, want_h in (ref, pal):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(h), _np(want_h), atol=tol, rtol=tol)


def test_scan_is_the_recurrence():
    """One step by hand: h1 = exp(dt a) * 0 + dt x B, y1 = C . h1; then
    h2 = exp(dt a) h1 + dt x B."""
    x = torch.tensor([[[2.0], [1.0]]])
    dt = torch.tensor([[[0.5], [0.25]]])
    bc = torch.tensor([[[1.0, -1.0], [2.0, 0.5]]])
    cc = torch.tensor([[[3.0, 1.0], [1.0, 1.0]]])
    a = torch.tensor([[-1.0, -2.0]])
    y, h = selective_scan_ref(x, dt, bc, cc, a)
    h1 = torch.tensor([1.0, -1.0])
    h2 = torch.exp(0.25 * a[0]) * h1 + 0.25 * torch.tensor([2.0, 0.5])
    assert torch.allclose(y[0, :, 0], torch.stack([(h1 * cc[0, 0]).sum(),
                                                   (h2 * cc[0, 1]).sum()]))
    assert torch.allclose(h[0, 0], h2)


def test_cpu_tensors_take_the_plain_version():
    ins, _ = _inputs((1, 16, 8, 4), "float32")
    before = dict(build.LAUNCHES)
    got = selective_scan(*ins)
    want = selective_scan_ref(*ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.LAUNCHES == before


def test_cuda_wrapper_rejects_cpu_tensors():
    ins, _ = _inputs((1, 16, 8, 4), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan_cuda(*ins)


# --------------------------------------------------------------------------
# the CUDA kernel's order of arithmetic (csrc/selective_scan.cu)

#: chip_smoke.py's SCAN_TOL: float32 max abs error <= 1e-5 x max |y| (resp.
#: |h|); bfloat16 |got - want| <= 2e-2 + 2e-2 |want| per element
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOG2E = np.float32(1.4426950408889634)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the kernel's fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def _k7_mirror(x, dt, bc, cc, a, lanes, chunk, channels):
    """K7's arithmetic on the CPU: for bfloat16 inputs log2(e) folded into
    A once and exp as exp2(dt * A'), for float32 exp(dt * A) on the
    unfolded A (the kernel keeps expf there); dt * x in float32, T padded
    to whole chunks with dt = x = B = C = 0 and D to whole channel blocks
    with A' = 0, h by fmaf, each lane's P = S / lanes products summed in
    order by fmaf, the lanes by an xor butterfly, y rounded to x's dtype at
    each step."""
    f32 = torch.float32
    b, t, d = x.shape
    s = bc.shape[-1]
    tp = -(-t // chunk) * chunk
    dp = -(-d // channels) * channels

    def padded(v, shape):
        out = torch.zeros(shape, dtype=f32)
        out[tuple(slice(0, n) for n in v.shape)] = v.to(f32)
        return out

    xf, dtf = padded(x, (b, tp, dp)), padded(dt, (b, tp, dp))
    bf, cf = padded(bc, (b, tp, s)), padded(cc, (b, tp, s))
    ex2 = x.dtype == torch.bfloat16
    a2 = padded(a.to(f32) * LOG2E if ex2 else a, (dp, s))
    exp = torch.exp2 if ex2 else torch.exp
    p = s // lanes
    lane = torch.arange(lanes)
    h = torch.zeros((b, dp, s), dtype=f32)
    y = torch.empty((b, tp, dp), dtype=f32)
    for i in range(tp):
        dtv = dtf[:, i, :, None]
        dtx = (dtf[:, i] * xf[:, i])[..., None]
        h = _fma(exp(dtv * a2), h, dtx * bf[:, i, None, :])
        hr = h.reshape(b, dp, lanes, p)
        cr = cf[:, i].reshape(b, 1, lanes, p)
        acc = torch.zeros((b, dp, lanes), dtype=f32)
        for q in range(p):
            acc = _fma(hr[..., q], cr[..., q], acc)
        off = lanes // 2
        while off:
            acc = acc + acc[..., lane ^ off]
            off //= 2
        y[:, i] = acc[..., 0]
    return y[:, :t, :d].to(x.dtype), h[:, :d]


def _within_scan_tol(got, want, dtype):
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    tol = SCAN_TOL[dtype]
    if dtype == "float32":
        return err.max() <= tol * np.abs(want).max()
    return bool((err <= tol + tol * np.abs(want)).all())


@pytest.mark.parametrize("shape", [(2, 1, 40, 16), (1, 33, 100, 8),
                                   (2, 100, 40, 16), (1, 33, 600, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape_of_kernel", [(2, 32, 64), (8, 16, 32)],
                         ids=["L2_TC32_CH64", "L8_TC16_CH32"])
def test_kernel_order_matches_reference(shape, dtype, shape_of_kernel):
    """Ragged T (a last chunk of 1 or 33 of 32 or 16 steps) and D (no whole
    channel block) in float32 and bfloat16: the kernel's order of
    arithmetic stays within the card check's tolerance of the oracle, and
    the zero-padded steps leave h as it was."""
    ins, jins = _inputs(shape, dtype, seed=23)
    y, h = _k7_mirror(*ins, *shape_of_kernel)
    want_y, want_h = jax_selective_scan_ref(*jins)
    assert y.dtype == ins[0].dtype and y.shape == ins[0].shape
    assert _within_scan_tol(y, want_y, dtype)
    assert _within_scan_tol(h, want_h, dtype)
