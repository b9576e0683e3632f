"""K7 (selective scan) of the PyTorch port: the plain version against the
reference package's jnp oracle and its Pallas kernel in interpret mode,
on the shapes of tests/test_kernels.py and a ragged one, in float32 and
bfloat16; and the dispatch rules (a CPU tensor takes the plain version,
the CUDA wrapper takes CUDA tensors only).

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
