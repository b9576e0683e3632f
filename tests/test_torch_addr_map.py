"""K4 (address decode + per-bank histogram) of the PyTorch port: the plain
version bit for bit against the reference package's jnp oracle and its
Pallas kernel in interpret mode, on the cases of tests/test_kernels.py
(random addresses at two topologies, the histogram total) and
tests/test_cxl_tiers.py (two tiered placements, a single-tier box that
ignores them); the entry point's rules for lifting and ignoring
``tier_flags``; and the dispatch rules."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.params import MemSimConfig as JaxConfig  # noqa: E402
from repro.kernels.addr_map.ops import addr_map as jax_addr_map  # noqa: E402
from repro_torch.core.params import MemSimConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.addr_map.addr_map import addr_map_cuda  # noqa: E402
from repro_torch.kernels.addr_map.ops import addr_map  # noqa: E402
from repro_torch.kernels.addr_map.ref import addr_map_ref  # noqa: E402

TIERED = dict(channels=2, tiers=2, cxl_channels=1, queue_size=16,
              sref_idle_cycles=400)


def _assert_same(got, addr, jcfg, tier_flags=None):
    """The port's four outputs equal JAX's oracle and Pallas kernel."""
    ja = jnp.asarray(addr)
    for use_pallas in (False, True):
        want = jax_addr_map(jcfg, ja, use_pallas, True, tier_flags)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [64, 1000, 4096])
@pytest.mark.parametrize("topology", [dict(), dict(channels=2)],
                         ids=["table1", "channels2"])
def test_addr_map_matches_reference(n, topology):
    rng = np.random.default_rng(n)
    addr = rng.integers(0, 1 << 28, size=(n,)).astype(np.int32)
    got = addr_map(MemSimConfig(**topology), torch.from_numpy(addr))
    _assert_same(got, addr, JaxConfig(**topology))


def test_addr_map_histogram_total():
    got = addr_map(MemSimConfig(), torch.arange(512, dtype=torch.int32))
    hist = got[3]
    assert int(hist.sum()) == 512
    assert int(hist.max()) == int(hist.min())  # uniform interleave
    _assert_same(got, np.arange(512, dtype=np.int32), JaxConfig())


@pytest.mark.parametrize("il,k", [(6, 1), (8, 2)])
def test_addr_map_tiered_matches_reference(il, k):
    kw = dict(TIERED, tier_interleave_log2=il, tier_cxl_frac_log2=k)
    rng = np.random.default_rng(il * 10 + k)
    addr = rng.integers(0, 1 << 28, size=2048).astype(np.int32)
    cfg = MemSimConfig(**kw)
    got = addr_map(cfg, torch.from_numpy(addr))  # flags lifted from cfg
    _assert_same(got, addr, JaxConfig(**kw))
    # explicit flags on the bare topology give the same decode
    flags = torch.tensor([il, k], dtype=torch.int32)
    again = addr_map(cfg.topology(), torch.from_numpy(addr), flags)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert int(got[3][cfg.tier_split_bank:].sum()) > 0  # CXL banks used


def test_addr_map_single_tier_ignores_flags():
    cfg = MemSimConfig(channels=2)
    addr = np.arange(2048, dtype=np.int32) * 37 % (1 << 20)
    got = addr_map(cfg, torch.from_numpy(addr), [8, 2])
    _assert_same(got, addr, JaxConfig(channels=2))


def test_addr_map_negative_addresses_shift_arithmetically():
    """The whole int32 range: ``>>`` keeps the sign, as jnp's does."""
    rng = np.random.default_rng(5)
    addr = rng.integers(-(1 << 31), (1 << 31) - 1, size=3000).astype(
        np.int32)
    for kw in (dict(), dict(TIERED, tier_interleave_log2=6,
                            tier_cxl_frac_log2=1)):
        got = addr_map(MemSimConfig(**kw), torch.from_numpy(addr))
        assert int(got[2].min()) < 0
        _assert_same(got, addr, JaxConfig(**kw))


def test_addr_map_bare_tiered_topology_needs_flags():
    topo = MemSimConfig(**TIERED).topology()
    with pytest.raises(ValueError, match="tier_flags required"):
        addr_map(topo, torch.zeros(4, dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version():
    cfg = MemSimConfig()
    addr = torch.arange(100, dtype=torch.int32) * 7
    before = dict(build.LAUNCHES)
    got = addr_map(cfg, addr)
    want = addr_map_ref(cfg, addr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.LAUNCHES == before


def test_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        addr_map_cuda(MemSimConfig(), torch.zeros(8, dtype=torch.int32))
