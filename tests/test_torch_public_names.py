"""Small public names of the reference that the port carries in its own
modules, against the reference on the same inputs: ``registry.is_encdec``
over every config, ``dram_model.bank_to_rank`` over every bank of
topologies of 1-2 channels and 1-2 ranks, ``layers.init_layernorm``'s
leaves (values, dtype and shape). All exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.core import dram_model as jdram  # noqa: E402
from repro.core.params import MemSimConfig as JaxConfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dram_model as tdram  # noqa: E402
from repro_torch.core.params import MemSimConfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402


def check_is_encdec():
    seen = set()
    for name, jcfg in JAX_ARCHS.items():
        got = tregistry.is_encdec(get_config(name))
        assert got == jregistry.is_encdec(jcfg), name
        seen.add(got)
    assert seen == {True, False}


def check_bank_to_rank():
    for channels in (1, 2):
        for ranks in (1, 2):
            kw = dict(channels=channels, ranks=ranks)
            jtopo, ttopo = JaxConfig(**kw).topology(), \
                MemSimConfig(**kw).topology()
            banks = np.arange(ttopo.num_banks, dtype=np.int32)
            want = np.asarray(jdram.bank_to_rank(jtopo, banks))
            got = tdram.bank_to_rank(ttopo, torch.from_numpy(banks))
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.dtype == torch.int32
            assert int(got.max()) == channels * ranks - 1


def check_init_layernorm():
    for d in (1, 64, 1024):
        want, got = jlayers.init_layernorm(d), tlayers.init_layernorm(d)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))


@pytest.mark.parametrize("check", [check_is_encdec, check_bank_to_rank,
                                   check_init_layernorm],
                         ids=["registry.is_encdec", "dram_model.bank_to_rank",
                              "layers.init_layernorm"])
def test_public_name_matches_reference(check):
    check()
