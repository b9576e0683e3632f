"""The port's LLM cost model and shape specs against the JAX reference.

``repro_torch.perfmodel.analytic`` (parameter counts, the per-cell FLOP and
byte model, the roofline terms) and the shape side of
``repro_torch.launch.specs`` (``SHAPES``, ``shape_skips``, the batch,
input and parameter shapes on ``meta``), held against
``repro.perfmodel.analytic`` and ``repro.launch.specs`` for every config
and every cell. The reference's trees stack layers over groups (and an
encoder-decoder's over layers); its shapes are regrouped one tree a layer
here before they are compared.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.perfmodel import analytic as ref_analytic  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.perfmodel import analytic  # noqa: E402

NAMES = sorted(ARCHS)


@pytest.fixture(autouse=True)
def cached_reference_counts(monkeypatch):
    """The reference's ``cell_cost`` counts its parameters by an abstract
    init at every call; the counts are a function of the config, so they
    are taken once a config here."""
    monkeypatch.setattr(ref_analytic, "param_counts", _ref_counts)


_REF_PARAM_COUNTS = ref_analytic.param_counts


@functools.lru_cache(maxsize=None)
def _ref_counts_cached(name):
    return _REF_PARAM_COUNTS(REF_ARCHS[name])


def _ref_counts(cfg):
    return dict(_ref_counts_cached(cfg.name))


# ---- shape trees -------------------------------------------------------------

def _sig(leaf, drop=0):
    """"shape dtype" of a tensor or a ShapeDtypeStruct, its first ``drop``
    dimensions dropped."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).replace("torch.", "")
    else:
        dtype = np.dtype(leaf.dtype).name
    return f"{tuple(leaf.shape)[drop:]} {dtype}"


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _unstacked(tree):
    """A reference subtree whose leaves carry a leading stacked axis, as
    one layer's (shape, dtype) signatures."""
    return jax.tree.map(lambda a: _sig(a, 1), tree)


def ref_layers(cfg, tree):
    """The reference's LM tree (``prefix`` and ``body`` stacked over
    groups) as one subtree a layer in layer order, leaves as signatures
    (the regrouping ``core.interop._layer_trees`` applies to arrays)."""
    out = [jax.tree.map(_sig, t) for t in tree.get("prefix", [])]
    for _ in range(cfg.groups):
        for slot in range(len(cfg.period)):
            out.append(_unstacked(tree["body"][str(slot)]))
    return out


def ref_tree_per_layer(cfg, tree):
    """Any reference parameter or cache tree in this package's layout."""
    if cfg.is_encdec:
        out = {k: jax.tree.map(_sig, v) for k, v in tree.items()
               if k not in ("enc", "dec")}
        for k, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
            if k in tree:
                out[k] = [_unstacked(tree[k])] * n
        return out
    out = {k: jax.tree.map(_sig, v) for k, v in tree.items()
           if k not in ("prefix", "body")}
    out["layers"] = ref_layers(cfg, tree)
    return out


def port_sigs(tree):
    return {k: _sig(v) for k, v in _flat(tree).items()}


def ref_sigs(tree):
    return _flat(tree)


# ---- parameter counts and cell costs -----------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_param_counts_match_the_reference(name):
    got = analytic.param_counts(ARCHS[name])
    want = _ref_counts(REF_ARCHS[name])
    assert got == want
    assert set(got) == {"total", "routed_experts", "active"}


@pytest.mark.parametrize("name", NAMES)
def test_cell_cost_matches_the_reference_on_every_cell(name):
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    n = 0
    for shape in specs.SHAPES:
        assert specs.shape_skips(cfg, shape) == \
            ref_specs.shape_skips(rcfg, shape)
        if specs.shape_skips(cfg, shape):
            continue
        for devices in (256, 1):
            for causal_skip in (False, True):
                got = analytic.cell_cost(cfg, shape, devices,
                                         causal_skip).as_dict()
                want = ref_analytic.cell_cost(rcfg, shape, devices,
                                              causal_skip).as_dict()
                assert set(got) == set(want)
                for k, w in want.items():
                    if isinstance(w, str):
                        assert got[k] == w, (shape, k)
                    else:
                        assert got[k] == pytest.approx(w, rel=1e-12,
                                                       abs=0), (shape, k)
                n += 1
    assert n >= 8


def test_shapes_and_skips_match_the_reference():
    assert specs.SHAPES == ref_specs.SHAPES
    assert specs.CROSS_SRC_LEN == ref_specs.CROSS_SRC_LEN
    skips = {(n, s): specs.shape_skips(ARCHS[n], s)
             for n in NAMES for s in specs.SHAPES}
    assert skips == {(n, s): ref_specs.shape_skips(REF_ARCHS[n], s)
                     for n in NAMES for s in specs.SHAPES}
    # only the sub-quadratic families take the 500k decode cell
    assert {n for (n, s), v in skips.items()
            if s == "long_500k" and v is None} == {"jamba-v0.1-52b",
                                                   "xlstm-1.3b"}


@pytest.mark.parametrize("name,shape", [
    ("xlstm-1.3b", "long_500k"), ("qwen3-14b", "decode_32k"),
    ("deepseek-v3-671b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
    ("seamless-m4t-medium", "decode_32k")])
def test_roofline_terms_match_the_reference_under_its_constants(name,
                                                                shape,
                                                                monkeypatch):
    """Under the reference's constants, the port's terms are the
    reference's; under its own it uses the H100's."""
    for devices in (256, 1):
        cost = analytic.cell_cost(ARCHS[name], shape, devices)
        h100 = analytic.roofline_terms(cost, 1.5e9, devices)
        assert h100["compute_s"] == cost.flops_total / (devices * 989e12)
        assert h100["memory_s"] == cost.hbm_bytes / 3.35e12
        assert h100["collective_s"] == 1.5e9 / 450e9
        assert h100["bound_s"] == max(h100["compute_s"], h100["memory_s"],
                                      h100["collective_s"])
        want = ref_analytic.roofline_terms(
            ref_analytic.cell_cost(REF_ARCHS[name], shape, devices),
            1.5e9, devices)
        with monkeypatch.context() as m:
            m.setattr(analytic, "PEAK_FLOPS", ref_analytic.PEAK_FLOPS)
            m.setattr(analytic, "HBM_BW", ref_analytic.HBM_BW)
            m.setattr(analytic, "LINK_BW", ref_analytic.ICI_BW)
            got = analytic.roofline_terms(cost, 1.5e9, devices)
        assert set(got) == set(want)
        for k, w in want.items():
            if isinstance(w, str):
                assert got[k] == w
            else:
                assert got[k] == pytest.approx(w, rel=1e-12, abs=0), k


def test_the_long_decode_cell_is_bound_by_its_weights_on_one_card():
    """xlstm-1.3b's long_500k step on one card: every bf16 weight read
    once dominates; the bound is the bytes over the H100's HBM rate."""
    cost = analytic.cell_cost(ARCHS["xlstm-1.3b"], "long_500k", devices=1)
    terms = analytic.roofline_terms(cost, 0.0, 1)
    assert terms["dominant"] == "memory"
    assert cost.params_total == 3504294224.0
    assert cost.hbm_bytes > 2 * cost.params_total
    assert terms["bound_s"] == cost.hbm_bytes / analytic.HBM_BW


# ---- shapes on meta ------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_batch_and_input_specs_match_the_reference(name):
    """Every cell's batch: shapes and dtypes leaf by leaf, caches regrouped
    one tree a layer (an encoder-decoder's cross K/V one pair a layer),
    every leaf on ``meta``."""
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    for shape in specs.SHAPES:
        if specs.shape_skips(cfg, shape):
            continue
        got = specs.batch_specs(cfg, shape)
        want = ref_specs.batch_specs(rcfg, shape)
        assert set(got) == set(want)
        for leaf in _flat(got).values():
            assert leaf.device.type == "meta"
        if "caches" in want:
            caches = want.pop("caches")
            per_layer = ([_unstacked(caches)] * cfg.n_layers
                         if cfg.is_encdec else ref_layers(cfg, caches))
            assert port_sigs(got.pop("caches")) == ref_sigs(per_layer)
        if "cross" in want:
            k, v = want.pop("cross")
            per_layer = [(_unstacked(k), _unstacked(v))
                         for _ in range(cfg.n_layers)]
            assert port_sigs(got.pop("cross")) == ref_sigs(per_layer)
        assert port_sigs(got) == ref_sigs(jax.tree.map(_sig, want))
        assert _flat(specs.input_specs(cfg, shape)).keys() == \
            _flat(specs.batch_specs(cfg, shape)).keys()


@pytest.mark.parametrize("name", NAMES)
def test_param_shapes_match_the_reference(name):
    """``param_shapes`` leaf by leaf against the reference's, float32 and
    cast to bf16, every leaf on ``meta``."""
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    got = specs.param_shapes(cfg)
    want = ref_tree_per_layer(rcfg, ref_specs.param_shapes(rcfg))
    assert port_sigs(got) == ref_sigs(want)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    bf16 = port_sigs(specs.param_shapes(cfg, torch.bfloat16))
    assert bf16 == ref_sigs(ref_tree_per_layer(
        rcfg, ref_specs.param_shapes(rcfg, jnp.bfloat16)))
    assert {v.split()[-1] for v in bf16.values()} == {"bfloat16"}


def test_param_shapes_draw_nothing(monkeypatch):
    """deepseek-v3's full tree (671 B parameters) comes out on ``meta``
    without a draw: the truncated-normal sampler is never called."""
    def refuse(*a, **k):
        raise AssertionError("a value was drawn")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    cfg = ARCHS["deepseek-v3-671b"]
    leaves = list(_flat(specs.param_shapes(cfg)).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == 671026404352
