"""PyTorch port, quantization: the port's `utils/quantize.py` gives the JAX
package's bytes exactly (int8, int4 split-halves with 1 and 2 groups, NF4),
dequantizes to the same values, and carries quantized leaves across the
weight bridge unchanged."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.utils import quantize as jq
from mingunivision_tpu_torch.utils import quantize as tq
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.pytree import layer_view, leaves
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CASES = [(8, 1, "linear"), (4, 1, "linear"), (4, 2, "linear"), (4, 1, "nf4")]
IDS = ["int8", "int4", "int4-groups2", "nf4"]


def _weights(shape, seed=0):
    return (0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _same_bytes(got: tq.QuantizedArray, want):
    assert (got.bits, got.groups, got.scheme) == (want.bits, want.groups, want.scheme)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.q.numpy().dtype == np.asarray(want.q).dtype
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


@pytest.mark.parametrize("bits,groups,scheme", CASES, ids=IDS)
@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 40)], ids=["2d", "stacked"])
def test_quantize_array_gives_jax_bytes(bits, groups, scheme, shape):
    w = _weights(shape)
    want = jq.quantize_array(jnp.asarray(w), bits, groups=groups, scheme=scheme)
    got = tq.quantize_array(torch.from_numpy(w), bits, groups=groups, scheme=scheme)
    _same_bytes(got, want)
    # dequant within 0
    np.testing.assert_array_equal(tq.dequant_weight(got, torch.float32).numpy(),
                                  np.asarray(jq.dequant_weight(want, jnp.float32)))


def test_take_weight_matches_jax():
    w = _weights((6, 32, 40))
    idx = np.array([4, 0, 4, 2])
    want = jq.take_weight(jq.quantize_array(jnp.asarray(w), 4), jnp.asarray(idx))
    got = tq.take_weight(tq.quantize_array(torch.from_numpy(w), 4), torch.from_numpy(idx))
    _same_bytes(got, want)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {
        "word_embeddings": {"w": f(300, 256)},
        "layers": {
            "input_layernorm": {"w": f(2, 256)},
            "attention": {"query_key_value": {"w": f(2, 256, 384), "b": f(2, 384)}},
            "mlp": {"gate": {"w": f(2, 256, 8)}, "experts": {"gate_proj": f(2, 8, 256, 64),
                                                              "down_proj": f(2, 8, 64, 256)}},
        },
        "odd": {"w": f(301, 256)},
        "lm_head": {"w": f(256, 300)},
        "proj": [{"w": f(256, 300)}, {"w": f(300, 300)}],
    }


@pytest.mark.parametrize("bits,scheme", [(4, "linear"), (8, "linear"), (4, "nf4")])
def test_quantize_tree_gives_jax_bytes(bits, scheme):
    tree = _tree()
    want = jq.quantize_tree({k: _to_jnp(v) for k, v in tree.items()}, bits=bits, scheme=scheme)
    got = tq.quantize_tree(_to_torch(tree), bits=bits, scheme=scheme)
    _compare_trees(got, want)
    # the in-place variant, one leaf at a time, gives the same tree
    _compare_trees(tq.quantize_tree_inplace(_to_torch(tree), bits=bits, scheme=scheme), want)


def test_quantize_tree_inplace_slices_large_leaves(monkeypatch):
    monkeypatch.setattr(tq, "_SLICE_BYTES", 1024)  # every stacked leaf goes one depth slice at a time
    tree = _tree(1)
    want = jq.quantize_tree({k: _to_jnp(v) for k, v in tree.items()}, bits=4)
    _compare_trees(tq.quantize_tree_inplace(_to_torch(tree), bits=4), want)


def test_params_from_jax_carries_quantized_leaves():
    tree = _tree(2)
    jtree = jq.quantize_tree({k: _to_jnp(v) for k, v in tree.items()}, bits=4)
    got = params_from_jax(jtree, "cpu")
    _compare_trees(got, jtree)
    view = layer_view(got["layers"], 1)
    gp = view["mlp"]["experts"]["gate_proj"]
    assert gp.q.data_ptr() == got["layers"]["mlp"]["experts"]["gate_proj"].q[1].data_ptr()  # zero-copy
    assert tuple(gp.q.shape) == (8, 128, 64) and tuple(gp.s.shape) == (8, 1, 64)
    assert sum(1 for _ in leaves(got["layers"]["mlp"]["experts"])) == 4  # q and s of each table


def _to_jnp(tree):
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jnp(v) for v in tree]
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _compare_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _compare_trees(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _compare_trees(g, w)
    elif isinstance(want, jq.QuantizedArray):
        assert isinstance(got, tq.QuantizedArray), got
        _same_bytes(got, want)
    else:
        assert not isinstance(got, tq.QuantizedArray)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mm_tree(seed=3):
    """An "llm" and an "rf_head" subtree with the leaves the tier policy tells apart."""
    tree = _tree(seed)
    rng = np.random.default_rng(seed + 1)
    f = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    rf = {"res_blocks": {"mlp": {"w12": {"w": f(2, 256, 512), "b": f(2, 512)}, "w3": {"w": f(2, 256, 256)}},
                         "in_ln": {"w": f(2, 256)}},
          "final_layer": {"linear": {"w": f(256, 300)}}}
    return {"llm": tree, "rf_head": rf}


@pytest.mark.parametrize(
    "param_dtype,rf_param_dtype,want",
    [("int8", None, ((8, "linear"), (8, "linear"))), ("int4", "int8", ((4, "linear"), (8, "linear"))),
     (None, None, ((4, "linear"), (4, "linear"))), ("int4-nf4", None, ((4, "nf4"), (4, "nf4"))),
     ("int4-nf4", "int8", ((4, "nf4"), (8, "linear")))],
    ids=["int8", "int4-llm-int8-rf", "default-int4", "int4-nf4", "nf4-llm-int8-rf"],
)
def test_quantize_mm_params_tier_gives_jax_bytes(param_dtype, rf_param_dtype, want):
    """`quantize_mm_params_inplace` at a RuntimeConfig's tier (`tier_bits`, as
    the JAX package's checkpoint load resolves param_dtype / rf_param_dtype),
    or with no tier arguments (int4), against the JAX `quantize_tree` bytes of
    each part."""
    from mingunivision_tpu_torch.config import RuntimeConfig
    from mingunivision_tpu_torch.utils.convert import quantize_mm_params_inplace, tier_bits

    tree = _mm_tree()
    if param_dtype is None:
        got = quantize_mm_params_inplace(_to_torch(tree))
    else:
        runtime = RuntimeConfig(param_dtype=param_dtype, rf_param_dtype=rf_param_dtype)
        kw = tier_bits(runtime)
        assert ((kw["bits"], kw["scheme"]), (kw["rf_bits"], kw["rf_scheme"])) == want
        got = quantize_mm_params_inplace(_to_torch(tree), **kw)
    for key, (bits, scheme) in zip(("llm", "rf_head"), want):
        _compare_trees(got[key], jq.quantize_tree(_to_jnp(tree[key]), bits=bits, scheme=scheme))
    assert tier_bits(RuntimeConfig()) is None  # bf16 keeps the tree floating
