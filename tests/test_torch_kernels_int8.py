"""PyTorch port, int8 kernel modules: the plain versions of the four int8 CUDA
kernels (decode MoE with s8 dots and with exact dequant, prefill MoE with
exact dequant through the expert-sorted and the capacity dispatch, the fused
RF sampler with exact dequant) against the JAX package's Pallas kernels run
in interpret mode on the CPU. The CUDA kernels themselves are held against
these plain versions in tests/test_torch_kernels_cuda.py.

Tolerances, relative to the largest output:
  - s8 dots: 1e-4, as the int4 file: the integer sums are exact, and the fp32
    epilogue runs in another order;
  - exact dequant: 4e-3, which admits one bf16 rounding of h that flips under
    fp32 reassociation.
Measured here (max abs error / max |want|): decode s8 7.6e-8 / 1.0e-7 /
1.2e-7 at N = 2 / 3 / 16, exact 5.7e-7 / 4.8e-7 / 5.6e-7 (bf16 rows: 0); prefill 4.4e-7
(sorted), 8.8e-7 (skewed), 7.2e-7 / 9.2e-7 (capacity, fits / overflow);
sampler 8.6e-8 to 1.2e-6 (fp32 and bf16 compute; its dots exact sums
rounded once, `rf_sampler._digit_dot`), grouped 8.1e-7 / 4.5e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import RFHeadConfig
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.ops.kernels import moe_capacity as jcap
from mingunivision_tpu.ops.kernels import moe_stream as jstream
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as jax_swiglu_gmm
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_array, quantize_tree
from mingunivision_tpu_torch.ops.kernels import moe_capacity as tcap
from mingunivision_tpu_torch.ops.kernels.moe_stream import (
    moe_experts_stream,
    moe_experts_stream_plain,
    moe_experts_stream_q8_plain,
    moe_experts_stream_q8s8_plain,
    table_kind,
)
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_q8,
    moe_experts_swiglu_gmm_q8_plain,
)
from mingunivision_tpu_torch.ops.kernels.rf_sampler import (
    MAX_ROWS,
    rf_sample_fused,
    rf_sample_fused_plain,
    rf_sample_fused_q8,
    rf_sample_fused_q8_plain,
    rf_sampler_supported,
)
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import is_int8_linear
from mingunivision_tpu_torch.utils.quantize import quantize_array as port_quantize_array
import test_torch_common  # noqa: F401  (one torch thread per test worker)

S8_REL = 1e-4
EXACT_REL = 4e-3
E, H, M = 8, 256, 384  # 128-aligned, as the Pallas kernels need


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _q8_experts(seed, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M), "down_proj": (E, M, H)}
    return {k: quantize_array(jnp.asarray(0.05 * rng.standard_normal(lead + s), jnp.float32), 8)
            for k, s in shapes.items()}


def _routing(seed, n, k, choices=None):
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if choices is None else np.asarray(choices)
    idx = np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


def test_int8_tables_are_recognised():
    ex = params_from_jax(_q8_experts(0), "cpu")
    assert all(is_int8_linear(t) for t in ex.values()) and table_kind("t", ex) == "int8"
    # the port's own quantizer gives the same kind of table; int4 is not int8
    assert is_int8_linear(port_quantize_array(torch.randn(4, 64, 32), 8))
    assert not is_int8_linear(port_quantize_array(torch.randn(4, 64, 32), 4))
    # linear int4 and NF4 tables have kinds of their own and run in both decode dot modes (exact-dequant int4
    # and the NF4 entries are ported); shard-grouped int4 tables stay unported and raise
    shapes = {"gate_proj": (E, 64, 32), "up_proj": (E, 64, 32), "down_proj": (E, 32, 64)}
    x, idx, w = torch.randn(2, 64), torch.tensor([[0, 1], [2, 1]]), torch.full((2, 2), 0.5)
    for scheme, kind in (("linear", "int4"), ("nf4", "nf4")):
        tables = {k: port_quantize_array(torch.randn(sh), 4, scheme=scheme) for k, sh in shapes.items()}
        assert table_kind("t", tables) == kind
        for int_dots in (True, False):
            y = moe_experts_stream_plain(tables, x, idx, w, int_dots=int_dots)
            assert y.shape == (2, 64) and bool(torch.isfinite(y).all())
    grouped = {k: port_quantize_array(torch.randn(sh), 4, groups=2) for k, sh in shapes.items()}
    with pytest.raises(NotImplementedError):
        table_kind("t", grouped)
    with pytest.raises(NotImplementedError):
        moe_experts_stream_plain(grouped, x, idx, w, int_dots=False)


# ---------------------------------------------------------------------------
# 7a / 7b: decode MoE, int8 tables, s8 dots and exact dequant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int_dots", [True, False], ids=["s8", "exact"])
@pytest.mark.parametrize("n", [2, 3, 16], ids=["N2", "N3-A>E", "N16-A>E"])
def test_moe_stream_q8_plain_matches_pallas(n, int_dots, monkeypatch):
    ex = _q8_experts(0, layers=3)
    idx, w = _routing(1, n, 4)
    x = np.random.default_rng(2).standard_normal((n, H)).astype(np.float32)
    monkeypatch.setattr(jstream, "INT_DOT_STREAM_INT8", int_dots)
    want = jstream.moe_experts_stream(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True,
                                      layer_idx=2)
    args = (params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    plain = moe_experts_stream_q8s8_plain if int_dots else moe_experts_stream_q8_plain
    got = plain(*args, layer_idx=2)
    _close(got.numpy(), want, S8_REL if int_dots else EXACT_REL)
    # the dispatching wrapper takes the same plain version for CPU tensors
    np.testing.assert_array_equal(moe_experts_stream(*args, layer_idx=2, int_dots=int_dots).numpy(), got.numpy())


def test_moe_stream_q8_exact_bf16_rows_match_pallas(monkeypatch):
    """bf16 rows, as on the card: both round h to bf16 before the down dot."""
    ex = _q8_experts(3)
    idx, w = _routing(4, 2, 4)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, H)), jnp.bfloat16)
    monkeypatch.setattr(jstream, "INT_DOT_STREAM_INT8", False)
    want = jstream.moe_experts_stream(ex, x, jnp.asarray(idx), jnp.asarray(w, jnp.bfloat16), interpret=True)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = moe_experts_stream_q8_plain(params_from_jax(ex, "cpu"), xt, torch.from_numpy(idx),
                                      torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), EXACT_REL)


# ---------------------------------------------------------------------------
# 7c: prefill MoE, int8 tables, exact dequant (sorted and capacity dispatch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("choices", [None, [1, 6]], ids=["sorted", "skewed-to-2"])
def test_swiglu_gmm_q8_plain_matches_pallas(choices):
    ex = _q8_experts(6, layers=2)
    idx, w = _routing(7, 40, 2, choices)
    x = np.random.default_rng(8).standard_normal((40, H)).astype(np.float32)
    want = jax_swiglu_gmm(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, tm=32, interpret=True,
                          layer_idx=1)
    args = (params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E)
    got = moe_experts_swiglu_gmm_q8_plain(*args, layer_idx=1)
    _close(got.numpy(), want, EXACT_REL)
    np.testing.assert_array_equal(moe_experts_swiglu_gmm(*args, layer_idx=1).numpy(), got.numpy())
    np.testing.assert_array_equal(moe_experts_swiglu_gmm_q8(*args, layer_idx=1).numpy(), got.numpy())


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_capacity_dispatch_q8_matches_pallas(case):
    ex = _q8_experts(9, layers=2)
    n, k = 32, 3
    idx, w = _routing(10, n, k)
    capacity = 96
    if case == "overflow":  # every assignment on expert 0: load 96 > capacity 32
        idx, capacity = np.zeros_like(idx), 32
    x = np.random.default_rng(11).standard_normal((n, H)).astype(np.float32)
    want = jcap.moe_experts_capacity_gmm_exact(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, capacity,
                                               tm_fallback=32, s8=False, interpret=True, layer_idx=1)
    fallbacks = tcap.moe_experts_capacity_gmm_exact.fallbacks
    got = tcap.moe_experts_capacity_gmm_exact(params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx),
                                              torch.from_numpy(w), E, capacity, layer_idx=1)
    _close(got.numpy(), want, EXACT_REL)
    assert tcap.moe_experts_capacity_gmm_exact.fallbacks == fallbacks + int(case == "overflow")


# ---------------------------------------------------------------------------
# 7d: fused RF sampler, int8 tables, exact dequant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rf_setup():
    # the Pallas kernel needs a 128-aligned width and hidden: width 384, mlp_mult 1 -> SwiGLU hidden 256
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=384, depth=2, mlp_mult=1, num_sampling_steps=4)
    params = init_rf_head_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    for leaf in (params["res_blocks"]["adaLN"], params["final_layer"]["adaLN"], params["final_layer"]["linear"]):
        leaf["w"] = jnp.asarray(0.05 * rng.standard_normal(leaf["w"].shape), jnp.float32)
    params["res_blocks"] = quantize_tree(params["res_blocks"], bits=8, min_size=1024)
    assert params["res_blocks"]["mlp"]["w12"]["w"].bits == 8
    return cfg, params


def _rf_inputs(cfg, params, cfg_rows, n_img, seed):
    rng = np.random.default_rng(seed)
    z = jnp.asarray(rng.standard_normal((cfg_rows * n_img, cfg.z_channels)), jnp.float32)
    noise = np.tile(rng.standard_normal((n_img, cfg.target_channels)).astype(np.float32), (cfg_rows, 1))
    ts, dts = _time_grid(cfg, None)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    return noise, block_mods, final_mods, dts


def _run_both(cfg, params, cfg_rows, n_img, renorm, dtype, seed):
    noise, block_mods, final_mods, dts = _rf_inputs(cfg, params, cfg_rows, n_img, seed)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm == "channel")
    want = jax_rf_sample_fused(params, cfg, jnp.asarray(noise), block_mods, final_mods, dts, jnp.float32(3.0),
                               jnp.float32(1.1), compute_dtype=getattr(jnp, dtype), interpret=True, **kw)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    args = (params_from_jax(params, "cpu"), cfg, t(noise), t(block_mods), t(final_mods), t(dts), 3.0, 1.1)
    return want, args, dict(compute_dtype=getattr(torch, dtype), **kw)


@pytest.mark.parametrize(
    "cfg_rows,n_img,renorm,dtype",
    [(2, 1, None, "float32"), (3, 1, "channel", "float32"), (1, 2, None, "float32"), (2, 1, "channel", "bfloat16"),
     (3, 1, "channel", "bfloat16")],
    ids=["cfg2-f32", "cfg3-renorm-f32", "unguided-2img-f32", "cfg2-renorm-bf16", "cfg3-renorm-bf16"],
)
def test_rf_sample_fused_q8_plain_matches_pallas(rf_setup, cfg_rows, n_img, renorm, dtype):
    cfg, params = rf_setup
    want, args, kw = _run_both(cfg, params, cfg_rows, n_img, renorm, dtype, seed=3)
    assert rf_sampler_supported(args[0], cfg_rows * n_img, cfg_rows)
    got = rf_sample_fused_q8_plain(*args, **kw)
    _close(got.numpy(), want, EXACT_REL)
    np.testing.assert_array_equal(rf_sample_fused_plain(*args, **kw).numpy(), got.numpy())
    np.testing.assert_array_equal(rf_sample_fused(*args, **kw).numpy(), got.numpy())


@pytest.mark.parametrize("cfg_rows,n_img,renorm", [(3, 2, "channel"), (2, 4, None)], ids=["2img-x3rows", "4img-x2rows"])
def test_rf_sample_fused_q8_over_more_rows_than_one_launch(rf_setup, cfg_rows, n_img, renorm):
    """6 and 8 block-major rows, more than the kernel's MAX_ROWS: the wrapper
    samples them in groups of whole images (on the CPU through the plain
    version), equal to the plain version over all rows at once up to the
    sums' order, and within the tolerance of the JAX kernel."""
    cfg, params = rf_setup
    assert cfg_rows * n_img > MAX_ROWS
    want, args, kw = _run_both(cfg, params, cfg_rows, n_img, renorm, "float32", seed=11)
    grouped = rf_sample_fused_q8(*args, **kw)
    _close(grouped.numpy(), rf_sample_fused_q8_plain(*args, **kw).numpy(), 1e-5)
    _close(grouped.numpy(), want, EXACT_REL)
