"""PyTorch port, int4 kernel modules: the plain versions of the three int4
CUDA kernels (decode MoE with s8 dots, prefill MoE with exact dequant, the
fused RF sampler) and the integer-dot helpers they share, against the JAX
package's Pallas kernels run in interpret mode on the CPU. The CUDA kernels
themselves are held against these plain versions in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import RFHeadConfig
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.ops.kernels import intdot as jintdot
from mingunivision_tpu.ops.kernels.moe_stream import moe_experts_stream as jax_moe_stream
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as jax_swiglu_gmm
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_array, quantize_tree
from mingunivision_tpu_torch.ops.kernels import intdot
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_q4s8_plain
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_q4_plain
from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sample_fused_plain
from mingunivision_tpu_torch.utils.convert import params_from_jax

# fp32 results of the same integer dots and the same fp32 epilogue, summed in
# another order: about 1e-4 relative to the largest output
REL = 1e-4
E, H, M = 8, 256, 384  # 128-aligned, as the Pallas kernels need


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# integer-dot helpers
# ---------------------------------------------------------------------------


def test_intdot_helpers_equal_jax():
    rng = np.random.default_rng(0)
    lo = rng.standard_normal((5, 64)).astype(np.float32)
    hi = rng.standard_normal((5, 64)).astype(np.float32)
    q = rng.integers(0, 256, (64, 48), dtype=np.uint8)
    want = jintdot.quant_rows_s8_pair(jnp.asarray(lo), jnp.asarray(hi))
    got = intdot.quant_rows_s8_pair(torch.from_numpy(lo), torch.from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        intdot.mm4_s8(torch.from_numpy(q), *got).numpy(), np.asarray(jintdot.mm4_s8(jnp.asarray(q), *want)))

    x = rng.standard_normal((5, 64)).astype(np.float32)
    q8 = rng.integers(-127, 128, (64, 48), dtype=np.int8)
    want8 = jintdot.quant_rows_s8(jnp.asarray(x))
    got8 = intdot.quant_rows_s8(torch.from_numpy(x))
    for g, w in zip(got8, want8):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(intdot.mm8_s8(torch.from_numpy(q8), *got8).numpy(),
                                  np.asarray(jintdot.mm8_s8(jnp.asarray(q8), *want8)))


def test_int_dot_is_exact_beyond_fp32_integers():
    """Sums past 2**24 stay exact (the int32 sums of the kernels)."""
    a = torch.full((1, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 1), -128, dtype=torch.int8)
    assert intdot.int_dot(a, b).item() == np.float32(-127 * 128 * 4096)


# ---------------------------------------------------------------------------
# K1: decode MoE, int4 tables, s8 dots
# ---------------------------------------------------------------------------


def _q4_experts(seed, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M), "down_proj": (E, M, H)}
    return {k: quantize_array(jnp.asarray(0.05 * rng.standard_normal(lead + s), jnp.float32), 4)
            for k, s in shapes.items()}


def _routing(seed, n, k):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("n,k,layers", [(2, 4, 3), (6, 4, None)], ids=["stacked-layer", "A>E-dedup"])
def test_moe_stream_q4s8_plain_matches_pallas(n, k, layers):
    ex = _q4_experts(0, layers)
    idx, w = _routing(1, n, k)
    x = np.random.default_rng(2).standard_normal((n, H)).astype(np.float32)
    lidx = None if layers is None else 2
    want = jax_moe_stream(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True, layer_idx=lidx)
    args = (params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    got = moe_experts_stream_q4s8_plain(*args, layer_idx=lidx)
    _close(got.numpy(), want)
    # the dispatching wrapper takes the same plain version for CPU tensors
    np.testing.assert_array_equal(moe_experts_stream(*args, layer_idx=lidx).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# K2: prefill MoE, int4 tables, exact dequant
# ---------------------------------------------------------------------------


def test_swiglu_gmm_q4_plain_matches_pallas():
    ex = _q4_experts(3, layers=2)
    idx, w = _routing(4, 24, 2)
    x = np.random.default_rng(5).standard_normal((24, H)).astype(np.float32)
    want = jax_swiglu_gmm(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, tm=32, interpret=True,
                          layer_idx=1)
    args = (params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E)
    got = moe_experts_swiglu_gmm_q4_plain(*args, layer_idx=1)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(moe_experts_swiglu_gmm(*args, layer_idx=1).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# K3: fused RF sampler, int4 tables, s8 dots
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rf_setup():
    # int4 split-halves need 128-aligned half planes in the Pallas kernel:
    # width 768, mlp_mult 1 -> SwiGLU hidden 512
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=768, depth=2, mlp_mult=1, num_sampling_steps=4)
    params = init_rf_head_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    for leaf in (params["res_blocks"]["adaLN"], params["final_layer"]["adaLN"], params["final_layer"]["linear"]):
        leaf["w"] = jnp.asarray(0.05 * rng.standard_normal(leaf["w"].shape), jnp.float32)
    params["res_blocks"] = quantize_tree(params["res_blocks"], bits=4, min_size=1024)
    return cfg, params


@pytest.mark.parametrize(
    "cfg_rows,n_img,renorm,dtype",
    [(2, 1, None, "float32"), (3, 1, "channel", "float32"), (1, 2, None, "float32"), (2, 1, None, "bfloat16"),
     (3, 1, "channel", "bfloat16")],
    ids=["cfg2-f32", "cfg3-renorm-f32", "unguided-2img-f32", "cfg2-bf16", "cfg3-renorm-bf16"],
)
def test_rf_sample_fused_plain_matches_pallas(rf_setup, cfg_rows, n_img, renorm, dtype):
    cfg, params = rf_setup
    rng = np.random.default_rng(3)
    B = cfg_rows * n_img
    z = jnp.asarray(rng.standard_normal((B, cfg.z_channels)), jnp.float32)
    noise = np.tile(rng.standard_normal((n_img, cfg.target_channels)).astype(np.float32), (cfg_rows, 1))
    ts, dts = _time_grid(cfg, None)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm == "channel")
    want = jax_rf_sample_fused(params, cfg, jnp.asarray(noise), block_mods, final_mods, dts, jnp.float32(3.0),
                               jnp.float32(1.1), compute_dtype=getattr(jnp, dtype), interpret=True, **kw)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    args = (params_from_jax(params, "cpu"), cfg, t(noise), t(block_mods), t(final_mods), t(dts), 3.0, 1.1)
    got = rf_sample_fused_plain(*args, compute_dtype=getattr(torch, dtype), **kw)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(rf_sample_fused(*args, compute_dtype=getattr(torch, dtype), **kw).numpy(),
                                  got.numpy())
