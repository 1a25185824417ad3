"""PyTorch port, the dot-mode variants of the quantized kernels and the NF4
entries: the plain versions of the four CUDA kernel modes added beside the
int4 / int8 kernels (7e: int4 decode MoE with exact dequant; 7f / 7g: int8
and int4 prefill MoE with s8 dots, through the expert-sorted and the
capacity dispatch; 7h: the fused int8 RF sampler with s8 dots) against the
JAX package's Pallas kernels run in interpret mode on the CPU, and the NF4
decode and prefill entries (plain dequant on every device; the JAX package
has no NF4 kernel) against the JAX functions that run NF4 there
(`moe_experts_gather`, `moe_experts_dense`). The CUDA kernels themselves are
held against these plain versions in tests/test_torch_kernels_cuda.py.

Tolerances, relative to the largest output:
  - exact dequant (7e): EXACT_REL = 4e-3, which admits one bf16 rounding of h
    that flips under fp32 reassociation;
  - s8 dots (7f, 7g, 7h): S8_REL = 1e-4 with the port's silu computed by the
    JAX package's formula (x * sigmoid(x)): the integer sums are exact, and
    the fp32 epilogue runs in another order. As shipped, the port's silu
    (`intdot.silu_exact`, the kernels' g / (1 + exp(-g)) with the exp in
    double) differs from that formula in the last place, and one such ulp
    can flip the s8 rounding of an element of a = silu(g) * u; a flip moves
    an output by one quantization step of its row's chunk times one weight,
    about max|a| / 127 * 8 * s2, so the shipped plain version is held within
    SILU_ULP_REL = 2e-3 (measured: 1.2e-4 in the int4 capacity case);
  - NF4: NF4_REL = 1e-5 in fp32, both sides plain dequant.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import RFHeadConfig
from mingunivision_tpu.models.bailing_moe import moe_experts_dense, moe_experts_gather
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.ops.kernels import moe_capacity as jcap
from mingunivision_tpu.ops.kernels import moe_stream as jstream
from mingunivision_tpu.ops.kernels import rf_mlp as jrf_mlp
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as jax_swiglu_gmm
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_array, quantize_tree
from mingunivision_tpu_torch.ops.kernels import moe_capacity as tcap
from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as tgmm
from mingunivision_tpu_torch.ops.kernels import rf_sampler as tsampler
from mingunivision_tpu_torch.ops.kernels.moe_stream import (
    moe_experts_nf4,
    moe_experts_stream,
    moe_experts_stream_plain,
    moe_experts_stream_q4_plain,
    table_kind,
)
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_plain,
    moe_experts_swiglu_gmm_q4_plain,
    moe_experts_swiglu_gmm_q8_plain,
    pick_chunk_q8,
)
from mingunivision_tpu_torch.ops.kernels.rf_sampler import (
    down_chunk,
    rf_sample_fused,
    rf_sample_fused_plain,
    rf_sample_fused_q8_plain,
)
from mingunivision_tpu_torch.utils.convert import params_from_jax
import test_torch_common  # noqa: F401  (one torch thread per test worker)

EXACT_REL = 4e-3
S8_REL = 1e-4
SILU_ULP_REL = 2e-3
NF4_REL = 1e-5
E, H, M = 8, 256, 384  # 128-aligned, as the Pallas kernels need


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _experts(seed, bits, layers=None, scheme="linear"):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M), "down_proj": (E, M, H)}
    return {k: quantize_array(jnp.asarray(0.05 * rng.standard_normal(lead + s), jnp.float32), bits, scheme=scheme)
            for k, s in shapes.items()}


def _routing(seed, n, k, choices=None):
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if choices is None else np.asarray(choices)
    idx = np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


def _jax_silu(monkeypatch, module):
    """The port's plain s8 versions in `module` with silu as the JAX package writes it."""
    monkeypatch.setattr(module, "silu_exact", lambda g: g * torch.sigmoid(g))


def _torch_args(ex, x, idx, w):
    return params_from_jax(ex, "cpu"), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w)


def test_the_modes_read_the_jax_shapes():
    """The chunk widths the s8 kernels re-quantize over are the JAX package's:
    128 columns of the 16B-A3B m = 1408 (int8 prefill), 4096 of H = 8192 (int8
    sampler), and what the tiny shapes here give."""
    from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import _pick_chunk

    for m in (1408, 384, 256, 640):
        assert pick_chunk_q8(m) == _pick_chunk(m, 2048, 1)
    assert down_chunk(8192) == 4096 and down_chunk(256) == 256 and down_chunk(6144) == 2048


# ---------------------------------------------------------------------------
# 7e: decode MoE, int4 tables, exact dequant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 16], ids=["N1", "N2", "N3", "N16-A>E"])
def test_moe_stream_q4_exact_plain_matches_pallas(n, monkeypatch):
    ex = _experts(0, 4, layers=3)
    idx, w = _routing(1, n, 4)
    x = np.random.default_rng(2).standard_normal((n, H)).astype(np.float32)
    monkeypatch.setattr(jstream, "INT_DOT_STREAM", False)
    want = jstream.moe_experts_stream(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True,
                                      layer_idx=2)
    args = _torch_args(ex, x, idx, w)
    got = moe_experts_stream_q4_plain(*args, layer_idx=2)
    _close(got.numpy(), want, EXACT_REL)
    # the dispatching wrapper takes the same plain version for CPU tensors in the exact dot mode
    np.testing.assert_array_equal(moe_experts_stream(*args, layer_idx=2, int_dots=False).numpy(), got.numpy())
    np.testing.assert_array_equal(moe_experts_stream_plain(*args, layer_idx=2, int_dots=False).numpy(), got.numpy())


def test_moe_stream_q4_exact_bf16_rows_match_pallas(monkeypatch):
    """bf16 rows, as on the card: both round h to bf16 before the down dots."""
    ex = _experts(3, 4)
    idx, w = _routing(4, 2, 4)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, H)), jnp.bfloat16)
    monkeypatch.setattr(jstream, "INT_DOT_STREAM", False)
    want = jstream.moe_experts_stream(ex, x, jnp.asarray(idx), jnp.asarray(w, jnp.bfloat16), interpret=True)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = moe_experts_stream_q4_plain(params_from_jax(ex, "cpu"), xt, torch.from_numpy(idx),
                                      torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), EXACT_REL)


# ---------------------------------------------------------------------------
# 7f / 7g: prefill MoE with s8 dots, int8 and int4 tables, both dispatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("choices", [None, [1, 6]], ids=["sorted", "skewed-to-2"])
def test_swiglu_gmm_s8_plain_matches_pallas(bits, choices, monkeypatch):
    ex = _experts(6 + bits, bits, layers=2)
    idx, w = _routing(7, 40, 2, choices)
    x = np.random.default_rng(8).standard_normal((40, H)).astype(np.float32)
    want = jax_swiglu_gmm(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, tm=32, interpret=True, s8=True,
                          layer_idx=1)
    args = _torch_args(ex, x, idx, w) + (E,)
    plain = moe_experts_swiglu_gmm_q8_plain if bits == 8 else moe_experts_swiglu_gmm_q4_plain
    got = plain(*args, layer_idx=1, s8=True)
    _close(got.numpy(), want, SILU_ULP_REL)
    np.testing.assert_array_equal(moe_experts_swiglu_gmm(*args, layer_idx=1, s8=True).numpy(), got.numpy())
    # and the exact mode is another function of the same tables
    assert not np.array_equal(plain(*args, layer_idx=1).numpy(), got.numpy())
    _jax_silu(monkeypatch, tgmm)
    _close(plain(*args, layer_idx=1, s8=True).numpy(), want, S8_REL)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_capacity_dispatch_s8_matches_pallas(bits, case, monkeypatch):
    ex = _experts(9 + bits, bits, layers=2)
    n, k = 32, 3
    idx, w = _routing(10, n, k)
    capacity = 96
    if case == "overflow":  # every assignment on expert 0: load 96 > capacity 32
        idx, capacity = np.zeros_like(idx), 32
    x = np.random.default_rng(11).standard_normal((n, H)).astype(np.float32)
    want = jcap.moe_experts_capacity_gmm_exact(ex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, capacity,
                                               tm_fallback=32, s8=True, interpret=True, layer_idx=1)
    fallbacks = tcap.moe_experts_capacity_gmm_exact.fallbacks
    args = _torch_args(ex, x, idx, w) + (E, capacity)
    got = tcap.moe_experts_capacity_gmm_exact(*args, layer_idx=1, s8=True)
    _close(got.numpy(), want, SILU_ULP_REL)
    assert tcap.moe_experts_capacity_gmm_exact.fallbacks == fallbacks + int(case == "overflow")
    np.testing.assert_array_equal(tcap.moe_experts_capacity_gmm_exact_plain(*args, layer_idx=1, s8=True).numpy(),
                                  got.numpy())
    _jax_silu(monkeypatch, tgmm)
    _close(tcap.moe_experts_capacity_gmm_exact(*args, layer_idx=1, s8=True).numpy(), want, S8_REL)


# ---------------------------------------------------------------------------
# 7h: fused RF sampler, int8 tables, s8 dots
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
    return cfg, params


@pytest.mark.parametrize(
    "cfg_rows,n_img,renorm,dtype",
    [(2, 1, None, "float32"), (3, 1, "channel", "float32"), (2, 1, None, "bfloat16"), (3, 1, "channel", "bfloat16")],
    ids=["cfg2-f32", "cfg3-renorm-f32", "cfg2-bf16", "cfg3-renorm-bf16"],
)
def test_rf_sample_fused_q8_s8_plain_matches_pallas(rf_setup, cfg_rows, n_img, renorm, dtype, monkeypatch):
    cfg, params = rf_setup
    rng = np.random.default_rng(3)
    z = jnp.asarray(rng.standard_normal((cfg_rows * n_img, cfg.z_channels)), jnp.float32)
    noise = np.tile(rng.standard_normal((n_img, cfg.target_channels)).astype(np.float32), (cfg_rows, 1))
    ts, dts = _time_grid(cfg, None)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm == "channel")
    monkeypatch.setattr(jrf_mlp, "INT8_INT_DOTS", True)
    want = jax_rf_sample_fused(params, cfg, jnp.asarray(noise), block_mods, final_mods, dts, jnp.float32(3.0),
                               jnp.float32(1.1), compute_dtype=getattr(jnp, dtype), interpret=True, **kw)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    args = (params_from_jax(params, "cpu"), cfg, t(noise), t(block_mods), t(final_mods), t(dts), 3.0, 1.1)
    kw["compute_dtype"] = getattr(torch, dtype)
    got = rf_sample_fused_q8_plain(*args, s8_dots=True, **kw)
    _close(got.numpy(), want, SILU_ULP_REL)
    np.testing.assert_array_equal(rf_sample_fused_plain(*args, s8_dots=True, **kw).numpy(), got.numpy())
    np.testing.assert_array_equal(rf_sample_fused(*args, s8_dots=True, **kw).numpy(), got.numpy())
    _jax_silu(monkeypatch, tsampler)
    _close(rf_sample_fused_q8_plain(*args, s8_dots=True, **kw).numpy(), want, S8_REL)


# ---------------------------------------------------------------------------
# NF4: plain-dequant decode and prefill entries
# ---------------------------------------------------------------------------


def test_nf4_tables_take_their_own_kind():
    ex = params_from_jax(_experts(20, 4, scheme="nf4"), "cpu")
    assert table_kind("t", ex) == "nf4"


@pytest.mark.parametrize("n", [1, 2, 16], ids=["N1", "N2", "N16"])
def test_nf4_decode_entry_matches_jax_gather(n):
    ex = _experts(21, 4, layers=2, scheme="nf4")
    idx, w = _routing(22, n, 3)
    x = np.random.default_rng(23).standard_normal((n, H)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[1], ex)
    want = moe_experts_gather(layer, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w))
    args = _torch_args(ex, x, idx, w)
    got = moe_experts_nf4(*args, layer_idx=1)
    _close(got.numpy(), want, NF4_REL)
    # the decode dispatch takes it in either dot mode (no kernel reads NF4)
    for int_dots in (True, False):
        np.testing.assert_array_equal(moe_experts_stream(*args, layer_idx=1, int_dots=int_dots).numpy(), got.numpy())


@pytest.mark.parametrize("s8", [False, True], ids=["exact", "s8-not-read"])
def test_nf4_prefill_entry_matches_jax_dense(s8):
    ex = _experts(24, 4, layers=2, scheme="nf4")
    idx, w = _routing(25, 40, 2)
    x = np.random.default_rng(26).standard_normal((40, H)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[0], ex)
    want = moe_experts_dense(layer, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E)
    args = _torch_args(ex, x, idx, w) + (E,)
    got = moe_experts_swiglu_gmm_plain(*args, layer_idx=0, s8=s8)
    _close(got.numpy(), want, NF4_REL)
    np.testing.assert_array_equal(moe_experts_swiglu_gmm(*args, layer_idx=0, s8=s8).numpy(), got.numpy())
