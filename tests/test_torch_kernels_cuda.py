"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch version
on the card, in bf16 (the int4 kernels on int4 tables of the same weights;
the RF sampler to the bit, since its plain version sums in its order; both
flash-attention entry points; the prefill MoE kernels also through the
capacity-dense dispatch). The
kernels have no CPU mode, so every test here is marked `cuda` and skips
without a card. Imports torch and the port only (the
card's machine has no JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from mingunivision_tpu_torch.config import RFHeadConfig
from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain
from mingunivision_tpu_torch.ops.kernels.flash import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
    flash_vit_attention,
    flash_vit_attention_plain,
)
from mingunivision_tpu_torch.ops.kernels.moe_capacity import (
    moe_experts_capacity_gmm,
    moe_experts_capacity_gmm_exact,
    moe_experts_capacity_gmm_exact_plain,
)
from mingunivision_tpu_torch.ops.kernels.moe_stream import (
    moe_experts_stream,
    moe_experts_stream_plain,
    moe_experts_stream_q4s8,
)
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_plain,
    moe_experts_swiglu_gmm_q4,
)
from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sample_fused_plain
from mingunivision_tpu_torch.utils.convert import _Init, init_rf_head_params
from mingunivision_tpu_torch.utils.quantize import quantize_array, quantize_tree_inplace

pytestmark = pytest.mark.cuda
E, H, M = 8, 256, 384


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _experts(dev, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"gate_proj": (layers, E, H, M), "up_proj": (layers, E, H, M), "down_proj": (layers, E, M, H)}
    return {k: torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.05, generator=g) for k, s in shapes.items()}


def _routing(dev, n, k, choices=None, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.rand((n, E), device=dev, generator=g)
    if choices is not None:
        allowed = torch.zeros(E, dtype=torch.bool, device=dev)
        allowed[choices] = True
        scores = scores.masked_fill(~allowed, -1.0)
    w, idx = torch.topk(scores, k)
    return idx, (w / w.sum(-1, keepdim=True)).to(torch.bfloat16)


def _close_bf16(got, want):
    """bf16 keeps about 3 significant digits: max |err| <= 1e-2 * max |want|."""
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item() + 1e-6, err


@pytest.mark.parametrize("n", [1, 2, 5, 16], ids=["1row", "2rows", "5rows", "16rows-2chunks-A>E"])
def test_moe_stream_kernel_matches_plain(dev, n):
    ex = _experts(dev)
    idx, w = _routing(dev, n, 6)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    before = moe_experts_stream.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert moe_experts_stream.launches == before + 1
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))


@pytest.mark.parametrize("choices", [None, [0, 3, 5]], ids=["spread", "skewed-empty-experts"])
def test_swiglu_gmm_kernel_matches_plain(dev, choices):
    ex = _experts(dev, seed=2)
    idx, w = _routing(dev, 96, 2, choices, seed=3)
    x = torch.randn(96, H, device=dev).to(torch.bfloat16)
    before = moe_experts_swiglu_gmm.launches
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    torch.cuda.synchronize()
    assert moe_experts_swiglu_gmm.launches == before + 1
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=0))


@pytest.mark.parametrize("D,G", [(128, 4), (64, 2)])
def test_decode_attention_kernel_matches_plain(dev, D, G):
    B, Hkv, S = 2, 4, 4096
    q = torch.randn(B, 1, Hkv * G, D, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, device=dev).to(torch.bfloat16)
    mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
    mask[0, :700] = True
    mask[1, :321] = True
    mask[1, 400:450] = True  # CFG-style hole
    mask[1, 4000] = True  # a lone allowed position in the last tile
    before = decode_attention.launches
    got = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _close_bf16(got, decode_attention_plain(q, k, v, mask))


def test_decode_attention_fully_masked_row_is_zero_not_nan(dev):
    q = torch.randn(1, 1, 8, 128, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 2, 512, 128, device=dev).to(torch.bfloat16)
    out = decode_attention(q, k, k, torch.zeros(1, 512, dtype=torch.bool, device=dev))
    assert torch.equal(out.float(), torch.zeros_like(out.float()))


def test_wrappers_raise_on_unsupported_input(dev):
    ex = _experts(dev)
    idx, w = _routing(dev, 2, 6)
    x = torch.randn(2, H, device=dev)  # fp32: the kernels take bf16
    with pytest.raises(ValueError):
        moe_experts_stream(ex, x, idx, w, layer_idx=0)
    with pytest.raises(ValueError):
        moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    q = torch.randn(1, 1, 8, 96, device=dev).to(torch.bfloat16)  # head_dim 96 is not built
    kc = torch.randn(1, 2, 64, 96, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        decode_attention(q, kc, kc, torch.ones(1, 64, dtype=torch.bool, device=dev))


def _q4(tables):
    return {k: quantize_array(v, 4) for k, v in tables.items()}


@pytest.mark.parametrize("n", [1, 2, 5, 16], ids=["1row", "2rows", "5rows-2chunks", "16rows-A>E"])
def test_moe_stream_q4s8_kernel_matches_plain(dev, n):
    ex = _q4(_experts(dev, seed=4))
    idx, w = _routing(dev, n, 6, seed=5)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    before = moe_experts_stream_q4s8.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert moe_experts_stream_q4s8.launches == before + 1
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))


@pytest.mark.parametrize("choices", [None, [0, 3, 5]], ids=["spread", "skewed-empty-experts"])
def test_swiglu_gmm_q4_kernel_matches_plain(dev, choices):
    ex = _q4(_experts(dev, seed=6))
    idx, w = _routing(dev, 96, 2, choices, seed=7)
    x = torch.randn(96, H, device=dev).to(torch.bfloat16)
    before = moe_experts_swiglu_gmm_q4.launches
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    torch.cuda.synchronize()
    assert moe_experts_swiglu_gmm_q4.launches == before + 1
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=0))


@pytest.mark.parametrize("rows,renorm", [(1, False), (2, False), (3, True)], ids=["unguided", "cfg2", "cfg3-renorm"])
def test_rf_sampler_kernel_matches_plain(dev, rows, renorm):
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(8)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=4, min_size=1024)
    ts, dts = _time_grid(cfg, None, device=dev)
    z = torch.randn(rows, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(1, cfg.target_channels, device=dev, generator=g).repeat(rows, 1)
    args = (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
    kw = dict(cfg_rows=rows, renorm_channel=renorm, compute_dtype=torch.bfloat16)
    before = rf_sample_fused.launches
    got = rf_sample_fused(*args, **kw)
    torch.cuda.synchronize()
    assert rf_sample_fused.launches == before + 1
    torch.testing.assert_close(got, rf_sample_fused_plain(*args, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("T,pads,Hq,Hkv,D", [(1152, 92, 16, 4, 128), (512, 0, 16, 4, 128), (640, 37, 4, 4, 64),
                                             (128, 100, 8, 2, 128)],
                         ids=["understanding-1152-92pads", "512-nopads", "640-mha-d64", "128-mostly-pads"])
def test_flash_prefill_kernel_matches_plain(dev, T, pads, Hq, Hkv, D):
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(2, T, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(2, T, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(2, T, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    valid = torch.ones(2, T, dtype=torch.bool, device=dev)
    valid[0, T - pads:] = False  # row 1 of the batch has no padding
    before = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v, valid, scale=D**-0.5)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == before + 1
    want = flash_prefill_attention_plain(q, k, v, valid, scale=D**-0.5)
    _close_bf16(got[valid], want[valid])
    _close_bf16(got, want)  # the padding rows are defined by the same rule


@pytest.mark.parametrize("B,H,N,D,dtype", [(1, 16, 1024, 64, torch.bfloat16), (2, 4, 512, 128, torch.bfloat16),
                                           (1, 16, 1024, 64, torch.float32)],
                         ids=["pixel-decoder", "d128", "fp32-in-default-tier"])
def test_flash_vit_kernel_matches_plain(dev, B, H, N, D, dtype):
    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(B, H, N, D, device=dev, generator=g).to(dtype) for _ in range(3))
    before = flash_vit_attention.launches
    got = flash_vit_attention(q, k, v, scale=D**-0.5)
    torch.cuda.synchronize()
    assert flash_vit_attention.launches == before + 1 and got.dtype == dtype
    _close_bf16(got, flash_vit_attention_plain(q, k, v, scale=D**-0.5))


def test_flash_wrappers_raise_on_unsupported_input(dev):
    q = torch.randn(1, 96, 4, 128, device=dev).to(torch.bfloat16)  # T = 96 is not a multiple of the tile
    with pytest.raises(ValueError):
        flash_prefill_attention(q, q, q, torch.ones(1, 96, dtype=torch.bool, device=dev), scale=1.0)
    q = torch.randn(1, 4, 128, 32, device=dev).to(torch.bfloat16)  # head_dim 32 is not built
    with pytest.raises(ValueError):
        flash_vit_attention(q, q, q, scale=1.0)


@pytest.mark.parametrize("tier", ["bf16", "int4"])
@pytest.mark.parametrize("case", ["fits", "fits-with-pads", "overflow"])
def test_swiglu_gmm_kernels_through_the_capacity_schedule_match_plain(dev, tier, case):
    """Kernels 2 and 5 launched through the capacity-dense dispatch: one group
    per expert, tiles over each expert's occupied slots; on overflow the
    expert-sorted dispatch runs and is counted as a fallback."""
    ex = _experts(dev, seed=11)
    if tier == "int4":
        ex = _q4(ex)
    n, k, capacity = 640, 2, 256  # mean load 160
    idx, w = _routing(dev, n, k, [0, 3, 5] if case == "overflow" else None, seed=12)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    valid = None
    if case == "fits-with-pads":  # 200 padding rows that all route to experts 0 and 1
        valid = torch.arange(n, device=dev) < n - 200
        x[~valid], idx[~valid], w[~valid] = x[-1].clone(), torch.tensor([0, 1], device=dev), w[-1].clone()
    kernel = moe_experts_swiglu_gmm_q4 if tier == "int4" else moe_experts_swiglu_gmm
    before = (kernel.launches, moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks)
    got = moe_experts_capacity_gmm_exact(ex, x, idx, w, E, capacity, token_valid=valid, layer_idx=1)
    torch.cuda.synchronize()
    fell_back = int(case == "overflow")
    assert (kernel.launches, moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks) == \
        (before[0] + 1, before[1] + 1 - fell_back, before[2] + fell_back)
    want = moe_experts_capacity_gmm_exact_plain(ex, x, idx, w, E, capacity, token_valid=valid, layer_idx=1)
    rows = slice(None) if valid is None else valid
    _close_bf16(got[rows], want[rows])
    _close_bf16(got[rows], moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=1)[rows])
    if valid is not None:
        assert not got[~valid].any()  # padding rows give zeros
