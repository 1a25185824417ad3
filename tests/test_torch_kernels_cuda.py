"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch version
on the card, in bf16 (the int4 and int8 kernels on int4 and int8 tables of
the same weights, in both dot modes, the int8 ones and the new modes also at
the 16B-A3B width; the int4 decode MoE with s8 dots and the int8 one with s8
dots to the bit, the int4 one with exact dequant within bf16's precision,
their launches, workspaces and tickets too; the int4 and int8 RF samplers (the int4 one in both
schedules, the int8 one in both dot modes; both at grids of 1, 5 and one CTA
per SM, their workspaces too) and the per-step RF stack in its four bodies to
the bit, since their plain versions sum in their order or exactly; the s8 prefill MoE kernels to the
bit, the full-expert-block prefill mode within bf16's precision; both
flash-attention entry points; the prefill MoE kernels also through the
capacity-dense dispatch; paged decode attention through block tables). The
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
    moe_experts_stream_q4,
    moe_experts_stream_q4s8,
    moe_experts_stream_q8,
    moe_experts_stream_q8s8,
)
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_plain,
    moe_experts_swiglu_gmm_q4,
    moe_experts_swiglu_gmm_q4_full,
    moe_experts_swiglu_gmm_q4s8,
    moe_experts_swiglu_gmm_q8,
    moe_experts_swiglu_gmm_q8_full,
    moe_experts_swiglu_gmm_q8s8,
)
from mingunivision_tpu_torch.ops.kernels import rf_mlp
from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_decode_attention, paged_gather_attention
from mingunivision_tpu_torch.ops.kernels.rf_sampler import (
    MAX_ROWS,
    rf_sample_fused,
    rf_sample_fused_plain,
    rf_sample_fused_q4_pipelined,
    rf_sample_fused_q8,
    rf_sample_fused_q8s8,
)
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


@pytest.mark.parametrize("n", [1, 2, 5, 16, 3, 12, 65],
                         ids=["1row", "2rows", "5rows-2chunks", "16rows-A>E", "3rows", "12rows", "65rows-2-launch-pairs"])
def test_moe_stream_q4s8_kernel_matches_plain(dev, n):
    """The s8-dot int4 kernel (two launches per 64 rows, the expert list built
    in the kernel): the plain version's bits, on layer 1 of stacked tables."""
    ex = _q4(_experts(dev, seed=4))
    idx, w = _routing(dev, n, 6, seed=5)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    before = moe_experts_stream_q4s8.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert moe_experts_stream_q4s8.launches == before + -(-n // 64)
    assert torch.equal(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))


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


@pytest.mark.parametrize("cfg_rows,n_img,renorm", [(3, 2, True), (2, 4, False)], ids=["2img-x3rows", "4img-x2rows"])
def test_rf_sampler_kernel_over_more_rows_than_one_launch(dev, cfg_rows, n_img, renorm):
    """More block-major rows than one launch holds: one launch per group of
    whole images, the same bits as the plain version over all rows."""
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(8)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=4, min_size=1024)
    ts, dts = _time_grid(cfg, None, device=dev)
    B = cfg_rows * n_img
    z = torch.randn(B, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    args = (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=torch.bfloat16)
    before = rf_sample_fused.launches
    got = rf_sample_fused(*args, **kw)
    torch.cuda.synchronize()
    per = MAX_ROWS // cfg_rows
    assert rf_sample_fused.launches == before + -(-n_img // per)
    torch.testing.assert_close(got, rf_sample_fused_plain(*args, **kw), rtol=0, atol=0)


def _paged_inputs(dev, B, Hq=16, Hkv=4, D=128, page=64, maxp=32, seed=13):
    """Lengths cycling through 0, 1, 63, 64, 65, 700, 2047; shuffled page ids,
    rows 0 and 1 sharing their first two pages; the scratch page, the tails
    of the last pages and the unused pages filled with +-1e4."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cycle = [0, 1, 63, 64, 65, 700, 2047]
    lengths = torch.tensor([cycle[(b + 3) % len(cycle)] for b in range(B)], dtype=torch.int32)
    if B > 1:
        lengths[:2] = torch.tensor([700, 2047], dtype=torch.int32)
    need = [-(-int(n) // page) for n in lengths]
    P = sum(need) + 2
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).tolist()
    tables = torch.full((B, maxp), P, dtype=torch.int32)
    for b in range(B):
        if b == 1:
            ids = tables[0, :2].tolist() + [perm.pop() for _ in range(need[b] - 2)]
        else:
            ids = [perm.pop() for _ in range(need[b])]
        tables[b, : need[b]] = torch.tensor(ids, dtype=torch.int32)
    kp, vp = (torch.full((Hkv, P + 1, page, D), 1e4, device=dev).to(torch.bfloat16) for _ in range(2))
    vp.neg_()
    for b in range(B):
        for i in range(need[b]):
            valid = min(page, int(lengths[b]) - i * page)
            pid = int(tables[b, i])
            kp[:, pid, :valid] = torch.randn(Hkv, valid, D, device=dev, generator=g).to(torch.bfloat16)
            vp[:, pid, :valid] = torch.randn(Hkv, valid, D, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(B, 1, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    return q, kp, vp, tables.to(dev), lengths.to(dev)


@pytest.mark.parametrize("B", [1, 7, 16])
def test_paged_attention_kernel_matches_plain(dev, B):
    q, kp, vp, tables, lengths = _paged_inputs(dev, B)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_gather_attention(q, kp, vp, tables, lengths)
    _close_bf16(got, want)
    assert not got[lengths == 0].any()  # a row of length 0 gives zeros


def test_paged_attention_raises_on_unsupported_input(dev):
    q, kp, vp, tables, lengths = _paged_inputs(dev, 2, Hq=8, Hkv=2, D=64, page=32, maxp=64)
    before = paged_decode_attention.launches
    bad = [(q[..., :48], kp[..., :48], vp[..., :48], tables, lengths),  # head_dim 48 is not built
           (q, kp, vp, tables.long(), lengths),  # int64 tables
           (q.repeat(1, 1, 9, 1), kp, vp, tables, lengths),  # 72 query heads over 2 kv heads: G = 36 > 8
           (q, kp.transpose(0, 1).contiguous().transpose(0, 1), vp, tables, lengths)]  # a non-contiguous pool
    for args in bad:
        with pytest.raises(ValueError):
            paged_decode_attention(*args)
    assert paged_decode_attention.launches == before  # nothing was launched, nothing fell back


@pytest.mark.parametrize("layout", ["right-pads", "left-pads", "scattered"])
@pytest.mark.parametrize("T,pads,Hq,Hkv,D", [(1152, 92, 16, 4, 128), (512, 0, 16, 4, 128), (640, 37, 4, 4, 64),
                                             (128, 100, 8, 2, 128), (1152, 128, 4, 1, 128), (640, 92, 16, 4, 64),
                                             (512, 300, 4, 4, 128)],
                         ids=["understanding-1152-92pads", "512-nopads", "640-mha-d64", "128-mostly-pads",
                              "1152-gqa4to1-128pads", "640-d64-92pads", "512-300pads"])
def test_flash_prefill_kernel_matches_plain(dev, T, pads, Hq, Hkv, D, layout):
    """The prefill on the forward's wgmma body (128-row query tiles, key tiles
    up to the diagonal) against its plain version: batch row 0 padded `pads`
    rows at its end, at its start (its valid rows' first key tiles all
    masked, its padding rows' later ones) or at scattered places (a
    non-prefix mask), batch row 1 unpadded; every row finite (each allows
    itself), the valid rows and the padding rows (defined by the same rule)
    within bf16's precision."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(2, T, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(2, T, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(2, T, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    valid = torch.ones(2, T, dtype=torch.bool, device=dev)
    pad_at = {"right-pads": torch.arange(T - pads, T), "left-pads": torch.arange(pads),
              "scattered": torch.randperm(T, generator=torch.Generator().manual_seed(pads))[:pads]}[layout]
    valid[0, pad_at.to(dev)] = False  # row 1 of the batch has no padding
    before = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v, valid, scale=D**-0.5)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches == before + 1
    assert not got[valid].isnan().any()
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


@pytest.mark.parametrize("tier", ["bf16", "int4", "int8"])
@pytest.mark.parametrize("case", ["fits", "fits-with-pads", "overflow"])
def test_swiglu_gmm_kernels_through_the_capacity_schedule_match_plain(dev, tier, case):
    """Kernels 2, 5 and 7c launched through the capacity-dense dispatch: one
    group per expert, tiles over each expert's occupied slots; on overflow the
    expert-sorted dispatch runs and is counted as a fallback."""
    ex = _experts(dev, seed=11)
    if tier != "bf16":
        ex = {k: quantize_array(v, int(tier[3:])) for k, v in ex.items()}
    n, k, capacity = 640, 2, 256  # mean load 160
    idx, w = _routing(dev, n, k, [0, 3, 5] if case == "overflow" else None, seed=12)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    valid = None
    if case == "fits-with-pads":  # 200 padding rows that all route to experts 0 and 1
        valid = torch.arange(n, device=dev) < n - 200
        x[~valid], idx[~valid], w[~valid] = x[-1].clone(), torch.tensor([0, 1], device=dev), w[-1].clone()
    kernel = {"int4": moe_experts_swiglu_gmm_q4, "int8": moe_experts_swiglu_gmm_q8}.get(tier, moe_experts_swiglu_gmm)
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


# ---------------------------------------------------------------------------
# int8 tables: 7a / 7b decode MoE (s8 dots / exact), 7c prefill MoE, 7d RF sampler
# ---------------------------------------------------------------------------


def _q8(tables):
    return {k: quantize_array(v, 8) for k, v in tables.items()}


@pytest.mark.parametrize("int_dots", [True, False], ids=["s8", "exact"])
@pytest.mark.parametrize("n", [1, 2, 3, 16], ids=["1row", "2rows", "3rows-2chunks", "16rows-A>E"])
def test_moe_stream_q8_kernels_match_plain(dev, n, int_dots):
    ex = _q8(_experts(dev, seed=14))
    idx, w = _routing(dev, n, 6, seed=15)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    kernel = moe_experts_stream_q8s8 if int_dots else moe_experts_stream_q8
    before = kernel.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1, int_dots=int_dots)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = moe_experts_stream_plain(ex, x, idx, w, layer_idx=1, int_dots=int_dots)
    if int_dots:  # the s8 mode's integer sums are exact and its fp32 steps the plain version's: its bits
        assert torch.equal(got, want)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("choices", [None, [0, 3, 5], "0-1-127-128-129", "all-on-one"],
                         ids=["spread", "skewed-empty-experts", "edges-0-1-127-128-129", "all-on-one"])
def test_swiglu_gmm_q8_kernel_matches_plain(dev, choices):
    """7c, the exact int8 prefill MoE on the wgmma body (128-row tiles), through
    the expert-sorted dispatch: top-2 spread or skewed, and k = 1 with experts
    of 0, 1, 127, 128 and 129 rows or all rows on one expert."""
    ex = _q8(_experts(dev, seed=16))
    if isinstance(choices, str):
        idx, w = _edge_routing(dev, _EDGE_LOADS[choices])
    else:
        idx, w = _routing(dev, 96, 2, choices, seed=17)
    x = torch.randn(idx.shape[0], H, device=dev).to(torch.bfloat16)
    before = moe_experts_swiglu_gmm_q8.launches
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    torch.cuda.synchronize()
    assert moe_experts_swiglu_gmm_q8.launches == before + 1
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=0))


def test_int8_moe_kernels_at_full_width(dev):
    """The 16B-A3B expert tables (64 experts, h 2048, m 1408, top-6): 7a / 7b at
    2 and 16 rows, 7c at a 128-token prompt."""
    g = torch.Generator(device=dev).manual_seed(18)
    Ef, h, m = 64, 2048, 1408
    shapes = {"gate_proj": (1, Ef, h, m), "up_proj": (1, Ef, h, m), "down_proj": (1, Ef, m, h)}
    ex = {k: quantize_array(torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g), 8)
          for k, s in shapes.items()}
    for n in (2, 16, 128):
        scores = torch.rand((n, Ef), device=dev, generator=g)
        wt, idx = torch.topk(torch.softmax(scores, -1), 6)
        wt = (wt / wt.sum(-1, keepdim=True)).to(torch.bfloat16)
        x = torch.randn((n, h), device=dev, generator=g).to(torch.bfloat16)
        if n == 128:
            got = moe_experts_swiglu_gmm(ex, x, idx, wt, Ef, layer_idx=0)
            torch.cuda.synchronize()
            _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, wt, Ef, layer_idx=0))
            continue
        for int_dots in (True, False):
            got = moe_experts_stream(ex, x, idx, wt, layer_idx=0, int_dots=int_dots)
            torch.cuda.synchronize()
            _close_bf16(got, moe_experts_stream_plain(ex, x, idx, wt, layer_idx=0, int_dots=int_dots))


def test_int8_wrappers_raise_on_unsupported_input(dev):
    ex = _q8(_experts(dev))
    idx, w = _routing(dev, 2, 6)
    x = torch.randn(2, H, device=dev)  # fp32: the kernels take bf16
    for int_dots in (True, False):
        with pytest.raises(ValueError):
            moe_experts_stream(ex, x, idx, w, layer_idx=0, int_dots=int_dots)
    with pytest.raises(ValueError):
        moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    grouped = {k: quantize_array(v, 4, groups=2) for k, v in _experts(dev).items()}
    with pytest.raises(NotImplementedError):  # shard-grouped int4 tables are not ported
        moe_experts_stream(grouped, x.bfloat16(), idx, w, layer_idx=0, int_dots=False)


def _rf_q8(dev, seed=19):
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(seed)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=8, min_size=1024)
    return cfg, rf, g


@pytest.mark.parametrize("cfg_rows,n_img,renorm", [(1, 1, False), (2, 1, False), (3, 1, True), (3, 2, True),
                                                   (2, 4, False)],
                         ids=["unguided", "cfg2", "cfg3-renorm", "2img-x3rows", "4img-x2rows"])
def test_rf_sampler_q8_kernel_matches_plain(dev, cfg_rows, n_img, renorm):
    """The int8 sampler (exact dequant: digit dots) against its plain version,
    whose dots are the same exact sums rounded once: to the bit; more rows
    than one launch holds go in groups of whole images."""
    cfg, rf, g = _rf_q8(dev)
    ts, dts = _time_grid(cfg, None, device=dev)
    B = cfg_rows * n_img
    z = torch.randn(B, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    args = (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=torch.bfloat16)
    before = (rf_sample_fused.launches, rf_sample_fused_q8.launches)
    got = rf_sample_fused(*args, **kw)
    torch.cuda.synchronize()
    assert (rf_sample_fused.launches, rf_sample_fused_q8.launches) == \
        (before[0], before[1] + -(-n_img // (MAX_ROWS // cfg_rows)))
    torch.testing.assert_close(got, rf_sample_fused_plain(*args, **kw), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the dot modes added beside them: 7e int4 decode MoE, exact dequant; 7f / 7g
# int8 / int4 prefill MoE, s8 dots (sorted and capacity dispatch); 7h the int8
# RF sampler, s8 dots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 16], ids=["1row", "2rows", "3rows-2chunks", "16rows-A>E"])
def test_moe_stream_q4_exact_kernel_matches_plain(dev, n):
    ex = _q4(_experts(dev, seed=21))
    idx, w = _routing(dev, n, 6, seed=22)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    before = (moe_experts_stream_q4.launches, moe_experts_stream_q4s8.launches)
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1, int_dots=False)
    torch.cuda.synchronize()
    assert (moe_experts_stream_q4.launches, moe_experts_stream_q4s8.launches) == (before[0] + 1, before[1])
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1, int_dots=False))


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("choices", [None, [0, 3, 5]], ids=["spread", "skewed-empty-experts"])
def test_swiglu_gmm_s8_kernels_match_plain_to_the_bit(dev, bits, choices):
    """The s8 prefill kernels: integer sums exact, the fp32 epilogue rounded as
    the plain version writes it, so the two agree to the bit."""
    ex = {k: quantize_array(v, bits) for k, v in _experts(dev, seed=23).items()}
    idx, w = _routing(dev, 96, 2, choices, seed=24)
    x = torch.randn(96, H, device=dev).to(torch.bfloat16)
    kernel = moe_experts_swiglu_gmm_q8s8 if bits == 8 else moe_experts_swiglu_gmm_q4s8
    exact = moe_experts_swiglu_gmm_q8 if bits == 8 else moe_experts_swiglu_gmm_q4
    before = (kernel.launches, exact.launches)
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0, s8=True)
    torch.cuda.synchronize()
    assert (kernel.launches, exact.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=0, s8=True), rtol=0,
                               atol=0)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("case", ["fits-with-pads", "overflow"])
def test_swiglu_gmm_s8_kernels_through_the_capacity_schedule_match_plain(dev, bits, case):
    ex = {k: quantize_array(v, bits) for k, v in _experts(dev, seed=25).items()}
    n, k, capacity = 640, 2, 256
    idx, w = _routing(dev, n, k, [0, 3, 5] if case == "overflow" else None, seed=26)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    valid = torch.arange(n, device=dev) < n - 200
    x[~valid], idx[~valid], w[~valid] = x[-1].clone(), torch.tensor([0, 1], device=dev), w[-1].clone()
    kernel = moe_experts_swiglu_gmm_q8s8 if bits == 8 else moe_experts_swiglu_gmm_q4s8
    before = (kernel.launches, moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks)
    got = moe_experts_capacity_gmm_exact(ex, x, idx, w, E, capacity, token_valid=valid, layer_idx=1, s8=True)
    torch.cuda.synchronize()
    fell_back = int(case == "overflow")
    assert (kernel.launches, moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks) == \
        (before[0] + 1, before[1] + 1 - fell_back, before[2] + fell_back)
    want = moe_experts_capacity_gmm_exact_plain(ex, x, idx, w, E, capacity, token_valid=valid, layer_idx=1, s8=True)
    torch.testing.assert_close(got[valid], want[valid], rtol=0, atol=0)


def test_new_modes_at_full_width(dev):
    """The 16B-A3B expert tables (64 experts, h 2048, m 1408, top-6): 7e at 2
    and 16 rows, 7f / 7g at a 128-token prompt."""
    g = torch.Generator(device=dev).manual_seed(27)
    Ef, h, m = 64, 2048, 1408
    shapes = {"gate_proj": (1, Ef, h, m), "up_proj": (1, Ef, h, m), "down_proj": (1, Ef, m, h)}
    bf = {k: torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g) for k, s in shapes.items()}
    for bits in (4, 8):
        ex = {k: quantize_array(v, bits) for k, v in bf.items()}
        for n in (2, 16, 128):
            scores = torch.rand((n, Ef), device=dev, generator=g)
            wt, idx = torch.topk(torch.softmax(scores, -1), 6)
            wt = (wt / wt.sum(-1, keepdim=True)).to(torch.bfloat16)
            x = torch.randn((n, h), device=dev, generator=g).to(torch.bfloat16)
            if n == 128:
                got = moe_experts_swiglu_gmm(ex, x, idx, wt, Ef, layer_idx=0, s8=True)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, moe_experts_swiglu_gmm_plain(ex, x, idx, wt, Ef, layer_idx=0, s8=True),
                                           rtol=0, atol=0)
            elif bits == 4:
                got = moe_experts_stream(ex, x, idx, wt, layer_idx=0, int_dots=False)
                torch.cuda.synchronize()
                _close_bf16(got, moe_experts_stream_plain(ex, x, idx, wt, layer_idx=0, int_dots=False))


@pytest.mark.parametrize("cfg_rows,n_img,renorm", [(1, 1, False), (2, 1, False), (3, 1, True), (3, 2, True),
                                                   (2, 4, False)],
                         ids=["unguided", "cfg2", "cfg3-renorm", "2img-x3rows", "4img-x2rows"])
def test_rf_sampler_q8_s8_kernel_matches_plain(dev, cfg_rows, n_img, renorm):
    """The int8 sampler with s8 dots against its plain version: to the bit."""
    cfg, rf, g = _rf_q8(dev, seed=28)
    ts, dts = _time_grid(cfg, None, device=dev)
    B = cfg_rows * n_img
    z = torch.randn(B, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    args = (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=torch.bfloat16)
    before = (rf_sample_fused_q8.launches, rf_sample_fused_q8s8.launches)
    got = rf_sample_fused(*args, s8_dots=True, **kw)
    torch.cuda.synchronize()
    assert (rf_sample_fused_q8.launches, rf_sample_fused_q8s8.launches) == \
        (before[0], before[1] + -(-n_img // (MAX_ROWS // cfg_rows)))
    torch.testing.assert_close(got, rf_sample_fused_plain(*args, s8_dots=True, **kw), rtol=0, atol=0)
    assert not torch.equal(got, rf_sample_fused_plain(*args, **kw))  # the exact mode is another function


# ---------------------------------------------------------------------------
# the per-step RF stack (four bodies), the int4 sampler's pipelined schedule,
# the full-expert-block prefill MoE
# ---------------------------------------------------------------------------

STACK_COUNTERS = {(4, True): rf_mlp.rf_mlp_stack_q4s8, (4, False): rf_mlp.rf_mlp_stack_q4,
                  (8, True): rf_mlp.rf_mlp_stack_q8s8, (8, False): rf_mlp.rf_mlp_stack_q8}


def _rf_head(dev, bits, seed):
    # width 256, mlp_mult 3 -> SwiGLU hidden 512: the stack's 128-aligned int4 halves
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=256, depth=2, mlp_mult=3, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(seed)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=bits, min_size=1024)
    return cfg, rf, g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 6], ids=["1row", "2rows", "3rows", "4rows", "6rows-2launches"])
@pytest.mark.parametrize("body", [(4, True), (4, False), (8, True), (8, False)], ids=["q4s8", "q4", "q8s8", "q8"])
def test_rf_mlp_stack_kernel_matches_plain(dev, body, rows, dtype):
    """One Euler step of the stack (the samplers' persistent body in its
    stack mode) against its plain version, whose dots are exact integer sums
    (s8, or digit dots) rounded as the kernel rounds them: to the bit; more
    rows than one launch holds go in groups (rows never mix)."""
    bits, s8 = body
    cfg, rf, g = _rf_head(dev, bits, seed=31)
    blocks = rf["res_blocks"]
    assert rf_mlp.rf_mlp_supported(blocks)
    x = torch.randn(rows, cfg.width, device=dev, generator=g).to(dtype)
    mods = 0.5 * torch.randn(cfg.depth, rows, 3 * cfg.width, device=dev, generator=g)
    before = {key: c.launches for key, c in STACK_COUNTERS.items()}
    got = rf_mlp.rf_mlp_stack(blocks, x, mods, ln_eps=cfg.ln_eps, int_dots=s8)
    torch.cuda.synchronize()
    launched = {key: c.launches - before[key] for key, c in STACK_COUNTERS.items()}
    assert launched == {key: (-(-rows // MAX_ROWS) if key == body else 0) for key in STACK_COUNTERS}
    assert got.dtype == dtype
    torch.testing.assert_close(got, rf_mlp.rf_mlp_stack_plain(blocks, x, mods, ln_eps=cfg.ln_eps, int_dots=s8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("grid", [1, 7], ids=["1cta", "7ctas"])
@pytest.mark.parametrize("body", [(4, True), (4, False), (8, True), (8, False)], ids=["q4s8", "q4", "q8s8", "q8"])
def test_rf_mlp_stack_kernel_on_a_small_grid(dev, body, grid, monkeypatch):
    """The stack's units split over fewer CTAs than the card has SMs (each
    CTA's run crossing tiles; the int8 s8 body with h in four pieces of 128
    columns, the int4 s8 one with w3 in two pieces of 128 packed rows): the
    plain version's bits at 2 and 3 rows, two calls back to back (the
    workspace left clean)."""
    bits, s8 = body
    monkeypatch.setattr(rf_mlp, "KC_Q4S8", 128)
    cfg, rf, g = _rf_head(dev, bits, seed=33)
    blocks = rf["res_blocks"]
    for rows in (2, 3):
        x = torch.randn(rows, cfg.width, device=dev, generator=g).to(torch.bfloat16)
        mods = 0.5 * torch.randn(cfg.depth, rows, 3 * cfg.width, device=dev, generator=g)
        kw = dict(ln_eps=cfg.ln_eps, int_dots=s8, chunk=128)
        want = rf_mlp.rf_mlp_stack_plain(blocks, x, mods, **kw)
        for _ in range(2):
            torch.testing.assert_close(rf_mlp.rf_mlp_stack(blocks, x, mods, grid=grid, **kw), want, rtol=0, atol=0)


def test_rf_mlp_stack_raises_on_unsupported_input(dev):
    cfg, rf, g = _rf_head(dev, 4, seed=32)
    x = torch.randn(2, cfg.width, device=dev).to(torch.bfloat16)
    mods = torch.zeros(cfg.depth, 2, 3 * cfg.width, device=dev)
    with pytest.raises(ValueError):  # fp16 compute is not built
        rf_mlp.rf_mlp_stack(rf["res_blocks"], x.half(), mods, int_dots=True)
    with pytest.raises(ValueError):  # modulations of another row count
        rf_mlp.rf_mlp_stack(rf["res_blocks"], x, mods[:, :1], int_dots=True)
    with pytest.raises(ValueError):  # int8 entry, int4 tables
        rf_mlp.rf_mlp_stack_q8(rf["res_blocks"], x, mods)


@pytest.mark.parametrize("cfg_rows,n_img,renorm", [(2, 1, False), (3, 1, True), (3, 2, True)],
                         ids=["cfg2", "cfg3-renorm", "2img-x3rows"])
def test_rf_sampler_q4_pipelined_kernel_matches_plain(dev, cfg_rows, n_img, renorm):
    """The int4 sampler's pipelined schedule (w3 in 128-row pieces, their
    descaled sums added in order) against its plain version: to the bit."""
    cfg, rf, g = _rf_head(dev, 4, seed=33)
    ts, dts = _time_grid(cfg, None, device=dev)
    B = cfg_rows * n_img
    z = torch.randn(B, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    args = (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=torch.bfloat16)
    before = (rf_sample_fused.launches, rf_sample_fused_q4_pipelined.launches)
    got = rf_sample_fused(*args, schedule="pipelined", down_chunk=128, **kw)
    torch.cuda.synchronize()
    assert (rf_sample_fused.launches, rf_sample_fused_q4_pipelined.launches) == \
        (before[0], before[1] + -(-n_img // (MAX_ROWS // cfg_rows)))
    torch.testing.assert_close(got, rf_sample_fused_plain(*args, schedule="pipelined", down_chunk=128, **kw),
                               rtol=0, atol=0)


# the int4 sampler's stream-K body: every row count and schedule at grids of 1, 5 and one CTA per SM
Q4_ROWS = {"1row": (1, 1), "2rows": (2, 1), "3rows": (3, 1), "4rows-2img": (2, 2)}


def _q4_sampler_case(dev, rows, renorm, dtype, seed=36):
    """A width-192 int4 head (w / 2 = 96 packed rows: a stage and a half; 192
    columns: one down tile, its last box past w), hidden 512, 4 steps x 2
    blocks; its inputs for `rows` (CFG rows, images), bf16 modulations."""
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(seed)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=4, min_size=1024)
    cfg_rows, n_img = rows
    ts, dts = _time_grid(cfg, None, device=dev)
    z = torch.randn(cfg_rows * n_img, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=dtype)
    return (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1), kw


@pytest.mark.parametrize("schedule", ["block", "pipelined"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("renorm", [False, True], ids=["plain-cfg", "renorm"])
@pytest.mark.parametrize("rows", list(Q4_ROWS.values()), ids=list(Q4_ROWS))
def test_rf_sampler_q4_stream_k_matches_plain_at_every_grid(dev, rows, renorm, dtype, schedule):
    """The int4 sampler's units split over 1 CTA, 5 and one per SM (most of
    them then with no unit): the plain version's bits in both schedules (the
    pipelined one in 128-row pieces), bf16 and fp32 modulations alike."""
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    args, kw = _q4_sampler_case(dev, rows, renorm, dtype)
    kw.update(schedule=schedule, down_chunk=128)
    want = rf_sample_fused_plain(*args, **kw)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for grid in (1, 5, sms):
        for mods in (torch.bfloat16, torch.float32):
            rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg = args
            got = rs._rf_sample_group(rf, cfg, noise, block_mods.to(mods), final_mods.to(mods), dts, tcfg, icfg,
                                      s8_dots=False, grid=grid, **kw)
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"grid {grid}, {mods} modulations")


def test_rf_sampler_q4_one_launch_one_allocation_and_a_clean_workspace(dev):
    """One kernel and one allocation (the output) per call, the operands and
    the workspace kept; after every call the workspace's accumulators,
    tickets, row maxima and barrier counts are back at zero; its int32 size
    is the library's."""
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    args, kw = _q4_sampler_case(dev, (2, 1), False, torch.bfloat16, seed=37)
    for schedule in ("block", "pipelined"):
        call = lambda: rf_sample_fused(*args, schedule=schedule, down_chunk=128, **kw)  # noqa: B023, E731
        events = _device_events(call, calls=3)
        assert 0 < len(events) <= 3 and all("rf_sampler_q4s8_kernel" in e for e in events), events
        assert _allocations(call) == 1  # the output only
        torch.cuda.synchronize()
        for _, iws in rs._sampler_workspaces.values():
            assert not iws.any()
    w, H = 192, 512
    for kc in (0, 128, 256):
        assert build.load().mu_rf_sampler_q4s8_workspace(w, H, kc) == rs.q4_workspace_sizes(w, H, kc)[1]


def test_rf_sampler_q4_raises_on_unsupported_input(dev):
    args, kw = _q4_sampler_case(dev, (2, 1), False, torch.bfloat16, seed=38)
    with pytest.raises(ValueError):  # pieces of 32 packed rows: not whole stages
        rf_sample_fused(*args, schedule="pipelined", down_chunk=32, **kw)
    with pytest.raises(RuntimeError):  # more CTAs than can be co-resident: the cooperative launch is refused
        from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

        rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg = args
        rs._rf_sample_group(rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg, s8_dots=False,
                            schedule="block", down_chunk=128, grid=100_000, **kw)


# the int8 sampler on row 6's body: both dot modes (the s8 one also with h in four 128-column pieces), every
# row count, bf16 and fp32, at grids of 1, 5 and one CTA per SM
Q8_MODES = {"exact": (False, None), "s8": (True, None), "s8-pieces": (True, 128)}


def _q8_sampler_case(dev, rows, renorm, dtype, seed=46):
    """A width-192 int8 head (three 64-row stages an up tile; one down tile of
    192 of its 256 columns, its last box past w), hidden 512 (four up tiles of
    128 h columns), 4 steps x 2 blocks; its inputs for `rows` (CFG rows,
    images), bf16 modulations."""
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=4)
    g = torch.Generator(device=dev).manual_seed(seed)
    rf = init_rf_head_params(cfg, _Init(dev, torch.bfloat16, g))
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"].normal_(0.0, 0.05, generator=g)
    quantize_tree_inplace(rf, bits=8, min_size=1024)
    cfg_rows, n_img = rows
    ts, dts = _time_grid(cfg, None, device=dev)
    z = torch.randn(cfg_rows * n_img, cfg.z_channels, device=dev, generator=g).to(torch.bfloat16)
    block_mods, final_mods = precompute_modulations(rf, cfg, ts, z)
    noise = torch.randn(n_img, cfg.target_channels, device=dev, generator=g).repeat(cfg_rows, 1)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm, compute_dtype=dtype)
    return (rf, cfg, noise, block_mods, final_mods, dts, 3.0, 1.1), kw


@pytest.mark.parametrize("mode", list(Q8_MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("renorm", [False, True], ids=["plain-cfg", "renorm"])
@pytest.mark.parametrize("rows", list(Q4_ROWS.values()), ids=list(Q4_ROWS))
def test_rf_sampler_q8_stream_k_matches_plain_at_every_grid(dev, rows, renorm, dtype, mode, monkeypatch):
    """The int8 sampler's units split over 1 CTA, 5 and one per SM: the plain
    version's bits in both dot modes (digit dots; s8 dots, h in one piece and
    in four), bf16 and fp32 modulations alike."""
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    s8, chunk = Q8_MODES[mode]
    if chunk:
        monkeypatch.setattr(rs, "CHUNK", chunk)
    args, kw = _q8_sampler_case(dev, rows, renorm, dtype)
    want = rf_sample_fused_plain(*args, s8_dots=s8, **kw)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for grid in (1, 5, sms):
        for mods in (torch.bfloat16, torch.float32):
            rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg = args
            got = rs._rf_sample_group(rf, cfg, noise, block_mods.to(mods), final_mods.to(mods), dts, tcfg, icfg,
                                      s8_dots=s8, schedule="block", down_chunk=128, grid=grid, **kw)
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"grid {grid}, {mods} modulations")


def test_rf_sampler_q8_one_launch_one_allocation_and_a_clean_workspace(dev):
    """In both dot modes: two calls back to back with no memset between them
    give the plain version's bits; one kernel and one allocation (the output)
    per call; after every call the workspace's accumulators, tickets, row
    maxima and barrier counts are back at zero; its int32 size is the
    library's."""
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    args, kw = _q8_sampler_case(dev, (2, 1), False, torch.bfloat16, seed=47)
    for s8 in (False, True):
        want = rf_sample_fused_plain(*args, s8_dots=s8, **kw)
        call = lambda: rf_sample_fused(*args, s8_dots=s8, **kw)  # noqa: B023, E731
        first, second = call(), call()
        torch.testing.assert_close(first, want, rtol=0, atol=0)
        torch.testing.assert_close(second, want, rtol=0, atol=0)
        events = _device_events(call, calls=3)
        assert 0 < len(events) <= 3 and all("rf_sampler_q8_kernel" in e for e in events), events
        assert _allocations(call) == 1  # the output only
        torch.cuda.synchronize()
        for _, iws in rs._sampler_workspaces.values():
            assert not iws.any()
    w, H = 192, 512
    assert build.load().mu_rf_sampler_q8_workspace(w, H, 0, 0) == rs.q8_workspace_sizes(w, H, 1)[1]
    assert build.load().mu_rf_sampler_q8_workspace(w, H, 1, 128) == rs.q8_workspace_sizes(w, H, 4)[1]
    assert build.load().mu_rf_sampler_q8_workspace(3072, 8192, 1, 4096) == rs.q8_workspace_sizes(3072, 8192, 2)[1]


def test_rf_sampler_q8_raises_on_unsupported_input(dev):
    """More CTAs than can be co-resident: the cooperative launch is refused, and raised."""
    from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs

    args, kw = _q8_sampler_case(dev, (2, 1), False, torch.bfloat16, seed=48)
    rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg = args
    for s8 in (False, True):
        with pytest.raises(RuntimeError):
            rs._rf_sample_group(rf, cfg, noise, block_mods, final_mods, dts, tcfg, icfg, s8_dots=s8,
                                schedule="block", down_chunk=128, grid=100_000, **kw)


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
@pytest.mark.parametrize("choices", [None, [0, 3, 5]], ids=["spread", "skewed-empty-experts"])
def test_swiglu_gmm_full_block_kernel_matches_plain(dev, bits, choices):
    ex = {k: quantize_array(v, bits) for k, v in _experts(dev, seed=34).items()}
    idx, w = _routing(dev, 96, 2, choices, seed=35)
    x = torch.randn(96, H, device=dev).to(torch.bfloat16)
    full = moe_experts_swiglu_gmm_q4_full if bits == 4 else moe_experts_swiglu_gmm_q8_full
    chunked = moe_experts_swiglu_gmm_q4 if bits == 4 else moe_experts_swiglu_gmm_q8
    before = (full.launches, chunked.launches)
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=1, full_block=True)
    torch.cuda.synchronize()
    assert (full.launches, chunked.launches) == (before[0] + 1, before[1])
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=1))
    with pytest.raises(ValueError):  # no s8 mode, and a stacked table needs its layer
        moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=1, full_block=True, s8=True)
    with pytest.raises(ValueError):
        moe_experts_swiglu_gmm(ex, x, idx, w, E, full_block=True)


# --- the grouped matmuls of MoE training (csrc/gmm.cu) ---------------------------------------------------

GMM_SIZES = {
    "uniform": [125] * 8,
    "skewed-empty-groups": [600, 0, 0, 250, 0, 130, 0, 0],
    "padded-last-group": [120, 130, 90, 110, 140, 100, 130, 104],  # 1,024 rows, the last 24 zero padding
}


# gmm only: groups of 1-63 rows (the second consumer warpgroup of the wgmma body idle), of exactly 128 and of 129
# rows (a 1-row tile), empty groups, then GMM_NO_GROUP_ROWS rows past the groups' sum that belong to none
GMM_CASES = {**GMM_SIZES, "edges-and-rows-of-no-group": [40, 128, 0, 129, 0, 63]}
GMM_NO_GROUP_ROWS = 40


def _gmm_operands(dev, case, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = torch.tensor(GMM_CASES[case], dtype=torch.int32, device=dev)
    R = int(sizes.sum()) + (GMM_NO_GROUP_ROWS if case == "edges-and-rows-of-no-group" else 0)
    lhs = torch.randn((R, K), device=dev, generator=g)
    if case == "padded-last-group":
        lhs[-24:] = 0.0
    rhs = torch.empty((len(GMM_CASES[case]), K, N), device=dev).normal_(0, 0.05, generator=g).to(torch.bfloat16)
    grad = torch.randn((R, N), device=dev, generator=g)
    return sizes, lhs, rhs, grad


def _close(got, want, rel):
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item() + 1e-6, err


# (K, N): multiples of 8 but not of the tiles (16-byte staging, ragged edges), and widths the
# kernels stage element by element
GMM_WIDTHS = {"16-byte-rows": (200, 312), "odd-widths": (100, 150)}
# gmm also at the model's widths (h 2048, m 1408), both ways
GMM_TEST_WIDTHS = {**GMM_WIDTHS, "model-h-to-m": (2048, 1408), "model-m-to-h": (1408, 2048)}


def _gmm_case(dev, case, width, transpose, lhs_dtype, seed=41):
    """(sizes, lhs, rhs (E, K, N) bf16, output columns) of one gmm case: rows
    (R, K) against rhs, or with `transpose` the cotangent (R, N) against rhs
    transposed."""
    sizes, lhs, rhs, grad = _gmm_operands(dev, case, *GMM_TEST_WIDTHS[width], seed=seed)
    if transpose:  # grad (R, N) against rhs (E, K, N) transposed -> (R, K)
        lhs = grad
    return sizes, lhs.to(lhs_dtype).contiguous(), rhs, rhs.shape[1] if transpose else rhs.shape[2]


@pytest.mark.parametrize("width", list(GMM_TEST_WIDTHS))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["out-fp32", "out-bf16"])
@pytest.mark.parametrize("lhs_dtype", [torch.bfloat16, torch.float32], ids=["lhs-bf16", "lhs-fp32"])
@pytest.mark.parametrize("transpose", [False, True], ids=["rhs", "rhs-transposed"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_kernel_matches_plain(dev, case, transpose, lhs_dtype, out_dtype, width):
    """Both rhs orientations, bf16 or fp32 rows (fp32 split into two bf16
    parts), fp32 or bf16 outputs, at widths that are no multiples of the
    kernel's tiles and at the model's: fp32 outputs within 1e-4 of max, bf16
    ones within 1e-2. The odd widths take the mma_sync body, the others the
    wgmma one (counted on the route); rows of no group are exactly zero in an
    output the kernel did not find zeroed (NaN left where it is allocated)."""
    from mingunivision_tpu_torch.ops.kernels import build, moe_gmm

    sizes, lhs, rhs, cols = _gmm_case(dev, case, width, transpose, lhs_dtype)
    route = "mma_sync" if width == "odd-widths" else "wgmma"
    assert moe_gmm.gmm_route(lhs, rhs, lhs.shape[1], cols) == route
    assert build.load().mu_gmm_tile_rows() == moe_gmm.TILE_ROWS
    op = "gmm_trhs" if transpose else "gmm"
    counters = (getattr(moe_gmm, op), moe_gmm.route_counts[op][route])
    before = [c.launches for c in counters]
    nan = torch.full((lhs.shape[0], cols), float("nan"), dtype=out_dtype, device=dev)
    del nan  # the caching allocator hands its NaN block to the output
    got = moe_gmm.gmm(lhs, rhs, sizes, out_dtype=out_dtype, transpose_rhs=transpose)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1] and got.dtype == out_dtype
    assert not got[int(sizes.sum()):].any()
    _close(got, moe_gmm.gmm_plain(lhs, rhs, sizes, out_dtype=out_dtype, transpose_rhs=transpose),
           1e-4 if out_dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("lhs_dtype", [torch.bfloat16, torch.float32], ids=["lhs-bf16", "lhs-fp32"])
@pytest.mark.parametrize("transpose", [False, True], ids=["rhs", "rhs-transposed"])
def test_gmm_mma_sync_body_at_the_model_widths(dev, transpose, lhs_dtype):
    """The mma_sync body, which chip_smoke.py times beside the wgmma one through
    the private route argument, is right at shapes the wgmma body serves; the
    wgmma body refuses widths TMA cannot take (the launch raises)."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    sizes, lhs, rhs, _ = _gmm_case(dev, "edges-and-rows-of-no-group", "model-h-to-m", transpose, lhs_dtype)
    got = moe_gmm._launch_gmm(lhs, rhs, sizes, torch.float32, transpose, None, "mma_sync")
    torch.cuda.synchronize()
    _close(got, moe_gmm.gmm_plain(lhs, rhs, sizes, transpose_rhs=transpose), 1e-4)
    sizes, lhs, rhs, _ = _gmm_case(dev, "edges-and-rows-of-no-group", "odd-widths", transpose, lhs_dtype)
    with pytest.raises(RuntimeError):
        moe_gmm._launch_gmm(lhs, rhs, sizes, torch.float32, transpose, None, "wgmma")


# tgmm: the gmm cases, groups that start off the wgmma body's 64-row stages (a group of one row among them),
# one group holding every row, and rows past the groups' sum (TGMM_NO_GROUP_ROWS) that belong to none
TGMM_CASES = {**GMM_SIZES, "starts-off-the-stages": [37, 91, 150, 1, 200, 0, 77, 64],
              "one-group-holds-every-row": [0, 0, 0, 1000, 0, 0, 0, 0],
              "rows-of-no-group": [40, 128, 0, 129, 0, 63, 33, 7]}
TGMM_NO_GROUP_ROWS = 40
# (K, N): lhs and grad widths; the odd ones take the mma_sync body, the rest the wgmma one
TGMM_WIDTHS = {**GMM_WIDTHS, "model-gate-table": (2048, 1408), "model-down-table": (1408, 2048)}


def _tgmm_operands(dev, case, width, grad_dtype, seed=42):
    """(sizes, lhs (R, K) bf16, grad (R, N)) of one tgmm case."""
    g = torch.Generator(device=dev).manual_seed(seed)
    K, N = TGMM_WIDTHS[width]
    sizes = torch.tensor(TGMM_CASES[case], dtype=torch.int32, device=dev)
    R = int(sizes.sum()) + (TGMM_NO_GROUP_ROWS if case == "rows-of-no-group" else 0)
    lhs = torch.randn((R, K), device=dev, generator=g).to(torch.bfloat16)
    grad = torch.randn((R, N), device=dev, generator=g).to(grad_dtype)
    return sizes, lhs, grad


def _tgmm_on_nan(lhs, grad, sizes, out_dtype, route, **kw):
    """tgmm on `route` into an output the kernel finds full of NaN (the caching
    allocator hands the freed block on), with its counts checked."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    nan = torch.full((sizes.shape[0], lhs.shape[1], grad.shape[1]), float("nan"), dtype=out_dtype, device=lhs.device)
    del nan
    counters = (moe_gmm.tgmm, moe_gmm.route_counts["tgmm"][route])
    before = [c.launches for c in counters]
    got = moe_gmm._launch_tgmm(lhs, grad, sizes, out_dtype, route, **kw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1] and got.dtype == out_dtype
    return got


@pytest.mark.parametrize("width", list(TGMM_WIDTHS))
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["out-bf16", "out-fp32"])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["grad-fp32", "grad-bf16"])
@pytest.mark.parametrize("case", list(TGMM_CASES))
def test_tgmm_kernel_matches_plain(dev, case, grad_dtype, out_dtype, width):
    """Per-group lhs^T grad on the body `tgmm_route` picks (the odd widths the
    mma_sync one, the others the wgmma one, counted on the route): fp32 outputs
    within 1e-4 of max, bf16 ones within 1e-2; an empty group's table is
    exactly zero in an output the kernel found full of NaN."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    sizes, lhs, grad = _tgmm_operands(dev, case, width, grad_dtype)
    route = "mma_sync" if width == "odd-widths" else "wgmma"
    assert moe_gmm.tgmm_route(lhs, grad, lhs.shape[1], grad.shape[1], sizes.shape[0]) == route
    before = moe_gmm.route_counts["tgmm"][route].launches
    got = moe_gmm.tgmm(lhs, grad, sizes, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert moe_gmm.route_counts["tgmm"][route].launches == before + 1
    _close(got, moe_gmm.tgmm_plain(lhs, grad, sizes, out_dtype=out_dtype),
           1e-4 if out_dtype == torch.float32 else 1e-2)
    got = _tgmm_on_nan(lhs, grad, sizes, out_dtype, route)
    for e in (sizes == 0).nonzero().flatten().tolist():
        assert not got[e].any()


@pytest.mark.parametrize("width", ["16-byte-rows", "odd-widths", "model-gate-table", "model-down-table"])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["grad-fp32", "grad-bf16"])
def test_tgmm_keeps_a_neighbours_nan_and_inf_out(dev, grad_dtype, width):
    """NaN and Inf in one group's rows of lhs and of grad (its first rows fall in
    the previous group's last wgmma stage) and in the rows of no group after
    the last: every other group's table is finite and equal to the plain
    version's, on both bodies."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    sizes, lhs, grad = _tgmm_operands(dev, "rows-of-no-group", width, grad_dtype)
    ends = sizes.long().cumsum(0).tolist()
    poisoned = 5  # rows 297 .. 359; the group before, rows 168 .. 296, ends one row into its last 64-row stage
    for t in (lhs, grad):
        t[ends[poisoned - 1]:ends[poisoned - 1] + 5] = float("nan")
        t[ends[poisoned - 1] + 5:ends[poisoned]] = float("inf")
        t[ends[-1]:] = float("nan")
    want = moe_gmm.tgmm_plain(lhs, grad, sizes)
    clean = [e for e in range(sizes.shape[0]) if e != poisoned]
    for route in ("wgmma", "mma_sync") if width != "odd-widths" else ("mma_sync",):
        got = _tgmm_on_nan(lhs, grad, sizes, torch.bfloat16, route)
        _close(got[clean], want[clean], 1e-2)


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["grad-fp32", "grad-bf16"])
@pytest.mark.parametrize("width", ["model-gate-table", "model-down-table"])
def test_tgmm_bodies_and_grids_at_the_model_widths(dev, width, grad_dtype):
    """At the model's widths the mma_sync body, which chip_smoke.py times
    beside the wgmma one through the private route argument, is right too;
    the wgmma body gives the same bits on any grid (one block walking every
    item, a few, one block per item) as on its persistent one; and it refuses
    widths TMA cannot take (the launch raises)."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    sizes, lhs, grad = _tgmm_operands(dev, "starts-off-the-stages", width, grad_dtype)
    want = moe_gmm.tgmm_plain(lhs, grad, sizes, out_dtype=torch.float32)
    _close(_tgmm_on_nan(lhs, grad, sizes, torch.float32, "mma_sync"), want, 1e-4)
    persistent = _tgmm_on_nan(lhs, grad, sizes, torch.float32, "wgmma")
    _close(persistent, want, 1e-4)
    for blocks in (1, 7, 2**30):
        assert torch.equal(_tgmm_on_nan(lhs, grad, sizes, torch.float32, "wgmma", max_blocks=blocks), persistent)
    sizes, lhs, grad = _tgmm_operands(dev, "uniform", "odd-widths", grad_dtype)
    with pytest.raises(RuntimeError):
        moe_gmm._launch_tgmm(lhs, grad, sizes, torch.bfloat16, "wgmma")


def test_gmm_wrappers_raise_on_unsupported_input(dev):
    from mingunivision_tpu_torch.ops.kernels import moe_gmm

    sizes, lhs, rhs, grad = _gmm_operands(dev, "uniform", 64, 96, seed=43)
    with pytest.raises(ValueError):  # fp32 tables have no kernel
        moe_gmm.gmm(lhs.to(torch.bfloat16), rhs.float(), sizes)
    with pytest.raises(ValueError):  # rows of width K = 64 against the transposed (E, 64, 96) table, which takes 96
        moe_gmm.gmm(lhs.to(torch.bfloat16), rhs, sizes, transpose_rhs=True)
    with pytest.raises(ValueError):  # tgmm's rows are bf16
        moe_gmm.tgmm(lhs, grad, sizes)


def _plain_training_moe(monkeypatch):
    """The differentiable prefill MoE through the plain versions: its forward
    and the grouped matmuls of its backward."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as msg

    monkeypatch.setattr(moe_gmm, "gmm", moe_gmm.gmm_plain)
    monkeypatch.setattr(moe_gmm, "tgmm", moe_gmm.tgmm_plain)
    monkeypatch.setattr(msg, "swiglu_gmm_ad_forward", msg.moe_experts_swiglu_gmm_plain)


def _ad_value_and_grads(experts, x, idx, w, layer_idx=1):
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_ad

    ex = {k: v.detach().clone().requires_grad_(True) for k, v in experts.items()}
    xx, ww = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    y = moe_experts_swiglu_gmm_ad(ex, xx, idx, ww, E, layer_idx=layer_idx)
    cot = torch.cos(torch.arange(y.numel(), device=y.device, dtype=torch.float32)).reshape(y.shape)
    y.backward(cot.to(y.dtype))
    return [y, ex["gate_proj"].grad[layer_idx], ex["up_proj"].grad[layer_idx], ex["down_proj"].grad[layer_idx],
            xx.grad, ww.grad]


@pytest.mark.parametrize("choices", [None, [0, 3, 5]], ids=["spread", "skewed-empty-experts"])
def test_swiglu_gmm_ad_matches_its_plain_versions(dev, choices, monkeypatch):
    """The differentiable fused prefill MoE on the card (row 2 forward; gmm,
    gmm_trhs, tgmm backward, three launches each) against the same Function
    through the plain versions at bf16 (within 1e-2 of each max), and
    printed against them at fp32."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as fused

    experts = _experts(dev, seed=44)
    idx, w = _routing(dev, 96, 2, choices, seed=45)
    x = torch.randn(96, H, device=dev).to(torch.bfloat16)
    before = [f.launches for f in (fused, moe_gmm.gmm, moe_gmm.gmm_trhs, moe_gmm.tgmm)]
    got = _ad_value_and_grads(experts, x, idx, w)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip((fused, moe_gmm.gmm, moe_gmm.gmm_trhs, moe_gmm.tgmm), before)] == [1, 3, 3, 3]
    with monkeypatch.context() as mp:
        _plain_training_moe(mp)
        plain = _ad_value_and_grads(experts, x, idx, w)
        ref = _ad_value_and_grads({k: v.float() for k, v in experts.items()}, x.float(), idx, w.float())
    for name, a, b, r in zip(("y", "gate", "up", "down", "x", "topk_w"), got, plain, ref):
        assert a.dtype == b.dtype
        _close(a, b, 1e-2)
        err = ((a.float() - r).abs().max() / r.abs().max()).item()
        print(f"{name}: kernel vs plain fp32 {err:.3e} of max")


def test_lm_loss_backward_on_the_card_reaches_every_leaf(dev):
    """One lm_loss backward of the small model (bf16, 1 layer) on the card: every
    leaf gets a nonzero grad (audio_gate aside: no loss reaches it), through the
    training kernels, each launched as counted per layer."""
    import chip_smoke
    from mingunivision_tpu_torch.engine.train import lm_loss
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as fused
    from mingunivision_tpu_torch.utils.pytree import leaves

    cfg, params = chip_smoke.small_llm(torch, dev)
    ids, mask, image = chip_smoke.train_batch(torch, cfg, dev)
    before = [f.launches for f in (fused, moe_gmm.gmm, moe_gmm.gmm_trhs, moe_gmm.tgmm)]
    for p in leaves(params):
        p.requires_grad_(True)
    lm_loss(params, cfg, ids, mask, image, balance_alpha=0.01, z_alpha=1e-4).backward()
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert [f.launches - b for f, b in zip((fused, moe_gmm.gmm, moe_gmm.gmm_trhs, moe_gmm.tgmm), before)] == \
        [L, 3 * L, 3 * L, 3 * L]
    for path, p in zip(chip_smoke.tree_paths(params), leaves(params)):
        if "/audio_gate/" in path:
            assert p.grad is None or not p.grad.any(), path
        else:
            assert p.grad is not None and p.grad.abs().max() > 0, path


# ---------------------------------------------------------------------------
# MingTok training: the ViT flash forward with residuals and its backward kernels
# ---------------------------------------------------------------------------


def _vit_inputs(dev, B, H, N, D, seed=21):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, N, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("B,H,N,D", [(1, 16, 1024, 64), (2, 4, 512, 128)], ids=["pixel-decoder", "d128"])
def test_flash_vit_forward_with_residuals_matches_plain(dev, B, H, N, D):
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, _ = _vit_inputs(dev, B, H, N, D)
    before = flash.flash_vit_attention.launches
    out, lse = flash.flash_vit_attention_lse(q, k, v, scale=D**-0.5)
    torch.cuda.synchronize()
    assert flash.flash_vit_attention.launches == before + 1 and lse.dtype == torch.float32 and lse.shape == (B, H, N)
    want, want_lse = flash.flash_vit_attention_lse_plain(q, k, v, scale=D**-0.5)
    _close_bf16(out, want)
    # the log-sum-exp is an fp32 sum of the same exponentials in another order
    assert (lse - want_lse).abs().max().item() <= 1e-4 * want_lse.abs().max().item() + 1e-5
    assert out.equal(flash.flash_vit_attention(q, k, v, scale=D**-0.5))  # the mode only adds the lse


@pytest.mark.parametrize("B,H,N,D", [(2, 16, 1024, 64), (1, 4, 512, 128), (1, 2, 128, 64), (8, 16, 1024, 64),
                                     (1, 4, 1024, 128)],
                         ids=["pixel-decoder-b2", "d128", "one-tile-pair", "pixel-decoder-b8", "d128-n1024"])
def test_flash_vit_backward_kernels_match_plain(dev, B, H, N, D):
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, do = _vit_inputs(dev, B, H, N, D)
    scale = D**-0.5
    out, lse = flash.flash_vit_attention_lse_plain(q, k, v, scale=scale)
    delta = flash.flash_vit_delta(out, do)
    before = (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches)
    dk, dv = flash.flash_vit_bwd_dkv(q, k, v, lse, do, delta, scale=scale)
    dq = flash.flash_vit_bwd_dq(q, k, v, lse, do, delta, scale=scale)
    torch.cuda.synchronize()
    assert (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want_dk, want_dv = flash.flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, scale=scale)
    want_dq = flash.flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, scale=scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        _close_bf16(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32-in-default-tier"])
def test_flash_vit_attention_autograd_on_the_card(dev, dtype):
    """Under grad the entry goes through the autograd Function: one residual
    forward, one dK / dV and one dQ launch; its grads against autograd of the
    plain forward in fp32."""
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, do = _vit_inputs(dev, 1, 16, 1024, 64, seed=22)
    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    counters = (flash.flash_vit_attention, flash.flash_vit_bwd_dkv, flash.flash_vit_bwd_dq)
    before = [f.launches for f in counters]
    out = flash.flash_vit_attention(*leaves, scale=0.125)
    out.backward(do.to(dtype))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert out.dtype == dtype and all(t.grad.dtype == dtype for t in leaves)
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    s = torch.matmul(ref[0], ref[1].transpose(-1, -2)) * 0.125
    torch.matmul(torch.softmax(s, -1), ref[2]).backward(do.float())
    for got, r in zip(leaves, ref):
        err = (got.grad.float() - r.grad).abs().max().item()
        assert err <= 2e-2 * r.grad.abs().max().item(), err


def _vit_bwd_args(dev, B, H, N, D, seed=24):
    """The backward kernels' inputs: q, k, v, dO and the plain forward's lse and delta."""
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, do = _vit_inputs(dev, B, H, N, D, seed=seed)
    out, lse = flash.flash_vit_attention_lse_plain(q, k, v, scale=D**-0.5)
    return q, k, v, lse, do, flash.flash_vit_delta(out, do)


def test_flash_vit_backward_copies_strided_and_misaligned_operands(dev):
    """q, k, v as the pixel decoder hands them in (views of one (B, N, 3, H, D)
    projection) and a dO 2 bytes past an aligned start: both wrappers copy them
    onto the wgmma bodies and match the plain version on the same values."""
    from mingunivision_tpu_torch.ops.kernels import flash

    B, H, N, D = 2, 16, 1024, 64
    q, k, v, lse, do, delta = _vit_bwd_args(dev, B, H, N, D)
    qkv = torch.stack((q, k, v)).permute(1, 3, 0, 2, 4).contiguous()  # (B, N, 3, H, D)
    views = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, N, D), as models/vit.py takes q, k, v
    assert not views[0].is_contiguous() and views[0].equal(q)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=dev)
    do_off = flat[1:].view(do.shape)
    do_off.copy_(do)
    assert do_off.data_ptr() % 16 != 0
    before = (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches)
    dk, dv = flash.flash_vit_bwd_dkv(views[0], views[1], views[2], lse, do_off, delta, scale=D**-0.5)
    dq = flash.flash_vit_bwd_dq(views[0], views[1], views[2], lse, do_off, delta, scale=D**-0.5)
    torch.cuda.synchronize()
    assert (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want_dk, want_dv = flash.flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, scale=D**-0.5)
    for got, want in ((dq, flash.flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, scale=D**-0.5)), (dk, want_dk),
                      (dv, want_dv)):
        _close_bf16(got, want)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_vit_backward_repeats_bit_equal(dev, D):
    """No two blocks write one output and nothing is summed by atomics: two
    calls on the same inputs give the same dQ, dK and dV to the bit."""
    from mingunivision_tpu_torch.ops.kernels import flash

    args = _vit_bwd_args(dev, 2, 16 if D == 64 else 4, 1024, D, seed=25)
    first = (*flash.flash_vit_bwd_dkv(*args, scale=D**-0.5), flash.flash_vit_bwd_dq(*args, scale=D**-0.5))
    second = (*flash.flash_vit_bwd_dkv(*args, scale=D**-0.5), flash.flash_vit_bwd_dq(*args, scale=D**-0.5))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert a.equal(b)


def test_flash_vit_backward_raises_off_its_tile(dev):
    """N 192, a multiple of 64 but not of the 128-row tile: both wrappers raise
    and nothing launches."""
    from mingunivision_tpu_torch.ops.kernels import flash

    args = _vit_bwd_args(dev, 1, 2, 192, 64)
    before = (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches)
    with pytest.raises(ValueError):
        flash.flash_vit_bwd_dkv(*args, scale=0.125)
    with pytest.raises(ValueError):
        flash.flash_vit_bwd_dq(*args, scale=0.125)
    assert (flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches) == before


def test_flash_vit_backward_wrappers_raise_on_unsupported_input(dev):
    from mingunivision_tpu_torch.ops.kernels import flash

    q = torch.randn(1, 2, 96, 64, device=dev).to(torch.bfloat16)  # N = 96 is not a multiple of the tile
    lse = torch.zeros(1, 2, 96, device=dev)
    with pytest.raises(ValueError):
        flash.flash_vit_bwd_dkv(q, q, q, lse, q, lse, scale=1.0)
    with pytest.raises(ValueError):
        flash.flash_vit_bwd_dq(q.float(), q, q, lse, q, lse, scale=1.0)


def test_vit_projections_round_once_on_the_card(dev):
    """The head-major flash block's projections on the card (bf16 GEMM with an
    fp32 result, the bias in fp32, one rounding) against the same on the CPU
    (fp32 products of the bf16 operands): equal within one bf16 step, and the
    backward's grads the same."""
    from mingunivision_tpu_torch.models import vit

    g = torch.Generator().manual_seed(23)
    x = torch.randn(512, 256, generator=g).to(torch.bfloat16)
    w = (0.05 * torch.randn(256, 768, generator=g)).to(torch.bfloat16)
    b = (0.1 * torch.randn(768, generator=g)).to(torch.bfloat16)
    gy = torch.randn(512, 768, generator=g).to(torch.bfloat16)
    outs = []
    for device in ("cpu", dev):
        xs, ws, bs = (t.detach().to(device).requires_grad_(True) for t in (x, w, b))
        y = vit._linear_round_once(xs, ws, bs)
        y.backward(gy.to(device))
        outs.append([t.detach().float().cpu() for t in (y, xs.grad, ws.grad, bs.grad)])
    for cpu, card in zip(*outs):
        assert (cpu - card).abs().max().item() <= 2 ** -7 * cpu.abs().max().item()


@pytest.mark.parametrize("A,N,ragged_h", [(12, 1408, False), (36, 2048, False), (5, 88, True)],
                         ids=["12-assignments-gate", "36-assignments-down", "ragged-tile-and-h"])
def test_gathered_expert_matmul_kernel_matches_plain(dev, A, N, ragged_h):
    """Row 12 against its plain version: a full 256-column tile and a ragged
    last one (1408 = 5.5 tiles), h not a multiple of the 8 warps x 4 rows."""
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import gathered_expert_matmul, gathered_expert_matmul_plain

    g = torch.Generator(device=dev).manual_seed(29)
    h = 100 if ragged_h else 256
    w = torch.empty((E, h, N), device=dev, dtype=torch.bfloat16).normal_(0, 0.05, generator=g)
    x = torch.randn((A, h), device=dev, generator=g).to(torch.bfloat16)
    ids = torch.randint(0, E, (A,), device=dev, generator=g, dtype=torch.int32)
    before = gathered_expert_matmul.launches
    got = gathered_expert_matmul(x, w, ids)
    torch.cuda.synchronize()
    assert gathered_expert_matmul.launches == before + 1 and got.dtype == torch.bfloat16
    _close_bf16(got, gathered_expert_matmul_plain(x, w, ids))


def _gather_ids(case, A, n_exp, dev, g):
    """Row 12's routing cases: ids drawn from all experts (repeats among 72
    of them), all equal, all distinct, 72 on 2 experts, or drawn with one
    out of range (its row NaN)."""
    if case == "all-equal":
        return torch.full((A,), 5, dtype=torch.int32, device=dev)
    if case == "all-distinct":
        return torch.randperm(n_exp, device=dev, generator=g)[:A].to(torch.int32)
    if case == "two-experts":
        return torch.tensor([3, 60], device=dev, dtype=torch.int32)[torch.randint(0, 2, (A,), device=dev,
                                                                                   generator=g)]
    ids = torch.randint(0, n_exp, (A,), device=dev, generator=g, dtype=torch.int32)
    if case == "out-of-range":
        ids[A // 2] = n_exp + 3
        ids[0] = -1
    return ids


@pytest.mark.parametrize("h,N", [(2048, 1408), (1408, 2048)], ids=["gate-table", "down-table"])
@pytest.mark.parametrize("case", ["drawn", "all-equal", "all-distinct", "two-experts", "out-of-range"])
@pytest.mark.parametrize("A", [1, 12, 72, 200])
def test_gathered_expert_matmul_routing_cases(dev, A, case, h, N):
    """Row 12 at the 16B-A3B slab shapes (64 experts) on every routing case:
    within one bf16 rounding of its plain version (their fp32 sums in another
    order), an out-of-range id's row all NaN and the others finite; one
    launch."""
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import gathered_expert_matmul, gathered_expert_matmul_plain

    n_exp = 64
    if case == "all-distinct" and A > n_exp:
        pytest.skip("more assignments than experts cannot all be distinct")
    g = torch.Generator(device=dev).manual_seed(A + len(case))
    w = torch.empty((n_exp, h, N), device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g)
    x = torch.randn((A, h), device=dev, generator=g).to(torch.bfloat16)
    ids = _gather_ids(case, A, n_exp, dev, g)
    before = gathered_expert_matmul.launches
    got = gathered_expert_matmul(x, w, ids)
    torch.cuda.synchronize()
    assert gathered_expert_matmul.launches == before + 1
    bad = (ids < 0) | (ids >= n_exp)
    assert torch.isnan(got[bad].float()).all() and torch.isfinite(got[~bad].float()).all()
    want = gathered_expert_matmul_plain(x[~bad], w, ids[~bad])
    err, wf = (got[~bad].float() - want.float()).abs(), want.float()
    ulp = torch.ldexp(torch.ones_like(wf), torch.frexp(wf).exponent - 8)  # one bf16 step at the plain value
    # beside it, the fp32 sums' reassociation (the kernel's eight warps' partials): 1e-5 of the largest output, which
    # decides the bf16 rounding of outputs near zero
    if want.numel():
        assert (err <= ulp + 1e-5 * wf.abs().max()).all(), (err - ulp).max().item()


@pytest.mark.parametrize("n", [2, 6], ids=["2rows", "6rows-shared-experts"])
def test_moe_experts_gather_kernel_matches_plain_and_stream(dev, n):
    """The whole gathered dispatch (three launches) against its plain version
    and against the decode-MoE stream kernel on the same stacked tables."""
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import (
        gathered_expert_matmul,
        moe_experts_gather_kernel,
        moe_experts_gather_plain,
    )

    ex = _experts(dev, seed=31)
    idx, w = _routing(dev, n, 6, seed=32)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    before = gathered_expert_matmul.launches
    got = moe_experts_gather_kernel(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert gathered_expert_matmul.launches == before + 3
    _close_bf16(got, moe_experts_gather_plain(ex, x, idx, w, layer_idx=1))
    _close_bf16(got, moe_experts_stream(ex, x, idx, w, layer_idx=1))


def test_gathered_expert_matmul_raises_on_unsupported_input(dev):
    from mingunivision_tpu_torch.ops.kernels.expert_matmul import gathered_expert_matmul, moe_experts_gather_kernel

    w = torch.zeros((E, 64, 64), device=dev, dtype=torch.bfloat16)
    x = torch.zeros((3, 64), device=dev, dtype=torch.bfloat16)
    ids = torch.zeros(3, device=dev, dtype=torch.int32)
    for bad in (dict(ids=ids.long()), dict(ids=ids[:2]), dict(ids=ids.cpu()), dict(x=x.float()),
                dict(w=torch.zeros((E, 64, 60), device=dev, dtype=torch.bfloat16))):
        kw = dict(x=x, w=w, ids=ids) | bad
        with pytest.raises(ValueError):
            gathered_expert_matmul(kw["x"], kw["w"], kw["ids"])
    idx, tw = _routing(dev, 3, 2)
    with pytest.raises(ValueError, match="layer index"):
        moe_experts_gather_kernel(_experts(dev), x.new_zeros((3, H)), idx, tw)


# ---------------------------------------------------------------------------
# decode attention, split over the cache (one launch: partials merged by the last block of each row)
# ---------------------------------------------------------------------------

_DECODE_MASKS = ("causal-prefix", "cfg-holes", "lone-last-tile", "fully-masked-row")


def _decode_mask(kind, B, S, dev):
    """(B, S) bool: row b allows a prefix of min(S, 300 + 37 b) positions (the
    slice's causal bound); with CFG holes, odd rows skip 50 positions from a
    third of it; or only position S - 1 - b (in the last split); or the
    prefixes with row 0 fully masked."""
    mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
    for b in range(B):
        n = min(S, 300 + 37 * b)
        if kind == "lone-last-tile":
            mask[b, S - 1 - b] = True
            continue
        mask[b, :n] = True
        if kind == "cfg-holes" and b % 2:
            mask[b, n // 3 : n // 3 + 50] = False
    if kind == "fully-masked-row":
        mask[0] = False
    return mask


def test_decode_attention_split_tile_matches_the_kernel(dev):
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import decode_attention as da

    assert build.load().mu_decode_attention_tile() == da.SPLIT_TILE


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-inf-masked"])
@pytest.mark.parametrize("kind", _DECODE_MASKS)
@pytest.mark.parametrize("S", [4096, 512])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 9, 12, 16])
def test_decode_attention_split_kernel_matches_plain(dev, B, S, kind, poison):
    """Every batch the port calls decode attention with (understanding 1, T2I 2,
    editing 3, n_images=2 4, the barrier batch 9, the image pool 12, the text
    pool up to 16), G 4, D 128: one launch per call; rows with an allowed
    position within bf16's precision of the plain version on the clean cache,
    a fully masked row exactly zero; NaN in every masked K position and Inf in
    every masked V position change nothing (they are never loaded)."""
    Hkv, G, D = 4, 4, 128
    g = torch.Generator(device=dev).manual_seed(31 + B)
    q = torch.randn(B, 1, Hkv * G, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
    mask = _decode_mask(kind, B, S, dev)
    want = decode_attention_plain(q, k, v, mask)
    kc, vc = k.clone(), v.clone()
    if poison:
        hidden = ~mask[:, None, :, None].expand_as(kc)
        kc[hidden] = float("nan")
        vc[hidden] = float("inf")
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    rows = mask.any(-1)
    if rows.any():
        _close_bf16(got[rows], want[rows])
    assert torch.equal(got[~rows].float(), torch.zeros_like(got[~rows].float()))
    again = decode_attention(q, kc, vc, mask)  # the counters were left at zero: the next launch merges again
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the ViT flash forward's wgmma body against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,D", [(1, 1024, 64), (2, 1024, 64), (8, 1024, 64), (1, 512, 64), (2, 512, 64),
                                   (8, 512, 64), (1, 512, 128), (2, 1024, 128)])
def test_flash_vit_wgmma_body_matches_plain(dev, B, N, D):
    from mingunivision_tpu_torch.ops.kernels import flash

    H = 16 if D == 64 else 4
    q, k, v, _ = _vit_inputs(dev, B, H, N, D, seed=40 + B)
    scale = D**-0.5
    before = flash.flash_vit_attention.launches
    out, lse = flash.flash_vit_attention_lse(q, k, v, scale=scale)
    plain_out = flash.flash_vit_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert flash.flash_vit_attention.launches == before + 2
    want, want_lse = flash.flash_vit_attention_lse_plain(q, k, v, scale=scale)
    _close_bf16(out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-4 * want_lse.abs().max().item() + 1e-5
    assert out.equal(plain_out)  # the residual mode only adds the lse


def test_flash_vit_forward_raises_off_its_tile(dev):
    """N 576, a multiple of 64 but not of the forward's 128-row tile: the
    wrapper raises (the pixel decoder's gate never sends it one)."""
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, _ = _vit_inputs(dev, 2, 4, 576, 64)
    before = flash.flash_vit_attention.launches
    with pytest.raises(ValueError):
        flash.flash_vit_attention_lse(q, k, v, scale=0.125)
    assert flash.flash_vit_attention.launches == before


def test_flash_vit_misaligned_operand_is_copied_onto_the_wgmma_body(dev):
    from mingunivision_tpu_torch.ops.kernels import flash

    q, k, v, _ = _vit_inputs(dev, 1, 16, 1024, 64)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_off = flat[1:].view(q.shape)  # 2 bytes past an aligned start: TMA cannot read it in place
    q_off.copy_(q)
    before = flash.flash_vit_attention.launches
    out = flash.flash_vit_attention(q_off, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert flash.flash_vit_attention.launches == before + 1
    _close_bf16(out, flash.flash_vit_attention_plain(q, k, v, scale=0.125))


# ---------------------------------------------------------------------------
# paged decode attention, split by page (one launch: partials merged by the last block of each row)
# ---------------------------------------------------------------------------


def _device_events(fn, calls=3):
    """The device events (kernels, copies, fills) of `calls` calls of fn, by
    torch.profiler, in no particular order. The profiler drops events now and
    then, so fewer than were launched may be listed, never more; a window it
    recorded nothing in is taken again, three times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return events


def _allocations(fn):
    """Device allocations one call of fn makes (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def _paged_split_inputs(dev, G, D, page, poison, Hkv=2, seed=51):
    """Rows of lengths 0, 1, 63, 64, 65, 2047; page ids shuffled; the 65-long row
    sharing the 2047-long row's first page; unused entries on the scratch page;
    with `poison`, NaN in K and Inf in V at the scratch page, every page's tail
    past its row's length and the pages no row owns. Returns the inputs and
    the clean pages."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 63, 64, 65, 2047]
    B, maxp = len(lengths), -(-2047 // page)
    need = [-(-n // page) for n in lengths]
    P = sum(need) + 3
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed)).tolist()
    tables = torch.full((B, maxp), P, dtype=torch.int32)
    for b in (5, 0, 1, 2, 3, 4):
        shared = [int(tables[5, 0])] if b == 4 else []
        tables[b, :need[b]] = torch.tensor(shared + [perm.pop() for _ in range(need[b] - len(shared))],
                                           dtype=torch.int32)
    kp = torch.randn(Hkv, P + 1, page, D, device=dev, generator=g).to(torch.bfloat16)
    vp = torch.randn(Hkv, P + 1, page, D, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(B, 1, Hkv * G, D, device=dev, generator=g).to(torch.bfloat16)
    kc, vc = kp.clone(), vp.clone()
    if poison:
        valid = torch.zeros(P + 1, page, dtype=torch.bool)
        for b, n in enumerate(lengths):
            for i in range(need[b]):
                valid[int(tables[b, i]), :min(page, n - i * page)] = True
        hidden = ~valid.to(dev)
        kc[:, hidden] = float("nan")
        vc[:, hidden] = float("inf")
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, kc, vc, tables.to(dev), lengths), (kp, vp)


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-inf-unread"])
@pytest.mark.parametrize("G,D,page", [(1, 64, 64), (4, 128, 64), (8, 128, 64), (8, 64, 64), (4, 128, 32),
                                      (1, 64, 32), (2, 128, 16)])
def test_paged_attention_split_kernel_matches_plain(dev, G, D, page, poison):
    """G 1 / 4 / 8, D 64 / 128, page 64, 32 and 16, lengths 0-2047, a shared
    page: one launch per call; rows within bf16's precision of the plain
    version on the clean pool, a row of length 0 exactly zero; NaN and Inf
    where no row's valid position lies change nothing (they are never read);
    a second launch gives the same bits (the tickets were left at zero)."""
    (q, kc, vc, tables, lengths), (kp, vp) = _paged_split_inputs(dev, G, D, page, poison)
    want = paged_gather_attention(q, kp, vp, tables, lengths)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kc, vc, tables, lengths)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    rows = lengths > 0
    _close_bf16(got[rows], want[rows])
    assert torch.equal(got[~rows].float(), torch.zeros_like(got[~rows].float()))
    assert torch.equal(paged_decode_attention(q, kc, vc, tables, lengths), got)


def test_paged_attention_tile_matches_the_kernel(dev):
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import paged_attention as pa

    assert build.load().mu_paged_attention_tile() == pa.SPLIT_TILE


def test_paged_attention_one_kernel_and_no_scratch_allocation_per_call(dev):
    q, kp, vp, tables, lengths = _paged_inputs(dev, 16)
    call = lambda: paged_decode_attention(q, kp, vp, tables, lengths)  # noqa: E731
    events = _device_events(call, calls=3)
    assert 0 < len(events) <= 3 and all("paged_split_kernel" in e for e in events), events
    assert _allocations(call) == 1  # the output only: the workspace is kept


def test_paged_attention_on_two_streams(dev):
    """Launches on two streams at once, each with its own workspace, give the
    default stream's result."""
    from mingunivision_tpu_torch.ops.kernels import decode_attention as da

    a, b = _paged_inputs(dev, 16, seed=61), _paged_inputs(dev, 8, seed=62)
    want_a, want_b = paged_decode_attention(*a), paged_decode_attention(*b)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            outs.append(("a", paged_decode_attention(*a)))
        with torch.cuda.stream(s2):
            outs.append(("b", paged_decode_attention(*b)))
    torch.cuda.synchronize()
    for which, out in outs:
        assert torch.equal(out, want_a if which == "a" else want_b)
    assert {(dev.index or 0, s.cuda_stream) for s in (s1, s2)} <= {(k[0] or 0, k[1]) for k in da._workspaces}


# ---------------------------------------------------------------------------
# the bf16 decode MoE: the expert list built in the kernel, products on the tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,choices", [(1, 6, None), (2, 6, None), (3, 6, None), (4, 6, None), (8, 6, None),
                                         (16, 6, None), (12, 8, None), (48, 6, None), (3, 6, [0, 1, 2, 3, 4, 5]),
                                         (16, 1, [5]), (5, 2, [2, 6])],
                         ids=["1row", "2rows", "3rows", "4rows", "8rows", "16rows-every-expert", "12rows-k8",
                              "48rows", "3rows-6-experts", "16rows-one-expert", "5rows-2-experts"])
def test_moe_stream_tensor_core_kernel_matches_plain(dev, n, k, choices):
    """N 1-48 (1, 2, 4 and 8 n-tiles), every expert routed (16 rows x top-6 of
    8), one expert only, on layer 1 of stacked tables: two launches per call,
    within bf16's precision of the plain version, the same bits again."""
    ex = _experts(dev, seed=70 + n)
    idx, w = _routing(dev, n, k, choices, seed=71 + n)
    x = torch.randn(n, H, device=dev, generator=torch.Generator(device=dev).manual_seed(n)).to(torch.bfloat16)
    if choices is None and n == 16:
        assert torch.unique(idx).numel() == E
    before = moe_experts_stream.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert moe_experts_stream.launches == before + 1
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))
    assert torch.equal(moe_experts_stream(ex, x, idx, w, layer_idx=1), got)


def test_moe_stream_takes_int32_ids_and_fp32_gates(dev):
    ex = _experts(dev, seed=80)
    idx, w = _routing(dev, 3, 6, seed=81)
    x = torch.randn(3, H, device=dev).to(torch.bfloat16)
    want = moe_experts_stream(ex, x, idx, w, layer_idx=0)
    got = moe_experts_stream(ex, x, idx.int(), w.float(), layer_idx=0)
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w.float(), layer_idx=0))
    _close_bf16(got, want)


def test_moe_stream_more_rows_than_one_launch(dev):
    """80 rows: one pair of launches per 64 rows."""
    from mingunivision_tpu_torch.ops.kernels import moe_stream as ms

    ex = _experts(dev, seed=82)
    idx, w = _routing(dev, 80, 6, seed=83)
    x = torch.randn(80, H, device=dev).to(torch.bfloat16)
    before = moe_experts_stream.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1)
    torch.cuda.synchronize()
    assert moe_experts_stream.launches == before + -(-80 // ms.ROWS_PER_LAUNCH)
    _close_bf16(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))


def test_moe_stream_rows_pad_matches_the_kernel(dev):
    from mingunivision_tpu_torch.ops.kernels import build
    from mingunivision_tpu_torch.ops.kernels import moe_stream as ms

    assert [build.load().mu_moe_stream_rows_pad(n) for n in range(1, 65)] == [ms.rows_pad(n) for n in range(1, 65)]


@pytest.mark.parametrize("n", [2, 16])
def test_moe_stream_two_kernels_and_no_scratch_allocation_per_call(dev, n):
    ex = _experts(dev, seed=84)
    idx, w = _routing(dev, n, 6, seed=85)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    call = lambda: moe_experts_stream(ex, x, idx, w, layer_idx=1)  # noqa: E731
    events = _device_events(call, calls=3)
    ups, downs = (sum(name in e for e in events) for name in ("moe_up_kernel", "moe_down_kernel"))
    assert 0 < ups <= 3 and 0 < downs <= 3 and ups + downs == len(events), events
    assert _allocations(call) == 1  # the output only: the workspace is kept


def test_moe_stream_at_full_width_matches_plain(dev):
    """The 16B-A3B tables (64 experts of 2048 x 1408), 2 and 16 rows top-6."""
    g = torch.Generator(device=dev).manual_seed(86)
    ex = {"gate_proj": torch.empty(64, 2048, 1408, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g),
          "up_proj": torch.empty(64, 2048, 1408, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g),
          "down_proj": torch.empty(64, 1408, 2048, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g)}
    for n in (2, 16):
        scores = torch.rand((n, 64), device=dev, generator=g)
        w, idx = torch.topk(torch.softmax(scores, -1), 6)
        x = torch.randn(n, 2048, device=dev, generator=g).to(torch.bfloat16)
        got = moe_experts_stream(ex, x, idx, (w / w.sum(-1, keepdim=True)).to(torch.bfloat16))
        _close_bf16(got, moe_experts_stream_plain(ex, x, idx, (w / w.sum(-1, keepdim=True)).to(torch.bfloat16)))


# ---------------------------------------------------------------------------
# the int4 decode MoE with s8 dots: the expert list built in the kernel, s8 products on the tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["int64-ids-fp32-gates", "int32-ids-bf16-gates", "last-layer-of-3", "repeat-and-drop"])
def test_moe_stream_q4s8_kernel_routing_inputs(dev, case):
    """int32 or int64 ids, bf16 or fp32 gates; a stacked table's last layer;
    a row naming one expert twice and ids outside [0, E) (dropped): the plain
    version's bits."""
    ex = _q4(_experts(dev, layers=3, seed=90))
    idx, w = _routing(dev, 3, 6, seed=91)
    x = torch.randn(3, H, device=dev).to(torch.bfloat16)
    layer = -1 if case == "last-layer-of-3" else 2
    if case == "int64-ids-fp32-gates":
        idx, w = idx.long(), w.float()
    elif case == "int32-ids-bf16-gates":
        idx = idx.int()
    elif case == "repeat-and-drop":
        idx = idx.clone()
        idx[0, 1] = idx[0, 0]
        idx[1, 2], idx[2, 0] = E, -1
    got = moe_experts_stream_q4s8(ex, x, idx, w, layer_idx=layer)
    torch.cuda.synchronize()
    assert torch.equal(got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=layer))


@pytest.mark.parametrize("n", [2, 16])
def test_moe_stream_q4s8_two_kernels_and_no_scratch_allocation_per_call(dev, n):
    ex = _q4(_experts(dev, seed=92))
    idx, w = _routing(dev, n, 6, seed=93)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    call = lambda: moe_experts_stream_q4s8(ex, x, idx, w, layer_idx=1)  # noqa: E731
    events = _device_events(call, calls=3)
    ups, downs = (sum(name in e for e in events) for name in ("q4s8_up_kernel", "q4s8_down_kernel"))
    assert 0 < ups <= 3 and 0 < downs <= 3 and ups + downs == len(events), events
    assert _allocations(call) == 1  # the output only: the workspace is kept


def test_moe_stream_q4s8_on_two_streams_leaves_the_tickets_at_zero(dev):
    """Calls on two streams at once, each with its own workspace, give the
    default stream's bits; every launch leaves its tickets at zero, and a
    second call on a stream reuses its workspace."""
    from mingunivision_tpu_torch.ops.kernels import moe_stream as ms

    ex = _q4(_experts(dev, seed=94))
    cases = []
    for n, seed in ((16, 95), (3, 96)):
        idx, w = _routing(dev, n, 6, seed=seed)
        cases.append((torch.randn(n, H, device=dev).to(torch.bfloat16), idx, w))
    want = [moe_experts_stream_q4s8(ex, x, idx, w, layer_idx=0) for x, idx, w in cases]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs, spaces = [], {}
    for _ in range(3):
        for which, stream in enumerate((s1, s2)):
            with torch.cuda.stream(stream):
                x, idx, w = cases[which]
                outs.append((which, moe_experts_stream_q4s8(ex, x, idx, w, layer_idx=0)))
                key = (x.device.index, stream.cuda_stream)
                bufs = tuple(t.data_ptr() for t in ms._q4s8_workspaces[key])
                assert spaces.setdefault(key, bufs) == bufs  # reused, not allocated again
    torch.cuda.synchronize()
    for which, out in outs:
        assert torch.equal(out, want[which])
    for key in spaces:
        assert not ms._q4s8_workspaces[key][2].any()


def test_moe_stream_q4s8_raises_on_unsupported_input(dev):
    ex = _q4(_experts(dev, seed=97))
    idx, w = _routing(dev, 2, 6, seed=98)
    x = torch.randn(2, H, device=dev)
    with pytest.raises(ValueError):
        moe_experts_stream_q4s8(ex, x, idx, w, layer_idx=0)  # fp32 rows
    with pytest.raises(ValueError):
        moe_experts_stream_q4s8(ex, x.to(torch.bfloat16), idx, w)  # a stacked table without its layer
    narrow = _q4({k: v[..., :320] if k != "down_proj" else v[..., :320, :] for k, v in _experts(dev, seed=99).items()})
    with pytest.raises(ValueError):
        moe_experts_stream_q4s8(narrow, x.to(torch.bfloat16), idx, w, layer_idx=0)  # m = 320: not whole tiles


def test_moe_stream_q4s8_at_full_width_matches_plain(dev):
    """The 16B-A3B int4 tables (64 experts of 2048 x 1408), 1, 2, 3, 12 and 16 rows top-6: the plain version's bits."""
    g = torch.Generator(device=dev).manual_seed(100)
    shapes = {"gate_proj": (1, 64, 2048, 1408), "up_proj": (1, 64, 2048, 1408), "down_proj": (1, 64, 1408, 2048)}
    ex = _q4({k: torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g)
              for k, s in shapes.items()})
    for n in (1, 2, 3, 12, 16):
        scores = torch.rand((n, 64), device=dev, generator=g)
        wt, idx = torch.topk(torch.softmax(scores, -1), 6)
        wt = (wt / wt.sum(-1, keepdim=True)).to(torch.bfloat16)
        x = torch.randn(n, 2048, device=dev, generator=g).to(torch.bfloat16)
        got = moe_experts_stream_q4s8(ex, x, idx, wt, layer_idx=0)
        torch.cuda.synchronize()
        assert torch.equal(got, moe_experts_stream_plain(ex, x, idx, wt, layer_idx=0)), n


# ---------------------------------------------------------------------------
# the int8 decode MoE with s8 dots (7a) and the int4 one with exact dequant (7e) on row 4's body: the expert
# list built in the kernel, two launches, s8 or bf16 products on the tensor cores
# ---------------------------------------------------------------------------

# name: (wrapper, quantized bits, the dot mode `moe_experts_stream` takes, its two kernels, rows a launch pair)
_RING = {"q8s8": (moe_experts_stream_q8s8, 8, True, ("q8s8_up_kernel", "q8s8_down_kernel"), 64),
         "q4": (moe_experts_stream_q4, 4, False, ("q4_up_kernel", "q4_down_kernel"), 32)}


def _ring_tables(dev, which, layers=2, seed=0):
    return {k: quantize_array(v, _RING[which][1]) for k, v in _experts(dev, layers=layers, seed=seed).items()}


def _ring_held(which, got, want):
    """7a gives the plain version's bits (exact integer sums, its fp32 steps); 7e sums fp32 in another order."""
    if which == "q8s8":
        assert torch.equal(got, want)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("which", list(_RING))
@pytest.mark.parametrize("case", ["int64-ids-fp32-gates", "int32-ids-bf16-gates", "last-layer-of-3", "repeat-and-drop"])
def test_moe_stream_ring_kernel_routing_inputs(dev, which, case):
    """int32 or int64 ids, bf16 or fp32 gates; a stacked table's last layer; a
    row naming one expert twice and ids outside [0, E) (dropped)."""
    ex = _ring_tables(dev, which, layers=3, seed=110)
    idx, w = _routing(dev, 3, 6, seed=111)
    x = torch.randn(3, H, device=dev).to(torch.bfloat16)
    layer = -1 if case == "last-layer-of-3" else 2
    if case == "int64-ids-fp32-gates":
        idx, w = idx.long(), w.float()
    elif case == "int32-ids-bf16-gates":
        idx = idx.int()
    elif case == "repeat-and-drop":
        idx = idx.clone()
        idx[0, 1] = idx[0, 0]
        idx[1, 2], idx[2, 0] = E, -1
    kernel, _, int_dots, _, _ = _RING[which]
    before = kernel.launches
    got = kernel(ex, x, idx, w, layer_idx=layer)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _ring_held(which, got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=layer, int_dots=int_dots))


@pytest.mark.parametrize("which", list(_RING))
@pytest.mark.parametrize("n", [2, 16])
def test_moe_stream_ring_two_kernels_and_no_scratch_allocation_per_call(dev, which, n):
    ex = _ring_tables(dev, which, seed=112)
    idx, w = _routing(dev, n, 6, seed=113)
    x = torch.randn(n, H, device=dev).to(torch.bfloat16)
    kernel, _, _, names, _ = _RING[which]
    call = lambda: kernel(ex, x, idx, w, layer_idx=1)  # noqa: E731
    events = _device_events(call, calls=3)
    ups, downs = (sum(name in e for e in events) for name in names)
    assert 0 < ups <= 3 and 0 < downs <= 3 and ups + downs == len(events), events
    assert _allocations(call) == 1  # the output only: the workspace is kept


@pytest.mark.parametrize("which", list(_RING))
def test_moe_stream_ring_on_two_streams_leaves_the_tickets_at_zero(dev, which):
    """Calls on two streams at once, each with its own workspace, give the
    default stream's bits; every launch leaves its tickets at zero, and a
    second call on a stream reuses its workspace."""
    from mingunivision_tpu_torch.ops.kernels import moe_stream as ms

    kernel = _RING[which][0]
    store = ms._q8s8_workspaces if which == "q8s8" else ms._q4_workspaces
    ex = _ring_tables(dev, which, seed=114)
    cases = []
    for n, seed in ((16, 115), (3, 116)):
        idx, w = _routing(dev, n, 6, seed=seed)
        cases.append((torch.randn(n, H, device=dev).to(torch.bfloat16), idx, w))
    want = [kernel(ex, x, idx, w, layer_idx=0) for x, idx, w in cases]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs, spaces = [], {}
    for _ in range(3):
        for which_case, stream in enumerate((s1, s2)):
            with torch.cuda.stream(stream):
                x, idx, w = cases[which_case]
                outs.append((which_case, kernel(ex, x, idx, w, layer_idx=0)))
                key = (x.device.index, stream.cuda_stream)
                bufs = tuple(t.data_ptr() for t in store[key])
                assert spaces.setdefault(key, bufs) == bufs  # reused, not allocated again
    torch.cuda.synchronize()
    for which_case, out in outs:
        assert torch.equal(out, want[which_case])
    for key in spaces:
        assert not store[key][2].any()


@pytest.mark.parametrize("which", list(_RING))
def test_moe_stream_ring_more_rows_than_one_launch(dev, which):
    """80 rows: one pair of launches per 64 rows (7a) or per 32 (7e)."""
    kernel, _, int_dots, _, rows = _RING[which]
    ex = _ring_tables(dev, which, seed=117)
    idx, w = _routing(dev, 80, 6, seed=118)
    x = torch.randn(80, H, device=dev).to(torch.bfloat16)
    before = kernel.launches
    got = moe_experts_stream(ex, x, idx, w, layer_idx=1, int_dots=int_dots)
    torch.cuda.synchronize()
    assert kernel.launches == before + -(-80 // rows)
    _ring_held(which, got, moe_experts_stream_plain(ex, x, idx, w, layer_idx=1, int_dots=int_dots))


@pytest.mark.parametrize("which", list(_RING))
def test_moe_stream_ring_raises_on_unsupported_input(dev, which):
    kernel = _RING[which][0]
    ex = _ring_tables(dev, which, seed=119)
    idx, w = _routing(dev, 2, 6, seed=120)
    x = torch.randn(2, H, device=dev)
    with pytest.raises(ValueError):
        kernel(ex, x, idx, w, layer_idx=0)  # fp32 rows
    with pytest.raises(ValueError):
        kernel(ex, x.to(torch.bfloat16), idx, w)  # a stacked table without its layer
    narrow = {k: quantize_array(v[..., :320] if k != "down_proj" else v[..., :320, :], _RING[which][1])
              for k, v in _experts(dev, seed=121).items()}
    with pytest.raises(ValueError):
        kernel(narrow, x.to(torch.bfloat16), idx, w, layer_idx=0)  # m = 320: not whole tiles
    other = _ring_tables(dev, "q4" if which == "q8s8" else "q8s8", seed=122)
    with pytest.raises(ValueError):
        kernel(other, x.to(torch.bfloat16), idx, w, layer_idx=0)  # the other tier's tables


@pytest.mark.parametrize("which", list(_RING))
def test_moe_stream_ring_at_full_width_matches_plain(dev, which):
    """The 16B-A3B tables (64 experts of 2048 x 1408), 1, 2, 3, 12 and 16 rows
    top-6: 7a the plain version's bits, 7e within bf16's precision."""
    kernel, bits, int_dots, _, _ = _RING[which]
    g = torch.Generator(device=dev).manual_seed(123)
    shapes = {"gate_proj": (1, 64, 2048, 1408), "up_proj": (1, 64, 2048, 1408), "down_proj": (1, 64, 1408, 2048)}
    ex = {k: quantize_array(torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.02, generator=g), bits)
          for k, s in shapes.items()}
    for n in (1, 2, 3, 12, 16):
        scores = torch.rand((n, 64), device=dev, generator=g)
        wt, idx = torch.topk(torch.softmax(scores, -1), 6)
        wt = (wt / wt.sum(-1, keepdim=True)).to(torch.bfloat16)
        x = torch.randn(n, 2048, device=dev, generator=g).to(torch.bfloat16)
        got = kernel(ex, x, idx, wt, layer_idx=0)
        torch.cuda.synchronize()
        _ring_held(which, got, moe_experts_stream_plain(ex, x, idx, wt, layer_idx=0, int_dots=int_dots))


# ---------------------------------------------------------------------------
# the prefill MoE on its wgmma body (row 2, bf16 tables; row 5, int4 tables, and row 7c, int8 tables, with
# exact dequant): 128-row schedule tiles, each kernel's own tile rows, a longer tile refused
# ---------------------------------------------------------------------------

# rows per expert of the edge cases (k = 1): 0, 1, 127, 128 and 129 (a full tile and one row past it), and
# all rows on one expert (three tiles, the last of 44 rows)
_EDGE_LOADS = {"0-1-127-128-129": [0, 1, 127, 128, 129, 3, 64, 65], "all-on-one": [0, 0, 0, 0, 0, 300, 0, 0]}
_WGMMA_KERNELS = {"bf16": moe_experts_swiglu_gmm, "int4": moe_experts_swiglu_gmm_q4, "int8": moe_experts_swiglu_gmm_q8}


def _wgmma_tables(dev, tier, h=H, m=M, seed=0, E_=E):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"gate_proj": (2, E_, h, m), "up_proj": (2, E_, h, m), "down_proj": (2, E_, m, h)}
    ex = {k: torch.empty(s, device=dev, dtype=torch.bfloat16).normal_(0, 0.05, generator=g) for k, s in shapes.items()}
    return {"bf16": dict, "int4": _q4, "int8": _q8}[tier](ex)


def _edge_routing(dev, loads):
    """k = 1 routing with exactly `loads[e]` tokens on expert e, shuffled."""
    ids = torch.repeat_interleave(torch.arange(len(loads), device=dev), torch.tensor(loads, device=dev))
    g = torch.Generator(device=dev).manual_seed(3)
    ids = ids[torch.randperm(ids.numel(), device=dev, generator=g)]
    return ids[:, None], torch.ones((ids.numel(), 1), device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("tier", list(_WGMMA_KERNELS))
@pytest.mark.parametrize("loads", list(_EDGE_LOADS))
def test_swiglu_gmm_wgmma_body_at_the_tile_edges(dev, tier, loads):
    """Rows 2 and 5 through the expert-sorted dispatch with experts of 0, 1,
    127, 128 and 129 rows, and all rows on one expert: one launch pair, the
    plain version within bf16's precision (both on layer 1 of stacked tables)."""
    ex = _wgmma_tables(dev, tier, seed=31)
    idx, w = _edge_routing(dev, _EDGE_LOADS[loads])
    x = torch.randn(idx.shape[0], H, device=dev).to(torch.bfloat16)
    kernel = _WGMMA_KERNELS[tier]
    before = kernel.launches
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=1)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=1))


@pytest.mark.parametrize("tier", list(_WGMMA_KERNELS))
@pytest.mark.parametrize("h,m", [(320, 192), (192, 448)], ids=["h320-m192", "h192-m448"])
def test_swiglu_gmm_wgmma_body_at_partial_column_tiles(dev, tier, h, m):
    """Widths that are multiples of 64 but not of the launches' 128 (up) and
    256 (down) columns: the tables' columns past the width are never stored."""
    ex = _wgmma_tables(dev, tier, h=h, m=m, seed=32)
    idx, w = _routing(dev, 160, 2, seed=33)
    x = torch.randn(160, h, device=dev).to(torch.bfloat16)
    got = moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=0)
    torch.cuda.synchronize()
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=0))


@pytest.mark.parametrize("tier", list(_WGMMA_KERNELS))
@pytest.mark.parametrize("case", ["fits-129-per-expert", "overflow"])
def test_swiglu_gmm_wgmma_body_through_the_capacity_dispatch(dev, tier, case):
    """The capacity dispatch at 256 slots an expert, each expert's slots in two
    128-row tiles (the second of 1 row where an expert holds 129), and on
    overflow the counted fallback to the sorted dispatch."""
    ex = _wgmma_tables(dev, tier, seed=34)
    loads = [129, 128, 127, 1, 0, 64, 256, 2] if case == "fits-129-per-expert" else [300, 10, 0, 0, 0, 0, 0, 0]
    idx, w = _edge_routing(dev, loads)
    x = torch.randn(idx.shape[0], H, device=dev).to(torch.bfloat16)
    before = (moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks)
    got = moe_experts_capacity_gmm_exact(ex, x, idx, w, E, 256, layer_idx=1)
    torch.cuda.synchronize()
    fell = int(case == "overflow")
    assert (moe_experts_capacity_gmm.launches, moe_experts_capacity_gmm_exact.fallbacks) == \
        (before[0] + 1 - fell, before[1] + fell)
    _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=1))


@pytest.mark.parametrize("tier", list(_WGMMA_KERNELS))
def test_swiglu_gmm_wgmma_body_at_full_width(dev, tier):
    """The 16B-A3B tables (64 experts of 2048 x 1408: 11 up tiles of 128
    columns, 8 down tiles of 256) at a 128-token prompt and 1,152 tokens, top-6."""
    ex = _wgmma_tables(dev, tier, h=2048, m=1408, seed=35, E_=64)
    g = torch.Generator(device=dev).manual_seed(36)
    for n in (128, 1152):
        wt, idx = torch.topk(torch.softmax(torch.rand((n, 64), device=dev, generator=g), -1), 6)
        wt = (wt / wt.sum(-1, keepdim=True)).to(torch.bfloat16)
        x = torch.randn(n, 2048, device=dev, generator=g).to(torch.bfloat16)
        got = moe_experts_swiglu_gmm(ex, x, idx, wt, 64, layer_idx=0)
        torch.cuda.synchronize()
        _close_bf16(got, moe_experts_swiglu_gmm_plain(ex, x, idx, wt, 64, layer_idx=0))


def test_swiglu_gmm_tile_rows_of_each_kernel(dev):
    """Each (table kind, mode)'s kernel reports its own tile rows: the wgmma
    body (bf16, int4 and int8 exact) 128, the s8-dot and full-block kernels 32."""
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import tile_rows

    assert [tile_rows("plain"), tile_rows("int4"), tile_rows("int4", s8=True), tile_rows("int8"),
            tile_rows("int8", s8=True), tile_rows("int4", full_block=True), tile_rows("int8", full_block=True)] == \
        [128, 128, 32, 128, 32, 32, 32]


_REFUSAL = """
import sys, torch
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import swiglu_gmm_rows, tile_rows
from mingunivision_tpu_torch.utils.quantize import quantize_array
kind, s8, full = sys.argv[1], sys.argv[2] == "1", sys.argv[3] == "1"
g = torch.Generator(device="cuda").manual_seed(0)
shapes = {"gate_proj": (2, 256, 384), "up_proj": (2, 256, 384), "down_proj": (2, 384, 256)}
ex = {k: torch.empty(s, device="cuda", dtype=torch.bfloat16).normal_(0, 0.05, generator=g) for k, s in shapes.items()}
if kind != "plain":
    ex = {k: quantize_array(v, int(kind[3:])) for k, v in ex.items()}
tile = tile_rows(kind, s8, full)
for rows in (tile, tile + 1):  # the kernel's own tile, then one row longer
    x = torch.randn(rows, 256, device="cuda").to(torch.bfloat16)
    sched = torch.tensor([[1, 0, rows]], dtype=torch.int32, device="cuda")
    swiglu_gmm_rows(ex, x, torch.arange(rows, dtype=torch.int32, device="cuda"), None, sched, 2, s8=s8,
                    full_block=full)
    torch.cuda.synchronize()
    print("ran", rows, flush=True)
"""


@pytest.mark.parametrize("kind,s8,full", [("plain", 0, 0), ("int4", 0, 0), ("int4", 1, 0), ("int8", 0, 0),
                                          ("int8", 1, 0), ("int4", 0, 1)],
                         ids=["bf16", "int4-exact", "int4-s8", "int8-exact", "int8-s8", "int4-full-block"])
def test_swiglu_gmm_kernels_refuse_a_tile_longer_than_their_own(dev, kind, s8, full):
    """A schedule tile one row longer than the kernel's tile rows traps the
    kernel (run in a child process: a trap ends the CUDA context); a tile of
    the kernel's own rows runs."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REFUSAL, kind, str(s8), str(full)], capture_output=True, text=True,
                          cwd=root, env=env, timeout=600)
    ran = [line for line in proc.stdout.splitlines() if line.startswith("ran")]
    assert len(ran) == 1 and proc.returncode != 0, (proc.stdout, proc.stderr[-2000:])


def test_swiglu_gmm_ad_over_two_tiles_an_expert_matches_its_plain_versions(dev, monkeypatch):
    """The differentiable fused prefill MoE where experts hold 129-300 rows
    (two or three 128-row tiles of row 2's forward): value and every grad
    against the same Function through the plain versions, within 1e-2 of each
    max (tests/test_torch_moe_gmm.py's bf16 bound is 2e-3 of the max plus a
    bf16 ulp of each value against the JAX package; here both sides are bf16)."""
    from mingunivision_tpu_torch.ops.kernels import moe_gmm
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as fused

    experts = _experts(dev, seed=46)
    idx, w = _routing(dev, 640, 3, seed=47)  # 1,920 rows: 240 an expert
    x = torch.randn(640, H, device=dev).to(torch.bfloat16)
    before = fused.launches
    got = _ad_value_and_grads(experts, x, idx, w)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    with monkeypatch.context() as mp:
        _plain_training_moe(mp)
        plain = _ad_value_and_grads(experts, x, idx, w)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype
        _close(a, b, 1e-2)
