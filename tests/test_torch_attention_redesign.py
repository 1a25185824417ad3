"""PyTorch port: what surrounds the two redesigned attention kernels, on the CPU.

- The ViT flash forward's contract (`flash._check_vit` at `flash.VIT_TILE`,
  `flash._aligned`): which shapes, dtypes and alignments its wgmma body takes,
  and that the pixel decoder's gate admits no other.
- Decode attention's workspace (`decode_attention.workspace_sizes`), the pure
  function of the shapes that the wrapper sizes it by, against a walk over the
  kernel's splits, and the workspace kept per device and stream.
- A plain-torch model of the split-and-merge that `csrc/decode_attention.cu`
  computes (per-split partials (m, l, acc) over the allowed positions only,
  merged by log-sum-exp, empty splits skipped), held against the plain
  version and against the JAX package's Pallas kernel in interpret mode on
  the same numpy-seeded inputs, in fp32.

The kernels themselves run on the card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.decode_attention import pallas_decode_attention
from mingunivision_tpu_torch.ops.kernels import decode_attention as da
from mingunivision_tpu_torch.ops.kernels import flash
import test_torch_common  # noqa: F401  (one torch thread per test worker)

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32: the same sums in another order
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the ViT forward's contract
# ---------------------------------------------------------------------------


def _vit(B=1, H=2, N=1024, D=64, dtype=torch.bfloat16, offset=0):
    """q, k, v (B, H, N, D); q starts `offset` elements past an aligned allocation."""
    q = torch.zeros(B * H * N * D + offset, dtype=dtype)[offset:].view(B, H, N, D)
    return q, torch.zeros(B, H, N, D, dtype=dtype), torch.zeros(B, H, N, D, dtype=dtype)


@pytest.mark.parametrize("N,D,dtype,offset,takes", [
    (1024, 64, torch.bfloat16, 0, True),      # the pixel decoder's shape
    (512, 64, torch.bfloat16, 0, True),       # the gate's smallest N
    (128, 64, torch.bfloat16, 0, True),       # one tile
    (1024, 128, torch.bfloat16, 0, True),     # D 128 shares the template
    (576, 64, torch.bfloat16, 0, False),      # a multiple of 64, not of 128
    (64, 64, torch.bfloat16, 0, False),
    (1024, 32, torch.bfloat16, 0, False),     # no body takes D 32
    (1024, 64, torch.bfloat16, 1, True),      # q 2 bytes past 16-byte alignment: copied
    (1024, 64, torch.bfloat16, 8, True),      # 16 bytes past: aligned, not copied
    (1024, 64, torch.float32, 0, False),      # fp32 reaches the kernel only as bf16
], ids=["1024x64", "512x64", "128x64", "1024x128", "576x64", "64x64", "d32", "misaligned", "offset-16B", "fp32"])
def test_flash_vit_forward_contract(N, D, dtype, offset, takes):
    q, k, v = _vit(N=N, D=D, dtype=dtype, offset=offset)
    if not takes:
        with pytest.raises(ValueError):
            flash._check_vit("flash_vit_attention", q, k, v)
        return
    assert flash._check_vit("flash_vit_attention", q, k, v) == (1, 2, N, D)
    got = flash._aligned(q)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, q)
    assert (got is q) == (q.data_ptr() % 16 == 0)


def test_flash_vit_gate_admits_only_the_forward_tile():
    """Every length the pixel decoder's gate sends to the kernel is one the wgmma body takes."""
    for N in range(64, 4097, 64):
        if flash.flash_vit_usable(N, torch.bfloat16):
            assert N % flash.VIT_TILE == 0


def test_flash_vit_wrapper_on_cpu_counts_no_launch():
    q, k, v = (torch.randn(1, 2, 512, 64, generator=torch.Generator().manual_seed(i)) for i in range(3))
    before = flash.flash_vit_attention.launches
    torch.testing.assert_close(flash.flash_vit_attention(q, k, v, scale=0.125),
                               flash.flash_vit_attention_plain(q, k, v, scale=0.125))
    flash.flash_vit_attention_lse(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale=0.125)
    assert flash.flash_vit_attention.launches == before


# ---------------------------------------------------------------------------
# decode attention's workspace
# ---------------------------------------------------------------------------


def _splits(S: int):
    """[(first, end)] of the kernel's splits of S positions: block x of the grid takes
    positions x * SPLIT_TILE up to the next split or S."""
    return [(x * da.SPLIT_TILE, min(S, (x + 1) * da.SPLIT_TILE)) for x in range(-(-S // da.SPLIT_TILE))]


@pytest.mark.parametrize("B,Hkv,S,G,D", [(2, 4, 4096, 4, 128), (1, 4, 4096, 4, 128), (16, 4, 2048, 4, 128),
                                         (3, 2, 1000, 2, 64), (12, 4, 4096, 4, 128), (1, 1, 5, 8, 256)])
def test_workspace_sizes_cover_every_split(B, Hkv, S, G, D):
    splits = _splits(S)
    cover = np.zeros(S, np.int64)
    for first, end in splits:
        assert 0 < end - first <= da.SPLIT_TILE
        cover[first:end] += 1
    np.testing.assert_array_equal(cover, np.ones(S, np.int64))  # every position in exactly one split
    # per (row, kv head, split): G maxima, G sums, G x D partial sums; a ticket per (row, kv head) and a flag per
    # split of each
    assert da.workspace_sizes(B, Hkv, S, G, D) == (B * Hkv * len(splits) * G * (D + 2), B * Hkv * (1 + len(splits)))


def test_workspace_sizes_at_the_slice_shape():
    """T2I: 2 CFG rows, 4 kv heads, Smax 4,096: 64 splits each, 512 blocks, about 1 MiB of partials."""
    assert da.SPLIT_TILE == 64 and len(_splits(4096)) == 64
    part_floats, counters = da.workspace_sizes(2, 4, 4096, 4, 128)
    assert part_floats * 4 == 1_064_960 and counters == 8 + 512


def test_workspace_is_kept_per_stream_and_grows():
    dev = torch.device("cpu")
    small, large = da.workspace_sizes(2, 4, 512, 4, 128), da.workspace_sizes(16, 4, 4096, 4, 128)
    part, counters = da._workspace(small, dev, stream=1001)
    assert part.numel() == small[0] and counters.dtype == torch.int32 and not counters.any()
    assert da._workspace(small, dev, stream=1001)[0] is part  # reused, not allocated again
    other, _ = da._workspace(small, dev, stream=1002)
    assert other is not part  # another stream has its own
    grown, grown_counters = da._workspace(large, dev, stream=1001)
    assert grown.numel() == large[0] and grown_counters.numel() == large[1] and not grown_counters.any()
    assert da._workspace(small, dev, stream=1001)[0] is grown  # a smaller call keeps the larger buffer
    for key in [(None, 1001), (None, 1002)]:
        da._workspaces.pop(key)


# ---------------------------------------------------------------------------
# the kernel's split-and-merge, modelled in plain torch
# ---------------------------------------------------------------------------


def split_merge_model(q, k, v, mask, tile, scale=None):
    """What csrc/decode_attention.cu computes, in fp32 with the kernel's steps:
    per (row, kv head) and split of `tile` positions, the allowed positions
    only (an index select: masked K and V rows are never read), scores in the
    base-2 domain (q pre-scaled by scale * log2 e), the split's m, l and
    acc = sum p v; then the non-empty splits merged in order by log-sum-exp;
    a row with no allowed position gives zeros."""
    B, _, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    out = torch.zeros(B, 1, Hq, D)
    for b in range(B):
        for h in range(Hkv):
            qg = q[b, 0, h * G:(h + 1) * G].float() * (scale * LOG2E)  # (G, D)
            parts = []
            for first in range(0, S, tile):
                pos = first + torch.nonzero(mask[b, first:first + tile]).flatten()
                if pos.numel() == 0:
                    continue  # an empty split: no partial
                s = qg @ k[b, h, pos].float().T  # (G, n)
                m = s.max(-1).values
                p = torch.exp2(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v[b, h, pos].float()))
            if not parts:
                continue
            big = torch.stack([m for m, _, _ in parts]).max(0).values
            w = [torch.exp2(m - big) for m, _, _ in parts]
            l_tot = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            acc = sum(wi[:, None] * a for wi, (_, _, a) in zip(w, parts))
            out[b, 0, h * G:(h + 1) * G] = acc / l_tot.clamp_min(1e-30)[:, None]
    return out


def _decode_inputs(B=3, Hkv=2, G=4, S=1024, D=64, seed=17):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[0, :700] = True
    mask[1, :321] = True
    mask[1, 1:31] = False  # a CFG hole: the unconditional row skips the text
    mask[1, 400:450] = True
    mask[B - 1, :] = False
    mask[B - 1, S - 3] = True  # an isolated late position; every earlier split of the row is empty
    return q, k, v, mask


@pytest.mark.parametrize("tile", [64, 128])
def test_split_merge_model_matches_plain_and_pallas(tile):
    q, k, v, mask = _decode_inputs()
    assert any(not mask[0, t:t + tile].any() for t in range(0, mask.shape[1], tile))  # some splits are empty
    want = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), tile_s=256,
                                   interpret=True, kv_head_major=True)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    plain = da.decode_attention_plain(tq, tk, tv, tm)
    got = split_merge_model(tq, tk, tv, tm, tile)
    torch.testing.assert_close(got, plain, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_merge_model_never_reads_masked_positions():
    """NaN and Inf in every masked K and V entry: the model, which selects the
    allowed rows, agrees with the plain version and the Pallas kernel on the
    clean cache (where the plain version itself would turn NaN into the sum)."""
    q, k, v, mask = _decode_inputs(seed=23)
    hidden = ~mask[:, None, :, None].repeat(k.shape[1], 1).repeat(k.shape[3], 3)
    kp, vp = k.copy(), v.copy()
    kp[hidden] = np.nan
    vp[hidden] = np.inf
    want = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), tile_s=256,
                                   interpret=True, kv_head_major=True)
    got = split_merge_model(*map(torch.from_numpy, (q, kp, vp, mask)), da.SPLIT_TILE)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, da.decode_attention_plain(*map(torch.from_numpy, (q, k, v, mask))), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_merge_model_fully_masked_row_is_zero():
    q, k, v, mask = _decode_inputs(B=2)
    mask[1] = False
    got = split_merge_model(*map(torch.from_numpy, (q, k, v, mask)), da.SPLIT_TILE)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    plain = da.decode_attention_plain(*map(torch.from_numpy, (q, k, v, mask)))
    torch.testing.assert_close(got[0], plain[0], **TOL)


def test_decode_wrapper_on_cpu_takes_the_plain_version_without_a_workspace():
    q, k, v, mask = map(torch.from_numpy, _decode_inputs(B=2))
    before, spaces = da.decode_attention.launches, dict(da._workspaces)
    torch.testing.assert_close(da.decode_attention(q, k, v, mask), da.decode_attention_plain(q, k, v, mask))
    assert da.decode_attention.launches == before and da._workspaces == spaces
