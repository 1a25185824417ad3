"""PyTorch port: the causal flash prefill on the forward's wgmma body
(`csrc/flash_attention.cu`, `mu_flash_prefill_bf16`), modelled on the CPU.

- A plain-torch model of the kernel's tile walk: 128-row query tiles, each
  visiting key tiles 0..qt only; the causal mask on the diagonal tile only,
  the valid rule (key j allowed for row i iff valid[i] == valid[j]) only in
  blocks whose keys 0..(qt + 1) 128 - 1 hold a padding byte, both applied to
  the fp32 scores after the product; the online softmax with the kernel's
  guard (a row with no allowed key yet keeps m = -inf and subtracts 0, so a
  fully masked tile adds zeros, never -inf - -inf), exp2 of the scaled
  scores, P rounded to v's type for the P V product, the sum of the
  unrounded P, O / l at the end.
- Held against the plain version (`flash_prefill_attention_plain`, the CPU
  path of the wrapper) within BF16_REL on bf16 inputs, at 0, 37, 127 and 128
  padding rows, with non-prefix masks (padding at the start, so a valid
  row's first key tiles are all masked, and scattered padding), GQA 4 / 1
  and 4 / 4, D 64 and 128; every row finite (each row allows itself).
- Held within fp32's tolerance against the JAX package's `attention_apply`
  on its `mha` path over the cache (the library Pallas flash kernel has no
  CPU mode), as tests/test_torch_flash.py holds the plain version: the
  port's `attention_apply(use_flash=True)` with the model in place of the
  flash entry, on the valid rows, at the same pads and masks.
- The wrapper's gate: 128-row tiles (T a multiple of 128).

Tolerance: BF16_REL = 1e-2 of the largest output, the bound the card's tests
hold the kernel to (`_close_bf16` in tests/test_torch_kernels_cuda.py):
outputs are bf16, and fp32 sums in another order flip roundings of P and of
the output. The kernel itself runs on the card only
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.models.bailing_moe import attention_apply as jax_attention_apply
from mingunivision_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from mingunivision_tpu_torch.models import bailing_moe
from mingunivision_tpu_torch.ops.kernels import flash
from mingunivision_tpu_torch.ops.rope import rope_cos_sin

from test_torch_common import ATOL, tiny_llm

BF16_REL = 1e-2
TILE = 128  # the body's query rows per block and keys per stage
LOG2E = 1.4426950408889634


def tile_walk_model(q, k, v, valid, *, scale: float):
    """The kernel's arithmetic: q (B, T, Hq, D), k / v (B, T, Hkv, D), valid
    (B, T) bool -> (B, T, Hq, D) in q's dtype. Products in fp32 of the inputs'
    values; P rounded to v's dtype for P V."""
    B, T, Hq, D = q.shape
    group = Hq // k.shape[2]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # head-major
    kf, vf = kf.repeat_interleave(group, dim=1), vf.repeat_interleave(group, dim=1)  # kv head hq // group
    sl2 = scale * LOG2E
    out = torch.empty((B, Hq, T, D), dtype=torch.float32)
    rows = torch.arange(TILE)
    for qt in range(T // TILE):
        n0 = qt * TILE
        # the blocks of this tile whose keys 0..n0 + 127 hold a padding byte take the valid rule
        masked = ~valid[:, : n0 + TILE].all(dim=1)  # (B,)
        rv = valid[:, n0 : n0 + TILE]  # the tile's rows' bytes (B, 128)
        Q = qf[:, :, n0 : n0 + TILE]
        m = torch.full((B, Hq, TILE), -torch.inf)
        l = torch.zeros((B, Hq, TILE))
        o = torch.zeros((B, Hq, TILE, D))
        for kt in range(qt + 1):
            S = Q @ kf[:, :, kt * TILE : (kt + 1) * TILE].transpose(-1, -2)  # (B, Hq, 128, 128) fp32
            ok = torch.ones((B, TILE, TILE), dtype=torch.bool)
            if kt == qt:  # the diagonal tile
                ok &= rows[None, None, :] <= rows[None, :, None]
            kv = valid[:, kt * TILE : (kt + 1) * TILE]
            rule = rv[:, :, None] == kv[:, None, :]
            ok &= torch.where(masked[:, None, None], rule, torch.ones_like(rule))
            S = torch.where(ok[:, None], S, torch.tensor(-torch.inf))
            mx = torch.maximum(m, S.amax(dim=-1))
            ms = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx * sl2)
            corr = torch.exp2(m * sl2 - ms)
            P = torch.exp2(S * sl2 - ms[..., None])
            l = l * corr + P.sum(dim=-1)
            o = o * corr[..., None] + P.to(v.dtype).float() @ vf[:, :, kt * TILE : (kt + 1) * TILE]
            m = mx
        out[:, :, n0 : n0 + TILE] = o / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _mask(T: int, pads: int, layout: str) -> torch.Tensor:
    """(1, T) valid bytes: `pads` padding rows at the end, at the start, or at
    numpy-seeded scattered places (a non-prefix mask)."""
    valid = np.ones(T, bool)
    if layout == "right":
        valid[T - pads :] = False
    elif layout == "left":
        valid[:pads] = False
    else:
        valid[np.random.default_rng(T + pads).permutation(T)[:pads]] = False
    return torch.from_numpy(valid)[None]


CASES = {"512-nopads-gqa4to1": (512, 0, 4, 1, "right"), "512-37pads-mha": (512, 37, 4, 4, "right"),
         "640-127pads-gqa4to1": (640, 127, 4, 1, "right"), "512-128pads-mha": (512, 128, 4, 4, "right"),
         "640-200-left-pads-gqa4to1": (640, 200, 4, 1, "left"), "512-37-scattered-mha": (512, 37, 4, 4, "scattered"),
         "640-128-scattered-gqa4to1": (640, 128, 4, 1, "scattered")}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_tile_walk_matches_the_plain_version(case, D):
    T, pads, Hq, Hkv, layout = CASES[case]
    rng = np.random.default_rng(T + pads + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, H, D)).astype(np.float32)).to(torch.bfloat16)
               for H in (Hq, Hkv, Hkv))
    valid = _mask(T, pads, layout)
    got = tile_walk_model(q, k, v, valid, scale=D**-0.5)
    want = flash.flash_prefill_attention_plain(q, k, v, valid, scale=D**-0.5)
    assert torch.isfinite(got.float()).all()  # every row allows itself: no NaN, valid rows or padding rows
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_REL * want.float().abs().max().item(), err


def test_fully_masked_tiles_add_nothing():
    """A valid row after 200 leading padding rows meets key tile 0 (keys
    0..127) with no allowed key: the guard keeps its state (m = -inf, l = 0,
    O = 0) through it, and the row equals attention over its allowed keys
    alone; without the guard the same walk gives NaN."""
    T, D = 384, 16
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, 2, D)).astype(np.float32)) for _ in range(3))
    valid = _mask(T, 200, "left")
    got = tile_walk_model(q, k, v, valid, scale=0.25)
    want = flash.flash_prefill_attention_plain(q, k, v, valid, scale=0.25)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    S = torch.full((4,), -torch.inf)  # a fully masked tile's scores for a row with m = -inf
    assert torch.isnan(torch.exp2(S - S.max())).all()  # the unguarded offset
    ms = torch.where(S.max() == -torch.inf, torch.tensor(0.0), S.max())
    assert torch.equal(torch.exp2(S - ms), torch.zeros(4))  # the kernel's


@pytest.mark.parametrize("case", ["512-37pads-mha", "640-127pads-gqa4to1", "512-128pads-mha", "512-nopads-gqa4to1",
                                  "640-200-left-pads-gqa4to1", "512-37-scattered-mha"])
def test_tile_walk_in_attention_apply_matches_jax_mha_on_valid_rows(case, monkeypatch):
    """JAX `attention_apply` on its `mha` path over the cache (use_flash=False)
    against the port's `attention_apply(use_flash=True)` with the tile-walk
    model as its flash entry, fp32: the valid rows agree (the mha path masks
    keys by the cache mask and causally by index, which for a valid row is
    the flash rule)."""
    T, pads, Hq, Hkv, layout = CASES[case]
    cfg = tiny_llm(num_attention_heads=Hq, num_key_value_heads=Hkv)
    D, h, S = cfg.head_dim, cfg.hidden_size, T + 64
    rng = np.random.default_rng(T + Hkv + pads)
    params = {"query_key_value": {"w": (0.1 * rng.standard_normal((h, (Hq + 2 * Hkv) * D))).astype(np.float32)},
              "dense": {"w": (0.1 * rng.standard_normal((Hq * D, h))).astype(np.float32)}}
    x = rng.standard_normal((1, T, h)).astype(np.float32)
    mask = np.zeros((1, S), bool)
    mask[:, :T] = _mask(T, pads, layout).numpy()
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)[:, :T]
    jp = {key: {"w": jnp.asarray(val["w"])} for key, val in params.items()}
    tp = {key: {"w": torch.from_numpy(val["w"])} for key, val in params.items()}
    cos, sin = jax_rope_cos_sin(jnp.asarray(pos), D, cfg.rope_theta)
    want, _, _ = jax_attention_apply(jp, cfg, jnp.asarray(x), cos, sin, jnp.zeros((1, Hkv, S, D)),
                                     jnp.zeros((1, Hkv, S, D)), 0, jnp.asarray(mask), use_flash=False)
    calls = []

    def model(q, k, v, valid_mask, *, scale):
        calls.append(q.shape)
        return tile_walk_model(q, k, v, valid_mask, scale=scale)

    monkeypatch.setattr(bailing_moe, "flash_prefill_attention", model)  # the name attention_apply calls
    tcos, tsin = rope_cos_sin(torch.from_numpy(pos), D, cfg.rope_theta)
    got = bailing_moe.attention_apply(tp, cfg, torch.from_numpy(x), tcos, tsin, torch.zeros((1, Hkv, S, D)),
                                      torch.zeros((1, Hkv, S, D)), 0, torch.from_numpy(mask), use_flash=True)
    assert calls == [(1, T, Hq, D)]  # the port's flash path took the model
    valid = mask[0, :T]
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy()[0, valid], np.asarray(want)[0, valid], rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("T", [128, 256, 1152])
def test_the_wrapper_takes_128_row_tiles(T):
    """The kernel's tile is 128 rows: the wrapper's gate asks T a multiple of
    it (`flash_usable` routes only T >= 512 there), and on the CPU the wrapper
    is the plain version."""
    assert flash.PREFILL_TILE == TILE
    q = torch.randn(1, T, 2, 16)
    valid = _mask(T, 3, "right")
    assert flash.flash_prefill_attention(q, q, q, valid, scale=0.25).equal(
        flash.flash_prefill_attention_plain(q, q, q, valid, scale=0.25))
