"""PyTorch port, the MingTok encoder side: positional-embedding interpolation,
patch embedding, the low-level encoder, the full-sequence semantic decoder,
`mingtok_encode` / `mingtok_enc_dec` and the pixel decoder's reduced tiers,
against the JAX package on the same numpy-seeded weights and images, at fp32
on the CPU (tolerance 2e-4 unless stated)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mingunivision_tpu.ops.kernels.flash as jflash
from mingunivision_tpu.config import tiny_mingtok_config
from mingunivision_tpu.models import mingtok as jmt
from mingunivision_tpu.models import vit as jvit
from mingunivision_tpu.ops import patching as jpatch
from mingunivision_tpu.ops.attention import mha as jax_mha
from mingunivision_tpu_torch.models import mingtok as tmt
from mingunivision_tpu_torch.models import vit as tvit
from mingunivision_tpu_torch.ops import patching as tpatch
from mingunivision_tpu_torch.utils.convert import _Init, init_mingtok_params, params_from_jax

from test_torch_common import ATOL

TOL = dict(rtol=ATOL, atol=ATOL)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def tok():
    """The tiny MingTok (64-px encoder at patch 16, 2 layers) with random
    weights, the zero-initialised leaves made random too."""
    cfg = tiny_mingtok_config()
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    jmt.init_mingtok_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(1)
    params["encoder"]["cls_token"] = (0.02 * rng.standard_normal(params["encoder"]["cls_token"].shape)).astype(np.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params, "cpu", torch.float32)


def _images(seed, size, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, 3, size, size)).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,new_grid,offset", [(4, 8, 0.1), (4, 8, 0.0), (4, 4, 0.1), (16, 32, 0.1), (8, 4, 0.1)],
                         ids=["4to8-offset", "4to8-no-offset", "identity", "16to32-offset", "8to4-offset"])
def test_interpolate_pos_embed_matches_jax(grid, new_grid, offset):
    pe = np.random.default_rng(grid).standard_normal((1, grid * grid + 1, 24)).astype(np.float32)
    want = jpatch.interpolate_pos_embed(jnp.asarray(pe), grid, new_grid, offset=offset)
    got = tpatch.interpolate_pos_embed(torch.from_numpy(pe), grid, new_grid, offset=offset)
    assert got.shape == (1, new_grid * new_grid + 1, 24)
    _close(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, -1].numpy(), pe[:, -1])  # CLS stays last, untouched
    if new_grid == grid:
        np.testing.assert_array_equal(got.numpy(), pe)


def test_weight_matrix_form_equals_torch_interpolate_with_a_scale_factor():
    """The explicit weight matrices are F.interpolate's bicubic when a scale
    factor is given (torch then maps coordinates by that factor): grid 16 ->
    32 with the 0.1 offset."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 6, 16, 16)).astype(np.float32))
    s = (32 + 0.1) / 16
    want = F.interpolate(x, scale_factor=(s, s), mode="bicubic", align_corners=False)
    assert want.shape[-2:] == (32, 32)
    torch.testing.assert_close(tpatch.bicubic_resize_torch(x, (32, 32), scale_hw=(s, s)), want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(tpatch.bicubic_resize_torch(x, (32, 32)), want, atol=1e-3)  # the offset matters


def test_patchify_matches_jax_and_inverts_unpatchify():
    imgs = _images(6, 32)
    got = tpatch.patchify(torch.from_numpy(imgs), 8)
    _close(got, jpatch.patchify(jnp.asarray(imgs), 8), rtol=0, atol=0)
    np.testing.assert_array_equal(tpatch.unpatchify(got, 8).numpy(), imgs)


def test_patch_embed_matches_jax(tok):
    cfg, jp, tp = tok
    imgs = _images(7, 64)
    want = jvit.patch_embed_apply(jp["encoder"]["patch_embed"], jnp.asarray(imgs), cfg.encoder.patch_size)
    got = tvit.patch_embed_apply(tp["encoder"]["patch_embed"], torch.from_numpy(imgs), cfg.encoder.patch_size)
    assert got.shape == (2, 16, cfg.encoder.embed_dim)
    _close(got, want)
    np.testing.assert_array_equal(tvit.extract_patches(torch.from_numpy(imgs), 16).numpy(),
                                  np.asarray(jvit.extract_patches(jnp.asarray(imgs), 16)))


# ---------------------------------------------------------------------------
# encoder, semantic decoder, encode, reconstruction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 128], ids=["native-grid", "doubled-image-interpolated-pos-embed"])
def test_encoder_matches_jax(tok, size):
    cfg, jp, tp = tok
    imgs = _images(size, size)
    want = jmt.encoder_apply(jp["encoder"], cfg.encoder, jnp.asarray(imgs), compute_dtype=jnp.float32)
    got = tmt.encoder_apply(tp["encoder"], cfg.encoder, torch.from_numpy(imgs), compute_dtype=torch.float32)
    assert got.shape == (2, (size // 16) ** 2 + 1, cfg.encoder.out_dim)
    _close(got, want)


def test_semantic_decoder_full_sequence_matches_jax_and_the_cached_steps(tok):
    cfg, jp, tp = tok
    sd = cfg.semantic_decoder
    lat = np.random.default_rng(8).standard_normal((2, 17, sd.in_dim)).astype(np.float32)
    want = jmt.semantic_decoder_apply(jp["semantic_decoder"], sd, jnp.asarray(lat), compute_dtype=jnp.float32)
    got = tmt.semantic_decoder_apply(tp["semantic_decoder"], sd, torch.from_numpy(lat), compute_dtype=torch.float32)
    assert got["x_norm_patchtokens"].shape == (2, 16, sd.embed_dim) and got["x_norm_clstoken"].shape == (2, sd.embed_dim)
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        _close(got[key], want[key])
    whole = tmt.semantic_decoder_apply(tp["semantic_decoder"], sd, torch.from_numpy(lat), compute_dtype=torch.float32,
                                       split_cls=False)["x_norm_patchtokens"]
    assert whole.shape == (2, 17, sd.embed_dim)
    # cached and full-sequence agree: 5 latents at once, then one at a time
    cache = tmt.make_semdec_cache(sd, 2, 17, dtype=torch.float32)
    steps = []
    for lo, hi in [(0, 5)] + [(i, i + 1) for i in range(5, 17)]:
        out, cache = tmt.semantic_decoder_step(tp["semantic_decoder"], sd, torch.from_numpy(lat[:, lo:hi]), cache,
                                               compute_dtype=torch.float32)
        steps.append(out["x_norm_patchtokens"])
    torch.testing.assert_close(torch.cat(steps, dim=1), whole, **TOL)


@pytest.mark.parametrize("size", [64, 128])
def test_mingtok_encode_matches_jax(tok, size):
    cfg, jp, tp = tok
    imgs = _images(9, size, batch=1)
    want = jmt.mingtok_encode(jp, cfg, jnp.asarray(imgs), compute_dtype=jnp.float32)
    got = tmt.mingtok_encode(tp, cfg, torch.from_numpy(imgs), compute_dtype=torch.float32)
    n = (size // 16) ** 2
    assert got["x_norm_patchtokens"].shape == (1, n, cfg.feature_dim) and got["latent"].shape == (1, n + 1, cfg.latent_dim)
    _close(got["x_norm_patchtokens"], want["x_norm_patchtokens"])
    _close(got["latent"], want["latent"])


@pytest.mark.parametrize("tier", ["high", "highest"])
def test_mingtok_enc_dec_matches_jax_at_fp32(tok, tier):
    cfg, jp, tp = tok
    cfg = dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, matmul_precision=tier))
    imgs = _images(10, 64)
    want = jmt.mingtok_enc_dec(jp, cfg, jnp.asarray(imgs), compute_dtype=jnp.float32)
    got = tmt.mingtok_enc_dec(tp, cfg, torch.from_numpy(imgs), compute_dtype=torch.float32)
    assert got.shape == (2, 3, 64, 64) and got.dtype == torch.float32
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
    _close(got, want)


# ---------------------------------------------------------------------------
# reduced pixel-decoder tiers: 1024 pixel tokens, so the flash branch engages
# ---------------------------------------------------------------------------


def _jax_flash_through_mha(monkeypatch):
    """On the JAX side, open the ViT flash gate as on a TPU and put `mha` in
    the place of the library Pallas kernel (which has no CPU mode), with the
    wrapper's own bf16 casts, as tests/test_pixdec_tiers.py does."""
    def fake_flash(q, k, v, *, scale, block=512):
        dt = q.dtype
        if dt == jnp.float32:
            q, k, v = q.astype(jnp.bfloat16), k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
        out = jax_mha(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), scale=scale)
        return out.transpose(0, 2, 1, 3).astype(dt)

    def usable(N, dtype):
        from mingunivision_tpu.ops.linear import _FP32_PRECISION

        tile_ok = N >= 512 and N % 128 == 0
        return tile_ok and (dtype == jnp.bfloat16 or (dtype == jnp.float32 and
                                                      _FP32_PRECISION.get() == jax.lax.Precision.DEFAULT))

    monkeypatch.setattr(jflash, "flash_vit_attention", fake_flash)
    monkeypatch.setattr(jflash, "flash_vit_usable", usable)


@pytest.mark.parametrize("tier,flash_calls,rel_tol", [("high", 0, 1e-4), ("default", 2, 2e-2), ("bf16", 2, 3e-2)])
def test_pixel_decoder_tiers_match_jax_tiers(tok, tier, flash_calls, rel_tol, monkeypatch):
    """A 256-px image: 256 encoder tokens (+ CLS, pos-embed 4 -> 16) and 1024
    pixel tokens, so the reduced tiers take the head-major flash branch (its
    plain version here) in both pixel-decoder blocks; "high" never does.
    Tolerance: relative L2 error against the JAX tier, fp32-tight at "high",
    bf16-wide (3 significant digits through two blocks) at the reduced tiers."""
    cfg, jp, tp = tok
    cfg = dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, matmul_precision=tier))
    _jax_flash_through_mha(monkeypatch)
    calls = []
    flash = tvit.flash_vit_attention
    monkeypatch.setattr(tvit, "flash_vit_attention", lambda *a, **k: calls.append(a[0].shape) or flash(*a, **k))
    imgs = np.tanh(_images(11, 256, batch=1))
    want = np.asarray(jmt.mingtok_enc_dec(jp, cfg, jnp.asarray(imgs), compute_dtype=jnp.float32))
    got = tmt.mingtok_enc_dec(tp, cfg, torch.from_numpy(imgs), compute_dtype=torch.float32)
    assert got.shape == (1, 3, 256, 256) and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert len(calls) == flash_calls and all(shape == (1, 2, 1024, 32) for shape in calls)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < rel_tol, (tier, rel)


def test_headmajor_flash_algebra_matches_token_major_block(tok):
    """The head-major projections around the flash kernel reproduce the
    token-major qkv + mha + proj path (weight reshape order, biases)."""
    cfg, _, tp = tok
    blocks = tp["pixel_decoder"]["blocks"]
    layer = {k: ({kk: {n: t[0] for n, t in vv.items()} for kk, vv in v.items()} if k in ("attn", "mlp") else
                 {n: t[0] for n, t in v.items()}) for k, v in blocks.items()}
    layer["attn"]["qkv"]["b"] = torch.from_numpy(np.random.default_rng(12).standard_normal(192).astype(np.float32))
    h = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 128, 64)).astype(np.float32))
    got = tvit._attn_flash_headmajor(layer, h.bfloat16(), 2).float()
    q, k, v = tvit._qkv(layer, h, 2)
    want = tvit.dense(tvit.mha(q, k, v).reshape(h.shape), layer["attn"]["proj"])
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)  # bf16 inputs and products against fp32


def test_init_mingtok_params_has_the_jax_leaves(tok):
    cfg, jp, _ = tok
    got = init_mingtok_params(cfg, _Init(torch.device("cpu"), torch.float32, torch.Generator().manual_seed(0)))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), got)
    assert shapes == want
    assert got["encoder"]["pos_embed"].shape == (1, 17, 64) and not got["encoder"]["cls_token"].any()
    # the encoder leaves arrive from the JAX tree in the layout the port's functions read
    imgs = _images(14, 64, batch=1)
    out = tmt.encoder_apply(got["encoder"], cfg.encoder, torch.from_numpy(imgs), compute_dtype=torch.float32)
    assert out.shape == (1, 17, cfg.encoder.out_dim) and torch.isfinite(out).all()
