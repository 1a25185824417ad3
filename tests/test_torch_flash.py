"""PyTorch port, flash attention: the plain versions of the two flash entry
points against the JAX package's `mha` paths on the same inputs, at fp32 on
the CPU, and the static gates. (The library Pallas flash kernel has no CPU
mode; the JAX package's own tests replace it by `mha` too. The CUDA kernel is
held against these plain versions in tests/test_torch_kernels_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.models.bailing_moe import attention_apply as jax_attention_apply
from mingunivision_tpu.ops.attention import mha as jax_mha
from mingunivision_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from mingunivision_tpu_torch.models.bailing_moe import attention_apply
from mingunivision_tpu_torch.ops.kernels import flash
from mingunivision_tpu_torch.ops.linear import fp32_matmul_precision
from mingunivision_tpu_torch.ops.rope import rope_cos_sin

from test_torch_common import ATOL, tiny_llm

TOL = dict(rtol=ATOL, atol=ATOL)  # fp32 on both sides; sums in another order


@pytest.mark.parametrize("T,pads,Hq,Hkv", [(512, 37, 4, 1), (640, 0, 4, 4), (512, 37, 4, 4), (640, 0, 4, 1)],
                         ids=["512-37pads-gqa", "640-nopads-mha", "512-37pads-mha", "640-nopads-gqa"])
def test_flash_prefill_plain_matches_jax_attention_on_valid_rows(T, pads, Hq, Hkv):
    """JAX `attention_apply` on its `mha` path over the cache (use_flash=False)
    against the port's `attention_apply(use_flash=True)`, which on the CPU runs
    the flash kernel's plain version over (q, k, v): the valid rows agree."""
    cfg = tiny_llm(num_attention_heads=Hq, num_key_value_heads=Hkv)
    D, h, S = cfg.head_dim, cfg.hidden_size, T + 64
    rng = np.random.default_rng(T + Hkv)
    params = {"query_key_value": {"w": (0.1 * rng.standard_normal((h, (Hq + 2 * Hkv) * D))).astype(np.float32)},
              "dense": {"w": (0.1 * rng.standard_normal((Hq * D, h))).astype(np.float32)}}
    x = rng.standard_normal((1, T, h)).astype(np.float32)
    mask = np.zeros((1, S), bool)
    mask[:, : T - pads] = True
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)[:, :T]
    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in params.items()}
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in params.items()}
    cos, sin = jax_rope_cos_sin(jnp.asarray(pos), D, cfg.rope_theta)
    want, want_k, _ = jax_attention_apply(jp, cfg, jnp.asarray(x), cos, sin, jnp.zeros((1, Hkv, S, D)),
                                          jnp.zeros((1, Hkv, S, D)), 0, jnp.asarray(mask), use_flash=False)
    tcos, tsin = rope_cos_sin(torch.from_numpy(pos), D, cfg.rope_theta)
    kc, vc = torch.zeros((1, Hkv, S, D)), torch.zeros((1, Hkv, S, D))
    got = attention_apply(tp, cfg, torch.from_numpy(x), tcos, tsin, kc, vc, 0, torch.from_numpy(mask), use_flash=True)
    valid = mask[0, :T]
    np.testing.assert_allclose(got.numpy()[0, valid], np.asarray(want)[0, valid], **TOL)
    np.testing.assert_allclose(kc.numpy(), np.asarray(want_k), **TOL)  # the cache is written on both paths
    assert np.isfinite(got.numpy()).all()  # padding rows are defined (they attend to padding keys), not NaN


def test_flash_prefill_plain_padding_rows_follow_the_rule():
    """Row i sees key j iff j <= i and valid[i] == valid[j]."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(np.float32)) for _ in range(3))
    valid = torch.tensor([[True, True, True, True, False, False]])
    got = flash.flash_prefill_attention_plain(q, k, v, valid, scale=0.3)
    # the first padding row sees only itself: its output is its own value row
    torch.testing.assert_close(got[0, 4], v[0, 4], rtol=1e-6, atol=1e-6)
    # a valid row equals attention over the valid prefix alone
    alone = flash.flash_prefill_attention_plain(q[:, :4], k[:, :4], v[:, :4], valid[:, :4], scale=0.3)
    torch.testing.assert_close(got[:, :4], alone, rtol=1e-6, atol=1e-6)
    assert flash.flash_prefill_attention(q, k, v, valid, scale=0.3).equal(got)  # a CPU tensor takes the plain version


@pytest.mark.parametrize("B,H,N,D", [(2, 4, 128, 16), (1, 2, 64, 32)])
def test_flash_vit_plain_matches_jax_mha(B, H, N, D):
    rng = np.random.default_rng(N)
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    want = jax_mha(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)), scale=D**-0.5).transpose(0, 2, 1, 3)
    # bf16 inputs are exact in fp32 on the JAX side; the plain version rounds fp32 inputs to bf16 first
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    want_bf = jax_mha(*(jnp.asarray(a.float().numpy()).transpose(0, 2, 1, 3) for a in (tq, tk, tv)),
                      scale=D**-0.5).transpose(0, 2, 1, 3)
    got = flash.flash_vit_attention_plain(tq.float(), tk.float(), tv.float(), scale=D**-0.5)
    assert got.dtype == torch.float32 and got.shape == (B, H, N, D)
    # fp32 in: through bf16, as the kernel's wrapper; probabilities and output rounded to bf16 (3 digits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_bf), rtol=2e-2, atol=2e-2)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-2
    assert flash.flash_vit_attention(tq, tk, tv, scale=D**-0.5).dtype == torch.bfloat16


@pytest.mark.parametrize("T,want", [(1152, True), (512, True), (384, False), (576, False), (4096, True), (500, False)])
def test_flash_usable_gate(T, want):
    assert flash.flash_usable(T) is want


@pytest.mark.parametrize("N,dtype,tier,want", [
    (1024, torch.bfloat16, "high", True), (1024, torch.float32, "high", False), (1024, torch.float32, "highest", False),
    (1024, torch.float32, "default", True), (1025, torch.bfloat16, "default", False),
    (256, torch.bfloat16, "default", False), (512, torch.float16, "default", False),
])
def test_flash_vit_usable_gate(N, dtype, tier, want):
    with fp32_matmul_precision(tier):
        assert flash.flash_vit_usable(N, dtype) is want
    assert flash.flash_vit_usable(N, dtype) is (want and dtype == torch.bfloat16)  # outside: "highest"
