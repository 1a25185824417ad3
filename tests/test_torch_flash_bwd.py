"""PyTorch port, the ViT flash attention's backward: the plain versions of the
forward with residuals and of the two backward kernels (dK / dV, dQ) against
the library's own reference backward (`mha_reference_bwd`, from the Pallas
flash attention that ships with JAX) and against `jax.vjp` of the JAX
package's `mha`, at fp32 on the CPU; the autograd Function (`flash_vit_attention`
under grad) against autograd of the plain forward; and the head-major block's
projections at bf16 against the JAX package's. The CUDA kernels are held
against these plain versions in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as lib

import mingunivision_tpu.ops.kernels.flash as jflash
from mingunivision_tpu.models import vit as jvit
from mingunivision_tpu.ops.attention import mha as jax_mha
from mingunivision_tpu_torch.models import vit as tvit
from mingunivision_tpu_torch.ops.kernels import flash

import test_torch_common  # noqa: F401  (one torch thread per test worker)

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 on both sides, sums in another order


def _inputs(B, H, N, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(4)]


# (heads, N, D, seed): the first two as before; head dim 128 (the kernels' other width) and the pixel
# decoder's 16 heads
SHAPES = [(2, 128, 64, 128), (2, 512, 64, 512), (2, 128, 128, 7), (16, 128, 64, 8)]
SHAPE_IDS = ["128", "512", "d128", "16-heads"]


@pytest.mark.parametrize("H,N,D,seed", SHAPES, ids=SHAPE_IDS)
def test_plain_backward_matches_the_library_reference_backward(H, N, D, seed):
    """`mha_reference_bwd` takes only sm_scale=1.0, so q goes in pre-scaled:
    its dq is then the gradient with respect to q * scale (times scale for q's),
    its l and m the residuals of `mha_reference_no_custom_vjp(save_residuals=True)`."""
    B = 1
    q, k, v, do = _inputs(B, H, N, D, seed=seed)
    scale = D**-0.5
    qs = jnp.asarray(q * scale)
    o, l, m = lib.mha_reference_no_custom_vjp(qs, jnp.asarray(k), jnp.asarray(v), save_residuals=True)
    dq, dk, dv, _ = lib.mha_reference_bwd(qs, jnp.asarray(k), jnp.asarray(v), None, None, o, l, m, jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash.flash_vit_attention_lse_plain(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), scale=scale)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, N)
    _, lse32 = flash.flash_vit_attention_lse_plain(tq, tk, tv, scale=scale)
    np.testing.assert_allclose(lse32.numpy(), np.asarray(m + np.log(l)), **TOL)  # lse = m + log l
    got_dq, got_dk, got_dv = flash.flash_vit_attention_bwd_plain(tq, tk, tv, torch.from_numpy(np.array(o)), lse32,
                                                                 tdo, scale=scale)
    np.testing.assert_allclose(got_dq.numpy(), np.asarray(dq) * scale, **TOL)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(dk), **TOL)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(dv), **TOL)


@pytest.mark.parametrize("H,N,D,seed", SHAPES, ids=SHAPE_IDS)
def test_plain_backward_matches_the_vjp_of_jax_mha(H, N, D, seed):
    """`jax.vjp` of the JAX package's `mha` (token-major) at fp32 against the
    plain dK / dV and dQ on the plain forward's output and log-sum-exp."""
    B = 1
    q, k, v, do = _inputs(B, H, N, D, seed=seed + 1)
    scale = D**-0.5
    tm = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731  (head-major -> token-major)
    out, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, scale=scale), tm(q), tm(k), tm(v))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(tm(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = torch.from_numpy(np.asarray(out).transpose(0, 2, 1, 3).copy())
    lse = flash.flash_vit_attention_lse_plain(tq, tk, tv, scale=scale)[1]
    delta = flash.flash_vit_delta(o, tdo)
    dk, dv = flash.flash_vit_bwd_dkv_plain(tq, tk, tv, lse, tdo, delta, scale=scale)
    dq = flash.flash_vit_bwd_dq_plain(tq, tk, tv, lse, tdo, delta, scale=scale)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32-in-default-tier"])
def test_autograd_function_on_the_cpu_matches_autograd_of_the_plain_forward(dtype):
    """Under grad `flash_vit_attention` runs the Function: the plain forward
    with residuals, then the plain backward pieces (the kernels' formula, fp32
    math, outputs rounded to bf16) where autograd of the plain forward goes
    through its bf16-rounded probabilities: one bf16 step of difference."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 2, 128, 64, seed=3))
    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = flash.flash_vit_attention(*leaves, scale=0.125)
    out.backward(do.to(dtype))
    assert out.dtype == dtype and all(t.grad.dtype == dtype for t in leaves)
    ref = [t.to(dtype).detach().requires_grad_(True) for t in (q, k, v)]
    want = flash.flash_vit_attention_plain(*ref, scale=0.125)
    want.backward(do.to(dtype))
    assert out.detach().equal(want.detach())  # the same forward
    for got, r in zip(leaves, ref):
        err = (got.grad.float() - r.grad.float()).abs().max().item()
        assert err <= 1e-2 * r.grad.float().abs().max().item(), err


def test_forward_and_backward_entries_take_the_plain_versions_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 2, 128, 64, seed=4))
    out, lse = flash.flash_vit_attention_lse(q, k, v, scale=0.125)
    want_out, want_lse = flash.flash_vit_attention_lse_plain(q, k, v, scale=0.125)
    assert out.equal(want_out) and lse.equal(want_lse)
    delta = flash.flash_vit_delta(out, do)
    before = (flash.flash_vit_attention.launches, flash.flash_vit_bwd_dkv.launches, flash.flash_vit_bwd_dq.launches)
    for got, want in zip(flash.flash_vit_bwd_dkv(q, k, v, lse, do, delta, scale=0.125),
                         flash.flash_vit_bwd_dkv_plain(q, k, v, lse, do, delta, scale=0.125)):
        assert got.equal(want) and got.dtype == torch.bfloat16
    assert flash.flash_vit_bwd_dq(q, k, v, lse, do, delta, scale=0.125).equal(
        flash.flash_vit_bwd_dq_plain(q, k, v, lse, do, delta, scale=0.125))
    # nothing launched: the counts move only where a kernel launches
    assert before == (flash.flash_vit_attention.launches, flash.flash_vit_bwd_dkv.launches,
                      flash.flash_vit_bwd_dq.launches)


@pytest.mark.parametrize("N,fits", [(128, True), (256, True), (1024, True), (64, False), (192, False), (576, False)])
def test_backward_contract_is_the_vit_tile(N, fits):
    """The backward kernels take what the forward takes: N a multiple of
    `VIT_TILE` (128), checked on CPU tensors too; N 192 is a multiple of 64
    (the earlier mma.sync bodies' tile) and raises."""
    q = torch.zeros((1, 2, N, 64), dtype=torch.bfloat16)
    for name in ("flash_vit_bwd_dkv", "flash_vit_bwd_dq"):
        if fits:
            assert flash._check_vit(name, q, q, q, q) == (1, 2, N, 64)
        else:
            with pytest.raises(ValueError, match="multiple of 128"):
                flash._check_vit(name, q, q, q, q)


def test_headmajor_projections_round_once_as_the_jax_package(monkeypatch):
    """The head-major flash block at bf16: the JAX package sums each
    projection in fp32 (`preferred_element_type`), adds the bias in fp32 and
    rounds once. Summing in bf16 and rounding again after the bias (the port's
    earlier arithmetic, rebuilt here) differs from JAX in about 3 of every 10
    q elements; the port's projections agree with JAX's to the bit but where
    a sum in another order crosses a rounding boundary (1 step, under 1e-3 of
    them)."""
    rng = np.random.default_rng(0)
    C, H, N = 128, 2, 64
    p = {"attn": {"qkv": {"w": 0.05 * rng.standard_normal((C, 3 * C)), "b": 0.1 * rng.standard_normal(3 * C)},
                  "proj": {"w": 0.05 * rng.standard_normal((C, C)), "b": 0.1 * rng.standard_normal(C)}}}
    h = rng.standard_normal((2, N, C))
    seen = {}

    def jax_flash(q, k, v, *, scale, block=512):
        seen["jax"] = [np.asarray(t.astype(jnp.float32)) for t in (q, k, v)]
        out = jax_mha(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), scale=scale)
        return out.transpose(0, 2, 1, 3)

    port_flash = tvit.flash_vit_attention

    def port_seen(q, k, v, *, scale):
        seen["port"] = [t.float().numpy() for t in (q, k, v)]
        return port_flash(q, k, v, scale=scale)

    monkeypatch.setattr(jflash, "flash_vit_attention", jax_flash)
    monkeypatch.setattr(tvit, "flash_vit_attention", port_seen)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(), p)
    jvit._attn_flash_headmajor(jp, jnp.asarray(h, jnp.bfloat16), H)
    hb = torch.from_numpy(h).bfloat16()
    tvit._attn_flash_headmajor(tp, hb, H)
    ulp = 2.0 ** -7
    for got, want in zip(seen["port"], seen["jax"]):
        assert (got != want).mean() < 1e-3
        assert (np.abs(got - want) <= ulp * np.abs(want)).all()
    twice = torch.einsum("bnc,cshd->sbhnd", hb, tp["attn"]["qkv"]["w"].reshape(C, 3, H, C // H))
    twice = (twice.float() + tp["attn"]["qkv"]["b"].float().reshape(3, 1, H, 1, C // H)).bfloat16()
    assert (twice[0].float().numpy() != seen["jax"][0]).mean() > 0.1
