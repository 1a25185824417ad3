"""PyTorch port, kernel modules: the plain versions of the three CUDA kernels
against the JAX Pallas kernels run in interpret mode on the CPU, the prefill
group schedule, and the no-fallback wrappers. The CUDA kernels themselves are
held against these plain versions in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.decode_attention import pallas_decode_attention
from mingunivision_tpu.ops.kernels.moe_stream import moe_experts_stream as jax_moe_stream
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as jax_swiglu_gmm
from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_plain
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, moe_experts_stream_plain
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    group_schedule,
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)  # fp32, as tests/test_pallas_kernels.py
E, H, M = 8, 256, 384  # 128-aligned, as the Pallas kernels need


def _experts(seed, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    return {
        "gate_proj": (0.05 * rng.standard_normal(lead + (E, H, M))).astype(np.float32),
        "up_proj": (0.05 * rng.standard_normal(lead + (E, H, M))).astype(np.float32),
        "down_proj": (0.05 * rng.standard_normal(lead + (E, M, H))).astype(np.float32),
    }


def _routing(seed, n, k, choices=None, num_experts=E):
    rng = np.random.default_rng(seed)
    pool = np.arange(num_experts) if choices is None else np.asarray(choices)
    idx = np.stack([rng.permutation(pool)[:k] for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# kernel 1: decode MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,k,dup",
    [(3, 4, True), (1, 6, False), (4, 4, False), (16, 6, False)],
    ids=["dup-across-rows", "single-token", "A>E-dedup", "A>E-16rows"],
)
def test_moe_stream_plain_matches_pallas(n, k, dup):
    ex = _experts(0)
    idx, w = _routing(1, n, k)
    if dup:
        idx[1] = idx[0][::-1]  # the same experts in two rows
    x = np.random.default_rng(2).standard_normal((n, H)).astype(np.float32)
    want = jax_moe_stream(_j(ex), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True)
    got = moe_experts_stream_plain(_t(ex), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_stream_plain_stacked_layer_matches_pallas():
    ex = _experts(3, layers=3)
    idx, w = _routing(4, 2, 6)
    x = np.random.default_rng(5).standard_normal((2, H)).astype(np.float32)
    want = jax_moe_stream(_j(ex), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), interpret=True, layer_idx=2)
    got = moe_experts_stream_plain(_t(ex), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
                                   layer_idx=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# kernel 2: prefill MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,k,tm,choices",
    [(96, 3, 32, None), (64, 2, 64, None), (50, 2, 32, [0, 3])],
    ids=["96tok", "64tok-tm64", "skewed-empty-experts"],
)
def test_swiglu_gmm_plain_matches_pallas(n, k, tm, choices):
    ex = _experts(6)
    idx, w = _routing(7, n, k, choices)
    x = np.random.default_rng(8).standard_normal((n, H)).astype(np.float32)
    want = jax_swiglu_gmm(_j(ex), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, tm=tm, interpret=True)
    got = moe_experts_swiglu_gmm_plain(_t(ex), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swiglu_gmm_plain_stacked_layer_matches_pallas():
    ex = _experts(9, layers=2)
    idx, w = _routing(10, 64, 3)
    x = np.random.default_rng(11).standard_normal((64, H)).astype(np.float32)
    want = jax_swiglu_gmm(_j(ex), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, tm=32, interpret=True,
                          layer_idx=1)
    got = moe_experts_swiglu_gmm_plain(_t(ex), torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E,
                                       layer_idx=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "n,k,n_exp,choices",
    [(128, 6, 64, None), (50, 2, 8, [0, 3]), (7, 2, 8, None), (128, 6, 64, list(range(6)))],
    ids=["slice-prefill", "empty-groups", "fewer-rows-than-tile", "all-to-6-experts"],
)
def test_group_schedule_covers_every_row_once(n, k, n_exp, choices):
    tile = 32
    idx, _ = _routing(12, n, k, choices, num_experts=n_exp)
    order, row_token, sched = group_schedule(torch.from_numpy(idx).long(), n_exp, tile)
    flat = idx.reshape(-1)
    A = n * k
    assert sched.shape == (-(-A // tile) + n_exp, 3)
    np.testing.assert_array_equal(row_token.numpy(), order.numpy() // k)
    assert (np.diff(flat[order.numpy()]) >= 0).all()  # rows sorted by expert
    cover = np.zeros(A, np.int64)
    for e, r0, r1 in sched.tolist():
        assert 0 <= r1 - r0 <= tile
        cover[r0:r1] += 1
        assert (flat[order.numpy()[r0:r1]] == e).all()  # no tile straddles a group
    np.testing.assert_array_equal(cover, np.ones(A, np.int64))


# ---------------------------------------------------------------------------
# kernel 3: decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Hq,Hkv", [(16, 4), (4, 4)])
def test_decode_attention_plain_matches_pallas(Hq, Hkv):
    B, S, D = 2, 1024, 64
    rng = np.random.default_rng(13)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[0, :700] = True
    mask[1, :321] = True
    mask[1, 400:450] = True  # CFG-style hole
    want = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), tile_s=256,
                                   interpret=True, kv_head_major=True)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# wrappers: plain version only for CPU tensors; a failed build raises
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_version_on_cpu_without_counting():
    ex = _t(_experts(14, layers=2))
    idx, w = _routing(15, 4, 2)
    idx, w = torch.from_numpy(idx), torch.from_numpy(w)
    x = torch.randn(4, H, generator=torch.Generator().manual_seed(0))
    counts = (moe_experts_stream.launches, moe_experts_swiglu_gmm.launches, decode_attention.launches)
    torch.testing.assert_close(moe_experts_stream(ex, x, idx, w, layer_idx=1),
                               moe_experts_stream_plain(ex, x, idx, w, layer_idx=1))
    torch.testing.assert_close(moe_experts_swiglu_gmm(ex, x, idx, w, E, layer_idx=1),
                               moe_experts_swiglu_gmm_plain(ex, x, idx, w, E, layer_idx=1))
    q, kc = torch.randn(1, 1, 4, 64), torch.randn(1, 2, 32, 64)
    mask = torch.ones(1, 32, dtype=torch.bool)
    torch.testing.assert_close(decode_attention(q, kc, kc, mask), decode_attention_plain(q, kc, kc, mask))
    assert (moe_experts_stream.launches, moe_experts_swiglu_gmm.launches, decode_attention.launches) == counts


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc here, and a broken source on a card: either way the build raises."""
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError):
        build.build()


def test_library_name_follows_sources(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path()
    (tmp_path / "a.cu").write_text("// two\n")
    assert build.library_path() != first
