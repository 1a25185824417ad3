"""PyTorch port, PERF.md row 12: the gathered-expert matmul's plain version
and the decode-MoE dispatch built on it (`ops/kernels/expert_matmul.py`) on
the CPU against the JAX package's Pallas kernel in interpret mode
(`gathered_expert_matmul`, `moe_experts_gather_pallas`) and its XLA dispatch
`bailing_moe.moe_experts_gather`: fp32 within ATOL = 2e-4 (as
tests/test_pallas_kernels.py holds the Pallas kernel); bf16 within BF16_TOL of
the fp32 result's max (both round g, u and the output to bf16, in another
order of the fp32 sums); depth-stacked tables through `layer_idx`, and a
stacked table without one raising. The CUDA kernel itself is tested on the
card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.models.bailing_moe import moe_experts_gather as jax_moe_experts_gather
from mingunivision_tpu.ops.kernels.expert_matmul import gathered_expert_matmul as jax_gathered
from mingunivision_tpu.ops.kernels.expert_matmul import moe_experts_gather_pallas
from mingunivision_tpu_torch.ops.kernels.expert_matmul import (
    gathered_expert_matmul,
    gathered_expert_matmul_plain,
    moe_experts_gather_kernel,
    moe_experts_gather_plain,
)

from test_torch_common import ATOL

BF16_TOL = 2e-2  # of max |fp32 result|: a few bf16 steps (2^-8) through three rounded products


def _tables(rng, E=8, h=64, m=32, layers=None):
    lead = () if layers is None else (layers,)
    return {"gate_proj": rng.standard_normal(lead + (E, h, m)).astype(np.float32),
            "up_proj": rng.standard_normal(lead + (E, h, m)).astype(np.float32),
            "down_proj": rng.standard_normal(lead + (E, m, h)).astype(np.float32)}


def _routing(rng, N, k, E=8):
    return rng.integers(0, E, (N, k)).astype(np.int32), rng.random((N, k)).astype(np.float32)


def test_plain_gathered_matmul_matches_the_pallas_kernel():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 32, 64)).astype(np.float32)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    ids = np.asarray([0, 3, 1, 1, 2], np.int32)
    want = np.asarray(jax_gathered(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), tile_n=32, interpret=True))
    t = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ids))
    np.testing.assert_allclose(gathered_expert_matmul_plain(*t).numpy(), want, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(gathered_expert_matmul(*t).numpy(), want, rtol=ATOL, atol=ATOL)  # CPU: the plain one


def test_moe_gather_matches_pallas_and_xla_dispatch_fp32():
    rng = np.random.default_rng(0)
    experts = _tables(rng)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    idx, w = _routing(rng, 3, 2)
    jx = {k: jnp.asarray(v) for k, v in experts.items()}
    want_xla = np.asarray(jax_moe_experts_gather(jx, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w)))
    want_pallas = np.asarray(moe_experts_gather_pallas(jx, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
                                                       interpret=True))
    tx = {k: torch.from_numpy(v) for k, v in experts.items()}
    args = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    for got in (moe_experts_gather_kernel(tx, *args), moe_experts_gather_plain(tx, *args)):
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_xla, rtol=ATOL, atol=ATOL)


def test_moe_gather_bf16_within_bf16_of_fp32():
    rng = np.random.default_rng(2)
    experts = {k: 0.1 * v for k, v in _tables(rng, E=8, h=128, m=64).items()}
    x = rng.standard_normal((6, 128)).astype(np.float32)
    idx, w = _routing(rng, 6, 3)
    jx = {k: jnp.asarray(v, jnp.bfloat16) for k, v in experts.items()}
    want_bf16 = np.asarray(moe_experts_gather_pallas(jx, jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx),
                                                     jnp.asarray(w, jnp.bfloat16), interpret=True), np.float32)
    tx = {k: torch.from_numpy(v) for k, v in experts.items()}
    fp32 = moe_experts_gather_plain(tx, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    bx = {k: v.to(torch.bfloat16) for k, v in tx.items()}
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(idx), torch.from_numpy(w).to(torch.bfloat16))
    tol = BF16_TOL * np.abs(fp32).max()
    for got in (moe_experts_gather_kernel(bx, *args), moe_experts_gather_plain(bx, *args)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), fp32, atol=tol)
        np.testing.assert_allclose(got.float().numpy(), want_bf16, atol=tol)


def test_stacked_tables_need_a_layer_index():
    rng = np.random.default_rng(3)
    stacked = _tables(rng, layers=3)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    idx, w = _routing(rng, 2, 2)
    tx = {k: torch.from_numpy(v) for k, v in stacked.items()}
    args = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    got = moe_experts_gather_kernel(tx, *args, layer_idx=2)
    layer = {k: jnp.asarray(v[2]) for k, v in stacked.items()}
    want = np.asarray(moe_experts_gather_pallas(layer, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w),
                                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    for fn in (moe_experts_gather_kernel, moe_experts_gather_plain):
        with pytest.raises(ValueError, match="layer index"):
            fn(tx, *args)
