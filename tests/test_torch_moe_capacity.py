"""PyTorch port, the capacity-dense prefill MoE dispatch: `expert_rank` and
`default_capacity` (exact), and the dispatch (on the CPU: the grouped-SwiGLU
kernels' plain version behind the slot placement) against the JAX package's
`moe_experts_capacity_gmm_exact` with its Pallas kernels in interpret mode,
for fp32 and int4 tables, in the fits and overflow branches, with and without
`token_valid`; tolerance 2e-4 of the output's maximum on the valid rows (fp32
on both sides, sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels import moe_capacity as jcap
from mingunivision_tpu.utils.quantize import quantize_array as jax_quantize_array
from mingunivision_tpu_torch.ops.kernels import moe_capacity as tcap
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_plain
from mingunivision_tpu_torch.utils.convert import params_from_jax
import test_torch_common  # noqa: F401  (one torch thread per test worker)

E, D, M, N, K = 8, 128, 256, 32, 3


def _toy(seed):
    rng = np.random.default_rng(seed)
    experts = {"gate_proj": (0.05 * rng.standard_normal((E, D, M))).astype(np.float32),
               "up_proj": (0.05 * rng.standard_normal((E, D, M))).astype(np.float32),
               "down_proj": (0.05 * rng.standard_normal((E, M, D))).astype(np.float32)}
    x = rng.standard_normal((N, D)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(N)]).astype(np.int32)
    w = rng.random((N, K)).astype(np.float32)
    return experts, x, idx, w / w.sum(-1, keepdims=True)


def _tables(experts, tier):
    ex = {k: jnp.asarray(v) for k, v in experts.items()}
    if tier == "int4":
        ex = {k: jax_quantize_array(v, 4) for k, v in ex.items()}
    return ex, params_from_jax(ex, "cpu")


def _rank_oracle(flat_e, num_experts):
    seen = np.zeros(num_experts, np.int32)
    out = np.zeros(len(flat_e), np.int32)
    for i, e in enumerate(flat_e):
        if 0 <= e < num_experts:
            out[i] = seen[e]
            seen[e] += 1
    return out, seen


@pytest.mark.parametrize("A,num_experts", [(7, 5), (512, 5), (700, 5), (1536, 16)])
def test_expert_rank_matches_jax_and_oracle(A, num_experts):
    flat = np.random.default_rng(A).integers(0, num_experts, size=A).astype(np.int32)
    rank, sizes = tcap.expert_rank(torch.from_numpy(flat), num_experts)
    want_rank, want_sizes = jcap.expert_rank(jnp.asarray(flat), num_experts)
    assert rank.dtype == torch.int32 and sizes.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    np.testing.assert_array_equal(rank.numpy(), _rank_oracle(flat, num_experts)[0])


def test_expert_rank_ignores_out_of_range_ids():
    flat = np.array([0, 2, 8, 2, 8, 0, 2], np.int32)  # 8 == num_experts: a padding row routed out of bounds
    rank, sizes = tcap.expert_rank(torch.from_numpy(flat), 8)
    want_rank, want_sizes = _rank_oracle(flat, 8)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(sizes.numpy(), want_sizes)


@pytest.mark.parametrize("args", [(1152, 6, 64, 2.0), (1024, 6, 64, 1.33), (2048, 6, 64, 1.33), (4096, 6, 64, 2.0),
                                  (512, 2, 8, 2.0), (640, 2, 8, 2.0), (32, 3, 8, 2.0)])
def test_default_capacity_matches_jax(args):
    assert tcap.default_capacity(*args) == jcap.default_capacity(*args)
    assert tcap.default_capacity(1152, 6, 64, 2.0) == 256


def _close_valid(got, want, valid=None):
    got, want = got.numpy(), np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("tier", ["fp32", "int4"])
@pytest.mark.parametrize("case", ["fits", "overflow", "pads-with-token-valid", "pads-without-token-valid"])
def test_capacity_dispatch_matches_jax(tier, case):
    experts, x, idx, w = _toy(10)
    jex, tex = _tables(experts, tier)
    capacity, valid = 96, None
    if case == "overflow":  # every assignment on expert 0: load 96 > capacity 32
        idx, capacity = np.zeros_like(idx), 32
    elif case.startswith("pads"):
        # rows 8..15 are padding and pile onto expert 0 (24 assignments > capacity 16); the valid rows
        # are spread round-robin, at most 9 per expert
        valid = np.ones(N, bool)
        valid[8:16] = False
        spread = (np.arange(N * K, dtype=np.int32) % E).reshape(N, K)
        idx = np.where(valid[:, None], spread, 0).astype(np.int32)
        capacity = 16
    token_valid = valid if case == "pads-with-token-valid" else None
    want = jcap.moe_experts_capacity_gmm_exact(
        jex, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), E, capacity, tm_fallback=32, s8=False, interpret=True,
        token_valid=None if token_valid is None else jnp.asarray(token_valid))
    launches, fallbacks = tcap.moe_experts_capacity_gmm.launches, tcap.moe_experts_capacity_gmm_exact.fallbacks
    got = tcap.moe_experts_capacity_gmm_exact(
        tex, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E, capacity,
        token_valid=None if token_valid is None else torch.from_numpy(token_valid))
    _close_valid(got, want, valid)
    # the fallback counter moves only on overflow; no kernel is launched for CPU tensors
    overflowed = case in ("overflow", "pads-without-token-valid")
    assert tcap.moe_experts_capacity_gmm_exact.fallbacks == fallbacks + int(overflowed)
    assert tcap.moe_experts_capacity_gmm.launches == launches
    if token_valid is not None:  # padding rows give zeros
        assert not got.numpy()[~valid].any()


@pytest.mark.parametrize("tier", ["fp32", "int4"])
def test_capacity_dispatch_equals_sorted_dispatch_when_it_fits(tier):
    experts, x, idx, w = _toy(11)
    _, tex = _tables(experts, tier)
    args = (tex, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w), E)
    got = tcap.moe_experts_capacity_gmm(*args, 96)
    torch.testing.assert_close(got, moe_experts_swiglu_gmm_plain(*args), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, moe_experts_swiglu_gmm(*args), rtol=1e-6, atol=1e-6)


def test_capacity_dispatch_drops_overflow_without_the_check():
    experts, x, idx, w = _toy(12)
    _, tex = _tables(experts, "fp32")
    idx0 = np.zeros_like(idx)
    args = (tex, torch.from_numpy(x), torch.from_numpy(idx0), torch.from_numpy(w), E)
    dropped = tcap.moe_experts_capacity_gmm(*args, 32)
    want = moe_experts_swiglu_gmm_plain(*args)
    assert (dropped - want).abs().max() > 1e-3  # hence the check of moe_experts_capacity_gmm_exact
    # the first 32 assignments (tokens 0..9 in full) kept their slots
    torch.testing.assert_close(dropped[:10], want[:10], rtol=1e-6, atol=1e-6)


def test_capacity_schedule_tiles_cover_exactly_the_occupied_slots():
    flat = torch.from_numpy(np.random.default_rng(13).integers(0, E, size=300).astype(np.int32))
    rank, sizes = tcap.expert_rank(flat, E)
    C, tile = 48, 32
    dst, row_expert, sched, ok = tcap.capacity_schedule(flat, rank, sizes, E, C, tile)
    covered = np.zeros(E * C, bool)
    for e, r0, r1 in sched.numpy():
        assert r1 - r0 <= tile and (r0 == r1 or (e * C <= r0 and r1 <= (e + 1) * C))
        assert not covered[r0:r1].any()
        covered[r0:r1] = True
    np.testing.assert_array_equal(covered, row_expert.numpy() >= 0)
    used = np.minimum(sizes.numpy(), C)
    assert covered.sum() == used.sum() == int(ok.sum())
    assert len(np.unique(dst[ok].numpy())) == int(ok.sum())  # one slot per kept assignment
    np.testing.assert_array_equal(row_expert.numpy()[dst[ok].numpy()], flat[ok].numpy())
