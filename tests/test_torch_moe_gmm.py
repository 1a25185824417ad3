"""PyTorch port: the grouped matmuls of MoE training (ops/kernels/moe_gmm.py)
and the differentiable fused prefill MoE, on the CPU, against the JAX package.

The plain `gmm` (both rhs orientations) and `tgmm` against megablox `gmm` /
`tgmm` in interpret mode, at the operand types of the training VJP (forward
bf16 x bf16 -> fp32; grad_lhs fp32 x bf16 -> bf16 with the rhs transposed;
tgmm bf16 x fp32 -> bf16) and at fp32, over uniform, skewed, one-empty-group
and padded-last-group routings: fp32 outputs agree up to the order of fp32
sums (1e-5 of max), bf16 outputs within 1e-2 of max (one rounding apart).
Then `moe_experts_gmm` and its grads against `jax.vjp` of the JAX package's
(megablox in interpret mode), and `moe_experts_swiglu_gmm_ad` against the JAX
package's custom_vjp entry of that name (its fused kernel in interpret
mode): at fp32 within 1e-4 of each max; at bf16 within 2e-3 of each max
plus one bf16 ulp of each value, where the JAX test (tests/test_swiglu_gmm.py)
holds fp32 values to atol=2e-3, rtol=1e-3: a bf16 value rounded from fp32
sums taken in another order can land one ulp away, and one such flip in the
bf16 cotangent of a = silu(g) * u moves the table grads that sum over its row
by about 1e-3 of their max. The CUDA kernels are held
against these plain versions by tests/test_torch_kernels_cuda.py on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.moe_gmm import moe_experts_gmm as jax_moe_experts_gmm
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_ad as jax_swiglu_ad
from mingunivision_tpu_torch.ops.kernels import moe_gmm
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_ad
import test_torch_common  # noqa: F401  (one torch thread per test worker)

ROWS, K, N, E = 256, 128, 256, 4
TILING = (128, 128, 128)
GROUPS = {
    "uniform": [64, 64, 64, 64],
    "skewed": [200, 30, 20, 6],
    "one-empty": [100, 0, 90, 66],
    "padded-last": [70, 60, 50, 76],  # the last 46 rows are zero padding, as moe_experts_gmm pads
}
BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value, at most
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# the megablox kernels themselves (the package's `gmm` name is their custom-VJP wrapper)
_megablox = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")
mb_gmm, mb_tgmm = _megablox.gmm, _megablox.tgmm


def _operands(case):
    rng = np.random.default_rng(sorted(GROUPS).index(case))
    lhs = rng.standard_normal((ROWS, K)).astype(np.float32)
    if case == "padded-last":
        lhs[-46:] = 0.0
    rhs = (0.1 * rng.standard_normal((E, K, N))).astype(np.float32)
    grad = rng.standard_normal((ROWS, N)).astype(np.float32)
    return lhs, rhs, grad, np.asarray(GROUPS[case], np.int32)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, rel):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("case", list(GROUPS))
def test_plain_gmm_and_tgmm_match_megablox(case):
    lhs, rhs, grad, sizes = _operands(case)
    gs_j, gs_t = jnp.asarray(sizes), torch.from_numpy(sizes)
    bf, f32 = torch.bfloat16, torch.float32
    # the forward: bf16 x bf16 -> fp32 (bf16 products are exact in fp32)
    want = mb_gmm(jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16), gs_j, jnp.float32, TILING,
                  interpret=True)
    _close(moe_gmm.gmm(_t(lhs, bf), _t(rhs, bf), gs_t, out_dtype=f32), want, 1e-5)
    # grad_lhs: the fp32 cotangent (ROWS, N) against the bf16 table (E, K, N) transposed -> bf16 (ROWS, K)
    want = mb_gmm(jnp.asarray(grad), jnp.asarray(rhs, jnp.bfloat16), gs_j, jnp.bfloat16, TILING,
                  transpose_rhs=True, interpret=True)
    got = moe_gmm.gmm(_t(grad, f32), _t(rhs, bf), gs_t, out_dtype=bf, transpose_rhs=True)
    assert got.dtype == bf
    _close(got, want, 1e-2)
    # grad_rhs: tgmm of the bf16 rows and the fp32 cotangent -> bf16 (zeros for an empty group)
    want = mb_tgmm(jnp.asarray(lhs, jnp.bfloat16).swapaxes(0, 1), jnp.asarray(grad), gs_j, jnp.bfloat16, TILING,
                   num_actual_groups=E, interpret=True)
    got = moe_gmm.tgmm(_t(lhs, bf), _t(grad, f32), gs_t, out_dtype=bf)
    _close(got, want, 1e-2)
    for e in np.flatnonzero(sizes == 0):
        assert not got[e].any()
    # fp32 operands in every role: the same up to the order of fp32 sums
    want = mb_gmm(jnp.asarray(lhs), jnp.asarray(rhs), gs_j, jnp.float32, TILING, interpret=True)
    _close(moe_gmm.gmm(_t(lhs, f32), _t(rhs, f32), gs_t), want, 1e-5)
    want = mb_gmm(jnp.asarray(grad), jnp.asarray(rhs), gs_j, jnp.float32, TILING, transpose_rhs=True,
                  interpret=True)
    _close(moe_gmm.gmm(_t(grad, f32), _t(rhs, f32), gs_t, transpose_rhs=True), want, 1e-5)
    want = mb_tgmm(jnp.asarray(lhs).swapaxes(0, 1), jnp.asarray(grad), gs_j, jnp.float32, TILING,
                   num_actual_groups=E, interpret=True)
    _close(moe_gmm.tgmm(_t(lhs, f32), _t(grad, f32), gs_t, out_dtype=f32), want, 1e-5)


def _moe_inputs(E_, h, m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    experts = {"gate_proj": 0.1 * rng.standard_normal((E_, h, m)), "up_proj": 0.1 * rng.standard_normal((E_, h, m)),
               "down_proj": 0.1 * rng.standard_normal((E_, m, h))}
    experts = {name: a.astype(np.float32) for name, a in experts.items()}
    x = rng.standard_normal((n, h)).astype(np.float32)
    idx = np.stack([rng.permutation(E_)[:k] for _ in range(n)]).astype(np.int32)
    logits = rng.standard_normal((n, k))
    w = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    cot = rng.standard_normal((n, h)).astype(np.float32)
    return experts, x, idx, w, cot


def _jax_value_and_grads(fn, experts, x, w, cot, dtype):
    cast = lambda a: jnp.asarray(a, JNP[dtype])  # noqa: E731
    y, vjp = jax.vjp(fn, {n: cast(a) for n, a in experts.items()}, cast(x), cast(w))
    ge, gx, gw = vjp(cast(cot).astype(y.dtype))
    return y, [ge["gate_proj"], ge["up_proj"], ge["down_proj"], gx, gw]


def _port_value_and_grads(fn, experts, x, idx, w, cot, dtype):
    tabs = {n: _t(a, dtype).requires_grad_(True) for n, a in experts.items()}
    xt, wt = _t(x, dtype).requires_grad_(True), _t(w, dtype).requires_grad_(True)
    y = fn(tabs, xt, torch.from_numpy(idx).long(), wt)
    y.backward(_t(cot, dtype))
    return y.detach(), [tabs["gate_proj"].grad, tabs["up_proj"].grad, tabs["down_proj"].grad, xt.grad, wt.grad]


def _hold(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= 1e-4 * scale, f"{err:.3e} > 1e-4 x {scale:.3e}"
    else:  # the JAX test's 2e-3, of the max, and one bf16 ulp (2^-7 of the value) for its rtol 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3 * float(np.abs(want).max()), rtol=BF16_ULP)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [64, 60], ids=["A=128", "A=120-padded"])
def test_moe_experts_gmm_and_grads_match_jax(n, dtype):
    E_, h, m, k = 4, 128, 256, 2
    experts, x, idx, w, cot = _moe_inputs(E_, h, m, n, k, seed=n)
    y_j, g_j = _jax_value_and_grads(
        lambda e, xx, ww: jax_moe_experts_gmm(e, xx, jnp.asarray(idx), ww, E_, interpret=True), experts, x, w, cot,
        dtype)
    y_p, g_p = _port_value_and_grads(lambda e, xx, i, ww: moe_gmm.moe_experts_gmm(e, xx, i, ww, E_), experts, x, idx,
                                     w, cot, dtype)
    _hold(y_p, y_j, dtype)
    for gp, gj in zip(g_p, g_j):
        assert gp.dtype == dtype
        _hold(gp, gj, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_swiglu_gmm_ad_matches_jax(dtype):
    """At the shapes of tests/test_swiglu_gmm.py's grad test: value and the
    grads of the tables, x and topk_w; none reaches topk_idx."""
    E_, h, m, n, k = 4, 128, 256, 64, 2
    experts, x, idx, w, cot = _moe_inputs(E_, h, m, n, k, seed=5)
    y_j, g_j = _jax_value_and_grads(lambda e, xx, ww: jax_swiglu_ad(e, xx, jnp.asarray(idx), ww, E_, 32, True),
                                    experts, x, w, cot, dtype)
    y_p, g_p = _port_value_and_grads(lambda e, xx, i, ww: moe_experts_swiglu_gmm_ad(e, xx, i, ww, E_), experts, x,
                                     idx, w, cot, dtype)
    _hold(y_p, y_j, dtype)
    for gp, gj in zip(g_p, g_j):
        _hold(gp, gj, dtype)


def test_swiglu_gmm_ad_on_stacked_tables_grads_the_layer_slice():
    """Depth-stacked tables with a layer index: the layer's slice of each
    stacked leaf gets the per-layer grads, the other layers zeros."""
    E_, h, m, n, k = 4, 128, 256, 64, 2
    experts, x, idx, w, cot = _moe_inputs(E_, h, m, n, k, seed=7)
    per_layer = _port_value_and_grads(lambda e, xx, i, ww: moe_experts_swiglu_gmm_ad(e, xx, i, ww, E_), experts, x,
                                      idx, w, cot, torch.float32)[1]
    stacked = {n_: torch.from_numpy(np.stack([0.5 * a, a])).requires_grad_(True) for n_, a in experts.items()}
    y = moe_experts_swiglu_gmm_ad(stacked, _t(x, torch.float32), torch.from_numpy(idx).long(),
                                  _t(w, torch.float32), E_, layer_idx=1)
    y.backward(_t(cot, torch.float32))
    for name, want in zip(("gate_proj", "up_proj", "down_proj"), per_layer):
        g = stacked[name].grad
        assert not g[0].any()
        torch.testing.assert_close(g[1], want, rtol=0, atol=0)


# --- the card route's choice and schedule, on the CPU ------------------------------------------------------

def _misaligned(t):
    """`t`'s values in a contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# (lhs dtype, K, N, transposed table, which operand starts off a 16-byte boundary) -> route
ROUTE_CASES = {
    "model-h-to-m-bf16": (torch.bfloat16, 2048, 1408, False, None, "wgmma"),
    "model-m-to-h-bf16": (torch.bfloat16, 1408, 2048, False, None, "wgmma"),
    "cotangent-fp32-transposed": (torch.float32, 2048, 1408, True, None, "wgmma"),
    "16-byte-rows": (torch.bfloat16, 200, 312, False, None, "wgmma"),
    "odd-widths": (torch.bfloat16, 100, 150, False, None, "mma_sync"),
    "fp32-K-multiple-of-4-only": (torch.float32, 100, 312, True, None, "mma_sync"),
    "N-not-multiple-of-8": (torch.bfloat16, 2048, 1404, False, None, "mma_sync"),
    "lhs-off-16-bytes": (torch.bfloat16, 2048, 1408, False, "lhs", "mma_sync"),
    "table-off-16-bytes": (torch.float32, 1408, 2048, True, "rhs", "mma_sync"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_gmm_route_depends_on_shape_and_alignment_alone(case):
    """`gmm_route` sends every operand TMA can describe (16-byte aligned bases,
    K and N multiples of 8) to the wgmma body, the rest to the mma_sync body,
    whatever the dtypes and orientation."""
    dtype, K, N, transposed, off, want = ROUTE_CASES[case]
    lhs = torch.zeros((16, K), dtype=dtype)
    rhs = torch.zeros((2, N, K) if transposed else (2, K, N), dtype=torch.bfloat16)
    if off == "lhs":
        lhs = _misaligned(lhs)
    elif off == "rhs":
        rhs = _misaligned(rhs)
    assert lhs.is_contiguous() and rhs.is_contiguous()
    assert moe_gmm.gmm_route(lhs, rhs, K, N) == want


# (grad dtype, K, N, rows, groups, which operand starts off a 16-byte boundary) -> tgmm's route
TGMM_ROUTE_CASES = {
    "gate-table-fp32-grad": (torch.float32, 2048, 1408, 64, 64, None, "wgmma"),
    "down-table-fp32-grad": (torch.float32, 1408, 2048, 64, 64, None, "wgmma"),
    "bf16-grad-16-byte-rows": (torch.bfloat16, 200, 312, 64, 8, None, "wgmma"),
    "odd-widths": (torch.float32, 100, 150, 64, 8, None, "mma_sync"),
    "K-multiple-of-4-only": (torch.float32, 100, 312, 64, 8, None, "mma_sync"),
    "N-not-multiple-of-8": (torch.bfloat16, 2048, 1404, 64, 8, None, "mma_sync"),
    "lhs-off-16-bytes": (torch.float32, 2048, 1408, 64, 8, "lhs", "mma_sync"),
    "grad-off-16-bytes": (torch.float32, 2048, 1408, 64, 8, "grad", "mma_sync"),
    "no-rows": (torch.float32, 2048, 1408, 0, 8, None, "mma_sync"),
    "most-groups-it-orders": (torch.float32, 2048, 1408, 64, moe_gmm.TGMM_MAX_GROUPS, None, "wgmma"),
    "more-groups-than-it-orders": (torch.float32, 2048, 1408, 64, moe_gmm.TGMM_MAX_GROUPS + 1, None, "mma_sync"),
}


@pytest.mark.parametrize("case", list(TGMM_ROUTE_CASES))
def test_tgmm_route_depends_on_shape_and_alignment_alone(case):
    """`tgmm_route` sends every operand pair TMA can describe (16-byte aligned
    bases, K and N multiples of 8, at least one row) over at most
    TGMM_MAX_GROUPS groups to the wgmma body, the rest to the mma_sync body,
    whatever the grad's dtype."""
    dtype, K, N, rows, groups, off, want = TGMM_ROUTE_CASES[case]
    lhs = torch.zeros((rows, K), dtype=torch.bfloat16)
    grad = torch.zeros((rows, N), dtype=dtype)
    if off == "lhs":
        lhs = _misaligned(lhs)
    elif off == "grad":
        grad = _misaligned(grad)
    assert lhs.is_contiguous() and grad.is_contiguous()
    assert moe_gmm.tgmm_route(lhs, grad, K, N, groups) == want


@pytest.mark.parametrize("seed", range(6))
def test_gmm_schedule_covers_every_row_once(seed):
    """`gmm_schedule` at the kernels' TILE_ROWS, for random sizes with empty
    groups and rows past (or short of) the groups' sum: every row lies in
    exactly one non-empty tile, of its own group (-1 past the sum), tiles hold
    at most TILE_ROWS rows, and walking the tiles as the kernels do (each a
    product of its rows with its group's table, zeros for group -1) into a
    NaN-filled output gives `gmm_plain`'s output."""
    rng = np.random.default_rng(seed)
    E_ = int(rng.integers(1, 9))
    sizes = rng.integers(0, 300, E_) * (rng.random(E_) < 0.7)
    R = int(sizes.sum()) + int(rng.integers(-40 if sizes.sum() > 40 else 0, 200))
    sched = moe_gmm.gmm_schedule(torch.from_numpy(sizes).to(torch.int32), R)
    assert sched.dtype == torch.int32 and sched.shape == (-(-R // moe_gmm.TILE_ROWS) + E_ + 1, 3)
    group_of = np.full(R, -1)
    ends = np.minimum(np.cumsum(sizes), R)
    for e, (start, end) in enumerate(zip(np.concatenate([[0], ends[:-1]]), ends)):
        group_of[start:end] = e
    cover = np.zeros(R, np.int64)
    for e, r0, r1 in sched.tolist():
        if r0 >= r1:
            continue
        assert r1 - r0 <= moe_gmm.TILE_ROWS and (group_of[r0:r1] == e).all()
        cover[r0:r1] += 1
    assert (cover == 1).all()
    lhs = torch.from_numpy(rng.standard_normal((R, 24)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((E_, 24, 40)).astype(np.float32))
    out = torch.full((R, 40), float("nan"))
    for e, r0, r1 in sched.tolist():
        if r0 < r1:
            out[r0:r1] = lhs[r0:r1] @ rhs[e] if e >= 0 else 0.0
    want = moe_gmm.gmm_plain(lhs, rhs, torch.from_numpy(sizes))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_moe_experts_gmm_builds_one_schedule_per_layer(dtype, monkeypatch):
    """`moe_experts_gmm` builds `gmm_schedule` once and hands that one tensor to
    its six gmm launches (three forward, three grad_lhs in the backward); the
    value and grads still match the JAX package's `moe_experts_gmm` as in
    `test_moe_experts_gmm_and_grads_match_jax`."""
    E_, h, m, k, n = 4, 128, 256, 2, 60
    experts, x, idx, w, cot = _moe_inputs(E_, h, m, n, k, seed=n)
    seen, real = [], moe_gmm.gmm

    def spy(*args, **kwargs):
        seen.append((kwargs.get("sched"), kwargs.get("transpose_rhs", False), args[2]))
        return real(*args, **kwargs)

    monkeypatch.setattr(moe_gmm, "gmm", spy)
    y_p, g_p = _port_value_and_grads(lambda e, xx, i, ww: moe_gmm.moe_experts_gmm(e, xx, i, ww, E_), experts, x, idx,
                                     w, cot, dtype)
    assert len(seen) == 6 and sorted(t for _, t, _ in seen) == [False] * 3 + [True] * 3
    sched, sizes = seen[0][0], seen[0][2]
    assert all(s is sched for s, _, _ in seen)
    torch.testing.assert_close(sched, moe_gmm.gmm_schedule(sizes, -(-n * k // moe_gmm.PAD_ROWS) * moe_gmm.PAD_ROWS),
                               rtol=0, atol=0)
    y_j, g_j = _jax_value_and_grads(
        lambda e, xx, ww: jax_moe_experts_gmm(e, xx, jnp.asarray(idx), ww, E_, interpret=True), experts, x, w, cot,
        dtype)
    _hold(y_p, y_j, dtype)
    for gp, gj in zip(g_p, g_j):
        _hold(gp, gj, dtype)
