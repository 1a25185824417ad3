"""PyTorch port: what surrounds the int4 decode-MoE kernel's s8-dot mode
(`csrc/moe_stream_q4.cu`, `mu_moe_stream_q4s8`), on the CPU.

- A plain-torch model of the kernel's arithmetic: the routing each block
  builds from the top-k ids and gates (`routing_model`, shared with the bf16
  kernel's tests), the rows of x quantized to the s8 operand pair, per slot
  the two integer dots of each packed table summed stage by stage (64 packed
  rows a stage, the kernel's order), the fp32 epilogue times the column
  scales, h = silu(g) * u re-quantized per row over all of m once per slot
  (the up launch's last block), the down dots the same way, and each row's
  merge over its slots in ascending order, each product rounded before the
  sum. Held to the bit against `moe_experts_stream_q4s8_plain`, and with the
  int4 kernel tests' tolerance against the JAX package's Pallas kernel
  (`_kernel_q4_s8`) in interpret mode, at 1, 2, 3, 12 and 16 rows, with N k >
  E, all rows on one expert, a row naming an expert twice and ids outside
  [0, E), on numpy-seeded inputs.
- The workspace the wrapper sizes (`q4s8_workspace_sizes`), kept per device
  and stream, the rows it launches per pair, and its argument checks
  (`check_q4s8_inputs`), case by case.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.moe_stream import moe_experts_stream as jax_moe_experts_stream
from mingunivision_tpu.utils.quantize import quantize_array as jax_quantize_array
from mingunivision_tpu_torch.ops.kernels import moe_stream as ms
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, silu_exact
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, quantize_array
import test_torch_common  # noqa: F401  (one torch thread per test worker)
from test_torch_moe_stream_redesign import routing_model

REL = 1e-4  # against the Pallas kernel: the same integer dots, fp32 steps in another order (test_torch_kernels_int4)
E, H, M = 8, 256, 384  # whole 128-column tiles, as the kernel and the Pallas kernel need
STAGE = 64  # packed rows per stage of the kernel's ring


# ---------------------------------------------------------------------------
# the kernel's arithmetic against the plain version and the Pallas kernel
# ---------------------------------------------------------------------------


def quant_pair_model(rows, tile=None):
    """The kernel's row quantization on fp32 rows (n, w): lo = the first half,
    hi = the second; per row the maxima of |lo - hi/16| and |hi| (with `tile`,
    as the up launch takes them: per tile of `tile` column pairs, then over
    the tiles), the scales max / 127 + 1e-12, the s8 operands rounded half to
    even, and corr = 8 (sum a1 * sa1 + sum a2 * (sa2 / 16)). Returns (a1, a2
    as int64, sa1, sa2, corr (n, 1) fp32)."""
    half = rows.shape[-1] // 2
    lo, hi = rows[:, :half], rows[:, half:]
    c1 = lo - hi * 0.0625

    def row_max(v):
        if tile is None:
            return v.abs().amax(dim=-1, keepdim=True)
        return v.abs().reshape(v.shape[0], -1, tile).amax(dim=-1).amax(dim=-1, keepdim=True)

    sa1 = div_exact(row_max(c1), 127.0) + 1e-12
    sa2 = div_exact(row_max(hi), 127.0) + 1e-12
    a1, a2 = torch.round(c1 / sa1), torch.round(hi / sa2)
    corr = 8.0 * (a1.sum(dim=-1, keepdim=True) * sa1 + a2.sum(dim=-1, keepdim=True) * (sa2 * 0.0625))
    return a1.long(), a2.long(), sa1, sa2, corr


def dots_model(q, a1, a2, sa1, sa2, corr, scale):
    """One packed (K/2, cols) table against the s8 pair: the two integer dots,
    (q & 0x0F) . a1 and s8(q ^ 0x80) . a2, summed a stage of 64 packed rows at
    a time as the ring streams them; then d1 sa1 + d2 (sa2 / 16) - corr, times
    the column scale, each step rounded in fp32."""
    lo, hi = (q & 0x0F).long(), (q ^ 0x80).view(torch.int8).long()
    d1 = torch.zeros(a1.shape[0], q.shape[1], dtype=torch.long)
    d2 = torch.zeros_like(d1)
    for k0 in range(0, q.shape[0], STAGE):
        d1 += a1[:, k0:k0 + STAGE] @ lo[k0:k0 + STAGE]
        d2 += a2[:, k0:k0 + STAGE] @ hi[k0:k0 + STAGE]
    return (d1.float() * sa1 + d2.float() * (sa2 * 0.0625) - corr) * scale


def kernel_model(experts, x, topk_idx, topk_w, layer_idx=None):
    """What the up and down launches compute, slot by slot in ascending expert
    id (x's rows quantized in each block, h from each 64-pair tile's maxima), and the merge
    of the last block of each column tile."""
    w1, w3, w2 = ms.layer_tables(experts, layer_idx)
    routed, _, rows = routing_model(topk_idx, topk_w, w1.q.shape[0])
    xq = quant_pair_model(x.float())
    ys = []
    for e in routed:
        g = dots_model(w1.q[e], *xq, w1.s[e])
        u = dots_model(w3.q[e], *xq, w3.s[e])
        h = silu_exact(g) * u  # fp32, into the workspace
        ys.append(dots_model(w2.q[e], *quant_pair_model(h, tile=64), w2.s[e]))  # h re-quantized once per slot
    out = torch.zeros(x.shape[0], w2.q.shape[-1])
    for n, pairs in enumerate(rows):
        for s, gate in pairs:
            out[n] = out[n] + gate * ys[s][n]
    return out.to(x.dtype)


def _q4_tables(seed, layers=None):
    """Linear int4 tables quantized by the JAX package (its bytes and scales)."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M), "down_proj": (E, M, H)}
    return {k: jax_quantize_array(jnp.asarray(0.05 * rng.standard_normal(lead + s), jnp.float32), 4)
            for k, s in shapes.items()}


def _routing(N, k, seed, kind="spread"):
    rng = np.random.default_rng(seed)
    if kind == "one-expert":  # every row routes to expert 3 (and, past k = 1, to the same others)
        idx = np.tile(np.concatenate([[3], rng.permutation([e for e in range(E) if e != 3])[:k - 1]]), (N, 1))
    else:
        idx = np.stack([rng.permutation(E)[:k] for _ in range(N)])
    w = rng.random((N, k)).astype(np.float32)
    idx = idx.astype(np.int32)
    if kind == "repeat":  # row 0 names its first expert twice, row 1 its second three times
        idx[0, 1] = idx[0, 0]
        idx[1, 2] = idx[1, 3] = idx[1, 1]
    return idx, w / w.sum(-1, keepdims=True)


CASES = {  # id: (N, k, routing kind)
    "1row": (1, 6, "spread"),
    "2rows": (2, 6, "spread"),
    "3rows": (3, 6, "spread"),
    "12rows": (12, 6, "spread"),
    "16rows-Nk>E": (16, 6, "spread"),
    "16rows-one-expert": (16, 1, "one-expert"),
    "3rows-repeated-expert": (3, 4, "repeat"),
    "2rows-ids-out-of-range": (2, 4, "out-of-range"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_is_the_plain_version_and_matches_pallas(case):
    N, k, kind = CASES[case]
    tables = _q4_tables(50 + N, layers=2)
    idx, w = _routing(N, k, 60 + N, kind)
    x = np.random.default_rng(70 + N).standard_normal((N, H)).astype(np.float32)
    jidx, jw = idx, w
    if kind == "out-of-range":  # dropped by the kernel; the Pallas kernel gets the same as a zero gate on expert 0
        idx = idx.copy()
        idx[0, 1], idx[1, 3] = E, -1
        jidx, jw = idx.copy(), w.copy()
        jidx[(idx < 0) | (idx >= E)] = 0
        jw[(idx < 0) | (idx >= E)] = 0.0
    ex = params_from_jax(tables, "cpu")
    args = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    model = kernel_model(ex, *args, layer_idx=1)
    plain = ms.moe_experts_stream_q4s8_plain(ex, *args, layer_idx=1)
    assert torch.equal(model, plain)
    want = np.asarray(jax_moe_experts_stream(tables, jnp.asarray(x), jnp.asarray(jidx), jnp.asarray(jw),
                                             interpret=True, layer_idx=1))
    err = np.abs(model.numpy() - want).max()
    assert np.isfinite(want).all() and err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def test_kernel_model_in_bf16_is_the_plain_version():
    """bf16 rows and gates, as the LLM step passes them: the same bits, a bf16 output."""
    ex = params_from_jax(_q4_tables(7), "cpu")
    idx, w = _routing(2, 6, 8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, H)).astype(np.float32)).bfloat16()
    args = (x, torch.from_numpy(idx).long(), torch.from_numpy(w).bfloat16())
    model, plain = kernel_model(ex, *args), ms.moe_experts_stream_q4s8_plain(ex, *args)
    assert model.dtype == torch.bfloat16 and torch.equal(model, plain)


def test_h_is_quantized_over_all_of_m_once_per_slot():
    """Per row, the down operands' scales are taken over all of m (both
    halves): quantizing two halves of the columns apart gives other bits."""
    h = torch.from_numpy(np.random.default_rng(11).standard_normal((3, M)).astype(np.float32))
    h[:, M // 4] *= 50.0  # a large value in the first quarter moves the row's lo scale
    whole = quant_pair_model(h)
    left, right = quant_pair_model(h[:, : M // 2]), quant_pair_model(h[:, M // 2:])
    assert not torch.equal(whole[2], left[2])  # sa1 of the whole row is not that of a part
    assert torch.equal(whole[0].abs().amax(dim=-1), torch.full((3,), 127, dtype=torch.long))


# ---------------------------------------------------------------------------
# the workspace and the wrapper
# ---------------------------------------------------------------------------


def test_workspace_sizes_at_the_decode_shapes():
    """16B-A3B tables (E 64, h 2048, m 1408), top-6: the T2I step's 2 rows take
    12 slots, a 16-slot serving step 64 (at most E)."""
    assert ms.q4s8_workspace_sizes(2, 6, 64, 2048, 1408) == (12 * 2 * 2048, 12 * 8 * 1424, 8 + 12)
    assert ms.q4s8_workspace_sizes(16, 6, 64, 2048, 1408) == (64 * 16 * 2048, 64 * 16 * 1424, 8 + 64)
    # h's tiles' row maxima outgrow the down products where m + m / 64 > h
    assert ms.q4s8_workspace_sizes(64, 8, 1024, 256, 384) == (512 * 64 * 390, 512 * 64 * 400, 1 + 512)
    assert ms.q4s8_workspace_sizes(1, 2, 8, 256, 384) == (2 * 390, 2 * 8 * 400, 1 + 2)


def test_workspace_is_kept_per_stream_and_grows():
    dev = torch.device("cpu")
    small, large = ms.q4s8_workspace_sizes(2, 6, 64, 2048, 1408), ms.q4s8_workspace_sizes(16, 6, 64, 2048, 1408)
    fbuf, qbuf, tickets = ms._q4s8_workspace(small, dev, stream=4001)
    assert fbuf.dtype == torch.float32 and qbuf.dtype == torch.int8 and tickets.dtype == torch.int32
    assert (fbuf.numel(), qbuf.numel(), tickets.numel()) == small and not tickets.any()
    assert ms._q4s8_workspace(small, dev, stream=4001)[1] is qbuf  # reused, not allocated again
    assert ms._q4s8_workspace(small, dev, stream=4002)[1] is not qbuf  # another stream has its own
    grown = ms._q4s8_workspace(large, dev, stream=4001)
    assert tuple(t.numel() for t in grown) == large and not grown[2].any()
    assert ms._q4s8_workspace(small, dev, stream=4001)[0] is grown[0]  # a smaller call keeps the larger buffers
    assert (None, 4001) not in ms._workspaces  # the bf16 kernel's buffers are apart
    for key in [(None, 4001), (None, 4002)]:
        ms._q4s8_workspaces.pop(key)


@pytest.mark.parametrize("N,chunks", [(1, [(0, 1)]), (64, [(0, 64)]), (65, [(0, 64), (64, 1)]),
                                      (150, [(0, 64), (64, 64), (128, 22)])])
def test_rows_take_one_launch_pair_per_64(N, chunks):
    assert list(ms.row_chunks(N)) == chunks


def test_wrapper_on_cpu_takes_the_plain_version_without_a_workspace():
    ex = params_from_jax(_q4_tables(12, layers=1), "cpu")
    idx, w = _routing(3, 4, 13)
    args = (ex, torch.from_numpy(np.ones((3, H), np.float32)).bfloat16(), torch.from_numpy(idx), torch.from_numpy(w))
    before, spaces = ms.moe_experts_stream_q4s8.launches, dict(ms._q4s8_workspaces)
    assert torch.equal(ms.moe_experts_stream(*args, layer_idx=0), ms.moe_experts_stream_q4s8_plain(*args, layer_idx=0))
    assert ms.moe_experts_stream_q4s8.launches == before and ms._q4s8_workspaces == spaces


def _q4_case(N=2, k=6, h=H, m=M, layers=2):
    shapes = {"gate_proj": (layers, E, h, m), "up_proj": (layers, E, h, m), "down_proj": (layers, E, m, h)}
    experts = {n: quantize_array(torch.ones(sh), 4) for n, sh in shapes.items()}
    return experts, torch.zeros(N, h, dtype=torch.bfloat16), torch.zeros(N, k, dtype=torch.int64), \
        torch.zeros(N, k, dtype=torch.bfloat16)


def _with(tables=None, x=None, idx=None, w=None, **shape):
    experts, x0, idx0, w0 = _q4_case(**shape)
    if tables is not None:
        experts = tables(experts)
    return experts, x0 if x is None else x(x0), idx0 if idx is None else idx(idx0), w0 if w is None else w(w0)


def _replace(experts, name, part, fn):
    t = experts[name]
    q, s = (fn(t.q), t.s) if part == "q" else (t.q, fn(t.s))
    return {**experts, name: QuantizedArray(q, s, t.bits, t.groups, t.scheme)}


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


_CONTRACT = {
    "slice-decode": (_with(), True),
    "int32-ids-fp32-gates": (_with(idx=lambda t: t.int(), w=lambda t: t.float()), True),
    "16rows": (_with(N=16), True),
    "64rows": (_with(N=64), True),
    "80rows": (_with(N=80), True),  # one launch pair per 64 rows
    "k8": (_with(k=8), True),
    "x-noncontiguous": (_with(x=lambda t: t.t().contiguous().t()), True),  # copied
    "x-misaligned": (_with(x=_misaligned), True),  # copied
    "h-256-m-128": (_with(h=256, m=128), True),
    "h-not-multiple-of-256": (_with(h=384), False),
    "m-not-multiple-of-128": (_with(m=320), False),
    "h-past-2048": (_with(h=2304, m=128, layers=1), False),
    "m-past-2048": (_with(h=256, m=2176, layers=1), False),
    "k9": (_with(k=9), False),
    "fp32-x": (_with(x=lambda t: t.float()), False),
    "bf16-tables": (_with(tables=lambda ex: {n: t.q.bfloat16() for n, t in ex.items()}), False),
    "int8-tables": (_with(tables=lambda ex: {n: quantize_array(torch.ones(t.q.shape[0], E, H, M) if n != "down_proj"
                                                                 else torch.ones(t.q.shape[0], E, M, H), 8)
                                              for n, t in ex.items()}), False),
    "int8-bytes": (_with(tables=lambda ex: _replace(ex, "up_proj", "q", lambda q: q.view(torch.int8))), False),
    "fp16-scales": (_with(tables=lambda ex: _replace(ex, "down_proj", "s", lambda s: s.half())), False),
    "bytes-noncontiguous": (_with(tables=lambda ex: _replace(ex, "gate_proj", "q",
                                                             lambda q: q.transpose(2, 3).contiguous().transpose(2, 3))),
                            False),
    "bytes-misaligned": (_with(tables=lambda ex: _replace(ex, "up_proj", "q", _misaligned)), False),
    "scales-misaligned": (_with(tables=lambda ex: _replace(ex, "gate_proj", "s", _misaligned)), False),
    "down-shape": (_with(tables=lambda ex: {**ex, "down_proj": ex["gate_proj"]}), False),
    "int16-ids": (_with(idx=lambda t: t.short()), False),
    "fp16-gates": (_with(w=lambda t: t.half()), False),
    "ids-rows": (_with(idx=lambda t: t[:1]), False),
    "gates-k": (_with(w=lambda t: t[:, :5]), False),
}


@pytest.mark.parametrize("case", list(_CONTRACT))
def test_moe_stream_q4s8_contract(case):
    (experts, x, idx, w), takes = _CONTRACT[case]
    if not takes:
        with pytest.raises(ValueError):
            ms.check_q4s8_inputs(experts, x, idx, w, layer_idx=1 if experts["gate_proj"].shape[0] > 1 else 0)
        return
    got_x, ptrs, got_idx, got_w, (E_, h, m) = ms.check_q4s8_inputs(experts, x, idx, w, layer_idx=1)
    assert got_x.is_contiguous() and got_x.data_ptr() % 16 == 0 and torch.equal(got_x, x)
    # layer 1's six tensors, by address: no copy
    assert ptrs == tuple(getattr(experts[n], part)[1].data_ptr() for n in ("gate_proj", "up_proj", "down_proj")
                         for part in ("q", "s"))
    assert (E_, h, m) == (E, 2 * experts["gate_proj"].q.shape[-2], experts["gate_proj"].q.shape[-1])
    assert got_idx is idx and got_w is w


def test_moe_stream_q4s8_contract_of_the_layer_index():
    """One layer's (E, ...) tables take no index; stacked ones need one within their depth."""
    experts, x, idx, w = _q4_case()
    one = {n: t[0] for n, t in experts.items()}
    assert ms.check_q4s8_inputs(one, x, idx, w)[1][0] == experts["gate_proj"].q[0].data_ptr()
    assert ms.check_q4s8_inputs(experts, x, idx, w, layer_idx=-1)[1][5] == experts["down_proj"].s[1].data_ptr()
    assert ms.check_q4s8_inputs(experts, x, idx, w, layer_idx=torch.tensor(1))[1][2] == \
        experts["up_proj"].q[1].data_ptr()
    with pytest.raises(ValueError, match="layer index"):
        ms.check_q4s8_inputs(experts, x, idx, w)
    for tables, layer in ((experts, 2), (experts, -3), (one, 0)):
        with pytest.raises(ValueError):
            ms.check_q4s8_inputs(tables, x, idx, w, layer_idx=layer)


def test_moe_stream_q4s8_contract_caps_the_experts():
    x, idx, w = torch.zeros(2, 256, dtype=torch.bfloat16), torch.zeros(2, 6, dtype=torch.int64), \
        torch.zeros(2, 6, dtype=torch.bfloat16)
    many = {n: quantize_array(torch.ones(1, ms.MAX_EXPERTS + 1, *((256, 128) if n != "down_proj" else (128, 256))), 4)
            for n in ("gate_proj", "up_proj", "down_proj")}
    with pytest.raises(ValueError):
        ms.check_q4s8_inputs(many, x, idx, w, layer_idx=0)


def test_shard_grouped_int4_tables_still_raise():
    """Tables packed per contraction group (groups > 1): the dispatch refuses
    them, and the kernel's checks too (their bytes are not one split-halves pack)."""
    experts = {n: quantize_array(torch.ones((E, H, M) if n != "down_proj" else (E, M, H)), 4, groups=2)
               for n in ("gate_proj", "up_proj", "down_proj")}
    x, idx, w = torch.zeros(2, H, dtype=torch.bfloat16), torch.zeros(2, 6, dtype=torch.int64), \
        torch.zeros(2, 6, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        ms.moe_experts_stream(experts, x, idx, w)
    with pytest.raises(ValueError):
        ms.check_q4s8_inputs(experts, x, idx, w)
