"""PyTorch port: what surrounds the int8 decode-MoE kernel's s8-dot mode
(`csrc/moe_stream_q8.cu`, `mu_moe_stream_q8s8`, row 7a) and the int4 one's
exact mode (`csrc/moe_stream_q4.cu`, `mu_moe_stream_q4`, row 7e), both on the
int4 s8 mode's two-launch body, on the CPU.

- A plain-torch model of 7a's arithmetic: the routing each block builds from
  the top-k ids and gates (`routing_model`, shared with the bf16 kernel's
  tests), the rows of x quantized once to s8, per slot the integer dots of
  each table summed stage by stage (64 rows a stage, the kernel's order), the
  fp32 epilogue times the row and column scales, h = silu(g) * u re-quantized
  per row over all of m once per slot (the up launch's last block, from the
  128-column tiles' maxima), the down dot the same way, and each row's merge
  over its slots in ascending order, each product rounded before the sum.
  Held to the bit against `moe_experts_stream_q8s8_plain`, and within S8_REL
  against the JAX package's Pallas kernel (`_kernel_q8_s8`) in interpret mode.
- A model of 7e's arithmetic: the nibbles as bf16 operands (exact), x's bf16
  values, fp32 sums per nibble plane stage by stage, the planes added, the
  column scales, h = silu(g) * u rounded to bf16, the down dots the same way,
  and the merge. Held within EXACT_REL against `moe_experts_stream_q4_plain`
  and the Pallas kernel (`_kernel_q4`) in interpret mode.
  Both at 1, 2, 3, 12 and 16 rows, with N k > E, all rows on one expert, a
  row naming an expert twice and ids outside [0, E), on numpy-seeded inputs.
- The workspaces the wrappers size (`q8s8_workspace_sizes`,
  `q4_workspace_sizes`), kept per device and stream, the rows each launches
  per pair, the CPU wrappers taking the plain versions without a workspace,
  and the argument checks (`check_q8s8_inputs`), case by case.

Tolerances, relative to the largest output: S8_REL = 1e-4 (the same integer
dots, the fp32 epilogue in another order: test_torch_kernels_int8);
EXACT_REL = 4e-3 (fp32 sums in another order, which admits one bf16 rounding
of h that flips: test_torch_kernels_modes). The kernels themselves run on the
card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels import moe_stream as jstream
from mingunivision_tpu.utils.quantize import quantize_array as jax_quantize_array
from mingunivision_tpu_torch.ops.kernels import moe_stream as ms
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, silu_exact
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, quantize_array
import test_torch_common  # noqa: F401  (one torch thread per test worker)
from test_torch_moe_stream_redesign import routing_model

S8_REL = 1e-4
EXACT_REL = 4e-3
E, H, M = 8, 256, 384  # whole 128-column tiles, as the kernels and the Pallas kernels need
STAGE = 64  # rows (7a) or packed rows (7e) per stage of the kernels' ring
UP_TILE = 128  # columns of m per up block


# ---------------------------------------------------------------------------
# the kernels' arithmetic against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------


def quant_rows_model(rows, tile=None):
    """The kernel's s8 quantization of fp32 rows (n, w): the row maximum of
    |v| (with `tile`, per tile of that many columns, then over the tiles), the
    scale max / 127 + 1e-12, the values rounded half to even. Returns (q as
    int64, scale (n, 1) fp32)."""
    a = rows.abs()
    mx = a.amax(dim=-1, keepdim=True) if tile is None else \
        a.reshape(a.shape[0], -1, tile).amax(dim=-1).amax(dim=-1, keepdim=True)
    sc = div_exact(mx, 127.0) + 1e-12
    return torch.round(rows / sc).long(), sc


def s8_dots_model(q, a, sa, scale):
    """One int8 (K, cols) table against s8 rows a (n, K): the integer dot
    summed a stage of 64 rows at a time as the ring streams them, then times
    the row scale and the column scale, each step rounded in fp32."""
    d = torch.zeros(a.shape[0], q.shape[1], dtype=torch.long)
    for k0 in range(0, q.shape[0], STAGE):
        d += a[:, k0:k0 + STAGE] @ q[k0:k0 + STAGE].long()
    return (d.float() * sa) * scale


def q8s8_model(experts, x, topk_idx, topk_w, layer_idx=None):
    """What 7a's up and down launches compute, slot by slot in ascending expert
    id (x's rows quantized in each block, h from the up tiles' maxima), and the
    merge of the last block of each column tile."""
    w1, w3, w2 = ms.layer_tables(experts, layer_idx)
    routed, _, rows = routing_model(topk_idx, topk_w, w1.q.shape[0])
    xq, sx = quant_rows_model(x.float())
    ys = []
    for e in routed:
        g = s8_dots_model(w1.q[e], xq, sx, w1.s[e])
        u = s8_dots_model(w3.q[e], xq, sx, w3.s[e])
        h = silu_exact(g) * u  # fp32, into the workspace
        ys.append(s8_dots_model(w2.q[e], *quant_rows_model(h, tile=UP_TILE), w2.s[e]))  # h re-quantized once
    out = torch.zeros(x.shape[0], w2.q.shape[-1])
    for n, pairs in enumerate(rows):
        for s, gate in pairs:
            out[n] = out[n] + gate * ys[s][n]
    return out.to(x.dtype)


def bf16_dots_model(q, rows, scale):
    """One split-halves packed (K/2, cols) table against rows (n, K) holding bf16
    values: each nibble plane's products (exact) summed in fp32 a stage of 64
    packed rows at a time, the low plane against rows[:, :K/2] and the high
    against rows[:, K/2:]; the planes added, times the column scale."""
    half = q.shape[0]
    lo, hi = ((q & 0xF).float() - 8.0), ((q >> 4).float() - 8.0)
    d_lo = torch.zeros(rows.shape[0], q.shape[1])
    d_hi = torch.zeros_like(d_lo)
    for k0 in range(0, half, STAGE):
        d_lo += rows[:, k0:k0 + STAGE] @ lo[k0:k0 + STAGE]
        d_hi += rows[:, half + k0:half + k0 + STAGE] @ hi[k0:k0 + STAGE]
    return (d_lo + d_hi) * scale


def q4_exact_model(experts, x, topk_idx, topk_w, layer_idx=None):
    """What 7e's up and down launches compute, slot by slot in ascending expert
    id (x's values as the bf16 operand, h rounded to bf16 in the workspace),
    and the merge of the last block of each column tile."""
    w1, w3, w2 = ms.layer_tables(experts, layer_idx)
    routed, _, rows = routing_model(topk_idx, topk_w, w1.q.shape[0])
    xb = x.float()
    ys = []
    for e in routed:
        g = bf16_dots_model(w1.q[e], xb, w1.s[e])
        u = bf16_dots_model(w3.q[e], xb, w3.s[e])
        h = (silu_exact(g) * u).to(x.dtype).float()
        ys.append(bf16_dots_model(w2.q[e], h, w2.s[e]))
    out = torch.zeros(x.shape[0], w2.q.shape[-1])
    for n, pairs in enumerate(rows):
        for s, gate in pairs:
            out[n] = out[n] + gate * ys[s][n]
    return out.to(x.dtype)


def _tables(seed, bits, layers=None):
    """Linear int4 or int8 tables quantized by the JAX package (its bytes and scales)."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M), "down_proj": (E, M, H)}
    return {k: jax_quantize_array(jnp.asarray(0.05 * rng.standard_normal(lead + s), jnp.float32), bits)
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

# mode: (bits, the model, the plain version, the JAX package's int-dot flag for its tier, held to the bit, rel)
MODES = {"7a-q8s8": (8, q8s8_model, ms.moe_experts_stream_q8s8_plain, "INT_DOT_STREAM_INT8", True, True, S8_REL),
         "7e-q4-exact": (4, q4_exact_model, ms.moe_experts_stream_q4_plain, "INT_DOT_STREAM", False, False,
                         EXACT_REL)}


def _case(mode, case):
    bits = MODES[mode][0]
    N, k, kind = CASES[case]
    tables = _tables(80 + N + bits, bits, layers=2)
    idx, w = _routing(N, k, 90 + N, kind)
    x = np.random.default_rng(100 + N).standard_normal((N, H)).astype(np.float32)
    jidx, jw = idx, w
    if kind == "out-of-range":  # dropped by the kernels; the Pallas kernel gets the same as a zero gate on expert 0
        idx = idx.copy()
        idx[0, 1], idx[1, 3] = E, -1
        jidx, jw = idx.copy(), w.copy()
        jidx[(idx < 0) | (idx >= E)] = 0
        jw[(idx < 0) | (idx >= E)] = 0.0
    return tables, x, idx, w, jidx, jw


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_model_matches_the_plain_version_and_pallas(mode, case, monkeypatch):
    _, model, plain_fn, flag, int_dots, bitwise, rel = MODES[mode]
    tables, x, idx, w, jidx, jw = _case(mode, case)
    ex = params_from_jax(tables, "cpu")
    args = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    got = model(ex, *args, layer_idx=1)
    plain = plain_fn(ex, *args, layer_idx=1)
    if bitwise:
        assert torch.equal(got, plain)
    else:
        _close(got.numpy(), plain.numpy(), rel)
    # the dispatching wrapper takes that plain version for CPU tensors in the mode's dot mode
    assert torch.equal(ms.moe_experts_stream(ex, *args, layer_idx=1, int_dots=int_dots), plain)
    monkeypatch.setattr(jstream, flag, int_dots)
    want = jstream.moe_experts_stream(tables, jnp.asarray(x), jnp.asarray(jidx), jnp.asarray(jw), interpret=True,
                                      layer_idx=1)
    _close(got.numpy(), want, rel)


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_model_in_bf16(mode):
    """bf16 rows and gates, as the LLM step passes them: a bf16 output, 7a the
    plain version's bits, 7e within its tolerance."""
    bits, model, plain_fn, _, _, bitwise, rel = MODES[mode]
    ex = params_from_jax(_tables(7 + bits, bits), "cpu")
    idx, w = _routing(2, 6, 8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, H)).astype(np.float32)).bfloat16()
    args = (x, torch.from_numpy(idx).long(), torch.from_numpy(w).bfloat16())
    got, plain = model(ex, *args), plain_fn(ex, *args)
    assert got.dtype == torch.bfloat16
    if bitwise:
        assert torch.equal(got, plain)
    else:
        _close(got.float().numpy(), plain.float().numpy(), rel)


def test_q8s8_h_is_quantized_over_all_of_m_once_per_slot():
    """Per row, the down operand's scale is the maximum over the up tiles'
    maxima, that of all of m: quantizing each 128-column tile apart gives
    other bits, quantizing from the tiles' maxima the same."""
    h = torch.from_numpy(np.random.default_rng(11).standard_normal((3, M)).astype(np.float32))
    h[:, M // 4] *= 50.0  # a large value in the first tile moves the row's scale
    whole, tiled = quant_rows_model(h), quant_rows_model(h, tile=UP_TILE)
    assert torch.equal(whole[0], tiled[0]) and torch.equal(whole[1], tiled[1])
    first = quant_rows_model(h[:, UP_TILE:2 * UP_TILE])
    assert not torch.equal(first[1], whole[1])  # a tile's own scale is not the row's
    assert torch.equal(whole[0].abs().amax(dim=-1), torch.full((3,), 127, dtype=torch.long))


def test_q4_exact_nibbles_are_exact_bf16_operands():
    """Every nibble's weight (-8..7) and every bf16 value times it are exact in
    fp32: only the sums' order differs from the plain version's."""
    q = torch.arange(256, dtype=torch.int32).to(torch.uint8)[:, None]
    both = torch.cat([(q & 0xF).float() - 8.0, (q >> 4).float() - 8.0])
    assert torch.equal(both.bfloat16().float(), both) and both.min() == -8 and both.max() == 7
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(4096).astype(np.float32)).bfloat16()
    assert torch.equal((x.double() * 7).float(), x.float() * 7)


# ---------------------------------------------------------------------------
# the workspaces and the wrappers
# ---------------------------------------------------------------------------


def test_workspace_sizes_at_the_decode_shapes():
    """16B-A3B tables (E 64, h 2048, m 1408), top-6: the T2I step's 2 rows take
    12 slots, a 16-slot serving step 64 (at most E)."""
    assert ms.q8s8_workspace_sizes(2, 6, 64, 2048, 1408) == (12 * 2 * 2048, 12 * 8 * 1424, 8 + 12)
    assert ms.q8s8_workspace_sizes(16, 6, 64, 2048, 1408) == (64 * 16 * 2048, 64 * 16 * 1424, 8 + 64)
    # h's tiles' row maxima outgrow the down products where m + m / 128 > h
    assert ms.q8s8_workspace_sizes(64, 8, 1024, 256, 384) == (512 * 64 * 387, 512 * 64 * 400, 1 + 512)
    assert ms.q8s8_workspace_sizes(1, 2, 8, 256, 384) == (2 * 387, 2 * 8 * 400, 1 + 2)
    assert ms.q4_workspace_sizes(2, 6, 64, 2048, 1408) == (12 * 2 * 2048, 12 * 2 * 1408, 8)
    assert ms.q4_workspace_sizes(16, 6, 64, 2048, 1408) == (64 * 16 * 2048, 64 * 16 * 1408, 8)
    assert ms.q4_workspace_sizes(32, 8, 1024, 256, 384) == (256 * 32 * 256, 256 * 32 * 384, 1)


@pytest.mark.parametrize("kind", ["q8s8", "q4"])
def test_workspace_is_kept_per_stream_and_grows(kind):
    dev = torch.device("cpu")
    sizes, workspace, store, dtype = {
        "q8s8": (ms.q8s8_workspace_sizes, ms._q8s8_workspace, ms._q8s8_workspaces, torch.int8),
        "q4": (ms.q4_workspace_sizes, ms._q4_workspace, ms._q4_workspaces, torch.bfloat16)}[kind]
    small, large = sizes(2, 6, 64, 2048, 1408), sizes(16, 6, 64, 2048, 1408)
    fbuf, hbuf, tickets = workspace(small, dev, stream=5001)
    assert fbuf.dtype == torch.float32 and hbuf.dtype == dtype and tickets.dtype == torch.int32
    assert (fbuf.numel(), hbuf.numel(), tickets.numel()) == small and not tickets.any()
    assert workspace(small, dev, stream=5001)[1] is hbuf  # reused, not allocated again
    assert workspace(small, dev, stream=5002)[1] is not hbuf  # another stream has its own
    grown = workspace(large, dev, stream=5001)
    assert tuple(t.numel() for t in grown) == large and not grown[2].any()
    assert workspace(small, dev, stream=5001)[0] is grown[0]  # a smaller call keeps the larger buffers
    assert (None, 5001) not in ms._q4s8_workspaces and (None, 5001) not in ms._workspaces  # the others' are apart
    for key in [(None, 5001), (None, 5002)]:
        store.pop(key)


@pytest.mark.parametrize("N,chunks", [(1, [(0, 1)]), (32, [(0, 32)]), (33, [(0, 32), (32, 1)]),
                                      (80, [(0, 32), (32, 32), (64, 16)])])
def test_the_exact_mode_takes_one_launch_pair_per_32_rows(N, chunks):
    assert list(ms.row_chunks(N, ms.Q4_ROWS_PER_LAUNCH)) == chunks


@pytest.mark.parametrize("mode", list(MODES))
def test_wrapper_on_cpu_takes_the_plain_version_without_a_workspace(mode):
    bits, _, plain_fn, _, int_dots, _, _ = MODES[mode]
    wrapper = ms.moe_experts_stream_q8s8 if bits == 8 else ms.moe_experts_stream_q4
    ex = params_from_jax(_tables(12, bits, layers=1), "cpu")
    idx, w = _routing(3, 4, 13)
    args = (ex, torch.from_numpy(np.ones((3, H), np.float32)).bfloat16(), torch.from_numpy(idx), torch.from_numpy(w))
    stores = (ms._q8s8_workspaces, ms._q4_workspaces, ms._q4s8_workspaces)
    before, spaces = wrapper.launches, [dict(st) for st in stores]
    want = plain_fn(*args, layer_idx=0)
    assert torch.equal(wrapper(*args, layer_idx=0), want)
    assert torch.equal(ms.moe_experts_stream(*args, layer_idx=0, int_dots=int_dots), want)
    assert wrapper.launches == before and [dict(st) for st in stores] == spaces


def _q8_case(N=2, k=6, h=H, m=M, layers=2):
    shapes = {"gate_proj": (layers, E, h, m), "up_proj": (layers, E, h, m), "down_proj": (layers, E, m, h)}
    experts = {n: quantize_array(torch.ones(sh), 8) for n, sh in shapes.items()}
    return experts, torch.zeros(N, h, dtype=torch.bfloat16), torch.zeros(N, k, dtype=torch.int64), \
        torch.zeros(N, k, dtype=torch.bfloat16)


def _with(tables=None, x=None, idx=None, w=None, **shape):
    experts, x0, idx0, w0 = _q8_case(**shape)
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
    "int4-tables": (_with(tables=lambda ex: {n: quantize_array(torch.ones(t.q.shape), 4) for n, t in ex.items()}),
                    False),
    "uint8-bytes": (_with(tables=lambda ex: _replace(ex, "up_proj", "q", lambda q: q.view(torch.uint8))), False),
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
def test_moe_stream_q8s8_contract(case):
    (experts, x, idx, w), takes = _CONTRACT[case]
    if not takes:
        with pytest.raises(ValueError):
            ms.check_q8s8_inputs(experts, x, idx, w, layer_idx=1 if experts["gate_proj"].shape[0] > 1 else 0)
        return
    got_x, ptrs, got_idx, got_w, (E_, h, m) = ms.check_q8s8_inputs(experts, x, idx, w, layer_idx=1)
    assert got_x.is_contiguous() and got_x.data_ptr() % 16 == 0 and torch.equal(got_x, x)
    # layer 1's six tensors, by address: no copy
    assert ptrs == tuple(getattr(experts[n], part)[1].data_ptr() for n in ("gate_proj", "up_proj", "down_proj")
                         for part in ("q", "s"))
    assert (E_, h, m) == (E, experts["gate_proj"].q.shape[-2], experts["gate_proj"].q.shape[-1])
    assert got_idx is idx and got_w is w


def test_moe_stream_q8s8_contract_of_the_layer_index():
    """One layer's (E, ...) tables take no index; stacked ones need one within their depth."""
    experts, x, idx, w = _q8_case()
    one = {n: t[0] for n, t in experts.items()}
    assert ms.check_q8s8_inputs(one, x, idx, w)[1][0] == experts["gate_proj"].q[0].data_ptr()
    assert ms.check_q8s8_inputs(experts, x, idx, w, layer_idx=-1)[1][5] == experts["down_proj"].s[1].data_ptr()
    with pytest.raises(ValueError, match="layer index"):
        ms.check_q8s8_inputs(experts, x, idx, w)
    for tables, layer in ((experts, 2), (experts, -3), (one, 0)):
        with pytest.raises(ValueError):
            ms.check_q8s8_inputs(tables, x, idx, w, layer_idx=layer)


def test_the_exact_int4_wrapper_checks_as_the_s8_one_under_its_own_name():
    """7e takes what row 4 takes (int4 tables by address, whole tiles): its checks name it."""
    experts, x, idx, w = _q8_case()
    with pytest.raises(ValueError, match="moe_experts_stream_q4:"):
        ms.check_q4s8_inputs(experts, x, idx, w, layer_idx=0, op="moe_experts_stream_q4")
    q4 = {n: quantize_array(torch.ones(t.q.shape), 4) for n, t in experts.items()}
    assert ms.check_q4s8_inputs(q4, x, idx, w, layer_idx=1, op="moe_experts_stream_q4")[4] == (E, H, M)
