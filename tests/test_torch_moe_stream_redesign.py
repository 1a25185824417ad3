"""PyTorch port: what surrounds the bf16 decode-MoE kernel (`csrc/moe_stream.cu`), on the CPU.

- A plain-torch model of the routing each block of the kernel builds from the
  top-k ids and gates (the routed experts as a bit set, slot s the s-th in
  ascending id, each row's routed slots in ascending order with the gates of
  duplicate assignments summed), held against `expert_slots`, which the int4
  and int8 wrappers still build on the device.
- A plain-torch model of the kernel's arithmetic (per slot: h = silu(x w1) *
  (x w3) rounded to x's dtype, y = h w2 in fp32; each row's output the sum of
  gate * y over its slots in ascending order), and the plain version, held
  against the JAX package's Pallas kernel in interpret mode at N 1, 2, 3 and
  16, with all rows on one expert and with N k > E, on numpy-seeded inputs.
- The workspace the wrapper sizes (`workspace_sizes`, `rows_pad`), kept per
  device and stream, and the wrapper's argument checks
  (`check_stream_inputs`), case by case.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.moe_stream import moe_experts_stream as jax_moe_experts_stream
from mingunivision_tpu_torch.ops.kernels import moe_stream as ms
import test_torch_common  # noqa: F401  (one torch thread per test worker)

TOL = dict(rtol=2e-4, atol=2e-4)  # fp32, two frameworks' sums (as the JAX package's own kernel tests)
E, H, M = 8, 256, 384


# ---------------------------------------------------------------------------
# the routing built in the kernel
# ---------------------------------------------------------------------------


def routing_model(topk_idx, topk_w, num_experts):
    """What every block of the kernel builds: the routed experts in ascending
    id (ids outside [0, E) dropped), each slot's gate column (N,) fp32 summed
    over the row's assignments to its expert in order, and each row's
    (slot, gate) list, slots ascending. Returns (experts, gate columns (U, N),
    rows)."""
    N, k = topk_idx.shape
    ids = topk_idx.long()
    valid = (ids >= 0) & (ids < num_experts)
    routed = sorted({int(e) for e in ids[valid]})
    slot = {e: s for s, e in enumerate(routed)}
    w = topk_w.float()
    cols = torch.zeros(len(routed), N)
    rows = []
    for n in range(N):
        pairs = {}
        for j in range(k):
            e = int(ids[n, j])
            if not valid[n, j]:
                continue
            s = slot[e]
            pairs[s] = pairs[s] + w[n, j] if s in pairs else w[n, j]
            cols[s, n] += w[n, j]
        rows.append(sorted(pairs.items()))
    return routed, cols, rows


def _routing(N, k, num_experts, seed, kind="spread"):
    rng = np.random.default_rng(seed)
    if kind == "one-expert":  # every row routes to expert 3 (and, past k = 1, to the same others)
        idx = np.tile(np.concatenate([[3], rng.permutation([e for e in range(num_experts) if e != 3])[:k - 1]]),
                      (N, 1))
    else:
        idx = np.stack([rng.permutation(num_experts)[:k] for _ in range(N)])
    w = rng.random((N, k)).astype(np.float32)
    return idx.astype(np.int64), w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("N,k,num_experts,kind", [(2, 6, 64, "spread"), (16, 6, 64, "spread"), (16, 6, 8, "spread"),
                                                  (3, 2, 8, "one-expert"), (16, 1, 8, "one-expert"),
                                                  (48, 6, 64, "spread"), (1, 8, 1024, "spread")])
def test_routing_model_matches_expert_slots(N, k, num_experts, kind):
    idx, w = _routing(N, k, num_experts, seed=N + k, kind=kind)
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)
    routed, cols, rows = routing_model(tidx, tw, num_experts)
    slot_expert, gates, n_unique = ms.expert_slots(tidx, tw, num_experts)
    U = int(n_unique)
    assert U == len(routed) and slot_expert.numel() == min(N * k, num_experts)
    assert slot_expert[:U].tolist() == routed
    torch.testing.assert_close(cols, gates[:U], rtol=0, atol=1e-7)
    assert not gates[U:].any()  # slots past the routed ones carry no gate
    for n, pairs in enumerate(rows):  # each row's list: its routed slots, ascending, with the column's gate
        assert [s for s, _ in pairs] == sorted(s for s in range(U) if gates[s, n] != 0)
        for s, g in pairs:
            torch.testing.assert_close(g, gates[s, n], rtol=0, atol=1e-7)


def test_routing_model_drops_ids_out_of_range_and_sums_duplicates():
    """An id outside [0, E) routes nowhere, and an expert named twice in a row
    is one slot with the two gates summed, in the kernel's list as in
    `expert_slots`."""
    idx = torch.tensor([[0, 9, 0], [-1, 2, 2]])
    w = torch.tensor([[0.5, 0.25, 0.125], [0.25, 0.5, 0.25]])
    routed, cols, rows = routing_model(idx, w, 8)
    slot_expert, gates, n_unique = ms.expert_slots(idx, w, 8)
    assert routed == [0, 2] == slot_expert[:int(n_unique)].tolist()
    assert [[(s, float(g)) for s, g in pairs] for pairs in rows] == [[(0, 0.625)], [(1, 0.75)]]
    torch.testing.assert_close(cols, gates[:2], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the kernel's arithmetic against the plain version and the Pallas kernel
# ---------------------------------------------------------------------------


def kernel_model(experts, x, topk_idx, topk_w):
    """What the up and down launches compute, slot by slot in ascending expert
    id: h = silu(x w1[e]) * (x w3[e]) in fp32, rounded to x's dtype; y = h w2[e]
    in fp32 for every row; then each row's output the fp32 sum, over its
    slots in ascending order, of the slot's summed gate times y, in x's dtype."""
    w1, w3, w2 = experts["gate_proj"], experts["up_proj"], experts["down_proj"]
    routed, _, rows = routing_model(topk_idx, topk_w, w1.shape[0])
    xf = x.float()
    ys = []
    for e in routed:
        h = (torch.nn.functional.silu(xf @ w1[e].float()) * (xf @ w3[e].float())).to(x.dtype).float()
        ys.append(h @ w2[e].float())
    out = torch.zeros(x.shape[0], w2.shape[-1])
    for n, pairs in enumerate(rows):
        for s, g in pairs:
            out[n] += g * ys[s][n]
    return out.to(x.dtype)


def _moe_inputs(N, k, kind, seed):
    rng = np.random.default_rng(seed)
    experts = {"gate_proj": (0.05 * rng.standard_normal((E, H, M))).astype(np.float32),
               "up_proj": (0.05 * rng.standard_normal((E, H, M))).astype(np.float32),
               "down_proj": (0.05 * rng.standard_normal((E, M, H))).astype(np.float32)}
    x = rng.standard_normal((N, H)).astype(np.float32)
    idx, w = _routing(N, k, E, seed + 1, kind)
    return experts, x, idx.astype(np.int32), w


@pytest.mark.parametrize("N,k,kind", [(1, 2, "spread"), (2, 6, "spread"), (3, 4, "spread"), (16, 6, "spread"),
                                      (16, 1, "one-expert"), (3, 2, "one-expert")],
                         ids=["1row", "2rows", "3rows", "16rows-Nk>E", "16rows-one-expert", "3rows-same-experts"])
def test_kernel_model_and_plain_match_pallas(N, k, kind):
    experts, x, idx, w = _moe_inputs(N, k, kind, seed=40 + N)
    assert kind != "spread" or N < 16 or N * k > E  # the dedup case aggregates slots
    want = np.asarray(jax_moe_experts_stream({n: jnp.asarray(t) for n, t in experts.items()}, jnp.asarray(x),
                                             jnp.asarray(idx), jnp.asarray(w), interpret=True))
    tex = {n: torch.from_numpy(t) for n, t in experts.items()}
    tx, tidx, tw = torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w)
    plain = ms.moe_experts_stream_bf16_plain(tex, tx, tidx, tw)
    model = kernel_model(tex, tx, tidx, tw)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(model.numpy(), want, **TOL)


def test_kernel_model_in_bf16_rounds_h_as_the_plain_version():
    """In bf16 both round h to bf16 before the down product: they agree within
    the output's own rounding."""
    experts, x, idx, w = _moe_inputs(2, 6, "spread", seed=5)
    tex = {n: torch.from_numpy(t).bfloat16() for n, t in experts.items()}
    tx, tidx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(idx), torch.from_numpy(w).bfloat16()
    plain, model = ms.moe_experts_stream_bf16_plain(tex, tx, tidx, tw), kernel_model(tex, tx, tidx, tw)
    assert plain.dtype == model.dtype == torch.bfloat16
    assert (plain.float() - model.float()).abs().max() <= 1e-2 * plain.float().abs().max()


# ---------------------------------------------------------------------------
# the workspace and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,pad", [(1, 8), (2, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                   (48, 64), (64, 64)])
def test_rows_pad_is_whole_n_tiles(N, pad):
    assert ms.rows_pad(N) == pad


def test_workspace_sizes_at_the_decode_shapes():
    """16B-A3B tables (E 64, h 2048, m 1408), top-6: the T2I step's 2 rows take
    12 slots, a 16-slot serving step 64 (at most E)."""
    assert ms.workspace_sizes(2, 6, 64, 2048, 1408) == (12 * 1408 * 8, 12 * 2 * 2048, 16)
    assert ms.workspace_sizes(16, 6, 64, 2048, 1408) == (64 * 1408 * 16, 64 * 16 * 2048, 16)
    assert ms.workspace_sizes(1, 2, 8, 256, 384) == (2 * 384 * 8, 2 * 256, 2)


def test_workspace_is_kept_per_stream_and_grows():
    dev = torch.device("cpu")
    small, large = ms.workspace_sizes(2, 6, 64, 2048, 1408), ms.workspace_sizes(16, 6, 64, 2048, 1408)
    hbuf, ypart, tickets = ms._workspace(small, dev, stream=3001)
    assert hbuf.dtype == torch.bfloat16 and ypart.dtype == torch.float32 and tickets.dtype == torch.int32
    assert (hbuf.numel(), ypart.numel(), tickets.numel()) == small and not tickets.any()
    assert ms._workspace(small, dev, stream=3001)[0] is hbuf  # reused, not allocated again
    assert ms._workspace(small, dev, stream=3002)[0] is not hbuf  # another stream has its own
    grown = ms._workspace(large, dev, stream=3001)
    assert grown[0].numel() == large[0] and grown[1].numel() == large[1]
    assert ms._workspace(small, dev, stream=3001)[1] is grown[1]  # a smaller call keeps the larger buffers
    for key in [(None, 3001), (None, 3002)]:
        ms._workspaces.pop(key)


def test_wrapper_on_cpu_takes_the_plain_version_without_a_workspace():
    experts, x, idx, w = _moe_inputs(3, 4, "spread", seed=9)
    tex = {n: torch.from_numpy(t)[None] for n, t in experts.items()}  # stacked, one layer
    args = (tex, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    before, spaces = ms.moe_experts_stream.launches, dict(ms._workspaces)
    torch.testing.assert_close(ms.moe_experts_stream(*args, layer_idx=0),
                               ms.moe_experts_stream_bf16_plain(*args, layer_idx=0))
    assert ms.moe_experts_stream.launches == before and ms._workspaces == spaces


def _bf16_case(N=2, k=6, h=256, m=384, layers=2):
    experts = {"gate_proj": torch.zeros(layers, E, h, m, dtype=torch.bfloat16),
               "up_proj": torch.zeros(layers, E, h, m, dtype=torch.bfloat16),
               "down_proj": torch.zeros(layers, E, m, h, dtype=torch.bfloat16)}
    return experts, torch.zeros(N, h, dtype=torch.bfloat16), torch.zeros(N, k, dtype=torch.int64), \
        torch.zeros(N, k, dtype=torch.bfloat16)


def _with(tables=None, x=None, idx=None, w=None, **shape):
    experts, x0, idx0, w0 = _bf16_case(**shape)
    if tables is not None:
        experts = tables(experts)
    return experts, x0 if x is None else x(x0), idx0 if idx is None else idx(idx0), w0 if w is None else w(w0)


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


_CONTRACT = {
    "slice-decode": (_with(), True),
    "int32-ids-fp32-gates": (_with(idx=lambda t: t.int(), w=lambda t: t.float()), True),
    "16rows": (_with(N=16), True),
    "48rows": (_with(N=48), True),
    "k8": (_with(k=8), True),
    "x-noncontiguous": (_with(x=lambda t: t.t().contiguous().t()), True),  # copied
    "x-misaligned": (_with(x=_misaligned), True),  # copied
    "h-not-multiple-of-32": (_with(h=240), False),
    "m-not-multiple-of-8": (_with(m=380), False),
    "h-past-8192": (_with(h=8224, m=8), False),
    "k9": (_with(k=9), False),
    "fp32-x": (_with(x=lambda t: t.float()), False),
    "fp32-tables": (_with(tables=lambda ex: {n: t.float() for n, t in ex.items()}), False),
    "table-noncontiguous": (_with(tables=lambda ex: {**ex, "up_proj": ex["up_proj"].transpose(2, 3).contiguous()
                                                     .transpose(2, 3)}), False),
    "down-shape": (_with(tables=lambda ex: {**ex, "down_proj": ex["gate_proj"]}), False),
    "int16-ids": (_with(idx=lambda t: t.short()), False),
    "fp16-gates": (_with(w=lambda t: t.half()), False),
    "ids-rows": (_with(idx=lambda t: t[:1]), False),
    "gates-k": (_with(w=lambda t: t[:, :5]), False),
}


@pytest.mark.parametrize("case", list(_CONTRACT))
def test_moe_stream_contract(case):
    (experts, x, idx, w), takes = _CONTRACT[case]
    if not takes:
        with pytest.raises(ValueError):
            ms.check_stream_inputs(experts, x, idx, w, layer_idx=1)
        return
    got_x, ptrs, got_idx, got_w, (E_, h, m) = ms.check_stream_inputs(experts, x, idx, w, layer_idx=1)
    assert got_x.is_contiguous() and got_x.data_ptr() % 16 == 0 and torch.equal(got_x, x)
    # layer 1's tables, by address: no copy
    assert ptrs == tuple(experts[n][1].data_ptr() for n in ("gate_proj", "up_proj", "down_proj"))
    assert (E_, h, m) == experts["gate_proj"].shape[1:] and got_idx is idx and got_w is w


def test_moe_stream_contract_of_the_layer_index():
    """One layer's (E, h, m) tables take no index; stacked ones need one within their depth (negative
    counts from the end, as indexing does)."""
    experts, x, idx, w = _bf16_case()
    one = {n: t[0] for n, t in experts.items()}
    assert ms.check_stream_inputs(one, x, idx, w)[1][0] == experts["gate_proj"][0].data_ptr()
    assert ms.check_stream_inputs(experts, x, idx, w, layer_idx=-1)[1][2] == experts["down_proj"][1].data_ptr()
    assert ms.check_stream_inputs(experts, x, idx, w, layer_idx=torch.tensor(1))[1][1] == \
        experts["up_proj"][1].data_ptr()
    for tables, layer in ((experts, 2), (experts, -3), (one, 0)):
        with pytest.raises(ValueError):
            ms.check_stream_inputs(tables, x, idx, w, layer_idx=layer)


def test_moe_stream_contract_needs_the_layer_of_a_stacked_table():
    experts, x, idx, w = _bf16_case()
    with pytest.raises(ValueError, match="layer index"):
        ms.check_stream_inputs(experts, x, idx, w)


def test_moe_stream_contract_caps_the_experts():
    _, x, idx, w = _bf16_case(h=32, m=8, layers=1)
    many = {n: torch.zeros(1, ms.MAX_EXPERTS + 1, *shape, dtype=torch.bfloat16)
            for n, shape in (("gate_proj", (32, 8)), ("up_proj", (32, 8)), ("down_proj", (8, 32)))}
    with pytest.raises(ValueError):
        ms.check_stream_inputs(many, x, idx, w, layer_idx=0)
