"""PyTorch port: what surrounds the prefill MoE's tensor-core body
(`csrc/swiglu_wgmma.cuh`), which runs the bf16 kernel (`csrc/moe_swiglu_gmm.cu`,
row 2) and the exact modes of the int4 one (`csrc/moe_swiglu_gmm_q4.cu`,
row 5) and of the int8 one (`csrc/moe_swiglu_gmm_q8.cu`, row 7c), on the CPU.

- A plain-torch model of the body's arithmetic: the schedule's tiles of at
  most 128 rows, per tile g and u as fp32 sums over stages of 64 contraction
  rows added in stage order, a = silu(g) * u rounded to bf16, the down dot
  the same way; for rows 5 and 7c the table's integers as exact operands
  (int8: each stage 64 consecutive table rows, the transposed product's
  register A; int4: each stage holding
  packed rows p0..p0+31, i.e. contraction rows p0..p0+31 (low nibbles) and
  K/2+p0..K/2+p0+31 (high nibbles) against the activations' columns at the
  same two offsets), the scales after the dots, s2 at the store. Held within
  BF16_REL against the plain version (`swiglu_rows_plain` behind the
  dispatch) and against the JAX package's Pallas kernels (`_kernel`,
  `_kernel_q4_chunked`, `_kernel_q8_chunked`) in interpret mode, on
  numpy-seeded inputs: experts with 0, 1, 127, 128 and 129 rows, all rows on
  one expert, a spread top-2 routing, and through the capacity dispatch
  (fitting, with an expert of 129 slots, and overflowing: the sorted
  fallback).
- In float64, that the stage order and the nibble-plane permutation take
  every contraction row once (the exact dot), that the nibble convert the
  kernel makes in registers (0x4300 | n is 128 + n, minus 136) and the byte
  convert of int8 tables into register A (a byte r beside 0x43, its sign bit
  cleared, minus the word masked to 0xFF80) are exact for every value, and that the
  intermediate's column order for int4 tables gives each down stage its two
  planes' columns as one box.
- The schedules: each (table kind, mode) reads its tile rows from the
  library that launches it (`tile_rows`: the wgmma body's 128, the s8-dot
  and full-block kernels' 32, read here from the sources through a
  stand-in library), and both dispatches' schedules at those rows cover each
  row once, never straddle an expert and never hand a 32-row kernel a longer
  tile; every kernel that reads a schedule traps on a longer tile.

Tolerance, relative to the largest output: BF16_REL = 1e-2, the bound the
card's tests hold these kernels to (`_close_bf16` in
tests/test_torch_kernels_cuda.py, REL_TOL in chip_smoke.py): the outputs are
bf16 and fp32 sums in another order flip roundings of a and of the output,
one ulp of an output near the maximum being 2^-8 to 2^-7 of it. The kernels
themselves run on the card only (tests/test_torch_kernels_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm as jax_swiglu_gmm
from mingunivision_tpu.utils.quantize import quantize_array as jax_quantize_array
from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels import moe_swiglu_gmm as msg
from mingunivision_tpu_torch.ops.kernels.moe_capacity import (
    capacity_schedule,
    expert_rank,
    moe_experts_capacity_gmm_exact_plain,
)
from mingunivision_tpu_torch.ops.kernels.moe_stream import layer_tables, nibbles, table_kind
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import quantize_array
import test_torch_common  # noqa: F401  (one torch thread per test worker)

BF16_REL = 1e-2
E, H, M = 8, 256, 384  # 128-aligned, as the Pallas kernels need
BK = 64  # contraction rows per stage of the body's ring (32 packed rows for int4 tables)
TIERS = ["bf16", "int4", "int8"]  # the body's three table kinds
CSRC = Path(msg.__file__).resolve().parents[2] / "csrc"

# rows per expert (k = 1): the tile's edges, and all rows on one expert (three tiles, the last of 44 rows)
LOADS = {"0-1-127-128-129": [0, 1, 127, 128, 129, 3, 64, 65], "all-on-one": [0, 0, 0, 0, 0, 300, 0, 0]}


def _source_int(name: str, pattern: str) -> int:
    return int(re.search(pattern, (CSRC / name).read_text()).group(1))


# each kernel's tile rows as its source defines them
BODY_ROWS = _source_int("swiglu_wgmma.cuh", r"constexpr int BM = (\d+);")
Q4_ROWS = _source_int("moe_swiglu_gmm_q4.cu", r"constexpr int TM = (\d+);")  # the int4 s8 and full-block kernels
Q8_ROWS = _source_int("moe_swiglu_gmm_q8.cu", r"constexpr int TM = (\d+);")  # the int8 s8 kernels


# ---------------------------------------------------------------------------
# the body's arithmetic
# ---------------------------------------------------------------------------


def stage_rows(K: int, q4: bool):
    """The contraction rows of each stage of the ring, in stage order: BK
    consecutive rows, or for packed int4 tables the 32 packed rows' two planes
    (rows p0..p0+31, then K/2+p0..K/2+p0+31)."""
    if not q4:
        return [torch.arange(k0, k0 + BK) for k0 in range(0, K, BK)]
    half, p = K // 2, BK // 2
    return [torch.cat([torch.arange(p0, p0 + p), torch.arange(half + p0, half + p0 + p)]) for p0 in range(0, half, p)]


def staged_dot(a, w, q4: bool):
    """a (R, K) . w (K, N) as the consumers sum it: one partial per stage, the
    partials added in stage order (fp32 for fp32 operands)."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=a.dtype)
    for idx in stage_rows(w.shape[0], q4):
        acc = acc + a[:, idx] @ w[idx]
    return acc


def _bf16_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bf16 bit patterns (below 0x8000) as float64 values."""
    return bits.to(torch.int16).view(torch.bfloat16).double()


def bytes_bf16(q: torch.Tensor) -> torch.Tensor:
    """The body's int8 convert (csrc/swiglu_wgmma.cuh `byte_pair_bf16`) of an
    int8 tensor: each byte r beside 0x43 is the bf16 0x43rr; with its sign bit
    cleared that is 128 + (r & 127), masked to 0xFF80 it is 128 or 256, and
    the kernel subtracts the two in bf16. The difference, taken in float64,
    must be a bf16 value (so the kernel's subtraction rounds nothing)."""
    t = 0x4300 | (q.to(torch.int32) & 0xFF)
    d = _bf16_bits(t & 0xFF7F) - _bf16_bits(t & 0xFF80)
    out = d.to(torch.bfloat16)
    assert torch.equal(out.double(), d)
    return out


def body_rows_model(experts, xr, sched, layer_idx=None):
    """ys (R, h) bf16 of the two launches over the schedule: rows of no tile
    stay zero. xr (R, h): each scheduled row's activations (x read through
    the row map); tables bf16, linear int4 or int8 (the bytes converted
    exactly, `bytes_bf16`)."""
    kind = table_kind("body_rows_model", experts)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    q4 = kind == "int4"
    unscaled = {"int4": nibbles, "int8": lambda q: bytes_bf16(q).float()}.get(kind)
    ys = torch.zeros((xr.shape[0], w2.shape[-1] if unscaled is None else w2.q.shape[-1]), dtype=torch.bfloat16)
    for e, r0, r1 in sched.tolist():
        if r0 >= r1:
            continue
        assert r1 - r0 <= BODY_ROWS
        xt = xr[r0:r1].float()
        if unscaled is not None:
            t1, t3, t2 = unscaled(w1.q[e]), unscaled(w3.q[e]), unscaled(w2.q[e])
            g, u = staged_dot(xt, t1, q4) * w1.s[e], staged_dot(xt, t3, q4) * w3.s[e]
        else:
            t1, t3, t2 = w1[e].float(), w3[e].float(), w2[e].float()
            g, u = staged_dot(xt, t1, False), staged_dot(xt, t3, False)
        a = (F.silu(g) * u).to(torch.bfloat16).float()
        y = staged_dot(a, t2, q4)
        ys[r0:r1] = (y if unscaled is None else y * w2.s[e]).to(torch.bfloat16)
    return ys


def sorted_dispatch_model(experts, x, idx, w, layer_idx=None):
    """The expert-sorted dispatch over the body: 128-row tiles, the rows
    un-sorted and combined (fp32, gate-weighted) as the wrapper does."""
    order, row_token, sched = msg.group_schedule(idx.long(), E, BODY_ROWS)
    ys = body_rows_model(experts, x[row_token.long()], sched, layer_idx)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel())
    return msg.combine_assignments(ys.index_select(0, inv), w, x.dtype)


def capacity_dispatch_model(experts, x, idx, w, capacity, layer_idx=None):
    """The capacity dispatch over the body when every load fits: the slots'
    schedule at 128-row tiles, each assignment's row gathered back by slot."""
    N, k = idx.shape
    flat_e = idx.reshape(-1)
    rank, sizes = expert_rank(flat_e, E)
    dst, _, sched, ok = capacity_schedule(flat_e, rank, sizes, E, capacity, BODY_ROWS)
    assert bool(ok.all())
    row_token = torch.zeros(E * capacity + 1, dtype=torch.long)
    row_token[dst] = torch.arange(N * k) // k
    ys = body_rows_model(experts, x[row_token[: E * capacity]], sched, layer_idx)
    return msg.combine_assignments(ys.index_select(0, dst), w, x.dtype)


def _inputs(seed, tier, loads=None, n=96, k=2):
    """bf16 tables (or int4 / int8 tables of fp32 weights, the JAX package's
    and the port's), bf16 x, routing: k = 1 with the given loads, else top-k
    spread."""
    rng = np.random.default_rng(seed)
    shapes = {"gate_proj": (2, E, H, M), "up_proj": (2, E, H, M), "down_proj": (2, E, M, H)}
    raw = {name: (0.05 * rng.standard_normal(s)).astype(np.float32) for name, s in shapes.items()}
    if tier == "bf16":
        jex = {name: jnp.asarray(v, jnp.bfloat16) for name, v in raw.items()}
        tex = {name: torch.from_numpy(v).to(torch.bfloat16) for name, v in raw.items()}
    else:
        jex = {name: jax_quantize_array(jnp.asarray(v), int(tier[3:])) for name, v in raw.items()}
        tex = params_from_jax(jex, "cpu")
    if loads is not None:
        ids = rng.permutation(np.repeat(np.arange(E), loads)).astype(np.int32)[:, None]
        wts = np.ones_like(ids, dtype=np.float32)
    else:
        ids = np.stack([rng.permutation(E)[:k] for _ in range(n)]).astype(np.int32)
        wts = rng.random((n, k)).astype(np.float32)
        wts /= wts.sum(-1, keepdims=True)
    x = torch.from_numpy(rng.standard_normal((ids.shape[0], H)).astype(np.float32)).to(torch.bfloat16)
    return jex, tex, x, torch.from_numpy(ids), torch.from_numpy(wts).to(torch.bfloat16)


def _close(got, want, rel=BF16_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


CASES = {**{name: dict(loads=loads) for name, loads in LOADS.items()}, "spread-top2": dict(n=96, k=2)}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", list(CASES))
def test_body_model_matches_the_plain_version_and_pallas(tier, case):
    jex, tex, x, idx, w = _inputs(61, tier, **CASES[case])
    got = sorted_dispatch_model(tex, x, idx, w, layer_idx=1)
    _close(got.float(), msg.moe_experts_swiglu_gmm_plain(tex, x, idx, w, E, layer_idx=1).float())
    want = jax_swiglu_gmm(jex, jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(idx.numpy()),
                          jnp.asarray(w.float().numpy()), E, tm=128, interpret=True, layer_idx=1)
    _close(got.float(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", ["fits-with-an-expert-of-129", "overflow"])
def test_body_model_through_the_capacity_dispatch(tier, case):
    """The capacity dispatch at 256 slots an expert: when the loads fit, the
    body over the slots' 128-row tiles (an expert of 129 slots takes a tile of
    128 and one of 1) against the dispatch's plain version; on overflow the
    dispatch runs the sorted one, whose model it then equals."""
    loads = [129, 128, 127, 1, 0, 64, 256, 2] if case.startswith("fits") else [300, 10, 0, 0, 0, 0, 0, 0]
    _, tex, x, idx, w = _inputs(62, tier, loads=loads)
    want = moe_experts_capacity_gmm_exact_plain(tex, x, idx, w, E, 256, layer_idx=0)
    got = capacity_dispatch_model(tex, x, idx, w, 256, layer_idx=0) if case.startswith("fits") else \
        sorted_dispatch_model(tex, x, idx, w, layer_idx=0)
    _close(got.float(), want.float())


def test_body_model_rounds_a_to_bf16_before_the_down_dot():
    """Without the bf16 rounding of a, the model leaves the plain version
    (which rounds as the JAX kernel's `.astype(x.dtype)` does) by more than the
    rounding's own size: the rounding is part of the arithmetic held."""
    _, tex, x, idx, w = _inputs(63, "bf16", n=64, k=2)
    order, row_token, sched = msg.group_schedule(idx.long(), E, BODY_ROWS)
    xr = x[row_token.long()].float()
    w1, w3, w2 = layer_tables(tex, 1)
    rounded = body_rows_model(tex, x[row_token.long()], sched, layer_idx=1).float()
    e, r0, r1 = next(t for t in sched.tolist() if t[2] > t[1])
    g, u = staged_dot(xr[r0:r1], w1[e].float(), False), staged_dot(xr[r0:r1], w3[e].float(), False)
    unrounded = staged_dot(F.silu(g) * u, w2[e].float(), False)
    assert torch.equal(rounded[r0:r1], staged_dot((F.silu(g) * u).to(torch.bfloat16).float(), w2[e].float(),
                                                  False).to(torch.bfloat16).float())
    assert not torch.equal(rounded[r0:r1], unrounded.to(torch.bfloat16).float())


@pytest.mark.parametrize("K", [128, 256, 2048])
def test_stage_order_takes_every_contraction_row_once(K):
    """In float64 the staged dot is the dot, for dense rows and for the two
    nibble planes of packed ones, and the stages' rows are a permutation."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((5, K)))
    w = torch.from_numpy(rng.standard_normal((K, 24)))
    for q4 in (False, True):
        rows = torch.cat(stage_rows(K, q4))
        assert torch.equal(rows.sort().values, torch.arange(K))
        torch.testing.assert_close(staged_dot(a, w, q4), a @ w, rtol=1e-12, atol=1e-12)
    q = torch.from_numpy(rng.integers(0, 256, (K // 2, 24)).astype(np.uint8))
    torch.testing.assert_close(staged_dot(a, nibbles(q).double(), True), a @ nibbles(q).double(), rtol=1e-12,
                               atol=1e-12)


def a_column(c: int, m: int) -> int:
    """The body's `a_column` (csrc/swiglu_wgmma.cuh): where the up launch
    stores a's column c of m for int4 tables."""
    half = m // 2
    plane = int(c >= half)
    cc = c - plane * half
    return 64 * (cc // 32) + 32 * plane + cc % 32


@pytest.mark.parametrize("m", [128, 384, 1408])
def test_the_intermediate_column_order_gives_each_down_stage_one_box(m):
    """For int4 tables the intermediate holds a's columns permuted so that the
    down launch's stage kt (packed rows 32 kt.., both nibble planes: a's
    columns 32 kt..32 kt+31 and m/2+32 kt..) is the 64 stored columns from
    64 kt on, one TMA box; the source computes the same map."""
    pos = [a_column(c, m) for c in range(m)]
    assert sorted(pos) == list(range(m))
    for kt, idx in enumerate(stage_rows(m, True)):
        assert [pos[c] for c in idx.tolist()] == list(range(64 * kt, 64 * kt + 64))
    assert "64 * (cc / kPackedRows) + kPackedRows * plane + cc % kPackedRows" in (CSRC / "swiglu_wgmma.cuh").read_text()


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of y:x."""
    pool = (y << 32) | x
    return sum(((pool >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _bf16_pair(word: int):
    bits = np.array([word & 0xFFFF, word >> 16], np.uint32) << 16
    return bits.view(np.float32)


def test_nibble_convert_in_registers_is_exact():
    """The kernel's convert of four packed bytes into bf16 pairs (the bytes
    beside 0x43 by __byte_perm, the low nibble masked in place, the high one
    shifted down, each 0x430n = 128 + n, minus 136): every byte value in
    every position gives its low and high nibble minus 8, exactly."""
    rng = np.random.default_rng(64)
    for pos in range(4):
        for b in range(256):
            others = rng.integers(0, 256, 4)
            others[pos] = b
            w = int(sum(int(v) << (8 * i) for i, v in enumerate(others)))
            got_lo, got_hi = [], []
            for sel in (0x4140, 0x4342):
                t = _byte_perm(w, 0x43, sel)
                got_lo += list(_bf16_pair(t & 0xFF0FFF0F) - 136.0)
                got_hi += list(_bf16_pair(((t >> 4) & 0x000F000F) | 0x43004300) - 136.0)
            assert got_lo == [float((int(v) & 15) - 8) for v in others]
            assert got_hi == [float((int(v) >> 4) - 8) for v in others]


def test_byte_convert_into_register_a_is_exact():
    """The int8 convert of a word of table bytes into bf16 pairs (the bytes
    beside 0x43 by __byte_perm, as `byte_pair_bf16`'s selectors 0x4240 and
    0x4341 pick them from two rows' byte pairs, the word with the sign bits
    cleared minus the word masked to 0xFF80), in float64: every byte value in
    every position of a word gives its signed value, -128..127, and that value
    is a bf16 (the kernel's bf16 subtraction is exact). Row 5's shortcut,
    0x4300 | n minus a constant, is not: past n = 127 the bit of 128 leaves
    bf16's 7-bit mantissa (0x4380 is 256)."""
    rng = np.random.default_rng(68)
    for pos in range(4):
        for b in range(256):
            others = rng.integers(0, 256, 4)
            others[pos] = b
            w = int(sum(int(v) << (8 * i) for i, v in enumerate(others)))
            got = []
            for sel in (0x4240, 0x4341):  # bytes (0, 2), then (1, 3)
                t = _byte_perm(w, 0x43, sel)
                v, m = t & 0xFF7FFF7F, t & 0xFF80FF80
                pair = _bf16_pair(v).astype(np.float64) - _bf16_pair(m).astype(np.float64)
                assert np.array_equal(torch.from_numpy(pair).to(torch.bfloat16).double().numpy(), pair)
                got += list(pair)
            assert got == [float(int(others[i]) - 256 * (int(others[i]) >> 7)) for i in (0, 2, 1, 3)]
    assert float(_bf16_pair(0x4300 | 0x81)[0]) - 128.0 != 0x81  # the nibble trick does not reach a full byte
    q = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(bytes_bf16(q).double(), q.double())


# ---------------------------------------------------------------------------
# each kernel's tile rows and the schedules built at them
# ---------------------------------------------------------------------------


class _Library:
    """A stand-in for the kernel library's tile-row queries, answering what
    each source defines."""

    @staticmethod
    def mu_swiglu_gmm_tile_rows():
        return BODY_ROWS

    @staticmethod
    def mu_swiglu_gmm_q4_tile_rows(s8):
        return Q4_ROWS if s8 else BODY_ROWS

    @staticmethod
    def mu_swiglu_gmm_q8_tile_rows(s8):
        return Q8_ROWS if s8 else BODY_ROWS

    @staticmethod
    def mu_swiglu_gmm_full_tile_rows():
        return Q4_ROWS


# (table kind, s8, full_block) -> the rows of the kernel `swiglu_gmm_rows` launches for them
MODES = {("plain", False, False): BODY_ROWS, ("int4", False, False): BODY_ROWS, ("int4", True, False): Q4_ROWS,
         ("int8", False, False): BODY_ROWS, ("int8", True, False): Q8_ROWS, ("int4", False, True): Q4_ROWS,
         ("int8", False, True): Q4_ROWS}


def _tables(kind):
    g = torch.Generator().manual_seed(65)
    ex = {n: torch.randn(s, generator=g).to(torch.bfloat16) * 0.05
          for n, s in {"gate_proj": (E, 128, 128), "up_proj": (E, 128, 128), "down_proj": (E, 128, 128)}.items()}
    return ex if kind == "plain" else {n: quantize_array(t, int(kind[3:])) for n, t in ex.items()}


def test_the_tile_rows_of_each_kernel(monkeypatch):
    """The body (bf16, int4 and int8 exact) takes 128 rows; the s8-dot and
    full-block kernels 32; each mode asks the library for its own kernel's
    rows."""
    assert (BODY_ROWS, Q4_ROWS, Q8_ROWS) == (128, 32, 32)
    monkeypatch.setattr(build, "load", _Library)
    assert {mode: msg.tile_rows(*mode) for mode in MODES} == MODES


def _routings(seed):
    rng = np.random.default_rng(seed)
    spread = np.stack([rng.permutation(E)[:6] for _ in range(128)])
    skewed = np.stack([rng.permutation([0, 3, 5, 6, 7])[:2] for _ in range(300)])
    edges = rng.permutation(np.repeat(np.arange(E), LOADS["0-1-127-128-129"]))[:, None]
    return {"spread-top6": spread, "skewed-3-empty": skewed, "edges-k1": edges}


@pytest.mark.parametrize("mode", list(MODES), ids=["-".join(map(str, m)) for m in MODES])
def test_sorted_schedule_covers_every_row_once_at_its_kernels_rows(mode, monkeypatch):
    monkeypatch.setattr(build, "load", _Library)
    kind, s8, full = mode
    tables = _tables(kind)
    for name, ids in _routings(66).items():
        idx = torch.from_numpy(ids.astype(np.int64))
        order, row_token, sched = msg.sorted_schedule(tables, idx, E, s8=s8, full_block=full)
        flat = idx.reshape(-1)[order]
        cover = torch.zeros(flat.numel(), dtype=torch.long)
        for e, r0, r1 in sched.tolist():
            assert 0 <= r1 - r0 <= MODES[mode], (name, r1 - r0)
            assert bool((flat[r0:r1] == e).all())  # no tile straddles an expert
            cover[r0:r1] += 1
        assert bool((cover == 1).all()), name


@pytest.mark.parametrize("mode", list(MODES)[:5], ids=["-".join(map(str, m)) for m in list(MODES)[:5]])
def test_capacity_schedule_covers_every_slot_once_at_its_kernels_rows(mode, monkeypatch):
    """The capacity dispatch's schedule at each kernel's rows (`tile_rows` of
    the table kind and dot mode, as `moe_capacity` asks): tiles over the
    occupied slots only, each slot once, none longer than the kernel's rows."""
    monkeypatch.setattr(build, "load", _Library)
    kind, s8, _ = mode
    tile = msg.tile_rows(kind, s8)
    C = 320
    for name, ids in _routings(67).items():
        flat = torch.from_numpy(ids.reshape(-1).astype(np.int64))
        rank, sizes = expert_rank(flat, E)
        dst, row_expert, sched, ok = capacity_schedule(flat, rank, sizes, E, C, tile)
        assert bool(ok.all())
        cover = torch.zeros(E * C, dtype=torch.long)
        for e, r0, r1 in sched.tolist():
            assert 0 <= r1 - r0 <= tile, (name, r1 - r0)
            assert bool((row_expert[r0:r1] == e).all())
            cover[r0:r1] += 1
        assert torch.equal(cover, (row_expert >= 0).long()), name


def test_every_scheduled_kernel_refuses_a_longer_tile():
    """Every CUDA kernel that reads a schedule tile (expert, first row, end
    row) traps when the tile is longer than its rows: the wgmma body (of
    all three table kinds) at BM, the 32-row kernels at TM; so a 32-row
    kernel is never handed a longer tile without an error."""
    sources = {"swiglu_wgmma.cuh": "BM", "moe_swiglu_gmm_q4.cu": "TM", "moe_swiglu_gmm_q8.cu": "TM"}
    for name, rows in sources.items():
        text = (CSRC / name).read_text()
        kernels = re.split(r"__global__ void", text)[1:]
        scheduled = [k for k in kernels if "sched[3 * tile + 2]" in k]
        assert scheduled, name
        for body in scheduled:
            head = body[: body.index("__syncthreads")]  # before the block's first barrier
            assert f"if (r1 - r0 > {rows}) __trap();" in head, (name, body[:80])
    for client in ("moe_swiglu_gmm.cu", "moe_swiglu_gmm_q4.cu", "moe_swiglu_gmm_q8.cu"):
        assert '#include "swiglu_wgmma.cuh"' in (CSRC / client).read_text(), client
