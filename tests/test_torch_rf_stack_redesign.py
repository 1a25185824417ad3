"""PyTorch port: the per-step RF stack (PERF.md row 8) as the stack mode of the
fused samplers' persistent body (`csrc/rf_sampler_q8.cu`: int8 exact, int8
s8 and int4 exact; `csrc/rf_sampler_q4.cu`: int4 s8), on the CPU.

- The int4 exact body's plane convert (`q4_mma.cuh` plane_s8): each byte's
  low and high nibble as the s8 weight n - 8, over all 256 bytes and inside
  words whose bytes must not borrow from each other.
- A plain-torch model of one Euler step as the kernel computes it: per block,
  x's operands over the whole row (digits on the row's fixed point, or s8
  values, or the int4 s8 pair); per CTA of a grid the integer dots of its
  stream-K run over the (tile, stage) units (the int8 geometry: up tiles of
  128 h columns, their gate and up columns, down tiles of 256 columns, stages
  of 64 rows, or of 64 packed rows whose two nibble planes meet the two
  halves of the contraction; the int4 s8 geometry: up tiles of 64 column
  pairs (j, j + H/2)), flushed once a tile (and, in the s8 bodies' down
  phase, once a piece), the contributions added in an arrival order drawn
  from a seed; the tile's last contributor's fp32 epilogue; h's operands from
  its row maxima; the down pieces' descaled sums in piece order (the int8 s8
  body each times s3, the int4 s8 one its two sums one after the other). It
  gives `rf_mlp_stack_plain`'s bits in all four bodies at 1-4 rows, fp32 and
  bf16, on grids of 1 to 132 CTAs, with the s8 bodies' h in several pieces.

The kernels run on the card only (tests/test_torch_kernels_cuda.py holds
them to the plain version's bits).
"""

import numpy as np
import pytest
import torch

from mingunivision_tpu_torch.config import RFHeadConfig
from mingunivision_tpu_torch.models.rf_head import _time_grid, precompute_modulations
from mingunivision_tpu_torch.ops.kernels import rf_mlp
from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, quant_rows_s8, quant_rows_s8_pair, split_bytes
from mingunivision_tpu_torch.utils.convert import _Init, init_rf_head_params
from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CHUNK = 128  # the int8 s8 body's columns of h quantized together here: four pieces of H = 512
KC = 128  # and the int4 s8 body's down pieces: two of H / 2 = 256 packed rows
BODIES = {"q4s8": (4, True), "q4": (4, False), "q8s8": (8, True), "q8": (8, False)}
ST, UP_COLS, UP_PAIRS, DOWN_COLS = rs.STAGE, rs.UP_COLS, rs.UP_PAIRS, rs.DOWN_COLS


# ---------------------------------------------------------------------------
# the int4 plane convert
# ---------------------------------------------------------------------------


def plane_s8(v):
    """q4_mma.cuh's plane_s8 on uint32 words (numpy uint64 holding them): the
    low nibble of each byte as the s8 byte n - 8."""
    return ((((v & 0x0F0F0F0F) | 0x80808080) - 0x08080808) ^ 0x80808080) & 0xFFFFFFFF


def test_plane_convert_over_every_byte():
    b = np.arange(256, dtype=np.uint64)
    lo = plane_s8(b).astype(np.uint8).view(np.int8)
    hi = plane_s8(b >> 4).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(lo, (b & 15).astype(np.int64) - 8)
    np.testing.assert_array_equal(hi, (b >> 4).astype(np.int64) - 8)
    # inside a word, byte by byte: no byte borrows from or carries into its neighbour (every byte value beside
    # every other at each position, and random words)
    rng = np.random.default_rng(0)
    words = np.concatenate([b * 0x01010101, b << 24 | 0x00F00F0, rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    for shift in (0, 4):
        got = plane_s8(words >> shift if shift else words)
        for k in range(4):
            byte = (words >> (8 * k)) & 0xFF
            want = (((byte >> shift) & 15).astype(np.int64) - 8) & 0xFF
            np.testing.assert_array_equal((got >> (8 * k)) & 0xFF, want)


# ---------------------------------------------------------------------------
# one Euler step as the kernel computes it
# ---------------------------------------------------------------------------


def _runs(units: int, grid: int):
    return [(rs.run_first(c, units, grid), rs.run_first(c + 1, units, grid)) for c in range(grid)]


def _arrived(parts, rng):
    """A tile's contributions added in a drawn arrival order (exact integers)."""
    total = torch.zeros_like(parts[0])
    for i in rng.permutation(len(parts)):
        total = total + parts[i]
    return total


def _streamed(units_per_tile, tiles, grid, partial, flush_at=None):
    """Each CTA's run over the tile-major units: its integer partials summed
    along the run and flushed at the tile's end, the run's end or (where
    flush_at(stage)) a piece's end -> {(tile, stage of the flush): [flushed]}."""
    parts: dict = {}
    for u0, u1 in _runs(tiles * units_per_tile, grid):
        acc = 0
        for u in range(u0, u1):
            tile, k = divmod(u, units_per_tile)
            acc = acc + partial(tile, k)
            piece_end = flush_at is not None and flush_at(k)
            if k == units_per_tile - 1 or u == u1 - 1 or piece_end:
                parts.setdefault((tile, k), []).append(acc)
                acc = 0
    return parts


def _by_piece(parts, kp):
    """{(tile, stage of the flush): [...]} -> {(tile, piece): [...]}, piece = stage // kp."""
    out: dict = {}
    for (tile, k), v in parts.items():
        out.setdefault((tile, k // kp), []).extend(v)
    return out


def _combined(acc, exact):
    """A flush of (ND, R, cols) partials: the exact bodies' digits combined, or the one s8 row."""
    return acc[0] + 256 * acc[1] + 65536 * acc[2] + 16777216 * acc[3] if exact else acc[0]


def _dot(S, scale, exact):
    """The dots' fp32 values from their exact sums: S 2^(E - 30) rounded once, or fp32(S) * the row scale."""
    return (S.double() * scale).float() if exact else S.double().float() * scale


def _block_int8_geometry(o, l, xs, H, cdt, bits, s8, ch, rng, grid):
    """One block of the int8 exact, int8 s8 and int4 exact bodies (rf_sampler_q8.cu's units)."""
    PL = 2 if bits == 4 else 1
    w = xs.shape[1]
    exact = not s8
    if bits == 4:  # the packed tables' two nibble planes, each an integer table of half the contraction
        q12 = o["q12"][l].long()
        p12 = ((q12 & 15) - 8, (q12 >> 4) - 8)
        q3 = o["q3"][l].long()
        p3 = ((q3 & 15) - 8, (q3 >> 4) - 8)
    else:
        p12, p3 = (o["q12"][l].long(),), (o["q3"][l].long(),)

    def operands(v):
        if exact:
            e, X = rs.fixed_point(v)
            return rs.digits(X), rs._pow2(e - rs.FIX)
        q, sc = quant_rows_s8(v)
        return q.long()[None], sc

    def stage_dot(op, planes, k, cols):
        """The stage's integer partial: its 64 rows of each plane against the operands of that plane's rows."""
        K = planes[0].shape[0]
        rows = slice(k * ST, (k + 1) * ST)
        return sum(op[:, :, p * K + k * ST : p * K + (k + 1) * ST] @ pl[rows][:, cols] for p, pl in enumerate(planes))

    xo, xsc = operands(xs.to(cdt).float() if exact else xs)
    Tu, KTu = -(-H // UP_COLS), (w // PL) // ST
    cols_of = lambda tile: torch.arange(tile * UP_COLS, min((tile + 1) * UP_COLS, H))  # noqa: E731
    parts = _streamed(KTu, Tu, grid,
                      lambda tile, k: stage_dot(xo, p12, k, torch.cat([cols_of(tile), H + cols_of(tile)])))
    parts = _by_piece(parts, KTu)
    h = torch.zeros((xs.shape[0], H))
    for (tile, _), contributions in parts.items():
        j = cols_of(tile)
        d = _dot(_combined(_arrived(contributions, rng), exact), xsc, exact)
        g = d[:, : j.numel()] * o["s12"][l, j] + o["b12"][l, j]
        u = d[:, j.numel() :] * o["s12"][l, H + j] + o["b12"][l, H + j]
        hv = rs.silu_exact(g) * u
        h[:, j] = hv.to(cdt).float() if exact else hv
    CH = ch if s8 else H
    if exact:
        ho, hsc = operands(h)
        hscs = [hsc]
    else:  # each piece on its own scale, from its row maxima
        hos, hscs = [], []
        for pc in range(H // CH):
            v = h[:, pc * CH : (pc + 1) * CH]
            sc = div_exact(v.abs().amax(-1, keepdim=True), 127.0) + 1e-12
            hos.append(torch.round(v / sc).long()[None])
            hscs.append(sc)
        ho = torch.cat(hos, dim=-1)
    Td, KTd, kp = -(-w // DOWN_COLS), (H // PL) // ST, (CH // PL) // ST
    dcols = lambda tile: torch.arange(tile * DOWN_COLS, min((tile + 1) * DOWN_COLS, w))  # noqa: E731
    parts = _by_piece(_streamed(KTd, Td, grid, lambda tile, k: stage_dot(ho, p3, k, dcols(tile)),
                                flush_at=lambda k: (k + 1) % kp == 0), kp)
    y = torch.zeros((xs.shape[0], w))
    for tile in range(Td):
        c = dcols(tile)
        if exact:
            y[:, c] = _dot(_combined(_arrived(parts[(tile, 0)], rng), True), hscs[0], True) * o["s3"][l, c] + o["b3"][l, c]
            continue
        acc = torch.zeros((xs.shape[0], c.numel()))
        for pc in range(H // CH):  # each piece's descaled sum times s3, added in piece order; then b3
            acc = acc + _dot(_combined(_arrived(parts[(tile, pc)], rng), False), hscs[pc], False) * o["s3"][l, c]
        y[:, c] = acc + o["b3"][l, c]
    return y


def _block_int4_s8(o, l, xs, H, cdt, kc, rng, grid):
    """One block of the int4 s8 body (rf_sampler_q4.cu's units)."""
    w, Hh = xs.shape[1], H // 2
    wq = w // 2
    a1, a2, sa1, sa2, corr = quant_rows_s8_pair(xs[:, :wq], xs[:, wq:])
    m12, bx12 = (t.long() for t in split_bytes(o["q12"][l]))
    m3, bx3 = (t.long() for t in split_bytes(o["q3"][l]))
    op_up = torch.stack([a1.long(), a2.long()])  # (2 dots, R, w / 2)
    Tu, KTu = -(-Hh // UP_PAIRS), -(-wq // ST)
    pairs = lambda tile: torch.arange(tile * UP_PAIRS, min((tile + 1) * UP_PAIRS, Hh))  # noqa: E731

    def cols(tile):  # gate j, gate H/2 + j, up H + j, up H + H/2 + j
        j = pairs(tile)
        return torch.cat([j, Hh + j, H + j, H + Hh + j])

    def up_dot(tile, k):
        rows = slice(k * ST, (k + 1) * ST)
        return torch.stack([op_up[0][:, rows] @ m12[rows][:, cols(tile)], op_up[1][:, rows] @ bx12[rows][:, cols(tile)]])

    parts = _by_piece(_streamed(KTu, Tu, grid, up_dot), KTu)
    h = torch.zeros((xs.shape[0], H))
    for (tile, _), contributions in parts.items():
        d = _arrived(contributions, rng).double().float()
        v = d[0] * sa1 + d[1] * (sa2 * (1.0 / 16.0)) - corr  # mm4_s8's epilogue
        c = cols(tile)
        v = v * o["s12"][l, c] + o["b12"][l, c]
        n = pairs(tile).numel()
        g_lo, g_hi, u_lo, u_hi = v[:, :n], v[:, n : 2 * n], v[:, 2 * n : 3 * n], v[:, 3 * n :]
        h[:, pairs(tile)] = (rs.silu_exact(g_lo) * u_lo).to(cdt).float()
        h[:, Hh + pairs(tile)] = (rs.silu_exact(g_hi) * u_hi).to(cdt).float()
    b1, b2, sb1, sb2, corrh = quant_rows_s8_pair(h[:, :Hh], h[:, Hh:])
    op_dn = torch.stack([b1.long(), b2.long()])
    Td, KTd, kp = -(-w // DOWN_COLS), -(-Hh // ST), kc // ST
    dcols = lambda tile: torch.arange(tile * DOWN_COLS, min((tile + 1) * DOWN_COLS, w))  # noqa: E731

    def down_dot(tile, k):
        rows = slice(k * ST, (k + 1) * ST)
        return torch.stack([op_dn[0][:, rows] @ m3[rows][:, dcols(tile)], op_dn[1][:, rows] @ bx3[rows][:, dcols(tile)]])

    parts = _by_piece(_streamed(KTd, Td, grid, down_dot, flush_at=lambda k: (k + 1) % kp == 0), kp)
    y = torch.zeros((xs.shape[0], w))
    for tile in range(Td):
        c = dcols(tile)
        acc = torch.zeros((xs.shape[0], c.numel()))
        for pc in range(-(-KTd // kp)):  # each piece's two descaled sums added one after the other
            d = _arrived(parts[(tile, pc)], rng).double().float()
            acc = (acc + d[0] * sb1) + d[1] * (sb2 * (1.0 / 16.0))
        y[:, c] = (acc - corrh) * o["s3"][l, c] + o["b3"][l, c]
    return y


def stack_model(blocks, x, mods, *, ln_eps, chunk, int_dots, grid=7, seed=0):
    """One Euler step of the stack as the kernel computes it on `grid` CTAs (see the module docstring)."""
    rng = np.random.default_rng(seed)
    bits = rf_mlp.stack_bits(blocks)
    o = rs.block_operands(blocks)
    L = o["q12"].shape[0]
    w, H = rf_mlp._width(blocks, bits)
    ch, kc = rf_mlp._tiling(H, chunk)
    xcur = x.float()
    for l in range(L):
        md = mods[l].float()
        xs = rs._modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, float(ln_eps))
        if bits == 4 and int_dots:
            y = _block_int4_s8(o, l, xs, H, x.dtype, kc, rng, grid)
        else:
            y = _block_int8_geometry(o, l, xs, H, x.dtype, bits, int_dots, ch, rng, grid)
        xcur = xcur + md[:, 2 * w :] * y
    return xcur.to(x.dtype)


def _head(bits):
    # width 256 (two 64-row packed stages an int4 up tile, four int8 ones; one down tile), SwiGLU hidden 512 (four
    # up tiles of 128 h columns, four of 64 column pairs)
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=256, depth=2, mlp_mult=3, num_sampling_steps=4)
    g = torch.Generator().manual_seed(50 + bits)
    rf = init_rf_head_params(cfg, _Init(torch.device("cpu"), torch.float32, g))
    rng = np.random.default_rng(bits)
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"] = torch.from_numpy((0.05 * rng.standard_normal(tuple(leaf["w"].shape))).astype(np.float32))
    quantize_tree_inplace(rf, bits=bits, min_size=1024)
    return cfg, rf


@pytest.fixture(scope="module")
def heads():
    return {bits: _head(bits) for bits in (4, 8)}


def _case(cfg, rf, rows, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, cfg.width), generator=g).to(dtype)
    z = torch.randn((rows, cfg.z_channels), generator=g)
    ts, _ = _time_grid(cfg, None)
    mods = precompute_modulations(rf, cfg, ts, z)[0][:, 3].float()  # step 3's (L, rows, 3w)
    return x, mods


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("body", list(BODIES))
def test_stack_model_is_the_plain_versions_bits(heads, body, rows, dtype, monkeypatch):
    """The model on 7 CTAs (runs that split tiles and pieces, drawn arrival
    orders) against `rf_mlp_stack_plain`: the same bits in every body."""
    monkeypatch.setattr(rf_mlp, "KC_Q4S8", KC)
    bits, s8 = BODIES[body]
    cfg, rf = heads[bits]
    x, mods = _case(cfg, rf, rows, dtype, seed=rows)
    kw = dict(ln_eps=cfg.ln_eps, chunk=CHUNK, int_dots=s8)
    want = rf_mlp.rf_mlp_stack_plain(rf["res_blocks"], x, mods, **kw)
    got = stack_model(rf["res_blocks"], x, mods, seed=rows, **kw)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("grid", [1, 5, 132])
@pytest.mark.parametrize("body", list(BODIES))
def test_stack_model_bits_do_not_depend_on_the_grid(heads, body, grid, monkeypatch):
    """1 CTA (one run over every unit), 5, and more CTAs than units (empty
    runs): the plain version's bits at 3 rows, bf16, with its pieces."""
    monkeypatch.setattr(rf_mlp, "KC_Q4S8", KC)
    bits, s8 = BODIES[body]
    cfg, rf = heads[bits]
    x, mods = _case(cfg, rf, 3, torch.bfloat16, seed=11)
    kw = dict(ln_eps=cfg.ln_eps, chunk=CHUNK, int_dots=s8)
    want = rf_mlp.rf_mlp_stack_plain(rf["res_blocks"], x, mods, **kw)
    np.testing.assert_array_equal(stack_model(rf["res_blocks"], x, mods, grid=grid, seed=grid, **kw).float().numpy(),
                                  want.float().numpy())


def test_stack_pieces_and_units_at_full_width():
    """At the 16B-A3B width (w 3072, H 8192): the int8 s8 body's four
    2,048-column pieces of h, the int4 s8 body's four 1,024-row down pieces,
    and each geometry's units (the exact int4 body: half the stages of the
    int8 one over the same tiles)."""
    ch, kc = rf_mlp._tiling(8192, rf_mlp.CHUNK)
    assert (8192 // ch, 4096 // kc) == (4, 4)
    assert rs.q8_units(3072, 8192) == (64, 48, 12, 128)
    assert rs.q4_units(3072, 8192) == (64, 24, 12, 64)
    assert rs.q8_workspace_sizes(3072, 8192, 4)[1] > rs.q8_workspace_sizes(3072, 8192, 2)[1]
