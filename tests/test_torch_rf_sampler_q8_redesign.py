"""PyTorch port: the fused int8 RF sampler's redesign (`csrc/rf_sampler_q8.cu`,
`mu_rf_sampler_q8`) on the CPU.

- Digit dots, the exact mode's arithmetic (`rf_sampler._digit_dot`): each
  activation row on its own fixed point (X = rint(x 2^(30 - E)), E its largest
  magnitude's exponent), X as four balanced base-256 s8 digits, each digit's
  dot with the int8 table an exact integer, their combination the exact sum
  of X @ q, rounded once. Held against exact integer and `Fraction`
  arithmetic on random and adversarial rows (one large value among tiny ones,
  a row of zeros, a negative maximum, bf16 and fp32), and to the same bits
  under any permutation of the contraction: what makes the kernel's stream-K
  split and its arrival order free.
- A plain-torch model of the kernel's arithmetic in both dot modes: x's
  operands over the whole row (4 digits, or 1 s8 value); per CTA the integer
  dots of its run's (tile, stage) units (up tiles of 128 h columns: their gate
  and up columns; down tiles of 256 columns; 64-row stages), the digits
  combined before they are added per tile in a shuffled arrival order; the
  last contributor's fp32 epilogue (h, its row maxima: per CHUNK-column piece
  in the s8 mode); h's operands from those maxima; the down partials per
  piece, added in piece order. Held to the bit against `rf_sample_fused_plain`
  at 1-4 rows, with and without renorm, bf16 and fp32, at several grids and in
  several pieces; within EXACT_REL (the int8 kernel tests' tolerance) of the
  JAX package's `_sampler_q8` in interpret mode over the five cases of
  `test_rf_sample_fused_q8_plain_matches_pallas`, and within S8_REL in the s8
  mode.
- One Euler step of one block from a common state against the JAX kernel.
- The wrapper's workspace sizes (the library's `mu_rf_sampler_q8_workspace`
  is held to them on the card) and the unit partition at the 16B-A3B width.
- The plain versions this change left alone keep their bits: the per-step
  stack's s8 bodies, the s8 int8 sampler (row 7h) and the int4 sampler (row
  6), held to digests of their outputs before the change; the stack's exact
  bodies (row 8), since moved to digit dots as well, give the bits of the
  exact int8 sampler's block (`_mlp_q8`) block by block, and over int4 tables
  those of the digit dots with both nibble planes unpacked apart.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""

import hashlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import RFHeadConfig
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.config import RFHeadConfig as PortRFHeadConfig
from mingunivision_tpu_torch.models.rf_head import _time_grid as port_time_grid
from mingunivision_tpu_torch.models.rf_head import precompute_modulations as port_precompute_modulations
from mingunivision_tpu_torch.ops.kernels import rf_mlp
from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, quant_rows_s8
from mingunivision_tpu_torch.utils.convert import _Init, params_from_jax
from mingunivision_tpu_torch.utils.convert import init_rf_head_params as port_init_rf_head_params
from mingunivision_tpu_torch.utils.quantize import quantize_tree_inplace
import test_torch_common  # noqa: F401  (one torch thread per test worker)

EXACT_REL = 4e-3  # as tests/test_torch_kernels_int8.py: one bf16 rounding of h that flips under reassociation
S8_REL = 1e-4  # as tests/test_torch_kernels_modes.py: exact integer sums, the fp32 epilogue in another order
FULL = (3072, 8192)  # the 16B-A3B head's width and SwiGLU hidden


# ---------------------------------------------------------------------------
# digit dots
# ---------------------------------------------------------------------------


def _exact_reference(x, q):
    """(the rounded result, the exact real dot) of `_digit_dot` computed from
    Python integers and Fractions: E from frexp of the row's largest |x|, X =
    x 2^(30 - E) rounded half to even, the integer sum of X q, its value S
    2^(E - 30) rounded once to fp32 (S 2^(E - 30) is a double exactly)."""
    xs, qs = x.double().tolist(), q.long().tolist()
    R, K, N = len(xs), len(qs), len(qs[0])
    got = np.zeros((R, N), np.float32)
    real = np.zeros((R, N), np.float64)
    for r in range(R):
        E = int(np.frexp(np.float32(max(abs(v) for v in xs[r])))[1])
        X = [round(Fraction(v) * Fraction(2) ** (rs.FIX - E)) for v in xs[r]]  # round(): half to even
        assert all(abs(v) < 2**rs.FIX for v in X)
        for n in range(N):
            S = sum(X[k] * qs[k][n] for k in range(K))
            got[r, n] = np.float32(float(S) * 2.0 ** (E - rs.FIX))
            real[r, n] = float(sum(Fraction(xs[r][k]) * qs[k][n] for k in range(K)))
    return got, real


def _rows(kind, dtype, K, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, K), generator=g)
    if kind == "one-large":  # one large value among tiny ones: the tiny ones round on the large one's point
        x = x * 1e-6
        x[:, 7] = torch.tensor([300.0, -2.5, 1e-3, 7.0])
    elif kind == "zeros":
        x[1] = 0.0
        x[3, ::2] = 0.0
    elif kind == "negative-max":
        x[:, 3] = -torch.tensor([50.0, 1.0, 0.25, 1024.0])
    elif kind == "wide-range":  # rows scaled from 2^-20 to 2^20
        x = x * torch.tensor([2.0**-20, 1.0, 2.0**20, 3.0])[:, None]
    return x.to(dtype).float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["random", "one-large", "zeros", "negative-max", "wide-range"])
def test_digit_dot_is_the_exact_sum_rounded_once(kind, dtype):
    """`_digit_dot` equals the rounded exact sum of the fixed-point row with
    the table, to the bit; that sum lies within one fp32 rounding and the
    fixed point's quantization (|x| below 2^(E - 31) per element, bf16 values
    within 2^-22 of the row's largest exact) of the real dot."""
    x = _rows(kind, dtype, 96, seed=1)
    q = torch.randint(-127, 128, (96, 5), generator=torch.Generator().manual_seed(2)).to(torch.int8)
    got = rs._digit_dot(x, q)
    want, real = _exact_reference(x, q)
    np.testing.assert_array_equal(got.numpy(), want)
    E = np.frexp(x.abs().amax(-1).numpy())[1].astype(np.float64)[:, None]
    bound = np.abs(real) * 2.0**-24 + 96 * 127 * 2.0 ** (E - rs.FIX - 1)
    assert (np.abs(got.numpy().astype(np.float64) - real) <= bound).all()
    if kind == "zeros":
        assert not got[1].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digit_dot_bits_do_not_depend_on_the_contraction_order(seed):
    """Any permutation of the contraction, and any split of it into pieces
    whose integer partials are added later (the kernel's stream-K units),
    gives the same bits."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((3, 512), generator=g) * torch.rand((3, 512), generator=g) ** 8).to(torch.bfloat16).float()
    q = torch.randint(-127, 128, (512, 24), generator=g).to(torch.int8)
    want = rs._digit_dot(x, q)
    perm = torch.randperm(512, generator=g)
    assert torch.equal(rs._digit_dot(x[:, perm], q[perm]), want)
    e, X = rs.fixed_point(x)
    d = rs.digits(X)
    cuts = sorted(torch.randperm(511, generator=g)[:6].add(1).tolist())
    parts = [d[:, :, a:b] @ q[a:b].long() for a, b in zip([0] + cuts, cuts + [512])]
    S = sum(parts[i] for i in np.random.default_rng(seed).permutation(len(parts)))  # (DIGITS, R, N) int64
    S = S[0] + 256 * S[1] + 65536 * S[2] + 16777216 * S[3]
    assert torch.equal((S.double() * rs._pow2(e - rs.FIX)).float(), want)


def test_fixed_point_and_digits():
    """X within 2^30, E from frexp (0 for a row of zeros), four digits in
    [-128, 127] that rebuild X, bf16 values near the row's largest exact."""
    x = _rows("random", torch.bfloat16, 64, seed=3)
    x[2] = 0.0
    e, X = rs.fixed_point(x)
    assert e[2].item() == 0 and not X[2].any()
    assert (X.abs() < 2**rs.FIX).all()
    d = rs.digits(X)
    assert d.shape == (rs.DIGITS, *X.shape) and d.min() >= -128 and d.max() <= 127
    assert torch.equal(d[0] + 256 * d[1] + 65536 * d[2] + 16777216 * d[3], X)
    big = x.abs() >= x.abs().amax(-1, keepdim=True) * 2.0**-22
    assert torch.equal((X.double() * rs._pow2(e - rs.FIX))[big], x.double()[big])
    assert torch.equal(rs._pow2(torch.tensor([-179, 0, 98])), torch.tensor([2.0**-179, 1.0, 2.0**98], dtype=torch.float64))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, modeled
# ---------------------------------------------------------------------------


def _runs(units: int, grid: int):
    return [(rs.run_first(c, units, grid), rs.run_first(c + 1, units, grid)) for c in range(grid)]


def _arrived(parts, rng):
    """The contributions of one tile added in a shuffled arrival order (exact integers)."""
    total = torch.zeros_like(parts[0])
    for i in rng.permutation(len(parts)):
        total = total + parts[i]
    return total


def _combined(acc, s8):
    """A CTA's per-operand-row partials (ND, R, cols) as it adds them: the exact mode's digits combined."""
    return acc[0] if s8 else acc[0] + 256 * acc[1] + 65536 * acc[2] + 16777216 * acc[3]


def _dots(S, scale, s8):
    """The dots' fp32 values from their exact sums S: S 2^(E - 30) rounded once, or fp32(S) * the row scale."""
    return S.double().float() * scale if s8 else (S.double() * scale).float()


def _operands(v, s8, scale_of):
    """v's operand rows (ND, R, K) int64 and the scale its dots are descaled by (2^(E - 30), or the s8 scale)."""
    if s8:
        q, sc = scale_of(v)
        return q.long()[None], sc
    e, X = rs.fixed_point(v)
    return rs.digits(X), rs._pow2(e - rs.FIX)


def kernel_model(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows, renorm_channel,
                 compute_dtype, s8_dots=False, grid=7, seed=0):
    """The sample as the kernel computes it on a grid of `grid` CTAs (see the module docstring)."""
    rng = np.random.default_rng(seed)
    o = rs._operands(params, compute_dtype)
    L, h2 = o["q12"].shape[0], o["q12"].shape[2]
    w, H = o["win"].shape[1], h2 // 2
    ST = rs.STAGE
    Tu, KTu, Td, KTd = rs.q8_units(w, H)
    CH = rs.fitting_chunk(H, rs.CHUNK) if s8_dots else H
    kp = CH // ST  # stages a piece
    up_runs, dn_runs = _runs(Tu * KTu, grid), _runs(Td * KTd, grid)
    mods, fmods, eps = block_mods.float(), final_mods.float(), float(cfg.ln_eps)
    xlat = noise.float()
    for s in range(dts.shape[0]):
        xcur = rs._seq_dot(xlat.to(compute_dtype).float(), o["win"]) + o["binp"]
        for l in range(L):
            md = mods[l, s]
            xs = rs._modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, eps).to(compute_dtype).float()
            xo, xsc = _operands(xs, s8_dots, quant_rows_s8)
            q12, q3 = o["q12"][l].long(), o["q3"][l].long()
            parts: dict = {}  # up units: per CTA its run's partials, flushed once per tile it touches
            for u0, u1 in up_runs:
                acc = 0
                for u in range(u0, u1):
                    tile, ks = divmod(u, KTu)
                    j = torch.arange(tile * rs.UP_COLS, min((tile + 1) * rs.UP_COLS, H))
                    rows = slice(ks * ST, (ks + 1) * ST)
                    acc = acc + xo[:, :, rows] @ q12[rows][:, torch.cat([j, H + j])]
                    if ks == KTu - 1 or u == u1 - 1:
                        parts.setdefault(tile, []).append(_combined(acc, s8_dots))
                        acc = 0
            h = torch.zeros((xs.shape[0], H))
            hmax = torch.zeros((xs.shape[0], H // CH))  # the tiles' maxima per row and piece
            for tile, contributions in parts.items():  # each tile's last contributor
                j = torch.arange(tile * rs.UP_COLS, min((tile + 1) * rs.UP_COLS, H))
                d = _dots(_arrived(contributions, rng), xsc, s8_dots)
                n = j.numel()
                g = d[:, :n] * o["s12"][l, j] + o["b12"][l, j]
                u = d[:, n:] * o["s12"][l, H + j] + o["b12"][l, H + j]
                hv = rs.silu_exact(g) * u
                h[:, j] = hv if s8_dots else hv.to(compute_dtype).float()
                for pc in range(H // CH):
                    in_piece = (j >= pc * CH) & (j < (pc + 1) * CH)
                    if in_piece.any():
                        hmax[:, pc] = torch.maximum(hmax[:, pc], h[:, j[in_piece]].abs().amax(-1))
            # h's operands from the maxima: each piece quantized on its own scale (s8), the digits on the row's
            # fixed point (exact: one piece); the down units' partials per piece
            hos, hscs = [], []
            for pc in range(H // CH):
                v = h[:, pc * CH : (pc + 1) * CH]
                if s8_dots:
                    sc = div_exact(hmax[:, pc : pc + 1], 127.0) + 1e-12
                    hos.append(torch.round(v / sc).long()[None])
                    hscs.append(sc)
                else:
                    e = torch.frexp(hmax[:, pc : pc + 1]).exponent.long()
                    hos.append(rs.digits(torch.round(v.double() * rs._pow2(rs.FIX - e)).long()))
                    hscs.append(rs._pow2(e - rs.FIX))
            ho = torch.cat(hos, dim=-1)
            parts = {}
            for u0, u1 in dn_runs:
                acc = 0
                for u in range(u0, u1):
                    tile, k = divmod(u, KTd)
                    cols = torch.arange(tile * rs.DOWN_COLS, min((tile + 1) * rs.DOWN_COLS, w))
                    rows = slice(k * ST, (k + 1) * ST)
                    acc = acc + ho[:, :, rows] @ q3[rows][:, cols]
                    if k == KTd - 1 or u == u1 - 1 or (k + 1) % kp == 0:
                        parts.setdefault((tile, k // kp), []).append(_combined(acc, s8_dots))
                        acc = 0
            new = xcur.clone()
            for tile in range(Td):
                cols = torch.arange(tile * rs.DOWN_COLS, min((tile + 1) * rs.DOWN_COLS, w))
                po = torch.zeros((xs.shape[0], cols.numel()))
                for pc in range(H // CH):  # the pieces' descaled sums in piece order (exact: one)
                    po = po + _dots(_arrived(parts[(tile, pc)], rng), hscs[pc], s8_dots)
                new[:, cols] = xcur[:, cols] + md[:, 2 * w + cols] * (po * o["s3"][l, cols] + o["b3"][l, cols])
            xcur = new
        xs = rs._modulated_ln(xcur, None, None, fmods[s], w, eps).to(compute_dtype).float()
        v = rs._final_linear(xs, o["wfin"]) + o["bfin"]
        xlat = xlat + dts[s] * rs.cfg_combine(v, cfg_rows, text_cfg, image_cfg, renorm_channel)
    return xlat


def _head(width, mlp_mult, depth=2, steps=4, seed=1):
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=width, depth=depth, mlp_mult=mlp_mult,
                       num_sampling_steps=steps)
    params = init_rf_head_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    for leaf in (params["res_blocks"]["adaLN"], params["final_layer"]["adaLN"], params["final_layer"]["linear"]):
        leaf["w"] = jnp.asarray(0.05 * rng.standard_normal(leaf["w"].shape), jnp.float32)
    params["res_blocks"] = quantize_tree(params["res_blocks"], bits=8, min_size=1024)
    assert params["res_blocks"]["mlp"]["w12"]["w"].bits == 8
    return cfg, params


@pytest.fixture(scope="module")
def small_head():
    # width 192 (three 64-row stages an up tile; one down tile of 192 of its 256 columns), hidden 512 (four up
    # tiles of 128 h columns, eight down stages)
    return _head(192, 4)


@pytest.fixture(scope="module")
def pallas_head():
    # the Pallas kernel's 128-aligned width and hidden: width 384, mlp_mult 1 -> hidden 256 (test_torch_kernels_int8)
    return _head(384, 1)


def _inputs(cfg, params, cfg_rows, n_img, seed):
    rng = np.random.default_rng(seed)
    B = cfg_rows * n_img
    z = jnp.asarray(rng.standard_normal((B, cfg.z_channels)), jnp.float32)
    noise = np.tile(rng.standard_normal((n_img, cfg.target_channels)).astype(np.float32), (cfg_rows, 1))
    ts, dts = _time_grid(cfg, None)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    jax_args = (params, cfg, jnp.asarray(noise), block_mods, final_mods, dts, jnp.float32(3.0), jnp.float32(1.1))
    return jax_args, (params_from_jax(params, "cpu"), cfg, t(noise), t(block_mods), t(final_mods), t(dts), 3.0, 1.1)


ROWS = {"1row": (1, 1), "2rows": (2, 1), "3rows": (3, 1), "4rows-2img": (2, 2)}


@pytest.mark.parametrize("mode", ["exact", "s8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [False, True], ids=["plain-cfg", "renorm"])
@pytest.mark.parametrize("rows", list(ROWS.values()), ids=list(ROWS))
def test_kernel_model_is_the_plain_versions_bits(small_head, rows, renorm, dtype, mode, monkeypatch):
    """The model on 7 CTAs (runs that split tiles, shuffled arrivals) against
    the plain version: the same bits in both dot modes (the s8 one with h in
    four 128-column pieces)."""
    monkeypatch.setattr(rs, "CHUNK", 128)
    cfg, params = small_head
    _, args = _inputs(cfg, params, *rows, seed=5)
    kw = dict(cfg_rows=rows[0], renorm_channel=renorm, compute_dtype=getattr(torch, dtype), s8_dots=mode == "s8")
    assert torch.equal(kernel_model(*args, **kw), rs.rf_sample_fused_plain(*args, **kw))


@pytest.mark.parametrize("grid", [1, 2, 5, 24, 132])
@pytest.mark.parametrize("mode", ["exact", "s8"])
def test_kernel_model_bits_do_not_depend_on_the_grid(small_head, grid, mode):
    cfg, params = small_head
    _, args = _inputs(cfg, params, 3, 1, seed=6)
    kw = dict(cfg_rows=3, renorm_channel=True, compute_dtype=torch.bfloat16, s8_dots=mode == "s8")
    assert torch.equal(kernel_model(*args, grid=grid, seed=grid, **kw), rs.rf_sample_fused_plain(*args, **kw))


PALLAS_CASES = {"cfg2-f32": (2, 1, None, "float32"), "cfg3-renorm-f32": (3, 1, "channel", "float32"),
                "unguided-2img-f32": (1, 2, None, "float32"), "cfg2-renorm-bf16": (2, 1, "channel", "bfloat16"),
                "cfg3-renorm-bf16": (3, 1, "channel", "bfloat16")}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("cfg_rows,n_img,renorm,dtype", list(PALLAS_CASES.values()), ids=list(PALLAS_CASES))
def test_kernel_model_matches_pallas(pallas_head, cfg_rows, n_img, renorm, dtype):
    """The exact mode's model against `_sampler_q8` (s8_dots = False) in
    interpret mode: exact sums rounded once against fp32 sums in the TPU
    kernel's order, within EXACT_REL, over the cases of
    test_rf_sample_fused_q8_plain_matches_pallas (measured: 1.5e-7 to 6.0e-7
    of the largest output, and 3.2e-4 at 3 rows with renorm in bf16, where a
    bf16 rounding of h flipped)."""
    cfg, params = pallas_head
    jax_args, args = _inputs(cfg, params, cfg_rows, n_img, seed=3)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm == "channel")
    want = jax_rf_sample_fused(*jax_args, compute_dtype=getattr(jnp, dtype), interpret=True, **kw)
    _close(kernel_model(*args, compute_dtype=getattr(torch, dtype), **kw), want, EXACT_REL)


def test_kernel_model_matches_pallas_in_the_s8_mode(pallas_head, monkeypatch):
    """The s8 mode's model against `_sampler_q8` with INT8_INT_DOTS on, in
    interpret mode: the same integer dots, within S8_REL."""
    from mingunivision_tpu.ops.kernels import rf_mlp as jrf_mlp

    monkeypatch.setattr(jrf_mlp, "INT8_INT_DOTS", True)
    monkeypatch.setattr(rs, "silu_exact", lambda g: g * torch.sigmoid(g))  # silu as the JAX package writes it
    cfg, params = pallas_head
    jax_args, args = _inputs(cfg, params, 2, 1, seed=4)
    kw = dict(cfg_rows=2, renorm_channel=False)
    want = jax_rf_sample_fused(*jax_args, compute_dtype=jnp.float32, interpret=True, **kw)
    got = kernel_model(*args, compute_dtype=torch.float32, s8_dots=True, **kw)
    _close(got, want, S8_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_one_euler_step_of_one_block_matches_pallas(dtype):
    """One Euler step over one block from a common state (the same noise and
    modulations), the plain version's digit dots against `_sampler_q8`'s fp32
    sums: within 5e-6 of the largest output, where nothing is amplified over
    steps. Measured on heads of seeds 9, 12, 15: 5.2e-7 to 1.07e-6 (fp32), 1.4e-7
    to 4.0e-7 (bf16); the former plain version, which summed in the first
    kernel's fixed order, 5.2e-7 to 1.13e-6 and the same in bf16: the rest of
    the step (input_proj, LN, final layer in the kernel's order) sets it."""
    rel = 5e-6
    cfg, params = _head(384, 1, depth=1, steps=1, seed=9)
    jax_args, args = _inputs(cfg, params, 2, 1, seed=10)
    kw = dict(cfg_rows=2, renorm_channel=False)
    want = jax_rf_sample_fused(*jax_args, compute_dtype=getattr(jnp, dtype), interpret=True, **kw)
    _close(rs.rf_sample_fused_plain(*args, compute_dtype=getattr(torch, dtype), **kw), want, rel)


# ---------------------------------------------------------------------------
# the wrapper: units, workspace
# ---------------------------------------------------------------------------


def test_unit_counts_at_full_width():
    """64 up tiles of 48 stages (3,072 units of 16 KB: every byte of w12) and
    12 down tiles of 128 stages (1,536 units: w3): 75.5 MB a block, 906 MB an
    Euler step over 12 blocks."""
    Tu, KTu, Td, KTd = rs.q8_units(*FULL)
    assert (Tu, KTu, Td, KTd) == (64, 48, 12, 128)
    stage_bytes = rs.STAGE * rs.DOWN_COLS
    assert rs.UP_COLS * 2 == rs.DOWN_COLS  # an up tile's gate and up columns fill a stage's four boxes
    assert (Tu * KTu + Td * KTd) * stage_bytes * 12 == 3 * 3072 * 8192 * 12 == 905_969_664
    assert rs.down_chunk(8192) % rs.STAGE == 0 and 8192 // rs.down_chunk(8192) == 2  # the s8 mode's two pieces


@pytest.mark.parametrize("shape", [FULL, (192, 512), (384, 256), (256, 2048)], ids=["full", "w192", "w384", "w256"])
def test_units_are_covered_once_in_balanced_contiguous_runs(shape):
    """Every (tile, stage) unit of both phases in exactly one run; the runs
    within one unit of each other; each tile's contributors' stage counts add
    to its stages (the ticket's total)."""
    Tu, KTu, Td, KTd = rs.q8_units(*shape)
    for tiles, stages in ((Tu, KTu), (Td, KTd)):
        for grid in (1, 2, 5, 7, 24, 131, 132):
            runs = _runs(tiles * stages, grid)
            lengths = [b - a for a, b in runs]
            assert runs[0][0] == 0 and runs[-1][1] == tiles * stages and max(lengths) - min(lengths) <= 1
            per_tile = np.bincount([u // stages for a, b in runs for u in range(a, b)], minlength=tiles)
            assert (per_tile == stages).all()


def test_workspace_sizes():
    """fp32: h and three buffers of x at MAX_ROWS rows (as the int4 kernel's);
    int32 words: an int64 accumulator a row and column (256 a tile) per up
    tile and per down tile and piece, the tickets, two buffers of h's row
    maxima per piece, the barrier's two counts."""
    acc = 2 * rs.MAX_ROWS * 256
    assert rs.q8_workspace_sizes(*FULL, 1) == (4 * (8192 + 3 * 3072), 64 * acc + 12 * acc + 76 + 2 * 4 + 2)
    assert rs.q8_workspace_sizes(*FULL, 2)[1] == 64 * acc + 2 * 12 * acc + 76 + 2 * 8 + 2
    assert rs.q8_workspace_sizes(192, 512, 4) == (4 * (512 + 576), 4 * acc + 4 * acc + 5 + 2 * 16 + 2)
    assert rs.q8_workspace_sizes(*FULL, 1)[0] == rs.q4_workspace_sizes(*FULL, 0)[0]


def test_one_workspace_per_device_and_stream_for_both_samplers():
    """The int4 and int8 kernels' launches on one stream share its buffers,
    grown to the larger need; another stream has its own."""
    cpu = torch.device("cpu")
    rs._sampler_workspaces.clear()
    f4, i4 = rs._sampler_workspace(rs.q4_workspace_sizes(192, 512, 0), cpu, stream=1)
    f8, i8 = rs._sampler_workspace(rs.q8_workspace_sizes(192, 512, 1), cpu, stream=1)
    assert f8.data_ptr() == f4.data_ptr() and i8.numel() == max(i4.numel(), rs.q8_workspace_sizes(192, 512, 1)[1])
    assert not i8.any()
    assert rs._sampler_workspace((16, 8), cpu, stream=2)[1].data_ptr() != i8.data_ptr()
    rs._sampler_workspaces.clear()


# ---------------------------------------------------------------------------
# what the change leaves alone
# ---------------------------------------------------------------------------

# sha256 prefixes of the plain outputs below, taken before the exact int8 sampler moved to digit dots (the
# stack's exact bodies, which moved to digit dots later, are held to their new contract instead)
UNCHANGED = {
    "stack-int4-s8-float32": "1fcec998878448bc",
    "sampler-int4-q4-float32": "795982f1454e317a",
    "stack-int4-s8-bfloat16": "17f1fb9b7963ea43",
    "sampler-int4-q4-bfloat16": "d7f37af8182a9a1b",
    "stack-int8-s8-float32": "4053b2caeca8aa61",
    "sampler-int8-s8-float32": "29e1679946c8f755",
    "stack-int8-s8-bfloat16": "82450e0d756d6f6b",
    "sampler-int8-s8-bfloat16": "15005032e0dfdc47",
}


def _port_head(bits):
    cfg = PortRFHeadConfig(target_channels=8, z_channels=32, width=192, depth=2, mlp_mult=4, num_sampling_steps=3)
    g = torch.Generator().manual_seed(41)
    rf = port_init_rf_head_params(cfg, _Init(torch.device("cpu"), torch.float32, g))
    rng = np.random.default_rng(41)
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"] = torch.from_numpy((0.05 * rng.standard_normal(tuple(leaf["w"].shape))).astype(np.float32))
    quantize_tree_inplace(rf, bits=bits, min_size=1024)
    return cfg, rf


def _int_dot(x, q):
    """x (R, K) fp32 @ q (K, N) integers as the exact dots' contract says,
    in numpy int64 apart from the port's digits: each row of x on its own
    fixed point (E the frexp exponent of its largest |x|, X = rint(x 2^(30 - E))),
    the exact integer sums of X q, each rounded once to fp32 from S 2^(E - 30)."""
    xd = x.double().numpy()
    e = np.frexp(np.abs(xd).max(axis=1, keepdims=True))[1]
    X = np.rint(np.ldexp(xd, 30 - e)).astype(np.int64)
    S = X @ q.numpy().astype(np.int64)  # |S| < 2^30 x 128 x K
    return torch.from_numpy(np.ldexp(S.astype(np.float64), e - 30).astype(np.float32))


def _exact_stack(rf, x, mods, eps, bits):
    """The stack's exact body as its contract says, block by block, its dots
    by `_int_dot`: over int8 tables the bytes as they are, over int4 tables
    each nibble plane unpacked apart (numpy) as the integer table of both
    halves of the contraction."""
    o = rs.block_operands(rf["res_blocks"])
    L, H = o["q12"].shape[0], o["q12"].shape[2] // 2
    w, dt = x.shape[1], x.dtype

    def table(q):
        b = q.numpy().astype(np.int16)
        return torch.from_numpy(b if bits == 8 else np.concatenate([(b & 15) - 8, (b >> 4) - 8]))

    xcur = x.float()
    for l in range(L):
        md = mods[l].float()
        xs = rs._modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, eps)
        gu = _int_dot(xs.to(dt).float(), table(o["q12"][l]))
        g = gu[:, :H] * o["s12"][l, :H] + o["b12"][l, :H]
        u = gu[:, H:] * o["s12"][l, H:] + o["b12"][l, H:]
        hf = (rs.silu_exact(g) * u).to(dt).float()
        y = _int_dot(hf, table(o["q3"][l])) * o["s3"][l] + o["b3"][l]
        xcur = xcur + md[:, 2 * w :] * y
    return xcur.to(dt)


def test_untouched_plain_versions_keep_their_bits():
    """The per-step stack's s8 bodies, the s8 int8 sampler and the int4
    sampler give the bits they gave before the exact int8 sampler's change;
    the stack's exact bodies give the bits of their digit-dot contract (3 rows
    with renorm, fp32 and bf16)."""
    digest = lambda t: hashlib.sha256(t.detach().float().contiguous().numpy().tobytes()).hexdigest()[:16]  # noqa: E731
    got = {}
    rng = np.random.default_rng(43)
    for bits in (4, 8):
        cfg, rf = _port_head(bits)
        x = torch.from_numpy(rng.standard_normal((3, cfg.width)).astype(np.float32))
        z = torch.from_numpy(rng.standard_normal((3, cfg.z_channels)).astype(np.float32))
        ts, dts = port_time_grid(cfg, None)
        bm, fm = port_precompute_modulations(rf, cfg, ts, z)
        for dt in (torch.float32, torch.bfloat16):
            for int_dots in (False, True):
                out = rf_mlp.rf_mlp_stack_plain(rf["res_blocks"], x.to(dt), bm[:, 0].float(), ln_eps=cfg.ln_eps,
                                                chunk=128, int_dots=int_dots)
                if int_dots:
                    got[f"stack-int{bits}-s8-{str(dt)[6:]}"] = digest(out)
                else:
                    assert torch.equal(out, _exact_stack(rf, x.to(dt), bm[:, 0], cfg.ln_eps, bits)), (bits, dt)
            noise = torch.from_numpy(rng.standard_normal((1, cfg.target_channels)).astype(np.float32)).repeat(3, 1)
            out = rs.rf_sample_fused_plain(rf, cfg, noise, bm, fm, dts, 3.0, 1.1, cfg_rows=3, renorm_channel=True,
                                           compute_dtype=dt, s8_dots=bits == 8)
            got[f"sampler-int{bits}-{'s8' if bits == 8 else 'q4'}-{str(dt)[6:]}"] = digest(out)
    assert got == UNCHANGED


def test_trace_tool_patches_the_int8_kernel_source():
    """`tools/trace_rf_sampler_q4.py --bits 8` stamps the int8 kernel's phases
    by replacing anchors of its source, each exactly once: they all match it,
    and the int4 kernel's anchors still match its own."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("trace_rf_sampler_q4", root / "tools" / "trace_rf_sampler_q4.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    stamps = {}
    for bits, source in ((8, tool.SOURCE_Q8), (4, tool.SOURCE)):
        traced = tool.patched((root / source).read_text(), bits)
        assert "g_no_stream" in traced
        stamps[bits] = traced.count("stamp(")
    assert stamps[8] == stamps[4] > 10
