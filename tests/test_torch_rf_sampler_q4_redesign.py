"""PyTorch port: what surrounds the fused int4 RF sampler's kernel
(`csrc/rf_sampler_q4.cu`, `mu_rf_sampler_q4s8`), on the CPU.

- The unit partition: each CTA of the persistent grid takes a contiguous run
  of the tile-major (tile, stage) units, up and down alike (`run_first`); the
  runs cover every unit once and are balanced within one unit, at grids of 1
  to 140 CTAs, at the 16B-A3B width and at the tests' tiny ones.
- A plain-torch model of the kernel's arithmetic: x's s8 pair over the whole
  row; per CTA the integer dots of its run's stages (64 packed rows a stage,
  the zero-filled rows past the table included), added per tile in a
  shuffled arrival order; the last contributor's fp32 epilogue (h in the
  compute dtype, its tile's row maxima); h's scales from the tiles' maxima,
  its s8 pair with each stage's sums, added per tile by the contributors for
  corr; the down partials per kc-row piece in the pipelined schedule, added
  in piece order. Held to the bit against `rf_sample_fused_plain` in both
  schedules at 1-4 rows, with and without renorm, in bf16 and fp32; and with
  the int4 kernel tests' tolerance against the JAX package's
  `_sampler_q4_s8` and `_sampler_q4_s8_pipelined` in interpret mode, on
  numpy-seeded inputs.
- The wrapper's workspace sizes, kept per device and stream, and its
  operands converted once per head.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import RFHeadConfig
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.ops.kernels import rf_sampler as rs
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, silu_exact, split_bytes
from mingunivision_tpu_torch.utils.convert import params_from_jax
import test_torch_common  # noqa: F401  (one torch thread per test worker)

REL = 1e-4  # against the Pallas kernel: the same integer dots, fp32 steps in another order (test_torch_kernels_int4)
FULL = (3072, 8192)  # the 16B-A3B head's width and SwiGLU hidden
TINY = {"w192": (192, 512), "w256": (256, 512), "w768": (768, 512), "w3072-h64": (3072, 64)}


# ---------------------------------------------------------------------------
# the unit partition
# ---------------------------------------------------------------------------


def _runs(units: int, grid: int):
    return [(rs.run_first(c, units, grid), rs.run_first(c + 1, units, grid)) for c in range(grid)]


@pytest.mark.parametrize("shape", [FULL, *TINY.values()], ids=["full", *TINY])
@pytest.mark.parametrize("phase", ["up", "down"])
def test_units_are_covered_once_in_balanced_contiguous_runs(shape, phase):
    """Every (tile, stage) unit in exactly one run; the runs in CTA order,
    contiguous, within one unit of each other; each tile's contributors'
    stage counts add to its stages (the ticket's total), and no run needs
    more kept h stages than the launch sizes (min(longest run, stages))."""
    w, H = shape
    Tu, KTu, Td, KTd = rs.q4_units(w, H)
    tiles, stages = (Tu, KTu) if phase == "up" else (Td, KTd)
    U = tiles * stages
    for grid in range(1, 141):
        runs = _runs(U, grid)
        assert runs[0][0] == 0 and runs[-1][1] == U
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        lengths = [b - a for a, b in runs]
        assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 0
        covered = np.zeros(U, np.int64)
        per_tile = np.zeros(tiles, np.int64)
        for u0, u1 in runs:
            covered[u0:u1] += 1
            for u in range(u0, u1):
                per_tile[u // stages] += 1
            if phase == "down" and u1 > u0:  # the kept stages: a cyclic interval from u0's stage
                kept = {u % stages for u in range(u0, u1)}
                assert len(kept) == min(u1 - u0, stages) <= min(-(-U // grid), stages)
                assert kept == {(u0 % stages + i) % stages for i in range(len(kept))}
        assert (covered == 1).all() and (per_tile == stages).all()


def test_unit_counts_at_full_width():
    """64 up tiles of 24 stages (1,536 units of 16 KB) and 12 down tiles of 64
    stages (768 units): 37.7 MB a block, 453 MB an Euler step over 12 blocks."""
    Tu, KTu, Td, KTd = rs.q4_units(*FULL)
    assert (Tu, KTu, Td, KTd) == (64, 24, 12, 64)
    stage_bytes = rs.STAGE * rs.DOWN_COLS  # 4 boxes of 64 bytes x 64 rows
    assert stage_bytes == 16384 and rs.DOWN_COLS == 4 * rs.UP_PAIRS
    assert (Tu * KTu + Td * KTd) * stage_bytes * 12 == 3 * 3072 * 8192 * 12 // 2  # every packed byte once


# ---------------------------------------------------------------------------
# the kernel's arithmetic, modeled
# ---------------------------------------------------------------------------


def _pair(lo, hi, rows_pad):
    """x's or h's s8 pair as the kernel forms it: (a1, a2) int64 padded with
    zero rows to rows_pad columns, and the scales from the row maxima."""
    c1 = lo - hi * (1.0 / 16.0)
    sa1 = div_exact(c1.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    sa2 = div_exact(hi.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    a1, a2 = torch.round(c1 / sa1).long(), torch.round(hi / sa2).long()
    pad = rows_pad - lo.shape[1]
    return torch.nn.functional.pad(a1, (0, pad)), torch.nn.functional.pad(a2, (0, pad)), sa1, sa2


def _planes(q, rows_pad):
    """A packed table's two integer operands, (q & 15) and s8(q ^ 0x80), its
    rows zero-filled to rows_pad bytes as the kernel's TMA boxes fill them."""
    q = torch.nn.functional.pad(q, (0, 0, 0, rows_pad - q.shape[0]))
    m, bx = split_bytes(q)
    return m.long(), bx.long()


def _corr(s1, s2, sa1, sa2):
    return 8.0 * (s1.float() * sa1 + s2.float() * (sa2 * (1.0 / 16.0)))


def _descale(d1, d2, sa1, sa2):
    return d1.float() * sa1 + d2.float() * (sa2 * (1.0 / 16.0))


def _arrived(parts, rng):
    """The contributions of one tile added in a shuffled arrival order (exact integers)."""
    total = torch.zeros_like(parts[0])
    for i in rng.permutation(len(parts)):
        total = total + parts[i]
    return total


def kernel_model(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows, renorm_channel,
                 compute_dtype, schedule, down_chunk=rs.DOWN_CHUNK, grid=7, seed=0):
    """The sample as the kernel computes it on a grid of `grid` CTAs (see the module docstring)."""
    rng = np.random.default_rng(seed)
    o = rs._operands(params, compute_dtype)
    L, h2 = o["q12"].shape[0], o["q12"].shape[2]
    w, H = o["win"].shape[1], h2 // 2
    wq, Hh, ST = w // 2, H // 2, rs.STAGE
    Tu, KTu, Td, KTd = rs.q4_units(w, H)
    kc = rs.fitting_chunk(Hh, down_chunk) if schedule == "pipelined" else 0
    kp = kc // ST if kc and kc != Hh else KTd  # stages a piece
    up_runs, dn_runs = _runs(Tu * KTu, grid), _runs(Td * KTd, grid)
    mods, fmods, eps = block_mods.float(), final_mods.float(), float(cfg.ln_eps)
    xlat = noise.float()
    for s in range(dts.shape[0]):
        xcur = rs._seq_dot(xlat.to(compute_dtype).float(), o["win"]) + o["binp"]
        for l in range(L):
            md = mods[l, s]
            xs = rs._modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, eps)
            a1, a2, sa1, sa2 = _pair(xs[:, :wq], xs[:, wq:], KTu * ST)
            corr = _corr(a1.sum(-1, keepdim=True), a2.sum(-1, keepdim=True), sa1, sa2)
            lo, hi = _planes(o["q12"][l], KTu * ST)
            # up units: per CTA its run's partials, flushed once per tile it touches
            parts: dict = {}
            for u0, u1 in up_runs:
                acc = 0
                for u in range(u0, u1):
                    tile, ks = divmod(u, KTu)
                    j = torch.arange(tile * rs.UP_PAIRS, min((tile + 1) * rs.UP_PAIRS, Hh))
                    cols = torch.cat([j, Hh + j, H + j, H + Hh + j])
                    rows = slice(ks * ST, (ks + 1) * ST)
                    acc = acc + torch.stack([a1[:, rows] @ lo[rows][:, cols], a2[:, rows] @ hi[rows][:, cols]])
                    if ks == KTu - 1 or u == u1 - 1:
                        parts.setdefault(tile, []).append(acc)
                        acc = 0
            h, tile_max = torch.zeros((xs.shape[0], H)), []
            for tile, contributions in parts.items():  # each tile's last contributor
                d1, d2 = _arrived(contributions, rng)
                j = torch.arange(tile * rs.UP_PAIRS, min((tile + 1) * rs.UP_PAIRS, Hh))
                cols = torch.cat([j, Hh + j, H + j, H + Hh + j])
                v = (_descale(d1, d2, sa1, sa2) - corr) * o["s12"][l, cols] + o["b12"][l, cols]
                n = j.numel()
                hlo = (silu_exact(v[:, :n]) * v[:, 2 * n : 3 * n]).to(compute_dtype).float()
                hhi = (silu_exact(v[:, n : 2 * n]) * v[:, 3 * n :]).to(compute_dtype).float()
                h[:, j], h[:, Hh + j] = hlo, hhi
                tile_max.append(torch.stack([(hlo - hhi * (1.0 / 16.0)).abs().amax(-1), hhi.abs().amax(-1)]))
            # h's scales from the tiles' maxima; its s8 pair and per-stage sums
            m1, m2 = torch.stack(tile_max).amax(0)
            sb1, sb2 = div_exact(m1[:, None], 127.0) + 1e-12, div_exact(m2[:, None], 127.0) + 1e-12
            c1 = h[:, :Hh] - h[:, Hh:] * (1.0 / 16.0)
            b1 = torch.nn.functional.pad(torch.round(c1 / sb1).long(), (0, KTd * ST - Hh))
            b2 = torch.nn.functional.pad(torch.round(h[:, Hh:] / sb2).long(), (0, KTd * ST - Hh))
            lo, hi = _planes(o["q3"][l], KTd * ST)
            # down units: partials per piece, operand sums per tile
            parts, sums = {}, {}
            for u0, u1 in dn_runs:
                acc, first = 0, None
                for u in range(u0, u1):
                    tile, k = divmod(u, KTd)
                    first = k if first is None else first
                    cols = torch.arange(tile * rs.DOWN_COLS, min((tile + 1) * rs.DOWN_COLS, w))
                    rows = slice(k * ST, (k + 1) * ST)
                    acc = acc + torch.stack([b1[:, rows] @ lo[rows][:, cols], b2[:, rows] @ hi[rows][:, cols]])
                    tile_end = k == KTd - 1 or u == u1 - 1
                    if tile_end or (k + 1) % kp == 0:
                        parts.setdefault((tile, k // kp), []).append(acc)
                        acc = 0
                    if tile_end:
                        rows = slice(first * ST, (k + 1) * ST)
                        sums.setdefault(tile, []).append(torch.stack([b1[:, rows].sum(-1), b2[:, rows].sum(-1)]))
                        first = None
            new = xcur.clone()
            for tile in range(Td):
                s1, s2 = _arrived(sums[tile], rng)
                corrh = _corr(s1[:, None], s2[:, None], sb1, sb2)
                cols = torch.arange(tile * rs.DOWN_COLS, min((tile + 1) * rs.DOWN_COLS, w))
                if kp == KTd:  # the block schedule: one sum
                    d1, d2 = _arrived(parts[(tile, 0)], rng)
                    val = _descale(d1, d2, sb1, sb2) - corrh
                else:  # the pieces' descaled sums in piece order
                    val = torch.zeros((xs.shape[0], cols.numel()))
                    for piece in range(KTd // kp):
                        d1, d2 = _arrived(parts[(tile, piece)], rng)
                        val = val + _descale(d1, d2, sb1, sb2)
                    val = val - corrh
                po = val * o["s3"][l, cols] + o["b3"][l, cols]
                new[:, cols] = xcur[:, cols] + md[:, 2 * w + cols] * po
            xcur = new
        xs = rs._modulated_ln(xcur, None, None, fmods[s], w, eps).to(compute_dtype).float()
        v = rs._final_linear(xs, o["wfin"]) + o["bfin"]
        xlat = xlat + dts[s] * rs.cfg_combine(v, cfg_rows, text_cfg, image_cfg, renorm_channel)
    return xlat


def _head(width, mlp_mult, seed=1):
    cfg = RFHeadConfig(target_channels=8, z_channels=32, width=width, depth=2, mlp_mult=mlp_mult,
                       num_sampling_steps=4)
    params = init_rf_head_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    for leaf in (params["res_blocks"]["adaLN"], params["final_layer"]["adaLN"], params["final_layer"]["linear"]):
        leaf["w"] = jnp.asarray(0.05 * rng.standard_normal(leaf["w"].shape), jnp.float32)
    params["res_blocks"] = quantize_tree(params["res_blocks"], bits=4, min_size=1024)
    return cfg, params


@pytest.fixture(scope="module")
def small_head():
    # width 192 (w / 2 = 96 packed rows: a stage and a half; one down tile of 192 of its 256 columns), hidden 512
    return _head(192, 4)


@pytest.fixture(scope="module")
def pallas_head():
    # the Pallas kernel's 128-aligned half planes: width 768, mlp_mult 1 -> hidden 512 (test_torch_kernels_int4)
    return _head(768, 1)


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


@pytest.mark.parametrize("schedule", rs.SCHEDULES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [False, True], ids=["plain-cfg", "renorm"])
@pytest.mark.parametrize("rows", list(ROWS.values()), ids=list(ROWS))
def test_kernel_model_is_the_plain_versions_bits(small_head, rows, renorm, dtype, schedule):
    """The model on 7 CTAs (runs that split tiles, shuffled arrivals) against
    the plain version: the same bits, in both schedules (the pipelined one in
    two 128-row pieces)."""
    cfg, params = small_head
    _, args = _inputs(cfg, params, *rows, seed=5)
    kw = dict(cfg_rows=rows[0], renorm_channel=renorm, compute_dtype=getattr(torch, dtype), schedule=schedule,
              down_chunk=128)
    want = rs.rf_sample_fused_plain(*args, **kw)
    assert torch.equal(kernel_model(*args, **kw), want)


@pytest.mark.parametrize("grid", [1, 2, 5, 24, 132])
def test_kernel_model_bits_do_not_depend_on_the_grid(small_head, grid):
    cfg, params = small_head
    _, args = _inputs(cfg, params, 3, 1, seed=6)
    kw = dict(cfg_rows=3, renorm_channel=True, compute_dtype=torch.bfloat16, schedule="pipelined", down_chunk=128)
    assert torch.equal(kernel_model(*args, grid=grid, seed=grid, **kw), rs.rf_sample_fused_plain(*args, **kw))


@pytest.mark.parametrize("schedule,rows,renorm,dtype", [("block", (2, 1), False, "float32"),
                                                         ("pipelined", (3, 1), True, "bfloat16")],
                         ids=["block-cfg2-f32", "pipelined-cfg3-renorm-bf16"])
def test_kernel_model_matches_pallas(pallas_head, schedule, rows, renorm, dtype):
    """The model against `_sampler_q4_s8` / `_sampler_q4_s8_pipelined` in
    interpret mode (w3 in 128-row pieces): the same integer dots, fp32 steps
    summed in another order."""
    cfg, params = pallas_head
    jax_args, args = _inputs(cfg, params, *rows, seed=7)
    kw = dict(cfg_rows=rows[0], renorm_channel=renorm)
    extra = dict(schedule="pipelined", down_chunk=128) if schedule == "pipelined" else {}
    want = jax_rf_sample_fused(*jax_args, compute_dtype=getattr(jnp, dtype), interpret=True, **kw, **extra)
    got = kernel_model(*args, compute_dtype=getattr(torch, dtype), schedule=schedule, down_chunk=128, **kw)
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert np.isfinite(got.numpy()).all() and err <= REL * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the wrapper: workspace, operands, arguments
# ---------------------------------------------------------------------------


def test_workspace_sizes():
    """fp32: h and three buffers of x at MAX_ROWS rows; int32: two dots x
    MAX_ROWS x 256 columns per up tile and per down tile and piece, two
    buffers of the down tiles' operand sums, the tickets, two buffers of row
    maxima, the barrier's two counts."""
    acc = 2 * rs.MAX_ROWS * 256
    assert rs.q4_workspace_sizes(*FULL, 0) == (4 * (8192 + 3 * 3072), 64 * acc + 12 * acc + 2 * 12 * 8 + 76 + 16 + 2)
    assert rs.q4_workspace_sizes(*FULL, 1024)[1] == 64 * acc + 4 * 12 * acc + 2 * 12 * 8 + 76 + 16 + 2
    assert rs.q4_workspace_sizes(*FULL, 4096) == rs.q4_workspace_sizes(*FULL, 0)  # one piece: the block sum
    assert rs.q4_workspace_sizes(192, 512, 128)[1] == 4 * acc + 2 * 1 * acc + 2 * 8 + 5 + 16 + 2


def test_workspace_is_kept_per_device_and_stream_and_grown():
    cpu = torch.device("cpu")
    rs._sampler_workspaces.clear()
    f1, i1 = rs._sampler_workspace((64, 32), cpu, stream=1)
    assert not i1.any()
    f2, i2 = rs._sampler_workspace((16, 8), cpu, stream=1)
    assert f2.data_ptr() == f1.data_ptr() and i2.data_ptr() == i1.data_ptr()  # reused
    f3, i3 = rs._sampler_workspace((64, 32), cpu, stream=2)
    assert i3.data_ptr() != i1.data_ptr()  # another stream: its own
    f4, i4 = rs._sampler_workspace((64, 64), cpu, stream=1)
    assert f4.data_ptr() == f1.data_ptr() and i4.numel() == 64 and not i4.any()  # the int32 part grown, as zeros
    rs._sampler_workspaces.clear()


def test_operands_are_converted_once_per_head(small_head):
    """The kernels' converted operands are kept while the head's tensors live
    unchanged (not its tables); an in-place change or another head converts
    them again."""
    cfg, params = small_head
    tp = params_from_jax(params, "cpu")
    first = rs._kernel_operands(tp, torch.bfloat16)
    again = rs._kernel_operands(tp, torch.bfloat16)
    assert all(again[k] is first[k] for k in first)
    assert first["q12"] is tp["res_blocks"]["mlp"]["w12"]["w"].q
    assert torch.equal(first["wfin_t"], first["wfin"].t())
    tp["final_layer"]["linear"]["b"].mul_(2.0)
    changed = rs._kernel_operands(tp, torch.bfloat16)
    assert changed["wfin_t"] is not first["wfin_t"]  # converted again
    assert torch.equal(changed["bfin"], tp["final_layer"]["linear"]["b"].float())
    other = params_from_jax(params, "cpu")
    assert rs._kernel_operands(other, torch.bfloat16)["win"] is not changed["win"]
    assert rs._kernel_operands(other, torch.float32)["win"] is not rs._kernel_operands(other, torch.bfloat16)["win"]


def test_pipelined_pieces_must_be_whole_stages(small_head):
    """On the card the pipelined schedule's pieces are whole 64-row stages (or
    all of H / 2); the CPU path, the plain version, takes any."""
    cfg, params = small_head
    _, args = _inputs(cfg, params, 2, 1, seed=8)
    got = rs.rf_sample_fused(*args, cfg_rows=2, renorm_channel=False, schedule="pipelined", down_chunk=32)
    assert torch.equal(got, rs.rf_sample_fused_plain(*args, cfg_rows=2, renorm_channel=False, schedule="pipelined",
                                                     down_chunk=32))


def test_trace_tool_patches_the_kernel_source():
    """`tools/trace_rf_sampler_q4.py` stamps the kernel's phases by replacing
    anchors of the source, each exactly once: they all still match it."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("trace_rf_sampler_q4", root / "tools" / "trace_rf_sampler_q4.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (root / tool.SOURCE).read_text()
    traced = tool.patched(source)
    assert traced.count("stamp(") > 10 and "g_no_stream" in traced
    assert tool.BUILD_PATCH[0] in (root / tool.BUILD).read_text()
