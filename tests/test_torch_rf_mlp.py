"""PyTorch port, the per-step RF route and the last two serving-path kernel
modes: the plain versions of the per-step residual stack in its four bodies
(`_kernel`, `_kernel_q8_s8`, `_kernel_q4`, `_kernel_q4_s8`), the RF head's
Euler loop through it (`rf_sample(fused=False)`) and a session with
RuntimeConfig(rf_fused_sampler=False), the fused int4 sampler's pipelined
schedule and the full-expert-block prefill MoE, against the JAX package's
Pallas kernels run in interpret mode on the CPU. The CUDA kernels themselves
are held against these plain versions in tests/test_torch_kernels_cuda.py.

Tolerances, relative to the largest output:
  - fp32, exact dequant: REL = 2e-4 (the port's dots are exact before one
    rounding, on each row's fixed point: `rf_sampler._digit_dot`; the JAX
    kernels sum the same products in fp32);
  - fp32, s8 dots: S8_REL = 1e-4 with the port's silu written as the JAX
    package writes it (x * sigmoid(x)): the integer sums are exact, the fp32
    epilogue runs in another order. As shipped, the port's silu differs from
    that formula in the last place, and one such ulp can flip the s8 rounding
    of one element of h; a flip moves an output by one quantization step of
    its row, max|h| / 127, times one weight and the scales, so the shipped
    plain version is held within SILU_ULP_REL = 2e-3;
  - bf16: BF16_REL = 1e-2, which admits the bf16 roundings of the modulated
    LN output and of h that flip under fp32 reassociation (one flip moves an
    element by 2**-8 of itself) and the rounding of the output;
  - the Euler loop over 4 steps: the stack's tolerance of its body.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import ImageGenConfig, RFHeadConfig
from mingunivision_tpu.models import rf_head as jrf_head
from mingunivision_tpu.models.rf_head import _time_grid, init_rf_head_params, precompute_modulations
from mingunivision_tpu.models.rf_head import rf_sample as jax_rf_sample
from mingunivision_tpu.ops.kernels import rf_mlp as jrf_mlp
from mingunivision_tpu.ops.kernels.moe_swiglu_gmm import swiglu_gmm_quant
from mingunivision_tpu.ops.kernels.rf_sampler import rf_sample_fused as jax_rf_sample_fused
from mingunivision_tpu.utils.quantize import quantize_array, quantize_tree
from mingunivision_tpu_torch.models import rf_head
from mingunivision_tpu_torch.ops.kernels import rf_mlp
from mingunivision_tpu_torch.ops.kernels import rf_sampler as trs
from mingunivision_tpu_torch.ops.kernels.moe_stream import layer_tables
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, swiglu_gmm_rows
from mingunivision_tpu_torch.utils.convert import init_mm_params, params_from_jax
from mingunivision_tpu_torch.utils.pytree import tree_map
from mingunivision_tpu_torch.utils.quantize import quantize_array as port_quantize_array


REL, S8_REL, SILU_ULP_REL, BF16_REL = 2e-4, 1e-4, 2e-3, 1e-2
MIN_SIZE = 1024  # the tiny tables are far below the quantizer's 65536-element default


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_silu(monkeypatch):
    """The port's plain s8 versions with silu as the JAX package writes it."""
    for module in (rf_mlp, trs):
        monkeypatch.setattr(module, "silu_exact", lambda g: g * torch.sigmoid(g))


def _jax_stack_route(monkeypatch):
    """The JAX package's per-step route as on its TPU: the fused sampler off,
    the parameters taken for TPU-resident, the stack kernel in interpret mode."""
    monkeypatch.setattr(jrf_head, "FUSED_SAMPLER", False)
    monkeypatch.setattr(jrf_head, "_params_on_tpu", lambda params: True)
    monkeypatch.setattr(jrf_mlp, "rf_mlp_stack", functools.partial(jrf_mlp.rf_mlp_stack, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# the per-step stack, four bodies
# ---------------------------------------------------------------------------

# One RF head for every test here. Width 256, mlp_mult 12 -> SwiGLU hidden
# 2048: 128-aligned halves (the Pallas kernels' rule), two 512-row down chunks
# in the exact int4 body, eight 256-column chunks in the int8 bodies at
# chunk=256, eight 128-row w3 pieces in the pipelined sampler at down_chunk=128
CFG = RFHeadConfig(target_channels=8, z_channels=32, width=256, depth=2, mlp_mult=12, num_sampling_steps=4)
CHUNK = 256


@pytest.fixture(scope="module")
def heads():
    """bits -> (the JAX head with int4 / int8 res_blocks, the port's tree of it); 0 -> the fp32 JAX head.
    The zero-initialised AdaLN and final layers are drawn at std 0.05, so they act."""
    params = init_rf_head_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    for leaf in (params["res_blocks"]["adaLN"], params["final_layer"]["adaLN"], params["final_layer"]["linear"]):
        leaf["w"] = jnp.asarray(0.05 * rng.standard_normal(leaf["w"].shape), jnp.float32)
    out = {0: params}
    for bits in (4, 8):
        qp = dict(params, res_blocks=quantize_tree(params["res_blocks"], bits=bits, min_size=MIN_SIZE))
        out[bits] = (qp, params_from_jax(qp, "cpu"))
    return out


def _stack_inputs(qp, rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, CFG.width)).astype(np.float32)
    z = jnp.asarray(rng.standard_normal((rows, CFG.z_channels)), jnp.float32)
    block_mods, _ = precompute_modulations(qp, CFG, jnp.asarray([0.6], jnp.float32), z)
    return x, np.asarray(block_mods[:, 0])  # (depth, rows, 3w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("body", ["q8", "q8s8", "q4", "q4s8"])
def test_stack_plain_matches_pallas(heads, body, rows, dtype, monkeypatch):
    bits, s8 = int(body[1]), body.endswith("s8")
    qp, tree = heads[bits]
    blocks = tree["res_blocks"]
    assert rf_mlp.rf_mlp_supported(blocks) and jrf_mlp.rf_mlp_supported(qp["res_blocks"])
    x, mods = _stack_inputs(qp, rows, seed=rows)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jrf_mlp.rf_mlp_stack(qp["res_blocks"], jnp.asarray(x, jdt), jnp.asarray(mods), ln_eps=CFG.ln_eps,
                                chunk=CHUNK, interpret=True, unpack_mode="s8" if s8 else ("i32" if bits == 4 else None))
    args = (blocks, _t(x).to(tdt), _t(mods))
    kw = dict(ln_eps=CFG.ln_eps, chunk=CHUNK, int_dots=s8)
    got = rf_mlp.rf_mlp_stack_plain(*args, **kw)
    assert got.dtype == tdt and got.shape == (rows, CFG.width)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(rf_mlp.rf_mlp_stack(*args, **kw).float().numpy(), got.float().numpy())
    if dtype == "bfloat16":
        _close(got.float().numpy(), np.asarray(want, np.float32), BF16_REL)
    elif s8:
        _close(got.numpy(), want, SILU_ULP_REL)
        _jax_silu(monkeypatch)
        _close(rf_mlp.rf_mlp_stack_plain(*args, **kw).numpy(), want, S8_REL)
    else:
        _close(got.numpy(), want, REL)


def test_stack_tiling_is_the_jax_package_s():
    """The chunks that decide the numbers at the 16B-A3B width (H = 8192) and
    here: the s8 bodies' (the int8 one's columns of h quantized together, the
    int4 one's down pieces); the exact bodies' dots are exact, so their
    chunks decide nothing."""
    assert rf_mlp._tiling(8192, rf_mlp.CHUNK) == (2048, 1024)
    assert rf_mlp._tiling(2048, CHUNK) == (256, 1024)
    assert rf_mlp._tiling(512, rf_mlp.CHUNK) == (512, 256)


def test_stack_support_follows_the_tables(heads):
    """Linear int4 / int8 tables of the JAX package's alignment take the stack;
    floating and NF4 tables and a width whose int4 halves are not 128-aligned
    take the loop over the blocks; a wrapper of the wrong table type raises."""
    assert rf_mlp.stack_bits(heads[4][1]["res_blocks"]) == 4 and rf_mlp.stack_bits(heads[8][1]["res_blocks"]) == 8
    def tables(w, H, **kw):
        return {"mlp": {"w12": {"w": port_quantize_array(torch.randn(2, w, 2 * H), 4, **kw)},
                        "w3": {"w": port_quantize_array(torch.randn(2, H, w), 4, **kw)}}}

    assert rf_mlp.rf_mlp_supported(tables(256, 256))
    for unsupported in (params_from_jax(heads[0]["res_blocks"], "cpu"), tables(256, 256, scheme="nf4"),
                        tables(192, 512)):  # w/2 = 96
        assert not rf_mlp.rf_mlp_supported(unsupported)
    with pytest.raises(ValueError):
        rf_mlp.rf_mlp_stack_q8(heads[4][1]["res_blocks"], torch.zeros(2, CFG.width), torch.zeros(2, 2, 3 * CFG.width))


# ---------------------------------------------------------------------------
# the per-step route: rf_sample(fused=False) and a session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,cfg_rows,renorm", [(4, 2, None), (4, 3, "channel"), (8, 2, "channel"), (8, 3, None)],
                         ids=["int4-cfg2", "int4-cfg3-renorm", "int8-cfg2-renorm", "int8-cfg3"])
def test_per_step_route_matches_jax(heads, bits, cfg_rows, renorm, monkeypatch):
    qp, tree = heads[bits]
    rng = np.random.default_rng(5 + cfg_rows)
    z = rng.standard_normal((cfg_rows, CFG.z_channels)).astype(np.float32)
    noise = rng.standard_normal((1, CFG.target_channels)).astype(np.float32)
    kw = dict(text_cfg=3.0, image_cfg=1.5, cfg_renorm_type=renorm, cfg_rows=cfg_rows)
    _jax_stack_route(monkeypatch)
    want = jax_rf_sample(qp, CFG, jnp.asarray(z), None, noise=jnp.asarray(noise), **kw)
    calls = []
    stack = rf_head.rf_mlp_stack
    monkeypatch.setattr(rf_head, "rf_mlp_stack", lambda *a, **k: calls.append(k["int_dots"]) or stack(*a, **k))
    got = rf_head.rf_sample(tree, CFG, _t(z), noise=_t(noise), fused=False, **kw)
    assert calls == [bits == 4] * CFG.num_sampling_steps  # one stack per Euler step, JAX's default dot modes
    _close(got.numpy(), want, SILU_ULP_REL if bits == 4 else REL)


def test_session_through_the_per_step_route_matches_jax(heads, monkeypatch):
    """T2I on the tiny model at int4 (4 image tokens, 4 Euler steps) through
    RuntimeConfig(rf_fused_sampler=False) against the JAX session on its TPU
    route (the stack kernel in interpret mode). The MoE entries of both take
    exact dequant (the JAX package's CPU path has no s8 MoE), so the per-step
    stack is what runs in s8 on both sides: the same tokens, a stack launch
    per Euler step and none of the fused sampler, and an image within twice
    the gap between the JAX session at int4 and at fp32 weights (the error
    the int4 tier itself is allowed, as tests/test_torch_slice_int4.py holds
    it): an s8 rounding that flips in one package moves a latent by about
    1e-3 of its maximum, which the image loop feeds back into the LLM."""
    from mingunivision_tpu.config import GenerationConfig, RuntimeConfig
    from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
    from mingunivision_tpu_torch.config import RuntimeConfig as PortRuntime
    from mingunivision_tpu_torch.engine.session import MingUniVisionSession
    from mingunivision_tpu_torch.models import bailing_moe
    from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_bf16_plain
    from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_bf16_plain
    from test_torch_common import IMG_START, tiny_mm, to_jax
    from test_torch_slice import _bias_image_start, _t2i_prompt
    from test_torch_slice_int4 import _exact

    base = tiny_mm()
    cfg = dataclasses.replace(base, rf_head=CFG, image_gen=ImageGenConfig(num_image_tokens=4))
    # the tiny model's random weights, built by the port's initialiser (the JAX package's tree, far faster
    # on the CPU than its eager init), with this file's RF head
    tree = init_mm_params(base, device="cpu", dtype=torch.float32, generator=torch.Generator().manual_seed(1))
    params = dict(tree_map(lambda t: t.numpy().copy(), tree), rf_head=heads[0])
    ids, am, um, tm = _t2i_prompt(2)
    _bias_image_start(params, cfg, ids)
    qparams = dict(params, llm=quantize_tree(to_jax(params["llm"]), bits=4, min_size=MIN_SIZE), rf_head=heads[4][0])
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, generation=GenerationConfig(max_new_tokens=1),
              image_gen=ImageGenConfig(num_image_tokens=4, temperature=0.0))
    _jax_stack_route(monkeypatch)
    jax_runtime = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
    want, want_f32 = (JaxSession(to_jax(p), cfg, jax_runtime, seed=0).generate(ids, am, **kw) for p in (qparams, params))
    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "decode", _exact(moe_experts_stream_bf16_plain))
    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "prefill", _exact(moe_experts_swiglu_gmm_bf16_plain))
    steps = []
    stack = rf_head.rf_mlp_stack
    monkeypatch.setattr(rf_head, "rf_mlp_stack", lambda *a, **k: steps.append(1) or stack(*a, **k))
    monkeypatch.setattr(rf_head, "rf_sample_fused", None)  # the fused sampler must not be reached
    runtime = PortRuntime(max_seq_len=192, compute_dtype="float32", rf_fused_sampler=False)
    sess = MingUniVisionSession(params_from_jax(qparams, "cpu", torch.float32), cfg, runtime, seed=0, device="cpu")
    got = sess.generate(ids, am, **kw)
    assert got.token_ids == want.token_ids == want_f32.token_ids == [IMG_START]
    assert len(steps) == 4 * cfg.rf_head.num_sampling_steps
    tier_gap = float(np.abs(want.images[0] - want_f32.images[0]).max())
    err = float(np.abs(got.images[0] - want.images[0]).max())
    assert 0 < tier_gap and np.isfinite(got.images[0]).all()
    assert err <= 2 * tier_gap, (err, tier_gap)


# ---------------------------------------------------------------------------
# the fused int4 sampler's pipelined schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_rows,renorm", [(2, None), (3, "channel")], ids=["cfg2", "cfg3-renorm"])
def test_pipelined_sampler_plain_matches_pallas(heads, cfg_rows, renorm):
    cfg, params = CFG, heads[4][0]
    rng = np.random.default_rng(3)
    z = jnp.asarray(rng.standard_normal((cfg_rows, cfg.z_channels)), jnp.float32)
    noise = np.tile(rng.standard_normal((1, cfg.target_channels)).astype(np.float32), (cfg_rows, 1))
    ts, dts = _time_grid(cfg, None)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm == "channel")
    want = jax_rf_sample_fused(params, cfg, jnp.asarray(noise), block_mods, final_mods, dts, jnp.float32(3.0),
                               jnp.float32(1.1), compute_dtype=jnp.float32, interpret=True, schedule="pipelined",
                               down_chunk=128, **kw)
    args = (heads[4][1], cfg, _t(noise), _t(block_mods), _t(final_mods), _t(dts), 3.0, 1.1)
    kw["compute_dtype"] = torch.float32
    got = trs.rf_sample_fused_plain(*args, schedule="pipelined", down_chunk=128, **kw)
    _close(got.numpy(), want, SILU_ULP_REL)
    np.testing.assert_array_equal(trs.rf_sample_fused_q4_pipelined(*args, down_chunk=128, **kw).numpy(), got.numpy())
    # against the block schedule: the same integer sums, descaled per piece and added (fp32 reassociation,
    # 1e-4, as tests/test_rf_sampler_fused.py holds the JAX pair); with channel renorm the reassociation moves
    # the renorm ratio and later s8 scales at the ulp level, which the requantization grows along the
    # trajectory: 5e-3, as the JAX package holds its renorm pair
    _close(got.numpy(), trs.rf_sample_fused_plain(*args, **kw).numpy(), 1e-4 if renorm is None else 5e-3)
    assert trs.fitting_chunk(8192 // 2, trs.DOWN_CHUNK) == 1024 and trs.fitting_chunk(2048 // 2, 128) == 128


# ---------------------------------------------------------------------------
# the full-expert-block prefill MoE
# ---------------------------------------------------------------------------


def _gmm_setup(E=4, h=256, m=256, N=16, k=2, seed=4):
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    experts = {"gate_proj": 0.1 * jax.random.normal(ks[0], (E, h, m), jnp.float32),
               "up_proj": 0.1 * jax.random.normal(ks[1], (E, h, m), jnp.float32),
               "down_proj": 0.1 * jax.random.normal(ks[2], (E, m, h), jnp.float32)}
    x = jax.random.normal(ks[3], (N, h), jnp.float32)
    idx = jax.random.randint(ks[4], (N, k), 0, E)
    return {n: quantize_array(v, 4) for n, v in experts.items()}, x, idx


def test_full_block_prefill_plain_matches_pallas():
    E, k = 4, 2
    q, x, idx = _gmm_setup(E=E, k=k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    xs = jnp.take(x, order // k, axis=0)
    gs = jnp.bincount(flat_e, length=E).astype(jnp.int32)
    want = swiglu_gmm_quant(xs, q["gate_proj"], q["up_proj"], q["down_proj"], gs, tm=32, interpret=True,
                            int4_chunked=False)
    tables = params_from_jax(q, "cpu")
    row_token = torch.from_numpy(np.array(order // k, np.int32))
    row_expert = torch.from_numpy(np.array(flat_e[order], np.int64))
    got = swiglu_gmm_rows(tables, torch.from_numpy(np.array(x)), row_token, row_expert, None, E, full_block=True)
    _close(got.numpy(), want, REL)
    with pytest.raises(ValueError):  # the full-expert-block kernel has no s8 mode
        swiglu_gmm_rows(tables, torch.from_numpy(np.array(x)), row_token, row_expert, None, E, full_block=True,
                        s8=True)


def test_stacked_tables_without_a_layer_index_raise():
    """A depth-stacked (L, E, ...) table needs its layer: read without one, its
    depth would pass for its experts."""
    q, x, idx = _gmm_setup()
    stacked = params_from_jax({n: jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), v) for n, v in q.items()}, "cpu")
    assert layer_tables(stacked, 1)[0].q.shape[0] == 4
    xt, it = torch.from_numpy(np.array(x)), torch.from_numpy(np.asarray(idx))
    w = torch.full(it.shape, 0.5)
    for full_block in (False, True):
        with pytest.raises(ValueError, match="layer index"):
            moe_experts_swiglu_gmm(stacked, xt, it, w, 4, full_block=full_block)
    np.testing.assert_array_equal(moe_experts_swiglu_gmm(stacked, xt, it, w, 4, layer_idx=0, full_block=True).numpy(),
                                  moe_experts_swiglu_gmm(params_from_jax(q, "cpu"), xt, it, w, 4).numpy())
