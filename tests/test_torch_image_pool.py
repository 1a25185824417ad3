"""PyTorch port, the continuous-batching T2I pool (`engine/image_pool.py`):
the cases of the JAX package's tests/test_image_pool.py on a tiny config at
fp32 on the CPU. A slot's image is bit-equal to a run alone in a pool of the
same width with the same seed, whatever else is scheduled and whenever it was
admitted; `chunk` schedules and does not change a bit; per-slot guidance acts;
the pool agrees with the barrier batcher within 1e-5 (their KV sits at other
offsets: another order of the attention sums). Against the JAX pool at
temperature 0 with mixed per-slot scales (the Euler loop: the JAX pool
broadcasts (n, 1) scales there): semantic tokens and images within
IMAGE_ATOL = 1e-3. The int4 and int8 RF heads through the fused sampler's
plain route with mixed scales: each image bit-equal to the same image sampled
alone with its own scales, and within FUSED_TOL of the Euler route at the same
tier with the same scales (the fused route rounds to bf16 where the Euler loop
at fp32 does not, and at int4 it quantizes to s8)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from mingunivision_tpu.config import ImageGenConfig
from mingunivision_tpu.config import RuntimeConfig as JaxRuntimeConfig
from mingunivision_tpu.engine.image_pool import ImagePoolEngine as JaxPool
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.config import RuntimeConfig
from mingunivision_tpu_torch.engine.image_pool import ImagePoolEngine
from mingunivision_tpu_torch.models import rf_head
from mingunivision_tpu_torch.ops.kernels import rf_sampler
from mingunivision_tpu_torch.serving.image_batch import batched_image_generation
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import random_params, tiny_mm, to_jax

IMAGE_ATOL = 1e-3
FUSED_TOL = 5e-2  # of the Euler route's max |latent|
MIN_SIZE = 1024  # the tiny tables are far below the quantizer's 65536-element default
RT = RuntimeConfig(max_seq_len=192, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_mm(), image_gen=ImageGenConfig(num_image_tokens=4, text_cfg=3.0, image_cfg=1.1))
    params = random_params(cfg, seed=0)
    return cfg, params, params_from_jax(params, "cpu", torch.float32)


def _req(rng, T):
    ids = rng.integers(0, 400, (1, T))
    am = np.ones((1, T), np.int64)
    um = am.copy()
    um[:, T // 2 :] = 0
    return {"input_ids": ids, "attention_mask": am, "uncond_attention_mask": um}


def _solo(cfg, params, req, seed, *, slots=1, chunk=2, rt=RT, **kw):
    """One request alone in a `slots`-wide pool."""
    eng = ImagePoolEngine(params, cfg, rt, slots=slots, chunk=chunk)
    r = eng.add_request(req, seed, **kw)
    eng.run_until_idle()
    assert r.done
    return r


def test_admission_invariance(setup):
    """B admitted while A is mid-loop: both bit-equal to their solo runs in a
    pool of the same width."""
    cfg, _, tp = setup
    rng = np.random.default_rng(0)
    a, b = _req(rng, 5), _req(rng, 9)
    solo_a, solo_b = _solo(cfg, tp, a, 11, slots=2), _solo(cfg, tp, b, 22, slots=2)
    eng = ImagePoolEngine(tp, cfg, RT, slots=2, chunk=2)
    ra = eng.add_request(a, 11)
    eng.step()  # A is 2 tokens in (of 5 LLM steps) ...
    rb = eng.add_request(b, 22)  # ... when B lands in the free slot
    eng.run_until_idle()
    assert ra.done and rb.done
    for got, want in ((ra, solo_a), (rb, solo_b)):
        np.testing.assert_array_equal(got.sem_tokens, want.sem_tokens)
        np.testing.assert_array_equal(got.image, want.image)
    assert np.abs(ra.image - rb.image).max() > 1e-3


def test_chunk_size_invariance(setup):
    cfg, _, tp = setup
    req = _req(np.random.default_rng(1), 7)
    r1 = _solo(cfg, tp, req, 3, chunk=1)
    r7 = _solo(cfg, tp, req, 3, chunk=7)
    np.testing.assert_array_equal(r1.sem_tokens, r7.sem_tokens)
    np.testing.assert_array_equal(r1.image, r7.image)


def test_matches_barrier_batched_path(setup):
    cfg, _, tp = setup
    req = _req(np.random.default_rng(2), 6)
    barrier = batched_image_generation(tp, cfg, RT, [req], 5)[0]
    pool = _solo(cfg, tp, req, 5)
    np.testing.assert_allclose(pool.image, barrier, atol=1e-5, rtol=1e-5)


def test_per_slot_guidance_acts(setup):
    cfg, _, tp = setup
    req = _req(np.random.default_rng(4), 5)
    eng = ImagePoolEngine(tp, cfg, RT, slots=2, chunk=3)
    r_lo = eng.add_request(req, 8, text_cfg=1.0)
    r_hi = eng.add_request(req, 8, text_cfg=9.0)
    eng.run_until_idle()
    assert not np.array_equal(r_lo.sem_tokens, r_hi.sem_tokens)
    again = _solo(cfg, tp, req, 8, slots=2, chunk=3, text_cfg=9.0)
    np.testing.assert_array_equal(again.sem_tokens, r_hi.sem_tokens)


def test_trailing_hidden_and_slot_reuse(setup):
    cfg, _, tp = setup
    rng = np.random.default_rng(6)
    a, b = _req(rng, 5), _req(rng, 5)
    eng = ImagePoolEngine(tp, cfg, RT, slots=1, chunk=8)
    ra = eng.add_request(a, 31)
    eng.run_until_idle()
    rb = eng.add_request(b, 32)
    eng.run_until_idle()
    assert ra.last_hidden.shape == (cfg.llm.hidden_size,)
    assert np.isfinite(ra.last_hidden).all() and np.abs(ra.last_hidden).max() > 0
    solo_b = _solo(cfg, tp, b, 32)
    np.testing.assert_array_equal(rb.sem_tokens, solo_b.sem_tokens)
    np.testing.assert_array_equal(rb.last_hidden, solo_b.last_hidden)
    # 257 LLM steps per image at full length: here the 4 image tokens and the trailing step
    assert eng.micro_steps == 2 * (cfg.image_gen.num_image_tokens + 1)


def test_pool_full_and_no_pixels(setup):
    cfg, _, tp = setup
    req = _req(np.random.default_rng(7), 5)
    eng = ImagePoolEngine(tp, cfg, RT, slots=1, chunk=2, decode_pixels=False)
    assert eng.add_request(req, 0) is not None
    assert eng.add_request(req, 1) is None  # full
    done = eng.run_until_idle()
    assert len(done) == 1 and done[0].image is None and done[0].sem_tokens is not None


def test_quantized_llm_tier_pool(setup):
    """The int4 LLM tier through the pool (quantized expert tables under
    pooled_forward's decode MoE)."""
    cfg, params, _ = setup
    q = dict(params)
    q["llm"] = quantize_tree(to_jax(params["llm"]), bits=4, min_size=MIN_SIZE)
    tq = params_from_jax(q, "cpu", torch.float32)
    r = _solo(cfg, tq, _req(np.random.default_rng(8), 5), 2, slots=2, chunk=4)
    assert np.isfinite(r.sem_tokens).all() and np.isfinite(r.image).all()


def test_sharded_pool_is_not_ported(setup):
    cfg, _, tp = setup
    with pytest.raises(NotImplementedError, match="Queue 1.8"):
        ImagePoolEngine(tp, cfg, RT, slots=2, mesh=object())


def test_matches_jax_pool_with_mixed_slot_scales(setup):
    """Three requests, one admitted mid-loop, text_cfg 1 / 3 / 9, the noise off
    on both sides: the JAX pool's semantic tokens and images."""
    cfg, params, tp = setup
    rng = np.random.default_rng(9)
    reqs = [_req(rng, T) for T in (5, 9, 7)]
    scales = (1.0, 3.0, 9.0)
    want_eng = JaxPool(to_jax(params), cfg, JaxRuntimeConfig(max_seq_len=192, compute_dtype="float32"), slots=3,
                       chunk=2)
    eng = ImagePoolEngine(tp, cfg, RT, slots=3, chunk=2)
    runs = []
    for pool, key in ((want_eng, jax.random.PRNGKey), (eng, int)):
        rs = [pool.add_request(r, key(i), text_cfg=s, temperature=0.0)
              for i, (r, s) in enumerate(zip(reqs[:2], scales))]
        pool.step()
        rs.append(pool.add_request(reqs[2], key(2), text_cfg=scales[2], temperature=0.0))
        pool.run_until_idle()
        runs.append(rs)
    for want, got in zip(*runs):
        np.testing.assert_allclose(got.sem_tokens, np.asarray(want.sem_tokens), atol=IMAGE_ATOL)
        np.testing.assert_allclose(got.image, np.asarray(want.image), atol=IMAGE_ATOL)
        np.testing.assert_allclose(got.last_hidden, np.asarray(want.last_hidden), atol=IMAGE_ATOL)


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
def test_fused_route_with_mixed_scales(setup, bits, monkeypatch):
    """A pool of 3 slots, one prompt and seed, text_cfg 1 / 3 / 9 at an int4 or
    int8 RF head: the fused sampler's plain route (one group per slot) gives
    each slot's image the one it gets alone with its scale, the images
    differ, and each sample of the pool's loop agrees with the Euler route
    at the same tier with the same per-image scales (FUSED_TOL)."""
    cfg, params, _ = setup
    q = dict(params)
    q["rf_head"] = quantize_tree(to_jax(params["rf_head"]), bits=bits, min_size=MIN_SIZE)
    tq = params_from_jax(q, "cpu", torch.float32)
    assert rf_sampler.table_bits(tq["rf_head"]) == bits
    req = _req(np.random.default_rng(10), 6)
    calls, euler_err, groups = [], [], []
    sample, group = rf_head.rf_sample, rf_sampler._rf_sample_group

    def both(*args, **kwargs):
        calls.append(kwargs["text_cfg"])
        out = sample(*args, **kwargs)
        euler = sample(*args, **{**kwargs, "fused": False})
        euler_err.append(float((out.float() - euler.float()).abs().max() / euler.float().abs().max()))
        return out

    from mingunivision_tpu_torch.engine import image_pool

    monkeypatch.setattr(image_pool, "rf_sample", both)
    monkeypatch.setattr(rf_sampler, "_rf_sample_group", lambda *a, **k: groups.append(k) or group(*a, **k))
    eng = ImagePoolEngine(tq, cfg, RT, slots=3, chunk=3)
    rs = [eng.add_request(req, 4, text_cfg=s) for s in (1.0, 3.0, 9.0)]
    eng.run_until_idle()
    n_steps = cfg.image_gen.num_image_tokens + 1
    assert calls[0] == [1.0, 3.0, 9.0] and len(calls) == n_steps
    assert len(groups) == 3 * n_steps  # one group per slot: 3 CFG rows fill a launch
    assert max(euler_err) <= FUSED_TOL, max(euler_err)
    monkeypatch.setattr(image_pool, "rf_sample", sample)
    for r, s in zip(rs, (1.0, 3.0, 9.0)):
        np.testing.assert_array_equal(r.sem_tokens, _solo(cfg, tq, req, 4, slots=3, chunk=3, text_cfg=s).sem_tokens)
    assert min(np.abs(rs[i].image - rs[j].image).max() for i, j in ((0, 1), (1, 2), (0, 2))) > 1e-3


@pytest.fixture(scope="module")
def rf_tiers(setup):
    """The RF head by table bits: None fp32 (the Euler loop), 4 and 8 (the fused sampler's plain route)."""
    _, params, tp = setup
    quantized = {bits: params_from_jax({"rf_head": quantize_tree(to_jax(params["rf_head"]), bits=bits,
                                                                 min_size=MIN_SIZE)}, "cpu", torch.float32)["rf_head"]
                 for bits in (4, 8)}
    return {None: tp["rf_head"], **quantized}


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["euler-fp32", "fused-int4", "fused-int8"])
@pytest.mark.parametrize("cfg_rows", [2, 3])
def test_rf_sample_per_image_scales(setup, rf_tiers, bits, cfg_rows):
    """`rf_sample` with one scale pair per image: equal scales given per image
    are bit-equal to the same scales given as numbers (the route as before);
    mixed scales give each image what it gets sampled alone with its own pair.
    The fused route forms its groups from images with equal pairs."""
    cfg = setup[0]
    rf = rf_tiers[bits]
    g = torch.Generator().manual_seed(0)
    n = 3
    z = torch.randn((cfg_rows * n, cfg.rf_head.z_channels), generator=g)
    noise = torch.randn((n, cfg.rf_head.target_channels), generator=g)
    kw = dict(noise=noise, cfg_rows=cfg_rows, cfg_renorm_type="channel")
    same = rf_head.rf_sample(rf, cfg.rf_head, z, text_cfg=3.0, image_cfg=1.5, **kw)
    torch.testing.assert_close(rf_head.rf_sample(rf, cfg.rf_head, z, text_cfg=[3.0] * n,
                                                 image_cfg=torch.full((n,), 1.5), **kw), same, rtol=0, atol=0)
    tcfg, icfg = [1.0, 9.0, 3.0], [1.5, 1.5, 2.0]
    mixed = rf_head.rf_sample(rf, cfg.rf_head, z, text_cfg=tcfg, image_cfg=icfg, **kw)
    for i in range(n):
        rows = torch.arange(cfg_rows) * n + i
        alone = rf_head.rf_sample(rf, cfg.rf_head, z[rows], noise=noise[i : i + 1], cfg_rows=cfg_rows,
                                  cfg_renorm_type="channel", text_cfg=tcfg[i], image_cfg=icfg[i])
        torch.testing.assert_close(mixed[rows], alone, rtol=0, atol=1e-6 if bits is None else 0)
    with pytest.raises(ValueError, match="guidance scales"):
        rf_head.rf_sample(rf, cfg.rf_head, z, text_cfg=[1.0, 2.0], **kw)
