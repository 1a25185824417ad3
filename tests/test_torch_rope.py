"""PyTorch port, rotary embeddings: MRoPE and the RoPE scaling family against
the JAX package's ops/rope.py on the same positions, at fp32 on the CPU
(tolerance 1e-6: the same fp32 formulas; cos/sin of the same angles)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.models import bailing_moe as jbm
from mingunivision_tpu.ops import rope as jrope
from mingunivision_tpu_torch.models import bailing_moe as tbm
from mingunivision_tpu_torch.ops import rope as trope
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import random_params, tiny_mm, to_jax

DIM, THETA, SECTIONS = 16, 600000.0, (2, 3, 3)
TOL = dict(rtol=0, atol=1e-6)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mrope_equal_planes_reduce_to_1d():
    pos = np.random.default_rng(0).integers(0, 300, (2, 7))
    planes = torch.from_numpy(np.stack([pos] * 3))
    got = trope.mrope_cos_sin(planes, DIM, THETA, SECTIONS)
    want = trope.rope_cos_sin(torch.from_numpy(pos), DIM, THETA)
    for g, w in zip(got, want):
        assert g.shape == (2, 7, DIM)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mrope_distinct_planes_match_jax():
    planes = np.random.default_rng(1).integers(0, 300, (3, 2, 7))
    _close(trope.mrope_cos_sin(torch.from_numpy(planes), DIM, THETA, SECTIONS),
           jrope.mrope_cos_sin(jnp.asarray(planes), DIM, THETA, SECTIONS))


@pytest.mark.parametrize("kw", [
    dict(scaling_type="none"),
    dict(scaling_type="linear", scaling_factor=4.0),
    dict(scaling_type="dynamic", scaling_factor=2.0, seq_len=100, max_position_embeddings=256),
    dict(scaling_type="dynamic", scaling_factor=2.0, seq_len=1000, max_position_embeddings=256),
    dict(scaling_type="dynamic", scaling_factor=1.0, seq_len=1000, max_position_embeddings=256),
    dict(scaling_type="yarn", scaling_factor=4.0, original_max_position_embeddings=64),
    dict(scaling_type="yarn", scaling_factor=8.0, original_max_position_embeddings=64, mscale=0.7, mscale_all_dim=0.3),
], ids=["none", "linear", "dynamic-within", "dynamic-beyond", "dynamic-factor1", "yarn", "yarn-mscale"])
def test_scaled_rope_matches_jax(kw):
    pos = np.random.default_rng(2).integers(0, 200, (2, 9))
    _close(trope.scaled_rope_cos_sin(torch.from_numpy(pos), DIM, 10000.0, **kw),
           jrope.scaled_rope_cos_sin(jnp.asarray(pos), DIM, 10000.0, **kw))


def test_scaling_helpers_match_jax():
    assert trope.dynamic_ntk_theta(1000, DIM, THETA, 2.0, 256) == jrope.dynamic_ntk_theta(1000, DIM, THETA, 2.0, 256)
    assert trope.dynamic_ntk_theta(100, DIM, THETA, 2.0, 256) == THETA
    assert trope.yarn_get_mscale(4.0, 0.7) == jrope.yarn_get_mscale(4.0, 0.7)
    with pytest.raises(ValueError):
        trope.scaled_rope_cos_sin(torch.zeros((1, 2), dtype=torch.long), DIM, THETA, scaling_type="ntk-by-parts",
                                  scaling_factor=2.0)


def test_bailing_forward_takes_mrope_planes_as_jax():
    """(3, B, T) positions go through MRoPE: distinct planes match the JAX
    forward (2e-4, fp32), equal planes equal the flat (B, T) positions."""
    cfg = tiny_mm().llm
    params = random_params(tiny_mm(), seed=5)["llm"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    planes = rng.integers(0, 40, (3, 2, 6))
    mask = np.ones((2, 16), bool)
    want, _ = jbm.bailing_forward(to_jax(params), cfg, jnp.asarray(x), jbm.LLMCache.create(cfg, 2, 16, jnp.float32),
                                  jnp.asarray(mask), positions=jnp.asarray(planes))
    tparams = params_from_jax(params, "cpu", torch.float32)

    def run(positions):
        cache = tbm.LLMCache.create(cfg, 2, 16, torch.float32)
        return tbm.bailing_forward(tparams, cfg, torch.from_numpy(x), cache, torch.from_numpy(mask),
                                   positions=torch.from_numpy(positions))[0]

    np.testing.assert_allclose(run(planes).numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(run(np.stack([planes[0]] * 3)), run(planes[0]), rtol=0, atol=0)
    assert not torch.equal(run(planes), run(planes[0]))  # the planes matter
