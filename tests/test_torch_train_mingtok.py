"""PyTorch port, MingTok training: `mingtok_train_loss`'s value and the grad of
every leaf against `jax.value_and_grad` of the JAX package's, on
`params_from_jax` of the same tree and the same images, on the CPU: the tiny
config (64 pixel-decoder tokens) and one whose pixel decoder reaches 1,024
tokens (256-px images), at the pixel decoder's "high", "default" and "bf16"
tiers, with and without a teacher; the remat route against the plain one;
the per-layer views by `unbind` against per-layer indexing, to the bit.

Tolerances. At "high" both packages compute in fp32 throughout: 2e-4 of each
leaf's maximum. At the reduced tiers the packages round at other places: on
the CPU the JAX package never takes the flash kernel (its gate needs a TPU),
so its "default" tier computes in fp32 there, while the port's plain version
of the kernel rounds q, k, v and the probabilities to bf16 (at "default" too)
and its backward follows the library's formula. So at a reduced tier the
port's loss and each leaf are held against the JAX package's fp32 result
("high") within twice the bf16 gap, the distance between the JAX package's
"bf16" tier and that fp32 result on the same inputs, plus 1e-3 of the fp32
maximum: the port's reduced tier may lie no further from fp32 than twice the
JAX package's own bf16 computation does. (Held against the JAX "bf16" tier
itself, two bf16 computations whose errors point in opposite directions can
lie more than two gaps apart: 2.03 gaps at one leaf here.)"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import tiny_mingtok_config
from mingunivision_tpu.engine import train as jtrain
from mingunivision_tpu.models import mingtok as jmt
from mingunivision_tpu_torch.engine import train as ttrain
from mingunivision_tpu_torch.models import vit as tvit
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.pytree import layer_view, layer_views, leaves

import test_torch_common  # noqa: F401  (one torch thread per test worker)

CONFIGS = {"tiny": 64, "n1024": 256}  # name -> image size (pixel-decoder tokens: 64 and 1,024)


def _cfg(name: str, tier: str):
    cfg = tiny_mingtok_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, img_size=CONFIGS[name]))
    return dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, matmul_precision=tier))


@functools.lru_cache(maxsize=None)
def _data(name: str):
    """The JAX init tree (numpy fp32, cls token random), a (1, 3, S, S) image
    in [-1, 1] and teacher features (1, N, 64), all from numpy seeds."""
    cfg = _cfg(name, "high")
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    jmt.init_mingtok_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    rng = np.random.default_rng(1)
    params["encoder"]["cls_token"] = (0.02 * rng.standard_normal(params["encoder"]["cls_token"].shape)).astype(np.float32)
    S = cfg.encoder.img_size
    images = np.tanh(rng.standard_normal((1, 3, S, S))).astype(np.float32)
    teacher = rng.standard_normal((1, (S // 16) ** 2, cfg.feature_dim)).astype(np.float32)
    return params, images, teacher


@functools.lru_cache(maxsize=None)
def _jax(name: str, tier: str, with_teacher: bool):
    """(loss, [grad leaves]) of the JAX package, fp32 params and compute."""
    params, images, teacher = _data(name)
    cfg = _cfg(name, tier)

    def f(p):
        return jtrain.mingtok_train_loss(p, cfg, jnp.asarray(images), jnp.asarray(teacher) if with_teacher else None,
                                         compute_dtype=jnp.float32)

    (loss, _), grads = jax.value_and_grad(f, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)]


def _port(name: str, tier: str, with_teacher: bool, remat: bool = False):
    """(loss, [grad leaves], metrics) of the port, fp32 params and compute, the
    backward inside the tier's context as the train step runs it."""
    params, images, teacher = _data(name)
    cfg = _cfg(name, tier)
    p = params_from_jax(params, "cpu", torch.float32)
    for t in leaves(p):
        t.requires_grad_(True)
    loss, metrics = ttrain.mingtok_train_loss(p, cfg, torch.from_numpy(images),
                                              torch.from_numpy(teacher) if with_teacher else None,
                                              compute_dtype=torch.float32, remat=remat)
    with ttrain.pixel_tier_context(cfg):
        loss.backward()
    grads = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves(p)]
    return float(loss), grads, metrics


@pytest.mark.parametrize("with_teacher", [True, False], ids=["teacher", "pixel-only"])
@pytest.mark.parametrize("tier", ["high", "default", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "n1024"])
def test_mingtok_train_loss_and_every_grad_match_jax(name, tier, with_teacher):
    want_loss, want = _jax(name, "high", with_teacher)  # fp32: the reference at every tier
    loss, got, metrics = _port(name, tier, with_teacher)
    assert set(metrics) == ({"pixel_loss", "feature_distill_loss"} if with_teacher else {"pixel_loss"})
    assert len(got) == len(want) and all(g.shape == w.shape for g, w in zip(got, want))
    if tier == "high":
        np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max() + 1e-7
        return
    gap_loss, gap = _jax(name, "bf16", with_teacher)
    assert abs(loss - want_loss) <= 2 * abs(gap_loss - want_loss) + 1e-3 * abs(want_loss)
    for g, w, b in zip(got, want, gap):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 2 * np.abs(b - w).max() + 1e-3 * np.abs(w).max()


@pytest.mark.parametrize("name,tier", [("tiny", "high"), ("n1024", "default")], ids=["tiny-high", "n1024-default"])
def test_remat_grads_equal_the_plain_route(name, tier):
    """As the JAX package's test_mingtok_remat_grads_match: the same loss and
    grads with each ViT block recomputed in the backward. At "default" the
    recompute runs outside the forward's tier context and must re-enter it (it
    takes the flash entry again)."""
    loss0, g0, _ = _port(name, tier, True)
    loss1, g1, _ = _port(name, tier, True, remat=True)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_unbind_layer_views_give_the_indexing_grads_to_the_bit(monkeypatch):
    """Under grad the blocks read their layers through one `unbind` per leaf;
    per-layer indexing (`layer_view`) gives the same grads, bit for bit."""
    params, _, _ = _data("tiny")
    p = params_from_jax(params, "cpu", torch.float32)
    tree = p["semantic_decoder"]["blocks"]
    depth = tree["norm1"]["w"].shape[0]
    views = layer_views(tree, depth)
    assert all(torch.equal(a, b) for i in range(depth) for a, b in zip(leaves(views[i]), leaves(layer_view(tree, i))))
    first, _, _ = _port("tiny", "high", True)
    grads = _port("tiny", "high", True)[1]
    monkeypatch.setattr(tvit, "layer_views", lambda t, d: [layer_view(t, i) for i in range(d)])
    loss, indexed, _ = _port("tiny", "high", True)
    assert loss == first
    assert all(np.array_equal(a, b) for a, b in zip(grads, indexed))
