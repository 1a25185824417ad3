"""PyTorch port: the training losses (engine/train.py) against the JAX package's
on the CPU, value and the grad of every leaf.

`lm_loss` on `tiny_llm_config()`, B = 2, T = 32 (B * T = 64, above the
decode MoE's 48 rows, so the MoE runs the differentiable fused entry and its
grouped-matmul backward, here through their plain versions), a padded row and
an image span (the image gate):
  - with the router aux losses, as shipped (k and v rounded to bf16 like the
    JAX package's bf16 cache): the loss within 1e-4, every grad within 1e-3 of
    its max. The bf16 rounding of k, v and their cotangents moves the fp32
    grads of either package by up to 5e-4 of their max under a 3e-6 relative
    change of the embeddings, so fp32 parity is held in the next case;
  - without the aux losses, k and v in fp32 on both sides
    (`test_torch_common.fp32_kv`): loss and every grad within 1e-4 of max
    (tests/test_torch_train_step.py);
  - at bf16, with the aux losses: each grad's error against the JAX package's
    fp32 grads within twice the JAX package's own bf16 error;
  - every leaf gets a nonzero grad (audio_gate aside: no loss reaches it, and
    its JAX grad is zero too); `remat_layers=True` gives the same grads;
  - the layers read through one `unbind` per stacked leaf (`layer_views`, the
    train forward's route) give the loss and grads of per-layer indexing
    (`layer_view` and the stacked expert tables), bit for bit, with and
    without remat.
The optimizer and the train steps are in tests/test_torch_train_step.py,
`image_gen_loss` in tests/test_torch_train_image.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu_torch.utils.convert import _same_path_leaves
from mingunivision_tpu_torch.utils.pytree import leaves
from chip_smoke import tree_paths
from test_torch_common import AUX, grad_errors, jax_lm_loss_grads, port_lm_loss_grads, train_batch

NO_GRAD = ("audio_gate",)  # lm_loss takes no audio mask: no loss reaches this router


@pytest.fixture(scope="module")
def batch():
    return train_batch()


@pytest.fixture(scope="module")
def shipped(batch):
    cfg, params, ids, mask, image = batch
    return (jax_lm_loss_grads(params, cfg, ids, mask, image, **AUX),
            port_lm_loss_grads(params, cfg, ids, mask, image, **AUX))


def test_lm_loss_with_aux_matches_jax(shipped):
    (loss_j, grads_j), (loss_p, port) = shipped
    assert abs(loss_p - loss_j) <= 1e-4 * abs(loss_j)
    for path, (err, scale) in grad_errors(port, grads_j).items():
        assert err <= 1e-3 * scale + 1e-12, f"{path}: {err:.3e} > 1e-3 x {scale:.3e}"


def test_every_leaf_gets_a_nonzero_grad(shipped):
    (_, grads_j), (_, port) = shipped
    for path, (p, g) in zip(tree_paths(port), _same_path_leaves(port, grads_j)):
        if any(f"/{name}/" in path for name in NO_GRAD):
            assert not g.any() and (p.grad is None or not p.grad.any()), path
        else:
            assert p.grad is not None and p.grad.abs().max() > 0, path


def test_lm_loss_bf16_within_twice_jax_bf16_error(batch, shipped):
    cfg, params, ids, mask, image = batch
    (loss_32, grads_32), _ = shipped
    loss_jb, grads_jb = jax_lm_loss_grads(params, cfg, ids, mask, image, jnp.bfloat16, **AUX)
    loss_pb, port_b = port_lm_loss_grads(params, cfg, ids, mask, image, torch.bfloat16, **AUX)
    assert abs(loss_pb - loss_32) <= 2 * abs(loss_jb - loss_32) + 1e-6
    jax_err = {path: float((g_b - g).abs().max()) for path, (g_b, g) in
               zip(tree_paths(grads_32), _same_path_leaves(grads_jb, grads_32))}
    for path, (err, _) in grad_errors(port_b, grads_32).items():
        assert err <= 2 * jax_err[path], f"{path}: {err:.3e} > 2 x {jax_err[path]:.3e}"


def test_remat_layers_gives_the_same_grads(batch, shipped):
    cfg, params, ids, mask, image = batch
    _, (_, port) = shipped
    _, remat = port_lm_loss_grads(params, dataclasses.replace(cfg, remat_layers=True), ids, mask, image, **AUX)
    for a, b in zip(leaves(port), leaves(remat)):
        if a.grad is not None:
            torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["layers", "remat-layers"])
def test_unbind_layer_views_give_the_indexing_grads_to_the_bit(batch, remat, monkeypatch):
    """The train forward takes each layer from one `unbind` per stacked leaf,
    the expert tables too (whose backward is one stack per leaf); the inference
    route's per-layer indexing, forced here, gives the same loss and grads to
    the bit."""
    from mingunivision_tpu_torch.models import bailing_moe

    cfg, params, ids, mask, image = batch
    cfg = dataclasses.replace(cfg, remat_layers=remat)
    split = bailing_moe.layer_views
    depths = []
    monkeypatch.setattr(bailing_moe, "layer_views", lambda tree, depth: depths.append(depth) or split(tree, depth))
    loss, viewed = port_lm_loss_grads(params, cfg, ids, mask, image, **AUX)
    assert depths == [cfg.num_hidden_layers]
    monkeypatch.setattr(bailing_moe, "is_float_tree", lambda tree: False)  # the route of quantized trees
    loss_i, indexed = port_lm_loss_grads(params, cfg, ids, mask, image, **AUX)
    assert depths == [cfg.num_hidden_layers] and loss == loss_i
    for path, a, b in zip(tree_paths(viewed), leaves(viewed), leaves(indexed)):
        assert (a.grad is None) == (b.grad is None), path
        if a.grad is not None:
            assert np.array_equal(a.grad.numpy(), b.grad.numpy()), path
