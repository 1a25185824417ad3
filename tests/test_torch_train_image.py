"""PyTorch port: `image_gen_loss` (engine/train.py) against the JAX package's
on the CPU: the LLM over [text, linear_proj(semantic tokens)] with the image
gate, vis_head, and the RF velocity loss through `rf_net_apply`, on the tiny
model with t and noise drawn from the JAX key and handed to the port. Its
cache dtype is the sequence's, fp32 here: the loss and every grad of the
{llm, rf_head, vis_head, linear_proj} tree within 1e-4 of max.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.engine import train as jax_train
from mingunivision_tpu_torch.engine import train as port_train
from mingunivision_tpu_torch.utils.convert import _same_path_leaves, params_from_jax
from mingunivision_tpu_torch.utils.pytree import leaves
from chip_smoke import tree_paths
from test_torch_common import random_params, tiny_mm, to_jax

B = 2


def test_image_gen_loss_matches_jax():
    mm = tiny_mm()
    full = random_params(mm, seed=4)
    params = {name: full[name] for name in ("llm", "rf_head", "vis_head", "linear_proj")}
    rng = np.random.default_rng(1)
    Tt, N = 8, 12
    text_ids = rng.integers(0, mm.llm.vocab_size, (B, Tt)).astype(np.int32)
    text_mask = np.ones((B, Tt), np.int32)
    text_mask[1, :2] = 0
    sem = rng.standard_normal((B, N, mm.mingtok.feature_dim)).astype(np.float32)
    latents = rng.standard_normal((B, N, mm.rf_head.target_channels)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.uniform(kt, (B * N,), jnp.float32))
    noise = np.asarray(jax.random.normal(kn, (B * N, mm.rf_head.target_channels), jnp.float32))
    loss_fn = functools.partial(jax_train.image_gen_loss, llm_cfg=mm.llm, rf_cfg=mm.rf_head)
    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        to_jax(params), text_ids=jnp.asarray(text_ids), text_mask=jnp.asarray(text_mask), sem_features=jnp.asarray(sem),
        latents=jnp.asarray(latents), key=key)
    grads_j = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j), "cpu")
    p = params_from_jax(params, "cpu")
    for leaf in leaves(p):
        leaf.requires_grad_(True)
    loss_p = port_train.image_gen_loss(p, mm.llm, mm.rf_head, torch.from_numpy(text_ids), torch.from_numpy(text_mask),
                                       torch.from_numpy(sem), torch.from_numpy(latents), t=torch.from_numpy(t),
                                       noise=torch.from_numpy(noise))
    loss_p.backward()
    assert abs(float(loss_p.detach()) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for path, (a, g) in zip(tree_paths(p), _same_path_leaves(p, grads_j)):
        got = torch.zeros_like(g) if a.grad is None else a.grad
        err, scale = float((got - g).abs().max()), float(g.abs().max())
        assert err <= 1e-4 * scale + 1e-12, f"{path}: {err:.3e} > 1e-4 x {scale:.3e}"
