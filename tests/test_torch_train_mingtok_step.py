"""PyTorch port, the MingTok train step and what surrounds it, against the JAX
package on the CPU: `pixel_reconstruction_loss` in each loss type, with and
without a patch mask, value and grad; one AdamW step of the tiny MingTok
(`make_mingtok_train_step`) from a JAX TrainState carried across by
`adamw_state_from_jax`, against `optax.adamw(1e-4)`: params and both moments;
the train checkpointer (save, step, restore, equal); the synthetic image
stream and its normalisation; the profiling helpers."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import tiny_mingtok_config
from mingunivision_tpu.engine import train as jtrain
from mingunivision_tpu.models import mingtok as jmt
from mingunivision_tpu_torch.engine import train as ttrain
from mingunivision_tpu_torch.models import mingtok as tmt
from mingunivision_tpu_torch.utils import checkpoint, profiling
from mingunivision_tpu_torch.utils.convert import _same_path_leaves, adamw_state_from_jax, params_from_jax
from mingunivision_tpu_torch.utils.pytree import leaves

import test_torch_common  # noqa: F401  (one torch thread per test worker)


def _loss_cfg(loss_type, norm_pix=True):
    cfg = tiny_mingtok_config()
    return dataclasses.replace(cfg, pixel_decoder=dataclasses.replace(cfg.pixel_decoder, loss_type=loss_type,
                                                                      norm_pix_loss=norm_pix))


@pytest.mark.parametrize("masked", [False, True], ids=["all-patches", "masked"])
@pytest.mark.parametrize("loss_type,norm_pix", [("L2", True), ("L2", False), ("L1", True), ("L1-tanh", True),
                                                ("L1-plain", True)],
                         ids=["L2-normpix", "L2", "L1", "L1-tanh", "L1-plain"])
def test_pixel_reconstruction_loss_matches_jax(loss_type, norm_pix, masked):
    """64-px images at pixel patch 8 (64 patches) against a 4 x 4 patch mask
    (each mask patch covers 2 x 2 pixel patches): value and grad of the
    prediction, fp32."""
    cfg = _loss_cfg(loss_type, norm_pix)
    rng = np.random.default_rng(len(loss_type) + masked)
    pred = rng.standard_normal((2, 64, 8 * 8 * 3)).astype(np.float32)
    target = np.tanh(rng.standard_normal((2, 3, 64, 64))).astype(np.float32)
    mask = (rng.random((2, 16)) < 0.4) if masked else None

    def jloss(p):
        return jmt.pixel_reconstruction_loss(p, jnp.asarray(target), cfg, None if mask is None else jnp.asarray(mask))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = tmt.pixel_reconstruction_loss(tp, torch.from_numpy(target), cfg,
                                        None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-8)


@pytest.fixture(scope="module")
def jax_steps():
    """The tiny MingTok's JAX TrainState after one `optax.adamw(1e-4)` step on
    a batch with a teacher (fp32, the "high" tier), and the state after a
    second step on the same batch."""
    cfg = tiny_mingtok_config()
    params = jmt.init_mingtok_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    S = cfg.encoder.img_size
    imgs = np.tanh(rng.standard_normal((1, 3, S, S))).astype(np.float32)
    teacher = rng.standard_normal((1, (S // 16) ** 2, cfg.feature_dim)).astype(np.float32)
    opt = optax.adamw(1e-4)

    def step(carry):
        p, o = carry
        (loss, _), grads = jax.value_and_grad(jtrain.mingtok_train_loss, has_aux=True)(
            p, cfg, jnp.asarray(imgs), jnp.asarray(teacher), compute_dtype=jnp.float32)
        updates, o = opt.update(grads, o, p)
        return (optax.apply_updates(p, updates), o), float(loss)

    first, _ = step((params, opt.init(params)))
    second, loss = step(first)
    return cfg, imgs, teacher, first, second, loss


def _port_state(first):
    params, opt_state = first
    state = ttrain.TrainState.create(params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"),
                                     ttrain.make_mingtok_optimizer(1e-4))
    adamw_state_from_jax(opt_state, state.opt_state)
    return state


def test_mingtok_train_step_matches_optax_adamw(jax_steps):
    """One more step from the JAX state after one: the loss, every param and
    both moments against optax.adamw(1e-4) (weight decay 1e-4). A param within
    1e-5 of its leaf's max plus 1e-2 of the learning rate: Adam divides each
    element's first moment by the root of its own second moment, so the grads'
    fp32 differences (about 1e-5 of a leaf's max) come back divided by that
    element's own grad, and an element whose grad is small against its leaf's
    moves by a part of its lr-sized step (3.1e-3 lr at worst here, in the
    zero-initialised biases). The moments within 1e-4 of their max (the grads'
    fp32 parity)."""
    cfg, imgs, teacher, first, second, want_loss = jax_steps
    state = _port_state(first)
    assert state.opt_state.count == 1 and state.opt_state.spec.weight_decay == 1e-4
    step = ttrain.make_mingtok_train_step(cfg, compute_dtype=torch.float32)
    state, (loss, metrics) = step(state, torch.from_numpy(imgs), torch.from_numpy(teacher))
    assert state.step == 1 and state.opt_state.count == 2 and set(metrics) == {"pixel_loss", "feature_distill_loss"}
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    want_params, want_opt = second
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params), "cpu")
    for p, w in _same_path_leaves(state.params, want):
        assert float((p.detach() - w).abs().max()) <= 1e-5 * float(w.abs().max()) + 1e-2 * 1e-4
    adam = want_opt[0]
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
        for p, w in _same_path_leaves(state.params, moments):
            got = state.opt_state.opt.state[p][name]
            assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-30, name


def test_async_checkpointer_saves_steps_and_restores(jax_steps, tmp_path):
    """save -> a step (params and moments move) -> restore: every param, moment,
    the update count and the step are the saved ones; the next step from the
    restored state equals the step taken after the save."""
    cfg, imgs, teacher, first, _, _ = jax_steps
    state = _port_state(first)
    step = ttrain.make_mingtok_train_step(cfg, compute_dtype=torch.float32)
    args = (torch.from_numpy(imgs), torch.from_numpy(teacher))

    def snapshot(st):
        return ([t.detach().clone() for t in leaves(st.params)],
                [{k: v.clone() for k, v in st.opt_state.opt.state[p].items()} for p in st.opt_state.leaves],
                st.opt_state.count, st.step)

    saved = snapshot(state)
    ckptr = checkpoint.AsyncTrainCheckpointer()
    path = str(tmp_path / "step_0000001.pt")
    ckptr.save(path, state)
    state, _ = step(state, *args)
    after = snapshot(state)
    assert not all(torch.equal(a, b) for a, b in zip(after[0], saved[0]))
    ckptr.restore(path, state)
    ckptr.close()
    restored = snapshot(state)
    assert all(torch.equal(a, b) for a, b in zip(restored[0], saved[0]))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(restored[1], saved[1]) for k in b)
    assert restored[2:] == saved[2:]
    state, _ = step(state, *args)
    assert all(torch.equal(a, b) for a, b in zip(snapshot(state)[0], after[0]))
    # a bare param tree round-trips too, and without a template comes back on the host
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    checkpoint.save_pytree(str(tmp_path / "tree.pt"), tree)
    back = checkpoint.restore_pytree(str(tmp_path / "tree.pt"))
    assert torch.equal(back["a"], tree["a"]) and back["b"][0].dtype == torch.bfloat16
    template = {"a": torch.zeros(2, 3), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    assert torch.equal(checkpoint.restore_pytree(str(tmp_path / "tree.pt"), template)["a"], tree["a"])


def test_image_stream_and_normalisation():
    """The synthetic stream is seeded (uint8 (B, S, S, 3), one generator) and
    normalises as the JAX package's `native_io.normalize_images_chw` computes
    it in numpy: (x / 255 - 0.5) / 0.5, channels first."""
    a, idx = ttrain.ImageStream(32, seed=0).batch(2)
    b, _ = ttrain.ImageStream(32, seed=0).batch(2)
    assert a.dtype == np.uint8 and a.shape == (2, 32, 32, 3) and np.array_equal(a, b) and not idx.any()
    assert not np.array_equal(a[0], a[1]) and a.min() < 10 and a.max() > 245
    got = ttrain.normalize_images_chw(a, torch.device("cpu"))
    want = ((a.astype(np.float32) / 255.0 - 0.5) / 0.5).transpose(0, 3, 1, 2)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_profiling_helpers():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.time("step", block_on={"x": torch.ones(4)}), profiling.trace("step"):
            pass
    summary = timer.summary()["step"]
    assert summary["n"] == 3 and summary["min_ms"] <= summary["p50_ms"] <= summary["max_ms"]
    assert profiling.force_sync([torch.ones(3), {"y": torch.full((2,), 2.0, dtype=torch.bfloat16)}]) == 7.0
