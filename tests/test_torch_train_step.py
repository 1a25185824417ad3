"""PyTorch port: the optimizer, its schedule and the train steps
(engine/train.py) against optax and the JAX package's on the CPU, at fp32.

  - `warmup_cosine_schedule` gives optax's value at every step of a 20-step
    schedule and past it (within fp32's rounding of optax's arithmetic; the
    first step's lr is 0);
  - `make_optimizer` and `make_scheduled_optimizer` (global-norm clip, then
    AdamW; gradients large enough to be clipped): three updates of a small
    tree, each within 1e-6 of each leaf's max of optax's;
  - `lm_loss` without the aux losses, k and v in fp32 on both sides
    (`test_torch_common.fp32_kv`): loss and every grad within 1e-4 of max;
  - `make_train_step` from a JAX TrainState after one step, carried across
    (`utils/convert.adamw_state_from_jax`: moments and count), one more step
    at accum_steps 1 and 2 (B = 4, T = 32: 64 rows per microbatch, above the
    decode MoE's 48), k and v in fp32 on both sides: the loss, and every
    updated param within 1e-5 of its leaf's max;
  - the JAX test's own check (tests/test_train.py): the loss falls over 1 + 5
    steps on a repeated batch (T = 32 here, so B * T passes the decode MoE);
  - the port's `TokenStream` (examples/train_lm.py's) gives seeded windows of
    its synthetic stream;
  - the router aux losses (balance, z, group balance, `moe_aux_losses`) give
    the JAX package's values.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.engine import train as jax_train
from mingunivision_tpu_torch.engine import train as port_train
from mingunivision_tpu_torch.utils.convert import _same_path_leaves, adamw_state_from_jax, params_from_jax
from test_torch_common import AUX, fp32_kv, grad_errors, jax_lm_loss_grads, port_lm_loss_grads, to_jax, train_batch


def _max_rel(got, want):
    return float((got.detach().float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_warmup_cosine_schedule_matches_optax():
    want = jax_train.warmup_cosine_schedule(3e-3, 5, 20)
    got = port_train.warmup_cosine_schedule(3e-3, 5, 20)
    assert got(0) == 0.0
    for count in range(24):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), count


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (scale * rng.standard_normal((4, 6))).astype(np.float32)},
            "b": [(scale * rng.standard_normal(5)).astype(np.float32),
                  (scale * rng.standard_normal((3, 2))).astype(np.float32)]}


@pytest.mark.parametrize("scheduled", [False, True], ids=["adamw", "clip-then-scheduled-adamw"])
def test_optimizer_updates_match_optax(scheduled):
    opt_j = jax_train.make_scheduled_optimizer(1e-2, 1, 5) if scheduled else jax_train.make_optimizer(1e-2)
    opt_p = port_train.make_scheduled_optimizer(1e-2, 1, 5) if scheduled else port_train.make_optimizer(1e-2)
    params_j = to_jax(_tree(0))
    state_j = opt_j.init(params_j)
    params_p = params_from_jax(_tree(0), "cpu")
    state_p = opt_p.init(params_p)
    for step in range(3):
        grads = _tree(step + 1, scale=10.0 if scheduled else 1.0)  # global norm about 50: clipped to 1
        updates, state_j = opt_j.update(to_jax(grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for p, g in _same_path_leaves(params_p, params_from_jax(grads, "cpu")):
            p.grad = g
        state_p.update()
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
        for p, w in _same_path_leaves(params_p, want):
            assert _max_rel(p, w) <= 1e-6, (step, _max_rel(p, w))
    assert state_p.count == 3


def test_lm_loss_fp32_parity_without_aux():
    cfg, params, ids, mask, image = train_batch()
    with pytest.MonkeyPatch.context() as mp:
        fp32_kv(mp)
        loss_j, grads_j = jax_lm_loss_grads(params, cfg, ids, mask, image)
        loss_p, port = port_lm_loss_grads(params, cfg, ids, mask, image)
    assert abs(loss_p - loss_j) <= 1e-4 * abs(loss_j)
    for path, (err, scale) in grad_errors(port, grads_j).items():
        assert err <= 1e-4 * scale + 1e-12, f"{path}: {err:.3e} > 1e-4 x {scale:.3e}"


@pytest.fixture(scope="module")
def jax_steps():
    """A JAX TrainState after one step (lr 1e-3, aux losses on), and the next
    step from it at accum_steps 1 and 2, k and v in fp32."""
    cfg, params, ids, mask, _ = train_batch(B=4)
    opt = jax_train.make_optimizer(1e-3)
    with pytest.MonkeyPatch.context() as mp:
        fp32_kv(mp)
        s0 = jax_train.TrainState(to_jax(params), opt.init(to_jax(params)), jnp.int32(0))
        s1, _ = jax_train.make_train_step(cfg, opt, donate=False, **AUX)(s0, jnp.asarray(ids), jnp.asarray(mask))
        nxt = {accum: jax_train.make_train_step(cfg, opt, accum_steps=accum, donate=False, **AUX)(
            s1, jnp.asarray(ids), jnp.asarray(mask)) for accum in (1, 2)}
    return cfg, ids, mask, s1, nxt


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_from_a_carried_jax_state(jax_steps, accum):
    cfg, ids, mask, s1, nxt = jax_steps
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, s1.params), "cpu")
    state = port_train.TrainState.create(params, port_train.make_optimizer(1e-3))
    adamw_state_from_jax(s1.opt_state, state.opt_state)
    state.step = int(s1.step)
    with pytest.MonkeyPatch.context() as mp:
        fp32_kv(mp)
        step = port_train.make_train_step(cfg, accum_steps=accum, **AUX)
        state, loss = step(state, torch.from_numpy(ids), torch.from_numpy(mask))
    want_state, want_loss = nxt[accum]
    assert state.step == int(want_state.step) == 2 and state.opt_state.count == 2
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_state.params), "cpu")
    for p, w in _same_path_leaves(state.params, want):
        assert _max_rel(p, w) <= 1e-5, _max_rel(p, w)


def test_train_step_reduces_loss_on_repeated_batch():
    cfg, params, ids, mask, _ = train_batch(T=32, seed=0)
    state = port_train.TrainState.create(params_from_jax(params, "cpu"), port_train.make_optimizer(1e-2))
    step = port_train.make_train_step(cfg)
    ids, mask = torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.int32)
    state, first = step(state, ids, mask)
    for _ in range(5):
        state, last = step(state, ids, mask)
    assert float(last) < float(first)
    assert state.step == 6


def test_token_stream_batches():
    """The synthetic stream: int32 windows of the vocabulary, the same for one
    seed, a period-97 pattern at about 90% of positions."""
    a, b = port_train.TokenStream(None, 500, seed=3), port_train.TokenStream(None, 500, seed=3)
    x = a.batch(2, 64)
    np.testing.assert_array_equal(x, b.batch(2, 64))
    assert x.shape == (2, 64) and x.dtype == np.int32 and 0 <= x.min() and x.max() < 500
    assert 0.8 < float(np.mean(a.ids[97:] == a.ids[:-97])) < 0.9


def test_router_losses_match_jax():
    """The three router aux losses on the same probabilities, logits and
    routing: balance and z over flat (N, E) rows, group balance per sample
    over (B, S, E) with 2 and 4 groups, and `moe_aux_losses` over stacked
    (L, N, E) router stats; within 1e-6 relative."""
    from mingunivision_tpu.models import bailing_moe as jax_bm
    from mingunivision_tpu_torch.models import bailing_moe as port_bm

    rng = np.random.default_rng(5)
    L, B, S, E, k = 2, 2, 24, 8, 2
    logits = rng.standard_normal((L, B * S, E)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[..., :k].astype(np.int32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = torch.from_numpy
    pairs = [(jax_bm.router_balance_loss(jnp.asarray(probs[0]), jnp.asarray(idx[0]), E),
              port_bm.router_balance_loss(t(probs[0]), t(idx[0]), E)),
             (jax_bm.router_z_loss(jnp.asarray(logits[0])), port_bm.router_z_loss(t(logits[0])))]
    for groups in (2, 4):
        p3, i3 = probs[0].reshape(B, S, E), idx[0].reshape(B, S, k)
        pairs.append((jax_bm.router_group_balance_loss(jnp.asarray(p3), jnp.asarray(i3), E, groups),
                      port_bm.router_group_balance_loss(t(p3), t(i3), E, groups)))
    want = jax_train.moe_aux_losses((jnp.asarray(logits), jnp.asarray(idx)), E, ep_groups=2)
    got = port_train.moe_aux_losses((t(logits), t(idx)), E, ep_groups=2)
    pairs += [(want[name], got[name]) for name in ("balance", "z", "group_balance")]
    for w, g in pairs:
        assert float(g) == pytest.approx(float(w), rel=1e-6)
