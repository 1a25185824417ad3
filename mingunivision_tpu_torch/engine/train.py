"""Training steps (counterpart of mingunivision_tpu/engine/train.py): the LM's
next-token loss with the router aux losses, the rectified-flow velocity loss
and the composed image-generation loss, MingTok's joint pixel-reconstruction
and feature-distillation loss, AdamW and its warmup-cosine schedule, train
steps that update the state in place, and the synthetic token and image
streams of the example training scripts.

The forward is the model's own with cfg.moe_differentiable set: the prefill
MoE goes through the differentiable fused entry (`moe_experts_swiglu_gmm_ad`:
the fused kernel forward, the grouped-matmul kernels `gmm` / `tgmm` in the
backward), attention runs over the new k and v without writing a cache, and
autograd does the rest. The optimizer is `torch.optim.AdamW` over the param
tree's leaves in tree order, with optax's semantics: every leaf decays (no
mask), eps outside the square root, moments in the param dtype, the learning
rate evaluated at the count of updates applied before the step (so the
warmup's first step applies none), and with `make_scheduled_optimizer` the
gradients clipped by their global norm first. A leaf no loss reaches gets a
zero gradient, as under jax.grad. Randomness is explicit: `rf_loss` takes t
and noise, or a torch.Generator to draw them.

RF loss convention (the JAX package's): x_t = t * noise + (1 - t) * data, and
the velocity target is v* = data - noise.

MingTok training (`mingtok_train_loss`, `make_mingtok_train_step`) runs the
three ViTs under autograd; on the pixel decoder's reduced tiers its attention
is the flash kernel with its backward kernels (ops/kernels/flash.py
`FlashViTAttention`), and the step's backward runs inside the pixel decoder's
fp32 tier, so the "default" tier's backward products use TF32 as its forward
does (the JAX package fixes each product's precision when it traces).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from mingunivision_tpu_torch.engine.generate import linear_proj_apply
from mingunivision_tpu_torch.models.bailing_moe import (
    bailing_forward,
    compute_logits,
    embed_tokens,
    router_balance_loss,
    router_group_balance_loss,
    router_z_loss,
)
from mingunivision_tpu_torch.models.mingtok import mingtok_encode, pixel_decoder_apply, pixel_reconstruction_loss
from mingunivision_tpu_torch.models.rf_head import rf_net_apply, vis_head_apply
from mingunivision_tpu_torch.ops.linear import dense, fp32_matmul_precision
from mingunivision_tpu_torch.ops.patching import expand_sem_to_pix_tokens
from mingunivision_tpu_torch.utils.pytree import leaves


def moe_aux_losses(router_stats, num_experts: int, ep_groups: int = 1) -> dict:
    """The router aux losses from `bailing_forward`'s router stats (logits
    (L, N, E) fp32, topk_idx (L, N, k)): dict(balance, z[, group_balance])."""
    logits, topk_idx = router_stats
    L, N, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    out = {
        "balance": router_balance_loss(probs.reshape(L * N, E), topk_idx.reshape(L * N, -1), num_experts),
        "z": router_z_loss(logits.reshape(L * N, E)),
    }
    if ep_groups > 1:
        out["group_balance"] = router_group_balance_loss(probs, topk_idx, num_experts, ep_groups)
    return out


def lm_loss(params, cfg, input_ids, attention_mask, image_mask=None, balance_alpha: float = 0.0,
            z_alpha: float = 0.0, group_alpha: float = 0.0, logits_l2_alpha: float = 0.0, ep_groups: int = 1):
    """Causal LM loss over a right-padded batch: input_ids (B, T), attention_mask
    (B, T). Non-zero balance_alpha / z_alpha / group_alpha add the router aux
    losses so weighted; logits_l2_alpha the mean L2 norm of the logits over the
    supervised positions. k and v are rounded to bf16, as the JAX package's
    bf16 cache holds them, at any param dtype."""
    cfg = dataclasses.replace(cfg, moe_differentiable=True)
    want_aux = balance_alpha > 0 or z_alpha > 0 or group_alpha > 0
    embeds = embed_tokens(params, input_ids)
    out = bailing_forward(params, cfg, embeds, None, attention_mask.bool(), image_mask=image_mask,
                          return_router_stats=want_aux, kv_dtype=torch.bfloat16)
    logits = compute_logits(params, cfg, out[0])[:, :-1]
    targets = input_ids[:, 1:]
    mask = attention_mask[:, 1:].float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    if want_aux:
        aux = moe_aux_losses(out[2], cfg.num_experts, ep_groups=max(ep_groups, 2 if group_alpha > 0 else 1))
        loss = loss + balance_alpha * aux["balance"] + z_alpha * aux["z"]
        if group_alpha > 0:
            loss = loss + group_alpha * aux["group_balance"]
    if logits_l2_alpha > 0:
        l2 = torch.linalg.vector_norm(logits.float(), dim=-1)
        loss = loss + logits_l2_alpha * (l2 * mask).sum() / denom
    return loss


def rf_loss(rf_params, cfg, data, z, generator: Optional[torch.Generator] = None, *, t=None, noise=None):
    """Velocity-matching loss of the RF head. data (N, target_channels) latents;
    z (N, z_channels) conditioning. t (N,) ~ U[0, 1) and noise ~ N(0, I) are
    drawn from `generator` unless given. MSE in fp32."""
    N = data.shape[0]
    if t is None:
        t = torch.rand((N,), generator=generator, device=data.device, dtype=torch.float32)
    if noise is None:
        noise = torch.randn(data.shape, generator=generator, device=data.device, dtype=torch.float32)
    data32 = data.float()
    x_t = t[:, None] * noise + (1.0 - t[:, None]) * data32
    v_pred = rf_net_apply(rf_params, cfg, x_t.to(data.dtype), t, z).float()
    return (v_pred - (data32 - noise)).square().mean()


def image_gen_loss(params, llm_cfg, rf_cfg, text_ids, text_mask, sem_features, latents,
                   generator: Optional[torch.Generator] = None, *, t=None, noise=None):
    """Teacher-forced AR image-generation loss over {llm, rf_head, vis_head,
    linear_proj}: the LLM runs over [text, linear_proj(semantic tokens)], the N
    hiddens at positions Tt-1 .. Tt+N-2 go through vis_head, and the RF loss
    regresses the ground-truth latents (B, N, C) from them. MingTok is frozen:
    its features arrive as data. t / noise / generator as in `rf_loss`."""
    llm_cfg = dataclasses.replace(llm_cfg, moe_differentiable=True)
    B, Tt = text_ids.shape
    N = sem_features.shape[1]
    embeds = embed_tokens(params["llm"], text_ids)
    proj = linear_proj_apply(params["linear_proj"], sem_features).to(embeds.dtype)
    seq = torch.cat([embeds, proj], dim=1)
    ones = torch.ones((B, N), dtype=torch.bool, device=seq.device)
    mask = torch.cat([text_mask.bool(), ones], dim=1)
    image_mask = torch.cat([torch.zeros_like(text_mask, dtype=torch.bool), ones], dim=1)
    hidden, _ = bailing_forward(params["llm"], llm_cfg, seq, None, mask, image_mask=image_mask, kv_dtype=seq.dtype)
    z = vis_head_apply(params["vis_head"], hidden[:, Tt - 1 : Tt - 1 + N])
    return rf_loss(params["rf_head"], rf_cfg, latents.reshape(B * N, -1), z.reshape(B * N, -1), generator,
                   t=t, noise=noise)


def mingtok_train_loss(params, cfg, images, teacher_features=None, *, pixel_weight: float = 1.0,
                       feature_weight: float = 1.0, compute_dtype=torch.bfloat16, remat: bool = False):
    """MingTok joint pretraining loss: pixel reconstruction plus semantic
    feature distillation. images (B, 3, H, W) normalised; teacher_features
    (B, N, feature_dim) targets for the semantic decoder's patch tokens, or
    None (pixel loss only). The pixel decoder runs from the semantic tokens
    through sem_to_pix (fp32) and the 2x2 token expand, kept at the patch
    level for `pixel_reconstruction_loss`. Returns (loss, metrics) with
    metrics["pixel_loss"] and, with a teacher, metrics["feature_distill_loss"]."""
    feats = mingtok_encode(params, cfg, images, compute_dtype=compute_dtype, remat=remat)
    sem = feats["x_norm_patchtokens"].float()
    ratio = cfg.semantic_decoder.patch_size // cfg.pixel_decoder.patch_size
    pix_in = expand_sem_to_pix_tokens(dense(sem, params["sem_to_pix"]), ratio)
    pred_patches = pixel_decoder_apply(params["pixel_decoder"], cfg.pixel_decoder, pix_in, remat=remat)
    loss = torch.zeros((), dtype=torch.float32, device=images.device)
    metrics = {}
    if pixel_weight:
        pl = pixel_reconstruction_loss(pred_patches, images.float(), cfg)
        loss = loss + pixel_weight * pl
        metrics["pixel_loss"] = pl
    if teacher_features is not None and feature_weight:
        fl = (sem - teacher_features.float()).square().mean()
        loss = loss + feature_weight * fl
        metrics["feature_distill_loss"] = fl
    return loss, metrics


# ---------------------------------------------------------------------------
# Optimizer / schedule / train steps
# ---------------------------------------------------------------------------


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, end_lr_frac: float = 0.1):
    """count -> lr: linear warmup from 0 to peak_lr over warmup_steps, then
    cosine decay to peak_lr * end_lr_frac at total_steps (optax's
    warmup_cosine_decay_schedule with init_value 0)."""
    end = peak_lr * end_lr_frac
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        c = min(count - warmup_steps, decay_steps)
        return peak_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, weight_decay) (b1 0.9, b2 0.999, eps 1e-8), after
    optax.clip_by_global_norm(clip) when `clip` is set. lr: a float or a
    schedule count -> lr. `init(params)` gives the state of one param tree."""

    lr: Union[float, Callable[[int], float]]
    weight_decay: float = 0.01
    clip: Optional[float] = None

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params) -> "AdamWState":
        return AdamWState(self, params)


class AdamWState:
    """AdamW over the floating leaves of `params` (made to require grad), in
    tree order; `count` updates applied so far."""

    def __init__(self, spec: AdamW, params):
        self.spec, self.params, self.count = spec, params, 0
        self.leaves = [p.requires_grad_(True) for p in leaves(params)]
        self.opt = torch.optim.AdamW(self.leaves, lr=spec.lr_at(0), betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=spec.weight_decay, foreach=False)

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    def update(self) -> None:
        """One update of every leaf, in place, from its .grad (None counts as
        zeros); the grads are clipped first when the spec says so."""
        grads = []
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.spec.clip is not None:
            clip_by_global_norm_(grads, self.spec.clip)
        for group in self.opt.param_groups:
            group["lr"] = self.spec.lr_at(self.count)
        self.opt.step()
        self.count += 1


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: every grad scaled as (g / norm) *
    max_norm when the global norm (fp32) is not below max_norm. Returns the norm."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay)


def make_scheduled_optimizer(peak_lr: float, warmup_steps: int, total_steps: int, weight_decay: float = 0.01,
                             clip: float = 1.0) -> AdamW:
    return AdamW(warmup_cosine_schedule(peak_lr, warmup_steps, total_steps), weight_decay, clip)


@dataclasses.dataclass
class TrainState:
    """params (updated in place by a step), the optimizer state over them, and
    the number of steps taken."""

    params: dict
    opt_state: AdamWState
    step: int = 0

    @classmethod
    def create(cls, params, optimizer: AdamW) -> "TrainState":
        return cls(params, optimizer.init(params), 0)


def _apply(state: TrainState, loss_and_backward) -> torch.Tensor:
    state.opt_state.zero_grad()
    loss = loss_and_backward()
    state.opt_state.update()
    state.opt_state.zero_grad()
    state.step += 1
    return loss


def make_train_step(cfg, accum_steps: int = 1, **loss_kwargs):
    """LM train step: `state, loss = step(state, input_ids, attention_mask)`
    updates the state's params and moments in place (the JAX package donates
    them) with the state's own optimizer (the JAX package passes it here).
    With accum_steps > 1 the batch splits into that many microbatches run in
    turn, their grads summed and divided by accum_steps, the loss averaged.
    `loss_kwargs` go to `lm_loss` (the router aux loss weights)."""

    def train_step(state: TrainState, input_ids, attention_mask):
        def loss_and_backward():
            if accum_steps == 1:
                loss = lm_loss(state.params, cfg, input_ids, attention_mask, **loss_kwargs)
                loss.backward()
                return loss.detach()
            mb = input_ids.shape[0] // accum_steps
            total = torch.zeros((), dtype=torch.float32, device=input_ids.device)
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                loss = lm_loss(state.params, cfg, input_ids[sl], attention_mask[sl], **loss_kwargs)
                loss.backward()
                total = total + loss.detach()
            for p in state.opt_state.leaves:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            return total / accum_steps

        return state, _apply(state, loss_and_backward)

    return train_step


def make_image_gen_train_step(llm_cfg, rf_cfg):
    """Image-generation train step over {llm, rf_head, vis_head, linear_proj}:
    `state, loss = step(state, text_ids, text_mask, sem_features, latents,
    generator, t=None, noise=None)`, in place, with the state's optimizer."""

    def train_step(state: TrainState, text_ids, text_mask, sem_features, latents, generator=None, *, t=None,
                   noise=None):
        def loss_and_backward():
            loss = image_gen_loss(state.params, llm_cfg, rf_cfg, text_ids, text_mask, sem_features, latents,
                                  generator, t=t, noise=noise)
            loss.backward()
            return loss.detach()

        return state, _apply(state, loss_and_backward)

    return train_step


def make_mingtok_optimizer(lr: float = 1e-4) -> AdamW:
    """`optax.adamw(lr)` as `examples/train_mingtok.py` uses it: weight decay 1e-4 (optax's default)."""
    return AdamW(lr, weight_decay=1e-4)


def pixel_tier_context(cfg):
    """The pixel decoder's fp32 tier as a context (none for "bf16")."""
    tier = cfg.pixel_decoder.matmul_precision
    return contextlib.nullcontext() if tier == "bf16" else fp32_matmul_precision(tier)


def make_mingtok_train_step(cfg, *, remat: bool = False, pixel_weight: float = 1.0, feature_weight: float = 1.0,
                            compute_dtype=torch.bfloat16):
    """MingTok train step (`examples/train_mingtok.py`'s `step`): `state, (loss,
    metrics) = step(state, images, teacher=None)` takes the value and grad of
    `mingtok_train_loss` and one AdamW update of the state's params and moments
    in place, with the state's optimizer (`make_mingtok_optimizer`). Without a
    teacher the feature weight is 1.0 and unused, as in the example. The
    backward runs inside the pixel decoder's fp32 tier (`pixel_tier_context`)."""

    def train_step(state: TrainState, images, teacher=None):
        out = {}

        def loss_and_backward():
            loss, metrics = mingtok_train_loss(state.params, cfg, images, teacher, pixel_weight=pixel_weight,
                                               feature_weight=feature_weight if teacher is not None else 1.0,
                                               compute_dtype=compute_dtype, remat=remat)
            with pixel_tier_context(cfg):
                loss.backward()
            out["metrics"] = {k: v.detach() for k, v in metrics.items()}
            return loss.detach()

        loss = _apply(state, loss_and_backward)
        return state, (loss, out["metrics"])

    return train_step


def synthetic_batch(rng: np.random.Generator, B: int, S: int) -> np.ndarray:
    """uint8 (B, S, S, 3) images with learnable low-frequency structure (the
    MingTok example's synthetic stream): per image two spatial frequencies in
    [0.5, 3) and a phase per channel from `rng`."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    out = np.empty((B, S, S, 3), np.uint8)
    for i in range(B):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        for c in range(3):
            img = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase[c])
            out[i, :, :, c] = (img * 255).astype(np.uint8)
    return out


class ImageStream:
    """The MingTok example's synthetic image stream: batches of uint8 (B, S, S,
    3) images from `synthetic_batch`, drawn from the numpy generator `seed`.
    (The example's file sources, an .npy or a directory of images, are not
    ported.)"""

    def __init__(self, S: int, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.S = S

    def batch(self, B: int):
        """-> (uint8 (B, S, S, 3) images, (B,) source indices, all 0: the
        example aligns teacher-feature rows with their images by them)."""
        return synthetic_batch(self.rng, B, self.S), np.zeros((B,), np.int64)


def normalize_images_chw(batch_hwc, device, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> torch.Tensor:
    """uint8 (B, H, W, 3) numpy -> fp32 (B, 3, H, W) on `device`, (x / 255 -
    mean) / std per channel: the uint8 bytes cross to the device and are
    normalised there (the port's stand-in for the JAX package's native
    prefetch queue, `utils/native_io.PrefetchQueue`)."""
    x = torch.from_numpy(np.ascontiguousarray(batch_hwc)).to(device)
    m = torch.tensor(mean, dtype=torch.float32, device=device)
    s = torch.tensor(std, dtype=torch.float32, device=device)
    return ((x.float() / 255.0 - m) / s).permute(0, 3, 1, 2).contiguous()


class TokenStream:
    """Batched (B, T)-window sampler over a flat token-id array (`lm_loss`
    shifts inputs and targets itself: feed T tokens, not T + 1). With a `path`:
    windows of that file (a .npy keeps its stored dtype, a raw binary is read
    as `data_dtype`) at offsets from the numpy generator `seed`; without: a
    synthetic stream of one repeated 97-token pattern with 10% of its tokens
    replaced at random, which a small model partly learns, where uniform
    random tokens would leave it at log(V)."""

    def __init__(self, path: Optional[str], vocab_size: int, seed: int = 0, data_dtype: str = "uint32"):
        self.rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        if path:
            self.ids = (np.load(path, mmap_mode="r") if path.endswith(".npy")
                        else np.memmap(path, dtype=np.dtype(data_dtype), mode="r"))
        else:
            base = self.rng.integers(0, vocab_size, 97)
            reps = np.tile(base, 4096 // 97 + 2)[: 4096 * 2]
            noise = self.rng.integers(0, vocab_size, reps.shape)
            keep = self.rng.random(reps.shape) < 0.9
            self.ids = np.where(keep, reps, noise).astype(np.uint32)

    def batch(self, B: int, T: int) -> np.ndarray:
        """(B, T) int32 windows at random offsets."""
        if len(self.ids) < T + 1:
            raise ValueError(f"data stream has {len(self.ids)} tokens; need at least seq+1 = {T + 1}")
        starts = self.rng.integers(0, len(self.ids) - T + 1, B)
        return np.stack([np.asarray(self.ids[s : s + T]) for s in starts]).astype(np.int32)
