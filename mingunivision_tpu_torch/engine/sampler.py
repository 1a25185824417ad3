"""Token sampling: greedy / temperature / top-k / top-p (counterpart of
mingunivision_tpu/engine/sampler.py). Sampling draws from an explicit
`torch.Generator`."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e10


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """logits (B, vocab) fp32 -> (B,) int64."""
    if not do_sample:
        return logits.argmax(dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep the smallest set with cumulative prob >= top_p (HF shift-right
        # semantics): the cutoff is the smallest KEPT logit
        cutoff = sorted_logits.masked_fill(cum - probs > top_p, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, NEG_INF)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


def sample_token_per_slot(logits: torch.Tensor, generator: Optional[torch.Generator], *, do_sample: torch.Tensor,
                          temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling parameters as tensors, so a pool of greedy and sampled
    slots with different temperature / top-k / top-p shares one step.

    logits (B, vocab) fp32; do_sample (B,) bool; temperature, top_p (B,) fp32;
    top_k (B,) int (0 = off). Returns (B,) int64. Greedy rows are the argmax
    whatever the other rows ask. The warpers run in `sample_token`'s order
    (temperature, top-k, then top-p with HF's shift-right rule on the top-k
    filtered logits); the draw is one uniform per row from `generator`, taken
    for every row and every step, through the inverse CDF of the kept
    probabilities (a cut token has probability 0 and is never picked)."""
    B, V = logits.shape
    greedy = logits.argmax(dim=-1)
    t = temperature.float().clamp(min=1e-6)[:, None]
    lt = logits / t
    sorted_l = torch.sort(lt, dim=-1, descending=True).values
    kth = sorted_l.gather(1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    lt = lt.masked_fill((top_k > 0)[:, None] & (lt < kth), NEG_INF)
    sorted_l = torch.sort(lt, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    cum = probs.cumsum(dim=-1)
    cutoff = sorted_l.masked_fill(cum - probs > top_p.float()[:, None], float("inf")).amin(dim=-1, keepdim=True)
    lt = lt.masked_fill((top_p < 1.0)[:, None] & (lt < cutoff), NEG_INF)
    cdf = torch.softmax(lt, dim=-1).cumsum(dim=-1)
    u = 1.0 - torch.rand((B, 1), generator=generator, device=logits.device)  # (0, 1]: never before the first kept token
    sampled = torch.searchsorted(cdf, u * cdf[:, -1:]).clamp(max=V - 1)[:, 0]
    return torch.where(do_sample.to(logits.device), sampled, greedy)
