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
