"""PyTorch port, `chip_smoke.py`'s reference check on an image prompt (the
MingTok encoder, flash prefill, the capacity MoE dispatch, text decode) run on
the CPU: it passes on the port as shipped, at both tiers, and fails a flash
output made 10% wrong and a capacity dispatch that drops a valid row. On the
card the same check holds the CUDA kernels."""

import pytest
import torch

import chip_smoke
from mingunivision_tpu_torch.models import bailing_moe

CPU = torch.device("cpu")


def _drop_last_valid_row(y):
    """The dispatch's output (N, h) with the prompt's last valid row (452 ids in the 512 bucket) left out."""
    y = y.clone()
    y[451] = 0
    return y


# (tier, entry of the image-prompt kernel path, how its output is made wrong)
WRONG_IMAGE = {
    "flash-prefill-x1.1": ("bfloat16", "flash_prefill_attention", lambda y: y * 1.1),
    "capacity-dispatch-drops-a-valid-row": ("bfloat16", "moe_experts_capacity_gmm_exact", _drop_last_valid_row),
    "int4-flash-prefill-x1.1": ("int4", "flash_prefill_attention", lambda y: y * 1.1),
}


@pytest.mark.parametrize("tier", ["bfloat16", "int4"])
def test_image_reference_check_passes_the_port(tier):
    assert chip_smoke.run_reference_image(torch, CPU, tier)


@pytest.mark.parametrize("case", list(WRONG_IMAGE))
def test_image_reference_check_fails_a_wrong_entry(case, monkeypatch):
    tier, attr, wrong = WRONG_IMAGE[case]
    entry = getattr(bailing_moe, attr)
    monkeypatch.setattr(bailing_moe, attr, lambda *a, **k: wrong(entry(*a, **k)))
    assert not chip_smoke.run_reference_image(torch, CPU, tier)
