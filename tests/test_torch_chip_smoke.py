"""PyTorch port, `chip_smoke.py`'s reference check run on the CPU: it passes on
the port as shipped (where the CPU's kernel entries are their plain versions,
so the kernel path equals the plain bf16 path) and fails when one entry of
the kernel path is made wrong by 10% or left out, at both tiers. On the card
the same check holds the CUDA kernels. The check on an image prompt is in
tests/test_torch_chip_smoke_image.py."""

import pytest
import torch

import chip_smoke
from mingunivision_tpu_torch.models import bailing_moe, rf_head

CPU = torch.device("cpu")
# (tier, module, entry the kernel path calls, how its output is made wrong)
WRONG = {
    "decode-moe-x1.1": ("bfloat16", bailing_moe, "moe_experts_stream", lambda y: y * 1.1),
    "prefill-moe-left-out": ("bfloat16", bailing_moe, "moe_experts_swiglu_gmm", lambda y: y * 0),
    "decode-attention-x1.1": ("bfloat16", bailing_moe, "decode_attention", lambda y: y * 1.1),
    "int4-decode-moe-x1.1": ("int4", bailing_moe, "moe_experts_stream", lambda y: y * 1.1),
    "int4-sampler-x1.1": ("int4", rf_head, "rf_sample_fused", lambda y: y * 1.1),
}


@pytest.mark.parametrize("tier", ["bfloat16", "int4"])
def test_reference_check_passes_the_port(tier):
    assert chip_smoke.run_reference(torch, CPU, tier)


@pytest.mark.parametrize("case", list(WRONG))
def test_reference_check_fails_a_wrong_entry(case, monkeypatch):
    tier, mod, attr, wrong = WRONG[case]
    entry = getattr(mod, attr)
    # only the kernel path: the check's plain runs restore the entries it finds and call the plain versions
    monkeypatch.setattr(mod, attr, lambda *a, **k: wrong(entry(*a, **k)))
    assert not chip_smoke.run_reference(torch, CPU, tier)
