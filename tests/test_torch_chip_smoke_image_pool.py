"""PyTorch port, `chip_smoke.py`'s image-pool reference check run on the CPU:
the small model's pool (3 slots, a request admitted mid-loop, per-slot
text_cfg 1 / 3 / 9) passes on the port as shipped at bf16 and int4 (the CPU's
kernel entries are their plain versions), and fails when the gathered-expert
matmul held in context is made wrong by 10%, or when the fused sampler's
groups are given the wrong slot's scales. On the card the same check holds the
CUDA kernels."""

import torch

import chip_smoke
from mingunivision_tpu_torch.ops.kernels import expert_matmul, rf_sampler
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CPU = torch.device("cpu")


def test_pool_reference_check_passes_the_port():
    assert chip_smoke.run_reference_pool(torch, CPU, "bfloat16")
    assert chip_smoke.run_reference_pool(torch, CPU, "int4")


def test_pool_reference_check_fails_a_wrong_gathered_matmul(monkeypatch):
    entry = expert_matmul.gathered_expert_matmul

    def wrong(*args, **kwargs):
        return entry(*args, **kwargs) * 1.1

    wrong.launches = 0
    monkeypatch.setattr(expert_matmul, "gathered_expert_matmul", wrong)
    assert not chip_smoke.run_reference_pool(torch, CPU, "bfloat16")


def test_pool_reference_check_fails_a_sampler_given_another_slots_scale(monkeypatch):
    scales = rf_sampler.image_scales
    # the kernel route's groups only: the plain version reads the scales through cfg_combine
    monkeypatch.setattr(rf_sampler, "image_scales", lambda scale, n: scales(scale, n)[::-1])
    assert not chip_smoke.run_reference_pool(torch, CPU, "int4")
