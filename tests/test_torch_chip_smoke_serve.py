"""PyTorch port, `chip_smoke.py`'s serve reference check run on the CPU: the
small model's paged serving engine with mid-flight admission passes on the
port as shipped (the CPU's kernel entries are their plain versions) and fails
when the paged decode attention is made wrong by 10%. On the card the same
check holds the CUDA kernels."""

import torch

import chip_smoke
from mingunivision_tpu_torch.engine import paged
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CPU = torch.device("cpu")


def test_serve_reference_check_passes_the_port():
    assert chip_smoke.run_reference_serve(torch, CPU)


def test_serve_reference_check_fails_a_wrong_paged_attention(monkeypatch):
    entry = paged.paged_decode_attention
    # only the kernel path: the check's plain runs swap in the plain version
    monkeypatch.setattr(paged, "paged_decode_attention", lambda *a, **k: entry(*a, **k) * 1.1)
    assert not chip_smoke.run_reference_serve(torch, CPU)
