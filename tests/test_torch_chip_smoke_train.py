"""PyTorch port, `chip_smoke.py`'s train reference check run on the CPU: the
small model's `lm_loss` backward through the training kernel entries against
their plain versions in fp32. It passes on the port as shipped (where the
CPU's entries are their plain versions, so the kernel route equals the plain
bf16 route), and fails when `tgmm` (the table gradients) or the backward's
`gmm` is made wrong by 10%: every call of those entries is held against its
plain version on the same inputs. On the card the same check holds the CUDA
kernels."""

import pytest
import torch

import chip_smoke
from mingunivision_tpu_torch.ops.kernels import moe_gmm
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CPU = torch.device("cpu")


def test_train_reference_check_passes_the_port():
    assert chip_smoke.run_reference_train(torch, CPU)


@pytest.mark.parametrize("entry", ["tgmm", "gmm"])
def test_train_reference_check_fails_a_wrong_entry(entry, monkeypatch):
    right = getattr(moe_gmm, entry)
    # only the kernel route: the check's plain runs patch the entries to their plain versions
    monkeypatch.setattr(moe_gmm, entry, lambda *a, **k: right(*a, **k) * 1.1)
    assert not chip_smoke.run_reference_train(torch, CPU)
