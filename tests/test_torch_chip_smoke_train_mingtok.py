"""PyTorch port, `chip_smoke.py`'s MingTok train reference check run on the
CPU: the small MingTok's `mingtok_train_loss` backward (the pixel decoder on
1,024 tokens, so its reduced tiers take the ViT flash entry) through the flash
training entries against their plain versions in fp32. It passes on the port
as shipped (where the CPU's entries are their plain versions, so the kernel
route equals the plain bf16 route), at "bf16" and with remat at "default",
and fails when the dQ or the dK / dV entry is made wrong by 10%: every call
of those entries is held against its plain version on the same inputs. On
the card the same check holds the CUDA kernels."""

import pytest
import torch

import chip_smoke
from mingunivision_tpu_torch.ops.kernels import flash
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CPU = torch.device("cpu")


@pytest.mark.parametrize("tier,remat", [("bf16", False), ("default", True)], ids=["bf16", "default-remat"])
def test_mingtok_reference_check_passes_the_port(tier, remat):
    assert chip_smoke.run_reference_mingtok(torch, CPU, tier, remat=remat)


@pytest.mark.parametrize("entry", ["flash_vit_bwd_dq", "flash_vit_bwd_dkv"])
def test_mingtok_reference_check_fails_a_wrong_entry(entry, monkeypatch):
    right = getattr(flash, entry)

    def wrong(*args, **kwargs):
        out = right(*args, **kwargs)
        return tuple(t * 1.1 for t in out) if isinstance(out, tuple) else out * 1.1

    # only the kernel route: the check's plain runs patch the entries to their plain versions
    monkeypatch.setattr(flash, entry, wrong)
    assert not chip_smoke.run_reference_mingtok(torch, CPU, "bf16")
