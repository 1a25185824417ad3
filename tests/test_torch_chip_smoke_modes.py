"""PyTorch port, `chip_smoke.py`'s reference check run on the CPU in the dot
modes of the quantized tiers and on the NF4 tier (the small models the
script's reference phase adds beside tests/test_torch_chip_smoke.py's tiers):
int4 with moe_int_dots=False, int8 with moe_prefill_int_dots and rf_int_dots
on, and NF4. The check passes on the port as shipped, where the CPU's kernel
entries are their plain versions; every LLM kernel entry is held against its
plain version at every call. On the card the same check holds the CUDA
kernels."""

import pytest
import torch

import chip_smoke
import test_torch_common  # noqa: F401  (one torch thread per test worker)

CPU = torch.device("cpu")
# (tier, RuntimeConfig fields), as chip_smoke.REFERENCE_TIERS names them
MODES = {"int4-exact-decode": ("int4", dict(moe_int_dots=False)),
         "int8-s8-prefill-and-sampler": ("int8", dict(moe_prefill_int_dots=True, rf_int_dots=True)),
         "nf4": ("nf4", {})}


def test_the_modes_are_the_reference_phase_s():
    assert all((tier, kw) in chip_smoke.REFERENCE_TIERS for tier, kw in MODES.values())


@pytest.mark.parametrize("mode", list(MODES))
def test_reference_check_passes_the_port_in_every_dot_mode(mode):
    tier, runtime_kw = MODES[mode]
    assert chip_smoke.run_reference(torch, CPU, tier, **runtime_kw)
