"""PyTorch port, independence from the JAX package: the port and chip_smoke.py
import neither `jax` nor `mingunivision_tpu` (not even its framework-free
modules), and the port's own config dataclasses equal the JAX package's
field by field; the port's RuntimeConfig adds the fields that take the place
of the JAX package's module-level kernel switches, with the flags' defaults."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

from mingunivision_tpu import config as jax_config
from mingunivision_tpu_torch import config as port_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mingunivision_tpu")
CONFIGS = ["ViTEncoderConfig", "SemanticDecoderConfig", "PixelDecoderConfig", "MingTokConfig", "BailingMoeConfig",
           "RFHeadConfig", "ImageGenConfig", "GenerationConfig", "MingUniVisionConfig", "RuntimeConfig"]


def _port_only_fields():
    """RuntimeConfig field -> the JAX package's module flags it stands for (the port passes them explicitly)."""
    from mingunivision_tpu.models import rf_head
    from mingunivision_tpu.ops.kernels import moe_swiglu_gmm, rf_mlp

    return {"RuntimeConfig": {"moe_prefill_int_dots": (moe_swiglu_gmm.INT_DOT_PREFILL_INT8,
                                                       moe_swiglu_gmm.INT_DOT_PREFILL_INT4),
                              "rf_int_dots": (rf_mlp.INT8_INT_DOTS,),
                              "rf_fused_sampler": (rf_head.FUSED_SAMPLER,),
                              "rf_int4_int_dots": (rf_mlp.INT4_UNPACK_MODE == "s8",)}}


def _forbidden(name: str) -> bool:
    """`jax`, `mingunivision_tpu` and their submodules, by exact name (not `mingunivision_tpu_torch`)."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_and_chip_smoke_load_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mingunivision_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'mingunivision_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in %r)]\n"
        "assert not bad, bad\n"
        "print(len(names))\n" % (FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25


def test_no_source_file_imports_the_jax_package():
    files = sorted((ROOT / "mingunivision_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not found, found


@pytest.mark.parametrize("name", CONFIGS)
def test_config_dataclass_fields_equal_jax(name):
    port, ref = getattr(port_config, name), getattr(jax_config, name)
    extra = _port_only_fields().get(name, {})
    assert [(f.name, f.compare) for f in dataclasses.fields(port) if f.name not in extra] == \
        [(f.name, f.compare) for f in dataclasses.fields(ref)]
    port_default, ref_default = port(), ref()
    for field, flags in extra.items():  # the flags' defaults, each flag read wherever the field applies
        assert all(getattr(port_default, field) == flag for flag in flags), field
    for f in dataclasses.fields(ref):
        got, want = getattr(port_default, f.name), getattr(ref_default, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("name", ["tiny_mingtok_config", "tiny_llm_config", "tiny_rf_config"])
def test_tiny_configs_equal_jax(name):
    assert dataclasses.asdict(getattr(port_config, name)()) == dataclasses.asdict(getattr(jax_config, name)())
