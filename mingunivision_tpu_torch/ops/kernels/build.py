"""Build and load the hand-written CUDA kernels.

All `.cu` sources under `mingunivision_tpu_torch/csrc/` are compiled by `nvcc`
for Hopper (`sm_90a`) into ONE shared library with a plain C interface, loaded
through `ctypes`. The library lands in `mingunivision_tpu_torch/_build/`, named
by a hash of the sources and flags (the nvcc/ptxas log beside it, `.log`), so an edited source is rebuilt and an
unchanged one is reused. The build runs at the first kernel launch (never at
import) and raises on any failure; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    "mu_moe_stream_bf16": [_P] * 10 + [_I] * 4 + [_P],
    "mu_swiglu_gmm_bf16": [_P] * 8 + [_I] * 3 + [_P],
    "mu_swiglu_gmm_tile_rows": [],
    "mu_decode_attention_bf16": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
}

_lib = None
build_info: dict = {}  # path / seconds / cached of the last build, for reports


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmingunivision_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is missing."""
    so = library_path()
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in CSRC_DIR.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC_DIR))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds, cached=False)
    return so


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def stream_handle(tensor) -> int:
    """The raw CUDA stream PyTorch would run `tensor`'s next op on."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
