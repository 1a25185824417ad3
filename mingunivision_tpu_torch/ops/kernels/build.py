"""Build and load the hand-written CUDA kernels.

Each `.cu` source under `mingunivision_tpu_torch/csrc/` is compiled by its own
`nvcc` for Hopper (`sm_90a`), all started together, and the objects are linked
into ONE shared library with a plain C interface, loaded through `ctypes`. The
library lands in `mingunivision_tpu_torch/_build/`, named by a hash of the
sources and flags (the nvcc/ptxas log beside it, `.log`), so an edited source
is rebuilt and an unchanged one is reused. The build runs at the first kernel
launch (never at import) and raises on any failure; there is no fallback.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    "mu_moe_stream_bf16": [_P] * 10 + [_I] * 4 + [_P],
    "mu_swiglu_gmm_bf16": [_P] * 8 + [_I] * 3 + [_P],
    "mu_swiglu_gmm_tile_rows": [],
    "mu_decode_attention_bf16": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "mu_moe_stream_q4s8": [_P] * 13 + [_I] * 4 + [_P],
    "mu_swiglu_gmm_q4": [_P] * 11 + [_I] * 3 + [_P],
    "mu_rf_sampler_q4s8": [_P] * 19 + [_I] * 9 + [ctypes.c_float] * 3 + [_P],
    "mu_rf_sampler_grid": [],
    "mu_flash_prefill_bf16": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "mu_flash_vit_bf16": [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P],
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
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        procs.append((src.name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                                 cwd=str(CSRC_DIR))))
        objs.append(obj)
    log, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(log))
    tmp = so.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True,
                          text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("\n".join(log) + link.stdout + link.stderr)
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
