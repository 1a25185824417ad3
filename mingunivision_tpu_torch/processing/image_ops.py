"""Host-side image preprocessing (counterpart of mingunivision_tpu/processing/image_ops.py).

Two pipelines, as the reference processors:
  - understanding: square-resize to 1024x1024 (PIL bicubic) -> normalize(0.5, 0.5)
  - generation/edit: resize the short side to 512 -> center-crop 512 -> normalize
PIL does the resize, as torchvision does for the reference. Generated images
are written as PNGs by a writer of its own (zlib + struct), so that saving
needs no PIL.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _to_pil(img):
    from PIL import Image

    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]:
        arr = np.transpose(arr, (1, 2, 0))
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr)


def normalize_chw(arr_hwc: np.ndarray, mean=0.5, std=0.5) -> np.ndarray:
    """uint8 HWC -> fp32 CHW normalized (ToTensor + Normalize)."""
    x = arr_hwc.astype(np.float32) / 255.0
    x = (x - mean) / std
    return np.transpose(x, (2, 0, 1))


def preprocess_understanding(img, image_size: int = 1024, mean=0.5, std=0.5) -> np.ndarray:
    """Square resize (distorting aspect) + normalize. (3, S, S) fp32."""
    from PIL import Image

    pil = _to_pil(img).convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    return normalize_chw(np.asarray(pil), mean, std)


def preprocess_generation(img, image_size: int = 512, mean=0.5, std=0.5) -> np.ndarray:
    """Resize the short side + center crop + normalize (torchvision Resize(int) /
    CenterCrop rounding)."""
    from PIL import Image

    pil = _to_pil(img).convert("RGB")
    w, h = pil.size
    if w < h:
        nw, nh = image_size, max(1, int(round(image_size * h / w)))
    else:
        nh, nw = image_size, max(1, int(round(image_size * w / h)))
    pil = pil.resize((nw, nh), Image.BICUBIC)
    left = int(round((nw - image_size) / 2.0))
    top = int(round((nh - image_size) / 2.0))
    pil = pil.crop((left, top, left + image_size, top + image_size))
    return normalize_chw(np.asarray(pil), mean, std)


def tensor_to_image(x: np.ndarray) -> np.ndarray:
    """Model output (3, H, W) in [-1, 1] -> uint8 (H, W, 3): x / 2 + 0.5, clipped."""
    x = np.asarray(x, np.float32)
    if x.ndim == 4:
        x = x[0]
    x = np.clip((x / 2.0 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return np.transpose(x, (1, 2, 0))


def png_bytes(arr_hwc: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> an 8-bit RGB PNG (filter 0 on every row, zlib level 6)."""
    arr = np.ascontiguousarray(arr_hwc, dtype=np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"png_bytes: needs (H, W, 3) uint8, got {arr.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit depth, colour type 2 (RGB)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def save_image_with_suffix(img_chw: np.ndarray, prefix: str) -> str:
    """Write a model output (3, H, W) in [-1, 1] as a PNG at `prefix.png`, or at
    `prefix_1.png`, `prefix_2.png`, ... when the name is taken (the reference's
    collision rule, as the JAX package's `save_image_with_suffix`). Returns the path."""
    data = png_bytes(tensor_to_image(img_chw))
    for i in range(100):
        name = f"{prefix}.png" if i == 0 else f"{prefix}_{i}.png"
        if not os.path.exists(name):
            with open(name, "wb") as f:
                f.write(data)
            return name
    raise RuntimeError(f"no free file name for {prefix!r}")
