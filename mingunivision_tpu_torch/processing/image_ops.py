"""Host-side image preprocessing (counterpart of mingunivision_tpu/processing/image_ops.py).

Two pipelines, as the reference processors:
  - understanding: square-resize to 1024x1024 (PIL bicubic) -> normalize(0.5, 0.5)
  - generation/edit: resize the short side to 512 -> center-crop 512 -> normalize
PIL does the resize, as torchvision does for the reference.
"""

from __future__ import annotations

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
