"""CLIP eval preprocessing on the host (Pillow + numpy, NHWC output).

Counterpart of ``eval_transform`` in ``flyp_tpu/data/transforms.py``:
resize the shortest side (bicubic), center-crop, RGB, scale to [0, 1] and
normalise with CLIP's mean and std.  Pillow is imported inside the
functions that decode, so the package imports without it.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def to_normalized_array(img) -> np.ndarray:
    """PIL image -> float32 HWC in CLIP-normalised space."""
    img = img.convert("RGB") if img.mode != "RGB" else img
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def resize_shortest(img, size: int):
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(size * h / w))
    else:
        new_w, new_h = max(1, round(size * w / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img, size: int):
    w, h = img.size
    left = round((w - size) / 2)
    top = round((h - size) / 2)
    return img.crop((left, top, left + size, top + size))


def eval_transform(n_px: int):
    """Resize shortest side + center crop + normalize. Returns fn(img)."""

    def apply(img, rng=None) -> np.ndarray:
        return to_normalized_array(center_crop(resize_shortest(img, n_px), n_px))

    return apply
