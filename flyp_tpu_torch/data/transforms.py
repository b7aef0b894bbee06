"""CLIP image preprocessing on the host (Pillow + numpy, NHWC output).

Counterpart of ``flyp_tpu/data/transforms.py``:

* train: RandomResizedCrop(n_px, scale=(0.9, 1.0), bicubic) -> RGB ->
  scale to [0, 1] -> normalise with CLIP's mean and std;
* eval: resize the shortest side (bicubic) -> center-crop -> RGB -> scale
  -> normalise.

The crop sampling is torchvision's RandomResizedCrop (10 area/ratio
attempts, then a center crop), drawn from an explicit
``numpy.random.Generator``.  Pillow is imported inside the functions that
resize, so the package imports without it (the native transforms of
``native_decode.py`` need none).
"""

from __future__ import annotations

import math
from typing import Tuple

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


def sample_resized_crop_box(
    w: int,
    h: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: (top, left, height, width)."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # Fallback: center crop at the closest valid aspect.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return top, left, ch, cw


def train_transform(n_px: int):
    """RandomResizedCrop(0.9-1.0, bicubic) + normalize. Returns fn(img, rng)."""

    def apply(img, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        w, h = img.size
        top, left, ch, cw = sample_resized_crop_box(w, h, rng)
        img = img.resize((n_px, n_px), Image.BICUBIC, box=(left, top, left + cw, top + ch))
        return to_normalized_array(img)

    return apply


def eval_transform(n_px: int):
    """Resize shortest side + center crop + normalize. Returns fn(img)."""

    def apply(img, rng=None) -> np.ndarray:
        return to_normalized_array(center_crop(resize_shortest(img, n_px), n_px))

    return apply
