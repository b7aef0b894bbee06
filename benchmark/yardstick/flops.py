"""The model FLOPs of a CLIP ViT step, counted from the configuration's
shapes: matrix products only, at ``2 M N K`` each, as
``torch.utils.flop_counter`` counts them on the program's plain route.

* Forward: the patch product, per block the QKV, score, ``p @ v``,
  out-projection, fc and proj products (scores over the full ``L x L``,
  causal or not), the two projections, and in training the ``[B, B]``
  logits.
* Backward: twice the forward for every product whose inputs need a
  gradient; the patch product's input is the images, so its backward is
  the weight gradient alone, once the forward.
* A remat model's recomputed forward is not counted: these are the model's
  FLOPs, so a share of the peak is model-FLOP utilisation.
"""

from __future__ import annotations


def _blocks(L: int, D: int, layers: int) -> float:
    """Forward FLOPs of ``layers`` pre-LN blocks on one sequence of ``L``."""
    return layers * (24 * L * D * D + 4 * L * L * D)


def image_forward(cfg: dict) -> tuple:
    """(patch product, the rest) of one image's forward."""
    v = cfg["vision"]
    p, W = v["patch_size"], v["width"]
    n = (v["image_size"] // p) ** 2
    return 2 * n * (3 * p * p) * W, _blocks(n + 1, W, v["layers"]) + 2 * W * cfg["embed_dim"]


def text_forward(cfg: dict, text_len: int) -> float:
    """One caption's forward at the fed width ``text_len``."""
    t = cfg["text"]
    return _blocks(text_len, t["width"], t["layers"]) + 2 * t["width"] * cfg["embed_dim"]


def train_step(cfg: dict, batch: int, text_len: int) -> float:
    """One train step over ``batch`` rows: both towers, the logits, forward
    and backward."""
    patch, rest = image_forward(cfg)
    per_row = 2 * patch + 3 * rest + 3 * text_forward(cfg, text_len)
    return batch * per_row + 3 * 2 * batch * batch * cfg["embed_dim"]


def serve_images(cfg: dict, images: int, classes: int) -> float:
    """The eval forward of ``images`` images and the head's product."""
    patch, rest = image_forward(cfg)
    return images * (patch + rest + 2 * cfg["embed_dim"] * classes)
