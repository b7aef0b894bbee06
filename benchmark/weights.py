"""The model's weights, made from the seed on the device.

:func:`spec` lists every parameter of a CLIP ViT configuration with its
shape and its init, by the names and layout of the JAX parameter tree that
the program loads (``qkv_kernel [3, D, D]`` q|k|v on the leading axis, the
patch kernel HWIO).  :func:`make` draws all of them in one call of a
``torch.Generator`` on the card: one float32 buffer of standard normals,
scaled in place per parameter by CLIP's init (``clip/model.py``:
``initialize_parameters``; LayerNorm scales one, biases zero,
``logit_scale`` log(1/0.07)).  The same seed gives the same weights, so the
reference works from weights made again, not from the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LOGIT_SCALE_INIT = math.log(1 / 0.07)


def _block(prefix: str, d: int) -> List[Tuple[str, tuple, object]]:
    return [
        (f"{prefix}.ln_1.scale", (d,), "one"), (f"{prefix}.ln_1.bias", (d,), "zero"),
        (f"{prefix}.attn.qkv_kernel", (3, d, d), d ** -0.5), (f"{prefix}.attn.qkv_bias", (3, d), "zero"),
        (f"{prefix}.attn.out_kernel", (d, d), d ** -0.5), (f"{prefix}.attn.out_bias", (d,), "zero"),
        (f"{prefix}.ln_2.scale", (d,), "one"), (f"{prefix}.ln_2.bias", (d,), "zero"),
        (f"{prefix}.mlp.fc_kernel", (d, 4 * d), (2 * d) ** -0.5), (f"{prefix}.mlp.fc_bias", (4 * d,), "zero"),
        (f"{prefix}.mlp.proj_kernel", (4 * d, d), d ** -0.5), (f"{prefix}.mlp.proj_bias", (d,), "zero"),
    ]


def spec(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter; init is a normal's standard
    deviation, or "one", "zero" or "logit_scale"."""
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    w, p = v["width"], v["patch_size"]
    n_pos = (v["image_size"] // p) ** 2 + 1
    out = [
        ("visual.patch_kernel", (p, p, 3, w), (1.0 / (3 * p * p)) ** 0.5),
        ("visual.class_embedding", (w,), w ** -0.5),
        ("visual.positional_embedding", (n_pos, w), w ** -0.5),
        ("visual.ln_pre.scale", (w,), "one"), ("visual.ln_pre.bias", (w,), "zero"),
    ]
    for i in range(v["layers"]):
        out += _block(f"visual.transformer.block_{i}", w)
    out += [("visual.ln_post.scale", (w,), "one"), ("visual.ln_post.bias", (w,), "zero"),
            ("visual.proj", (w, e), w ** -0.5)]
    tw = t["width"]
    out += [("text.token_embedding", (t["vocab_size"], tw), 0.02),
            ("text.positional_embedding", (t["context_length"], tw), 0.01)]
    for i in range(t["layers"]):
        out += _block(f"text.transformer.block_{i}", tw)
    out += [("text.ln_final.scale", (tw,), "one"), ("text.ln_final.bias", (tw,), "zero"),
            ("text.text_projection", (tw, e), tw ** -0.5), ("logit_scale", (), "logit_scale")]
    return out


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter as a float32 tensor on ``device``, drawn from
    ``seed`` in one call (module docstring).  The tensors are views of one
    buffer: clone what is to be updated apart from it."""
    entries = spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in entries]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, scaled, stds = {}, [], []
    for (name, shape, init), t in zip(entries, torch.split(flat, sizes)):
        t = t.view(shape)
        if init == "one":
            t.fill_(1.0)
        elif init == "zero":
            t.zero_()
        elif init == "logit_scale":
            t.fill_(LOGIT_SCALE_INIT)
        else:
            scaled.append(t)
            stds.append(init)
        out[name] = t
    torch._foreach_mul_(scaled, stds)
    return out


def head(embed_dim: int, classes: int, seed: int, device) -> torch.Tensor:
    """A zero-shot head of ``classes`` unit rows ``[classes, embed_dim]``,
    drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    w = torch.randn(classes, embed_dim, generator=gen, device=device)
    return w / w.norm(dim=-1, keepdim=True)
