"""The train step and synthetic batch the measurement tools share.

Counterpart of ``bench.py``'s ``build_bench_parts``/``build_bench_step``,
which the JAX tools import: the model at ``model_name`` from seed 0 (bf16
on the card, fp32 on the CPU, as the JAX bench takes bf16 on a TPU and fp32
elsewhere), AdamW on ``warmup_cosine_lr(1e-5, 500, 10_000)`` with weight
decay 0.1 and bf16 moments (``FLYP_ADAM_MOMENT_DTYPE=float32`` reverts), and
a batch drawn as the JAX bench draws it: images from
``np.random.default_rng(0)``, then captions of 6-20 tokens (BOS, random
ids, EOT) cut by ``shrink_context``.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from flyp_tpu_torch.models import ClassificationHead, build_clip_model
from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tokenizer import shrink_context
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr


def compute_dtype(device) -> str:
    """The tools' compute type: bf16 on the card, fp32 on the CPU."""
    return "bfloat16" if resolve_device(device).type == "cuda" else "float32"


def bench_batch(batch_size: int, px: int, seed: int = 0):
    """(images ``[B, px, px, 3]`` float32, tokens ``[B, ctx]`` int32) on the
    host, drawn as the JAX bench draws them."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, px, px, 3)).astype(np.float32)
    tokens = np.zeros((batch_size, 77), dtype=np.int32)
    tokens[:, 0] = 49406
    for i, n in enumerate(rng.integers(6, 20, batch_size)):
        tokens[i, 1:n] = rng.integers(1, 49000, n - 1)
        tokens[i, n] = 49407
    return images, shrink_context(tokens)


def random_head(embed_dim: int, classes: int, rng: np.random.Generator, device) -> ClassificationHead:
    """A normalising zero-shot head of ``classes`` rows drawn from ``rng``
    at scale ``embed_dim ** -0.5``, as the JAX serving tools draw theirs."""
    weight = rng.standard_normal((classes, embed_dim)) * embed_dim ** -0.5
    return ClassificationHead(torch.tensor(weight, dtype=torch.float32), normalize=True).to(device)


def build_bench_parts(batch_size: int, model_name: str, remat: bool, device="cuda"):
    """(model, optimizer, state, images, tokens, config) for the bench step
    on ``device``; the images in the compute type."""
    device = resolve_device(device)
    dtype = compute_dtype(device)
    cfg = SimpleNamespace(model=model_name, clip_load=None, compute_dtype=dtype, seed=0, remat=remat)
    model = build_clip_model(cfg, device=device)
    moment_dtype = os.environ.get("FLYP_ADAM_MOMENT_DTYPE", "bfloat16")
    optimizer = make_optimizer(warmup_cosine_lr(1e-5, 500, 10_000), weight_decay=0.1, moment_dtype=moment_dtype)
    state = create_train_state(model, optimizer)
    config = model.config
    images, tokens = bench_batch(batch_size, config.vision.image_size)
    images = torch.from_numpy(images).to(device).to(model.compute_dtype)
    return model, optimizer, state, images, torch.from_numpy(tokens).to(device), config


def build_bench_step(batch_size: int, model_name: str, remat: bool, device="cuda"):
    """(step_fn, state, images, tokens, config): the direct train step the
    tools time."""
    model, optimizer, state, images, tokens, config = build_bench_parts(batch_size, model_name, remat, device)
    return make_train_step(model, optimizer), state, images, tokens, config
