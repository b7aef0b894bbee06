"""Zero-shot classification head built from the text tower.

Counterpart of ``flyp_tpu/evaluation/zeroshot.py``: every classname x
template prompt is tokenized and encoded, each embedding is L2-normalised,
the per-class mean is renormalised, and the matrix is scaled by
``exp(logit_scale)``; the head normalises its input features.  Prompts are
encoded in fixed-size chunks sliced to the bucketed max-EOT width
(``shrink_context``), and every chunk is launched before any is fetched.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.tokenizer import shrink_context, tokenize


@functools.lru_cache(maxsize=16)
def _tokenize_tuple(prompts: tuple) -> np.ndarray:
    """BPE-tokenize with an LRU cache keyed by the prompt tuple; the cached
    array is read-only so a consumer cannot poison it."""
    arr = np.asarray(tokenize(list(prompts)))
    arr.flags.writeable = False
    return arr


@torch.inference_mode()
def class_embeddings(
    model: CLIPModel,
    classnames: Sequence[str],
    template: Sequence,
    encode_batch: int = 1024,
) -> np.ndarray:
    """[num_classes, embed_dim] normalised mean-of-templates embeddings.  The
    text tower runs in eval mode whatever the model's mode (the JAX package's
    ``train=False``); the model's mode is restored afterwards."""
    prompts = [t(name) for name in classnames for t in template]
    tokens = shrink_context(_tokenize_tuple(tuple(prompts)))  # [C*T, <=ctx]

    n = tokens.shape[0]
    encode_batch = min(encode_batch, max(8, n))
    pad = (-n) % encode_batch
    if pad:
        tokens = np.concatenate([tokens, np.tile(tokens[:1], (pad, 1))], axis=0)

    device = model.device
    with pinned_mode(model, train=False):
        chunks = [
            model.encode_text(torch.from_numpy(np.ascontiguousarray(tokens[s : s + encode_batch])).to(device))
            for s in range(0, tokens.shape[0], encode_batch)
        ]
    emb = torch.cat([c.float().cpu() for c in chunks])[:n].numpy()

    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    emb = emb.reshape(len(classnames), len(template), -1).mean(axis=1)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb


def get_zeroshot_classifier(
    model: CLIPModel,
    classnames: Sequence[str],
    template: Sequence,
    logit_scale: Optional[float] = None,
    encode_batch: int = 1024,
) -> ClassificationHead:
    """The zero-shot head, on the model's device."""
    emb = class_embeddings(model, classnames, template, encode_batch)
    if logit_scale is None:
        logit_scale = model.logit_scale.detach().float().cpu().numpy()
    scale = np.exp(np.asarray(logit_scale, np.float32))
    return ClassificationHead(torch.from_numpy(emb * scale), normalize=True).to(model.device)
