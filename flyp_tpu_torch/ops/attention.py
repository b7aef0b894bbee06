"""Multi-head attention dispatch: the B6 attention kernel or plain attention.

Counterpart of ``flyp_tpu/ops/attention.py``.  ``FLYP_ATTENTION_IMPL``
picks the attention route, read once per process as in the JAX package:

* ``xla``: plain attention (:func:`xla_attention`);
* ``pallas``: the whole-row attention kernel (``ops/flash_attention.py``,
  B6); shapes it refuses fall through to plain attention;
* ``pallas_qkv``: attention straight from the fused projection
  (``ops/fused_qkv_attention.py``, B5), chosen in ``models/layers.py``;
* ``pallas_block`` / ``pallas_block_mlp``: the fused attention sub-block
  (and MLP block), chosen in ``models/layers.py``; for
  :func:`multi_head_attention` itself they mean plain attention;
* ``auto`` (the default): ``pallas_block`` on every device.  This is the
  one place where the port departs from the JAX package, whose ``auto``
  is ``pallas_block`` on a TPU and ``xla`` elsewhere: the port's main
  path is the fused sub-block kernel on the card, and on the CPU that
  route is its plain version.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

_IMPL_ENV = "FLYP_ATTENTION_IMPL"


@functools.lru_cache()
def _default_impl() -> str:
    choice = os.environ.get(_IMPL_ENV, "auto")
    return "pallas_block" if choice == "auto" else choice


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Plain self-attention over ``[B, L, H, Dh]`` tensors; returns the same
    layout.  fp32 scores scaled by ``head_dim**-0.5``, a ``-inf`` causal
    mask, an fp32 softmax cast to the input type, and an fp32-accumulated
    ``p @ v`` cast to the input type."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        L = q.shape[1]
        keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)


plain_attention = xla_attention


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, impl: Optional[str] = None
) -> torch.Tensor:
    """Self-attention over ``[B, L, H, Dh]`` tensors.

    ``impl``: ``"pallas"`` takes the B6 kernel (its plain version for CPU
    tensors), any other value the plain path; the default follows
    ``FLYP_ATTENTION_IMPL``.  Only B6's two shape refusals (``L > 1024``,
    and key length unequal to query length), raised before anything is
    built or launched, fall through to the plain path, as in the JAX
    package; a failed build or launch raises."""
    impl = impl or _default_impl()
    if impl == "pallas":
        from flyp_tpu_torch.ops.flash_attention import UnsupportedShape, flash_attention

        try:
            return flash_attention(q, k, v, causal)
        except UnsupportedShape:
            pass  # the kernel's shape rule: plain attention instead
    return xla_attention(q, k, v, causal)
