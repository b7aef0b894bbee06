"""Ops: the fused attention-block ops (CUDA kernels + plain versions), plain
attention and the contrastive loss.  The training op is
``flyp_tpu_torch.ops.attention_block.attention_block`` (the package keeps
that name for the module)."""

from .attention import plain_attention
from .attention_block import (
    attention_block_backward_reference,
    attention_block_inference,
    attention_block_inference_reference,
    attention_block_reference,
)
from .losses import clip_loss

__all__ = [
    "attention_block_backward_reference",
    "attention_block_inference",
    "attention_block_inference_reference",
    "attention_block_reference",
    "clip_loss",
    "plain_attention",
]
