"""Ops: the fused attention-block ops, the MLP-block op, the fused-QKV and
whole-row attention ops (CUDA kernels + plain versions), the attention
dispatch and the contrastive loss.  The ops named as their modules are
reached through them (``ops.attention_block.attention_block``,
``ops.mlp_block.mlp_block``, ``ops.fused_qkv_attention.
fused_qkv_attention``, ``ops.flash_attention.flash_attention``): the
package keeps those names for the modules."""

from .attention import multi_head_attention, plain_attention, xla_attention
from .attention_block import (
    attention_block_backward_reference,
    attention_block_inference,
    attention_block_inference_reference,
    attention_block_reference,
)
from .flash_attention import flash_attention_backward_reference, flash_attention_reference
from .fused_qkv_attention import fused_qkv_attention_backward_reference, fused_qkv_attention_reference
from .losses import clip_loss
from .mlp_block import mlp_block_backward, mlp_block_reference

__all__ = [
    "attention_block_backward_reference",
    "attention_block_inference",
    "attention_block_inference_reference",
    "attention_block_reference",
    "clip_loss",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "fused_qkv_attention_backward_reference",
    "fused_qkv_attention_reference",
    "mlp_block_backward",
    "mlp_block_reference",
    "multi_head_attention",
    "plain_attention",
    "xla_attention",
]
