"""Attention ops: the fused attention-block op (CUDA kernel + plain version)
and plain attention."""

from .attention import plain_attention
from .attention_block import attention_block_inference, attention_block_inference_reference

__all__ = ["attention_block_inference", "attention_block_inference_reference", "plain_attention"]
