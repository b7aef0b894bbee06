"""Plain multi-head attention, the oracle for attention inside the block.

Counterpart of ``flyp_tpu/ops/attention.py::xla_attention``: fp32 scores
scaled by ``head_dim**-0.5``, a ``-inf`` causal mask, an fp32 softmax cast
to the input type, and an fp32-accumulated ``p @ v``.  The serving path
never calls it: every block of both towers runs the fused attention-block
op (``ops/attention_block.py``).
"""

from __future__ import annotations

import torch


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Self-attention over ``[B, L, H, Dh]`` tensors; returns the same layout."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        L = q.shape[1]
        keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)
