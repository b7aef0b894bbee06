"""Attention straight from the fused QKV projection (B5).

Counterpart of ``flyp_tpu/ops/fused_qkv_attention.py``: the input is the
raw ``[B, L, 3D]`` projection, q|k|v along the feature axis in that order,
each head-major; the output is the merged ``[B, L, D]`` ready for the
out-projection, and the backward returns one ``dqkv [B, L, 3D]``.  Rounding
points as B6's (``ops/flash_attention.py``): the backward keeps only the
projection and recomputes the softmax.

On the card both directions run the kernels of ``csrc/attention.cu``
reading q, k and v in place through a row stride of 3D and head offsets of
0, D and 2D, and writing dq, dk and dv into the three thirds of ``dqkv``:
no head split or transpose reaches device memory.  The kernels take
``L <= 1024`` (the JAX op has no limit; ROADMAP.md §C); a CPU tensor takes
the plain versions, which take any length.
"""

from __future__ import annotations

import torch

from flyp_tpu_torch.ops.attention_block import _HEAD_DIM, _device_route
from flyp_tpu_torch.ops.flash_attention import (
    MAX_SEQ_LEN,
    _check_kernel_inputs,
    flash_attention_backward_reference,
    flash_attention_reference,
    kernel_backward,
    kernel_forward,
)


def _heads(qkv, heads):
    """[B, L, 3D] -> q, k, v ``[B, L, H, Dh]`` views (row stride 3D)."""
    B, L, threeD = qkv.shape
    D = threeD // 3
    return tuple(qkv[..., t * D:(t + 1) * D].reshape(B, L, heads, D // heads) for t in range(3))


def fused_qkv_attention_reference(qkv, heads: int, causal: bool = False):
    """Plain version of the forward: ``[B, L, 3D]`` -> ``[B, L, D]``."""
    B, L, threeD = qkv.shape
    return flash_attention_reference(*_heads(qkv, heads), causal).reshape(B, L, threeD // 3)


def fused_qkv_attention_backward_reference(qkv, do, heads: int, causal: bool = False):
    """Plain version of the backward -> ``dqkv [B, L, 3D]`` in the compute
    type."""
    B, L, threeD = qkv.shape
    grads = flash_attention_backward_reference(*_heads(qkv, heads), do.reshape(B, L, heads, -1), causal)
    return torch.cat([g.reshape(B, L, threeD // 3) for g in grads], dim=-1)


def _check(qkv, heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"fused_qkv_attention takes [B, L, 3D] with D divisible by heads={heads}, "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[1] > MAX_SEQ_LEN:
        raise ValueError(f"the fused-QKV attention kernel takes L <= {MAX_SEQ_LEN}, got L={qkv.shape[1]}")


def _forward(qkv, heads, causal):
    if not _device_route(qkv, "fused_qkv_attention"):
        return fused_qkv_attention_reference(qkv, heads, causal)
    _check(qkv, heads)
    q, k, v = _heads(qkv.contiguous(), heads)
    _check_kernel_inputs(q, k, v, "fused_qkv_attention")
    o = kernel_forward(q, k, v, causal)
    fused_qkv_attention.fwd_launches += 1
    B, L, threeD = qkv.shape
    return o.reshape(B, L, threeD // 3)


def fused_qkv_attention_backward(qkv, do, heads: int, causal: bool = False):
    """The op's backward -> ``dqkv [B, L, 3D]``: the kernel for CUDA tensors
    (dq, dk, dv written into the thirds of ``dqkv``), the plain version for
    CPU ones."""
    if not _device_route(qkv, "fused_qkv_attention"):
        return fused_qkv_attention_backward_reference(qkv, do, heads, causal)
    _check(qkv, heads)
    q, k, v = _heads(qkv.contiguous(), heads)
    _check_kernel_inputs(q, k, v, "fused_qkv_attention")
    B, L, threeD = qkv.shape
    dqkv = torch.empty((B, L, threeD), dtype=qkv.dtype, device=qkv.device)
    kernel_backward(q, k, v, do.reshape(B, L, heads, _HEAD_DIM), causal, *_heads(dqkv, heads))
    fused_qkv_attention.bwd_launches += 1
    return dqkv


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, causal):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal = heads, causal
        return _forward(qkv, heads, causal)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return fused_qkv_attention_backward(qkv, g, ctx.heads, ctx.causal), None, None


def fused_qkv_attention(qkv, heads: int, causal: bool = False):
    """``[B, L, 3D]`` fused projection (q|k|v, each head-major) -> ``[B, L,
    D]`` merged attention output, in the input type.  On the card: head_dim
    64 and ``L <= 1024`` (``ValueError`` otherwise)."""
    return _FusedQKVAttention.apply(qkv, heads, causal)


# Kernel launches since the counts were last reset (one per call on CUDA).
fused_qkv_attention.fwd_launches = 0
fused_qkv_attention.bwd_launches = 0
