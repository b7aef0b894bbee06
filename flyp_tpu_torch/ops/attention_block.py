"""Fused pre-LN attention sub-block, inference forward.

``attention_block_inference`` computes ``x + out_proj(attention(LN(x) @
Wqkv + bqkv))`` for ``x [B, L, D]``.  It is the counterpart of
``flyp_tpu/ops/attention_block.py::attention_block_inference``, and its
CUDA kernel (``csrc/attention_block.cu``) replaces the TPU kernel
``_fwd_infer_kernel``.  On the H100 the ideal kernel is bound by the tensor
cores (the block does ~1500 FLOPs per byte it must move at ViT-B/16
widths); the TPU kernel's single fused body needed the whole weight in
VMEM, which does not fit in 227 KB of shared memory, so the CUDA version is
three kernels launched back to back (LN+QKV GEMM, attention, out-projection
GEMM with the residual epilogue).  See the source note for the design.

A tensor on the CPU takes :func:`attention_block_inference_reference`, the
same math in eager PyTorch with the same rounding points; a CUDA tensor
launches the kernel or raises.  The op is forward-only: the backward kernels
come with the training forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flyp_tpu_torch.ops import _kernels

EPS = 1e-5
_NEG = -1e30
_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_block_inference_reference(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int, causal: bool = False
):
    """Plain PyTorch version of the kernel, rounding where it rounds.

    Every product of compute-type values accumulates in fp32 (the operands
    are upcast, so bf16 products are exact), biases add in fp32, and the
    results round to the compute type at the TPU kernel's cast points:
    the LN output, q/k/v, ``q * head_dim**-0.5``, the probabilities, the
    attention output and the block output."""
    B, L, D = x.shape
    dtype = x.dtype
    hd = D // heads
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    y = (((x32 - mean) * torch.rsqrt(var + EPS)) * ln_scale.float() + ln_bias.float()).to(dtype)
    y32 = y.float()
    w = qkv_kernel.to(dtype).float()
    b = qkv_bias.float()
    q, k, v = ((torch.matmul(y32, w[t]) + b[t]).to(dtype) for t in range(3))
    q = (q.float() * hd ** -0.5).to(dtype)

    def heads_first(t):
        return t.float().reshape(B, L, heads, hd).transpose(1, 2)

    s = torch.matmul(heads_first(q), heads_first(k).transpose(-1, -2))
    if causal:
        keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        s = s + torch.where(keep, 0.0, _NEG)
    p = torch.softmax(s, dim=-1).to(dtype)
    o = torch.matmul(p.float(), heads_first(v)).to(dtype)
    o = o.transpose(1, 2).reshape(B, L, D)
    proj = torch.matmul(o.float(), out_kernel.to(dtype).float())
    return ((x32 + proj) + out_bias.float()).to(dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("attention_block")
    fn = lib.flyp_attention_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, D], got shape {tuple(x.shape)}")
    B, L, D = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention-block kernel takes float32 or bfloat16, got {x.dtype}")
    if D != heads * _HEAD_DIM or D % 128:
        raise ValueError(f"the attention-block kernel needs head_dim 64 and D % 128 == 0; got D={D}, heads={heads}")
    if B * L == 0:
        raise ValueError("empty input")
    shapes = {
        "ln_scale": (ln_scale, (D,)), "ln_bias": (ln_bias, (D,)), "qkv_kernel": (qkv_kernel, (3, D, D)),
        "qkv_bias": (qkv_bias, (3, D)), "out_kernel": (out_kernel, (D, D)), "out_bias": (out_bias, (D,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def attention_block_inference(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int, causal: bool = False
):
    """``x + LN -> QKV -> attention -> out-proj`` for ``x [B, L, D]``.

    Weights follow the JAX param tree: ``qkv_kernel [3, D, D]`` (q|k|v on
    the leading axis, head-major output features), ``qkv_bias [3, D]``,
    ``out_kernel [D, D]``, fp32 LN ``ln_scale``/``ln_bias`` and
    ``out_bias [D]``.  Matrices are cast to ``x.dtype``; LN params and
    biases stay fp32.  ``causal`` masks the upper triangle (text tower)."""
    args = (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "attention_block_inference is forward-only; run it under torch.inference_mode() or torch.no_grad()"
        )
    if x.device.type == "cpu":
        return attention_block_inference_reference(*args, heads, causal)
    if x.device.type != "cuda":
        raise RuntimeError(f"attention_block_inference runs on cuda or cpu tensors, got {x.device}")
    _check_inputs(*args, heads)
    B, L, D = x.shape
    dtype = x.dtype
    x = x.contiguous()
    f32 = [t.to(torch.float32).contiguous() for t in (ln_scale, ln_bias, qkv_bias, out_bias)]
    wqkv = qkv_kernel.to(dtype).contiguous()
    wout = out_kernel.to(dtype).contiguous()
    out = torch.empty_like(x)
    qkv_scratch = torch.empty((3, B * L, D), dtype=dtype, device=x.device)
    o_scratch = torch.empty((B * L, D), dtype=dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.flyp_attention_block_fwd(
            x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), wqkv.data_ptr(), f32[2].data_ptr(),
            wout.data_ptr(), f32[3].data_ptr(), out.data_ptr(), qkv_scratch.data_ptr(), o_scratch.data_ptr(),
            B, L, D, heads, int(bool(causal)), _DTYPE_CODES[dtype], stream,
        )
    _kernels.check(lib, code, "attention-block kernel launch")
    attention_block_inference.launches += 1
    return out


# Kernel launches since the count was last reset (one per call on CUDA).
attention_block_inference.launches = 0
