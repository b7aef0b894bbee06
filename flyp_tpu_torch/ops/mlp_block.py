"""Fused pre-LN MLP block: ``x + c_proj(quick_gelu(c_fc(LN(x))))`` (B4).

Counterpart of ``flyp_tpu/ops/mlp_block.py``.  The forward is the CUDA
kernel of ``csrc/mlp_block.cu`` on the card, the plain version on the CPU.
In bf16 it is four launches: LN once per row into scratch ``y``; ``c_fc``
on ``csrc/gemm_sm90.cuh`` (TMA + ``wgmma``) with a ``+b1`` epilogue,
writing the pre-activation ``h_pre``; ``h = quick_gelu(h_pre)`` of the
rounded ``h_pre`` into scratch; ``c_proj`` on the same GEMM over ``h`` with
a ``+b2 +x`` epilogue.  fp32 runs ``common.cuh``'s FMA GEMM twice, LN and
the GELU in its operand prologues.  It rounds where the TPU kernel
rounds:

    y     = T(LN(x))                     fp32 LN
    h_pre = T(y @ W1 + b1)               fp32 accumulate, fp32 bias
    h     = T(h_pre * sigmoid(1.702 h_pre))   in fp32, of the rounded h_pre
    out   = T(x + (h @ W2 + b2))          fp32

The forward keeps ``h_pre`` (in the compute type) for the backward, which is
plain PyTorch on both devices, as the JAX package leaves its backward to
XLA: it mirrors every cast of ``_mlp_bwd``, so B4 has a forward kernel only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.ops.attention_block import _DTYPE_CODES, _device_route, _layer_norm, _param_grads, _stream


def _quick_gelu32(h32):
    return h32 * torch.sigmoid(1.702 * h32)


def mlp_hidden(h_pre):
    """``h = T(quick_gelu(fp32(h_pre)))``: the hidden activations the
    forward computes from its rounded pre-activation."""
    return _quick_gelu32(h_pre.float()).to(h_pre.dtype)


def mlp_block_reference(x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias):
    """Plain version of the forward kernel -> ``(out, h_pre)``."""
    dtype = x.dtype
    _, _, y32 = _layer_norm(x.float(), ln_scale, ln_bias)
    y = y32.to(dtype).float()
    h_pre = (torch.matmul(y, fc_kernel.to(dtype).float()) + fc_bias.float()).to(dtype)
    h = mlp_hidden(h_pre)
    proj = torch.matmul(h.float(), proj_kernel.to(dtype).float()) + proj_bias.float()
    return (x.float() + proj).to(dtype), h_pre


def mlp_block_backward(g, x, ln_scale, ln_bias, fc_kernel, proj_kernel, h_pre):
    """``_mlp_bwd`` -> ``(dx, dscale, dbias, dw1, db1, dw2, db2)``: ``dx`` in
    ``x.dtype``, the rest fp32.  ``dh`` and ``dhpre`` are products in the
    compute type (``W2`` cast to it); ``dW1``, ``dW2`` and ``dY`` fp32
    products (``W1`` unrounded)."""
    dtype = x.dtype
    xhat, rstd, y32 = _layer_norm(x.float(), ln_scale, ln_bias)
    y = y32.to(dtype)

    hpre32 = h_pre.float()
    sig = torch.sigmoid(1.702 * hpre32)
    h = (hpre32 * sig).to(dtype)
    dgelu = (sig * (1.0 + 1.702 * hpre32 * (1.0 - sig))).to(dtype)

    g = g.to(dtype)
    g32 = g.float()
    D, Hd = x.shape[-1], h_pre.shape[-1]
    dw2 = torch.matmul(h.float().reshape(-1, Hd).T, g32.reshape(-1, D))
    db2 = g32.sum(dim=(0, 1))
    dh = torch.matmul(g, proj_kernel.to(dtype).T)
    dhpre = dh * dgelu

    dhpre32 = dhpre.float()
    dw1 = torch.matmul(y.float().reshape(-1, D).T, dhpre32.reshape(-1, Hd))
    db1 = dhpre32.sum(dim=(0, 1))
    dY = torch.matmul(dhpre32, fc_kernel.float().T)

    dscale = (dY * xhat).sum(dim=(0, 1))
    dbias = dY.sum(dim=(0, 1))
    dxhat = dY * ln_scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (g32 + rstd * (dxhat - m1 - xhat * m2)).to(dtype)
    return dx, dscale, dbias, dw1, db1, dw2, db2


# ---------------------------------------------------------------------------
# The kernel.


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("mlp_block")
    lib.flyp_mlp_block_fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.flyp_mlp_block_fwd.restype = ctypes.c_int
    return lib


def _kernel_forward(x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias, *, out=None, h_pre=None,
                    hidden=None):
    """The kernel -> ``(out, h_pre)``.  ``out``, ``h_pre`` and, in bf16,
    ``hidden`` (which then receives ``h``, the transient the kernel keeps in
    device memory for its second product) are optional contiguous
    outputs."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the MLP-block kernel takes float32 or bfloat16 [B, L, D], got {x.dtype} {tuple(x.shape)}")
    B, L, D = x.shape
    Hd = fc_kernel.shape[-1]
    shapes = {"ln_scale": (ln_scale, (D,)), "ln_bias": (ln_bias, (D,)), "fc_kernel": (fc_kernel, (D, Hd)),
              "fc_bias": (fc_bias, (Hd,)), "proj_kernel": (proj_kernel, (Hd, D)), "proj_bias": (proj_bias, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D % 128 or Hd % 128 or B * L == 0:
        raise ValueError(f"the MLP-block kernel needs D and the hidden width multiples of 128; got D={D}, "
                         f"hidden={Hd}, B*L={B * L}")
    dtype = x.dtype
    if hidden is not None and dtype != torch.bfloat16:
        raise ValueError("the MLP-block kernel keeps h in device memory in bfloat16 only")
    for name, t, shape in (("out", out, (B, L, D)), ("h_pre", h_pre, (B, L, Hd)), ("hidden", hidden, (B, L, Hd))):
        _kernels.check_out(f"the MLP-block kernel's {name}", t, shape, dtype, x.device)
    x = x.contiguous()
    f32 = [t.detach().to(torch.float32).contiguous() for t in (ln_scale, ln_bias, fc_bias, proj_bias)]
    w1 = fc_kernel.detach().to(dtype).contiguous()
    w2 = proj_kernel.detach().to(dtype).contiguous()
    out = torch.empty_like(x) if out is None else out
    h_pre = torch.empty((B, L, Hd), dtype=dtype, device=x.device) if h_pre is None else h_pre
    y = h = None
    if dtype == torch.bfloat16:  # LN(x) and h, scratch between the three launches
        y = torch.empty((B, L, D), dtype=dtype, device=x.device)
        h = torch.empty((B, L, Hd), dtype=dtype, device=x.device) if hidden is None else hidden
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.flyp_mlp_block_fwd(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), w1.data_ptr(),
                                      f32[2].data_ptr(), w2.data_ptr(), f32[3].data_ptr(), out.data_ptr(),
                                      h_pre.data_ptr(), ptr(y), ptr(h), B * L, D, Hd, _DTYPE_CODES[dtype],
                                      _stream(x.device))
    _kernels.check(lib, code, "MLP-block kernel launch")
    mlp_block.fwd_launches += 1
    return out, h_pre


class _MLPBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias):
        args = (x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias)
        if _device_route(x, "mlp_block"):
            out, h_pre = _kernel_forward(*args)
        else:
            out, h_pre = mlp_block_reference(*args)
        ctx.save_for_backward(x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias, h_pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias, h_pre = ctx.saved_tensors
        grads = mlp_block_backward(g, x, ln_scale, ln_bias, fc_kernel, proj_kernel, h_pre)
        return _param_grads(grads, (x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias))


def mlp_block(x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias):
    """``x + c_proj(quick_gelu(c_fc(LN(x))))`` for ``x [B, L, D]``, one fused
    forward op.  Weights follow the JAX param tree: ``fc_kernel [D, 4D]``,
    ``proj_kernel [4D, D]`` (cast to ``x.dtype`` inside), fp32 LN params and
    biases.  Grads come back in the parameters' own types."""
    return _MLPBlock.apply(x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias)


# Forward-kernel launches since the count was last reset (one per call on
# CUDA).  The backward is plain PyTorch: it launches no kernel of its own.
mlp_block.fwd_launches = 0
