"""Whole-row softmax attention over ``[B, L, H, 64]`` tensors (B6).

Counterpart of ``flyp_tpu/ops/flash_attention.py``: CLIP's sequences are
short (197 vision, at most 77 text tokens), so a query's whole score row
fits on chip and the softmax is computed over it at once, normalised in
fp32 before ``p`` is cast; the backward keeps only q, k and v and
recomputes the softmax.  Rounding points, as the TPU kernel's:

    s  = (q k^T) * scale (fp32), -1e30 on causal columns
    p  = softmax(s) (fp32);  o = T(T(p) @ v)
    dv = T(T(p)^T do);  dp = do v^T (fp32)
    ds = T(p (dp - rowsum(p dp)) * scale);  dq = T(ds k);  dk = T(ds^T q)

On the card both directions run the CUDA kernels of ``csrc/attention.cu``
(shared with the fused-QKV op, ``ops/fused_qkv_attention.py``), which read
q, k and v through a batch and a row stride, so strided views of a fused
projection need no copy.  A CPU tensor takes the plain versions
(:func:`flash_attention_reference`, :func:`flash_attention_backward_reference`).
The op refuses ``L > 1024`` and key lengths unequal to the query's with
:class:`UnsupportedShape` before anything is built or launched; the
dispatch in ``ops/attention.py`` then takes plain attention, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.ops.attention_block import _DTYPE_CODES, _HEAD_DIM, _NEG, _device_route, _stream

MAX_SEQ_LEN = 1024


class UnsupportedShape(NotImplementedError):
    """A shape the B6 op does not take (JAX's ``NotImplementedError``)."""


# ---------------------------------------------------------------------------
# Plain PyTorch versions over [B, L, H, Dh]: fp32 products of compute-type
# values, rounding to the compute type where the TPU kernels round.


def _probs(q, k, causal):
    """fp32 softmax [B, H, L, L] of ``(q k^T) * scale`` with -1e30 on causal
    columns."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        L = q.shape[1]
        keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, _NEG)
    return torch.softmax(s, dim=-1)


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain version of the forward: ``o = T(T(softmax(s)) @ v)``."""
    p = _probs(q, k, causal).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def flash_attention_backward_reference(q, k, v, do, causal: bool = False):
    """Plain version of the backward -> ``(dq, dk, dv)`` in the compute type;
    ``p`` is recomputed from q and k."""
    dtype = q.dtype
    p = _probs(q, k, causal)
    do32 = do.to(dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do32).to(dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = ((p * (dp - (p * dp).sum(dim=-1, keepdim=True))) * q.shape[-1] ** -0.5).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels (csrc/attention.cu), shared with the fused-QKV op.


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("attention")
    lib.flyp_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flyp_attention_fwd.restype = ctypes.c_int
    lib.flyp_attention_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int] * 2 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.flyp_attention_bwd.restype = ctypes.c_int
    return lib


def _strided(q, k, v):
    """(q, k, v, batch stride, row stride): the three share one layout whose
    (head, feature) axes are dense and whose rows are 16-byte aligned;
    otherwise contiguous copies."""
    el = q.element_size()

    def fits(t):
        return (t.stride(3) == 1 and t.stride(2) == _HEAD_DIM and t.stride()[:2] == q.stride()[:2]
                and t.data_ptr() % 16 == 0 and (t.stride(1) * el) % 16 == 0)

    if not all(fits(t) for t in (q, k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v, q.stride(0), q.stride(1)


def _check_kernel_inputs(q, k, v, op):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"{op} takes q, k, v of one shape [B, L, H, 64], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{op} takes float32 or bfloat16 q, k, v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] != _HEAD_DIM:
        raise ValueError(f"{op}'s kernel needs head_dim {_HEAD_DIM}, got {q.shape[-1]}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{op}: q, k, v lie on {q.device}, {k.device}, {v.device}")
    if q.shape[0] * q.shape[1] == 0:
        raise ValueError("empty input")


def kernel_forward(q, k, v, causal: bool):
    """The forward kernel -> o ``[B, L, H, 64]`` (contiguous)."""
    B, L, H, _ = q.shape
    q, k, v, sb, sr = _strided(q, k, v)
    o = torch.empty((B, L, H, _HEAD_DIM), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flyp_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), sb, sr, B, L, H,
                                      int(bool(causal)), _DTYPE_CODES[q.dtype], _stream(q.device))
    _kernels.check(lib, code, "attention forward kernel launch")
    return o


def kernel_backward(q, k, v, do, causal: bool, dq, dk, dv):
    """The backward kernel: writes dq, dk, dv (``[B, L, H, 64]`` views that
    share one batch and row stride, dense in (head, feature))."""
    B, L, H, _ = q.shape
    q, k, v, sb, sr = _strided(q, k, v)
    do = do.to(q.dtype).contiguous()
    if not (dq.stride() == dk.stride() == dv.stride() and dq.stride(3) == 1 and dq.stride(2) == _HEAD_DIM):
        raise ValueError("dq, dk, dv must share a layout dense in (head, feature)")
    # Each row's softmax max and sum, and delta = rowsum(p dp), from the
    # backward's query-tile pass to its key-tile pass.
    stats = torch.empty((B, L, H, 2), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, L, H), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flyp_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), delta.data_ptr(), sb, sr, dq.stride(0), dq.stride(1), B, L, H, int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q.device))
    _kernels.check(lib, code, "attention backward kernel launch")


# ---------------------------------------------------------------------------
# The op.


def _forward(q, k, v, causal):
    if not _device_route(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal)
    _check_kernel_inputs(q, k, v, "flash_attention")
    o = kernel_forward(q, k, v, causal)
    flash_attention.fwd_launches += 1
    return o


def flash_attention_backward(q, k, v, do, causal: bool = False):
    """The op's backward -> ``(dq, dk, dv)``: the kernel for CUDA tensors,
    the plain version for CPU ones."""
    if not _device_route(q, "flash_attention"):
        return flash_attention_backward_reference(q, k, v, do, causal)
    _check_kernel_inputs(q, k, v, "flash_attention")
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    kernel_backward(q, k, v, do, causal, dq, dk, dv)
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_backward(*ctx.saved_tensors, g, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = False):
    """Self-attention over ``[B, L, H, Dh]`` (head_dim 64 on the card);
    returns the same layout in the input type.  Raises
    :class:`UnsupportedShape` for ``L > 1024`` or a key length unequal to
    the query's, before any build or launch."""
    L = q.shape[1]
    if L > MAX_SEQ_LEN:
        raise UnsupportedShape(f"sequence {L} exceeds the attention kernel's limit of {MAX_SEQ_LEN}")
    if k.shape[1] != L:
        raise UnsupportedShape("flash_attention requires equal q/k lengths (self-attention)")
    return _FlashAttention.apply(q, k, v, causal)


# Kernel launches since the counts were last reset (one per call on CUDA).
flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0
