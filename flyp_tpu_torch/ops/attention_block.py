"""Fused pre-LN attention sub-block: inference and training forward, and the
training backward.

Both ops compute ``x + out_proj(attention(LN(x) @ Wqkv + bqkv))`` for ``x
[B, L, D]``; they are the counterparts of ``attention_block_inference`` and
``attention_block`` in ``flyp_tpu/ops/attention_block.py``.  Three CUDA
kernels replace the TPU kernels:

* B3, ``_fwd_infer_kernel``: the inference forward
  (``csrc/attention_block.cu``, entry ``flyp_attention_block_fwd``);
* B1, ``_fwd_kernel``: the training forward, which also returns q, k, v,
  the attention output o and the per-(row, head) log-sum-exp for the
  backward (same source, entry ``flyp_attention_block_fwd_train``);
* B2, ``_bwd_kernel``: the training backward, the out-projection's grads
  included (``csrc/attention_block_bwd.cu``).

On the H100 the ideal kernels are bound by the tensor cores (the block does
~1500 FLOPs per byte it must move at ViT-B/16 widths).  The TPU kernels'
single fused bodies needed the whole weight in VMEM, which does not fit in
227 KB of shared memory, so each CUDA version is a few kernels launched back
to back; the sources describe the designs.  Heads are 64 wide, or 80 wide
(ViT-H/14: D = 1,280 in 16 heads) for the whole block in bf16 over rows of
257-1,024 keys, which ``csrc/attention.cuh``'s streamed route takes at that
width; any other head width, and 80 on another route, in fp32 or in a head
shard, is refused with a ``ValueError`` naming the rule.  The forwards write
``LN(x)`` once per row into a ``[B, L, D]`` scratch of the compute type that
the QKV product reads (77 MB at batch 256 and the vision shape in bf16, for
the call's duration); in bf16 every product runs on ``csrc/gemm_sm90.cuh``
(``ops/gemm_sm90.py`` exposes each alone).  The backward takes rows of up
to 1024 keys, and D up to 1,024 (1,280 at heads of 80).

Head-group tensor parallelism (``parallel/tp.py``) runs the same kernels on
one shard of the heads, as the JAX package's ``_partitioned`` lowering
does: ``qkv_kernel [3, D, Dv]``, ``qkv_bias [3, Dv]`` and ``out_kernel [Dv,
D]`` hold ``heads`` local heads (``Dv = 64 heads``, less than ``D``).  In
``partial`` mode the forwards return the fp32 out-projection of the shard's
heads without ``+ x + bout``; with ``add_g=False`` the backward's ``dx`` is
the shard's LayerNorm backward without ``+ g``, and its ``dscale``/``dbias``
are the shard's part.  :func:`tp_attention_block` sums the parts over the
model axis and adds the residual once (module ``parallel/comm.py``).  On the
card a shard takes any whole number of heads: ``Dv`` = 192 (ViT-B/16's
vision tower, ViT-L/14's text tower at ``--mesh_model 4``) runs the GEMM's
64-column tiles (``csrc/gemm_sm90.cuh``).  ``D`` stays a multiple of 128;
another shape is refused with a ``ValueError`` naming it.

A tensor on the CPU takes the plain PyTorch versions
(:func:`attention_block_inference_reference`,
:func:`attention_block_reference`, :func:`attention_block_backward_reference`),
the same math with the same rounding points; a CUDA tensor launches the
kernels or raises.  Both ops are differentiable: the training op saves the
forward's residuals, and the inference op's backward re-runs the training
forward and then the training backward, as the JAX package's does.

Every kernel call is a span of ``utils/profiling.py`` while a profiler runs:
``attn.block_fwd`` (B1), ``attn.block_bwd`` (B2) and ``attn.block_infer``
(B3), timed on the call's stream, with the attributes ``B``, ``L``, ``D``,
``heads``, ``head_dim``, ``causal`` and ``route`` (``"register"`` or
``"stream"``: the bf16 attention route ``csrc/attention.cuh`` takes at that
length; ``"fp32"``).  Without a profiler a call reads one flag.  Beside the
launch counters, ``launches_by_head_dim`` counts each op's launches by head
width (``chip_smoke.py`` holds each of its B1-B3 checks to its width with
them, and resets them with the other counters).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.utils import profiling

EPS = 1e-5
_NEG = -1e30
_HEAD_DIM = 64
_WIDE_HEAD_DIM = 80  # csrc/attention.cuh's kWideHeadDim: the streamed route only
_REG_KEYS = 256  # the longest bf16 row of the register route (kRegKeys)
_MAX_TRAIN_LEN = 1024  # keys per row the backward kernel takes (its attention passes' limit)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WIDE_RULE = (f"head_dim {_WIDE_HEAD_DIM} runs only the whole block (no head shard) in bfloat16 over rows of "
              f"{_REG_KEYS + 1}-{_MAX_TRAIN_LEN} keys, on the streamed route")


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  Every product of compute-type values accumulates in
# fp32 (the operands are upcast, so bf16 products are exact), biases add in
# fp32, and results round to the compute type where the TPU kernels round.


def _layer_norm(x32, ln_scale, ln_bias):
    """(xhat, rstd, LN(x)) in fp32."""
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    rstd = torch.rsqrt(var + EPS)
    xhat = (x32 - mean) * rstd
    return xhat, rstd, xhat * ln_scale.float() + ln_bias.float()


def _heads_first(t, heads):
    """[B, L, D] -> fp32 [B, H, L, head_dim]."""
    B, L, D = t.shape
    return t.float().reshape(B, L, heads, D // heads).transpose(1, 2)


def _heads_last(t):
    """[B, H, L, head_dim] -> [B, L, D]."""
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def _scores(qs, k, heads, causal):
    """fp32 scores T(q*scale) k^T [B, H, L, L], with -1e30 above the diagonal
    when causal (exp of it after the max shift is exactly 0)."""
    s = torch.matmul(_heads_first(qs, heads), _heads_first(k, heads).transpose(-1, -2))
    if causal:
        L = qs.shape[1]
        keep = torch.ones(L, L, dtype=torch.bool, device=qs.device).tril()
        s = s + torch.where(keep, 0.0, _NEG)
    return s


def _project(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, heads):
    """(q, k, v, T(q * scale)) in the compute type, each ``[B, L, Dv]``."""
    dtype = x.dtype
    _, _, y32 = _layer_norm(x.float(), ln_scale, ln_bias)
    y = y32.to(dtype).float()
    w = qkv_kernel.to(dtype).float()
    b = qkv_bias.float()
    q, k, v = ((torch.matmul(y, w[t]) + b[t]).to(dtype) for t in range(3))
    qs = (q.float() * (qkv_kernel.shape[-1] // heads) ** -0.5).to(dtype)
    return q, k, v, qs


def _out_proj(x, o, out_kernel, out_bias, partial=False):
    """``T(x + o Wout + bout)``, or with ``partial`` the fp32 ``o Wout``."""
    proj = torch.matmul(o.float(), out_kernel.to(x.dtype).float())
    if partial:
        return proj
    return ((x.float() + proj) + out_bias.float()).to(x.dtype)


def attention_block_inference_reference(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int, causal: bool = False,
    partial: bool = False,
):
    """Plain version of the inference kernel (B3).  Rounds the LN output,
    q/k/v, ``q * head_dim**-0.5``, the normalised probabilities, the
    attention output and the block output: ``o = T(T(softmax(s)) @ v)``.
    ``heads`` counts the heads of ``qkv_kernel [3, D, Dv]``; ``partial``
    returns the fp32 out-projection alone (module docstring)."""
    dtype = x.dtype
    _, k, v, qs = _project(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, heads)
    p = torch.softmax(_scores(qs, k, heads, causal), dim=-1).to(dtype)
    o = _heads_last(torch.matmul(p.float(), _heads_first(v, heads)).to(dtype))
    return _out_proj(x, o, out_kernel, out_bias, partial)


def attention_block_reference(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int, causal: bool = False,
    partial: bool = False,
):
    """Plain version of the training forward (B1) -> ``(out, o, q, k, v,
    lse)``.  As ``_fwd_kernel`` rounds: the unnormalised ``e = exp(s - m)``
    is cast for ``e @ v`` and the fp32 product divided by ``l``,
    ``o = T((T(e) @ v) / l)``; ``lse = m + log(l)`` ``[B, L, H]`` fp32,
    relative to the scaled scores.  ``partial`` as in the inference
    version."""
    dtype = x.dtype
    q, k, v, qs = _project(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, heads)
    s = _scores(qs, k, heads, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1).transpose(1, 2).contiguous()
    o = _heads_last((torch.matmul(e.to(dtype).float(), _heads_first(v, heads)) / l).to(dtype))
    return _out_proj(x, o, out_kernel, out_bias, partial), o, q, k, v, lse


def attention_block_backward_reference(
    g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, heads: int, causal: bool = False,
    add_g: bool = True,
):
    """Plain version of the training backward (B2, the out-projection's
    grads included) -> ``(dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout)``;
    ``dx`` in ``x.dtype``, the rest fp32.  Rounds where ``_bwd_kernel``
    rounds: ``do = T(g Wout^T)``, ``T(p)`` in ``dv`` only,
    ``ds = T(p (dp - rowsum(p dp)))``, and dq/dk/dv before the weight, bias
    and LN grads, which run in fp32 with ``dx`` rounded last.  With
    ``add_g=False`` (a head shard's part) ``dx`` is the LayerNorm backward
    alone, rounded, without ``+ g``."""
    dtype = x.dtype
    B, L, D = x.shape
    Dv = qkv_kernel.shape[-1]
    hd = Dv // heads
    scale = hd ** -0.5
    xhat, rstd, y32 = _layer_norm(x.float(), ln_scale, ln_bias)
    y = y32.to(dtype).float().reshape(B * L, D)
    g32 = g.to(dtype).float()
    do = torch.matmul(g32, out_kernel.to(dtype).float().T).to(dtype)
    qs = (q.float() * scale).to(dtype)

    s = _scores(qs, k, heads, causal)
    p = torch.exp(s - lse.transpose(1, 2).unsqueeze(-1))
    do_h = _heads_first(do, heads)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do_h).to(dtype)
    dp = torch.matmul(do_h, _heads_first(v, heads).transpose(-1, -2))
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(dtype).float()
    dq = (torch.matmul(ds, _heads_first(k, heads)) * scale).to(dtype)
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(qs, heads)).to(dtype)

    w = qkv_kernel.to(dtype).float()
    dwqkv = torch.empty(3, D, Dv, dtype=torch.float32, device=x.device)
    dbqkv = torch.empty(3, Dv, dtype=torch.float32, device=x.device)
    dY = torch.zeros(B * L, D, dtype=torch.float32, device=x.device)
    for t, d_t in enumerate((dq, dk, dv)):
        d_t = _heads_last(d_t).float().reshape(B * L, Dv)
        dwqkv[t] = torch.matmul(y.T, d_t)
        dbqkv[t] = d_t.sum(dim=0)
        dY = dY + torch.matmul(d_t, w[t].T)
    dY = dY.reshape(B, L, D)
    dscale = (dY * xhat).sum(dim=(0, 1))
    dbias = dY.sum(dim=(0, 1))
    dxhat = dY * ln_scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    dx = (dx + g32 if add_g else dx).to(dtype)

    dwout = torch.matmul(o.float().reshape(B * L, Dv).T, g32.reshape(B * L, D))
    dbout = g32.sum(dim=(0, 1))
    return dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout


# ---------------------------------------------------------------------------
# The kernels.


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = _kernels.load("attention_block")
    for name, n_ptrs in (("flyp_attention_block_fwd", 11), ("flyp_attention_block_fwd_train", 12)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # The head-shard entry: lse may be null (the inference forward); ints
    # B, L, D, Dv, H, causal, partial, dtype.
    lib.flyp_attention_block_fwd_shard.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.flyp_attention_block_fwd_shard.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _kernels.load("attention_block_bwd")
    lib.flyp_attention_block_bwd_workspace.argtypes = [ctypes.c_int] * 5
    lib.flyp_attention_block_bwd_workspace.restype = ctypes.c_longlong
    lib.flyp_attention_block_bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.flyp_attention_block_bwd.restype = ctypes.c_int
    lib.flyp_attention_block_bwd_shard_workspace.argtypes = [ctypes.c_int] * 6
    lib.flyp_attention_block_bwd_shard_workspace.restype = ctypes.c_longlong
    # ints B, L, D, Dv, H, causal, add_g, dtype.
    lib.flyp_attention_block_bwd_shard.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.flyp_attention_block_bwd_shard.restype = ctypes.c_int
    return lib


def _check_head_dim(kernel, dtype, L, D, Dv, heads, shard):
    """The head width rule of the kernels (module docstring): ``ValueError``
    naming it for any other shape."""
    if D % 128 or Dv > D or heads < 1 or Dv % heads:
        raise ValueError(f"{kernel} needs D a multiple of 128, Dv <= D and whole heads; got D={D}, Dv={Dv}, "
                         f"heads={heads}")
    hd = Dv // heads
    if hd == _HEAD_DIM:
        return
    if hd != _WIDE_HEAD_DIM:
        raise ValueError(f"{kernel} needs head_dim {_HEAD_DIM} (or {_WIDE_HEAD_DIM}: {_WIDE_RULE}); got head_dim "
                         f"{Dv / heads:g} (D={D}, Dv={Dv}, heads={heads})")
    if dtype != torch.bfloat16 or shard or not _REG_KEYS < L <= _MAX_TRAIN_LEN:
        raise ValueError(f"{kernel}: {_WIDE_RULE}; got {dtype}, L={L}, D={D}, Dv={Dv}, heads={heads}"
                         + (", a head shard" if shard else ""))


def _check_inputs(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, shard=False):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, D], got shape {tuple(x.shape)}")
    B, L, D = x.shape
    Dv = qkv_kernel.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention-block kernel takes float32 or bfloat16, got {x.dtype}")
    _check_head_dim("the attention-block kernel", x.dtype, L, D, Dv, heads, shard or Dv != D)
    if B * L == 0:
        raise ValueError("empty input")
    shapes = {
        "ln_scale": (ln_scale, (D,)), "ln_bias": (ln_bias, (D,)), "qkv_kernel": (qkv_kernel, (3, D, Dv)),
        "qkv_bias": (qkv_bias, (3, Dv)), "out_kernel": (out_kernel, (Dv, D)), "out_bias": (out_bias, (D,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _span(name, x, Dv, heads, causal):
    """The kernel call's span (module docstring); nothing without a profiler."""
    if not profiling.spans_on():
        return profiling.span(name)
    B, L, D = x.shape
    route = "fp32" if x.dtype == torch.float32 else "register" if L <= _REG_KEYS else "stream"
    return profiling.span(name, stream_of=x, B=B, L=L, D=D, heads=heads, head_dim=Dv // heads,
                          causal=bool(causal), route=route)


def _fwd_kernel_call(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal, train,
                     partial=False):
    """B3 (``train=False``) -> out, or B1 -> (out, o, q, k, v, lse); with
    ``partial`` ``out`` is the fp32 out-projection alone."""
    _check_inputs(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, shard=partial)
    B, L, D = x.shape
    Dv = qkv_kernel.shape[-1]
    dtype = x.dtype
    x = x.contiguous()
    f32 = [t.detach().to(torch.float32).contiguous() for t in (ln_scale, ln_bias, qkv_bias, out_bias)]
    wqkv = qkv_kernel.detach().to(dtype).contiguous()
    wout = out_kernel.detach().to(dtype).contiguous()
    out = torch.empty((B, L, D), dtype=torch.float32 if partial else dtype, device=x.device)
    qkv = torch.empty((3, B, L, Dv), dtype=dtype, device=x.device)
    o = torch.empty((B, L, Dv), dtype=dtype, device=x.device)
    y = torch.empty((B, L, D), dtype=dtype, device=x.device)  # LN(x), written once per row
    lse = torch.empty((B, L, heads), dtype=torch.float32, device=x.device) if train else None
    lib = _fwd_lib()
    ptrs = [x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), wqkv.data_ptr(), f32[2].data_ptr(),
            wout.data_ptr(), f32[3].data_ptr(), out.data_ptr(), qkv.data_ptr(), o.data_ptr(), y.data_ptr()]
    with torch.cuda.device(x.device), _span("attn.block_fwd" if train else "attn.block_infer", x, Dv, heads, causal):
        if Dv != D or partial:
            code = lib.flyp_attention_block_fwd_shard(
                *ptrs, lse.data_ptr() if train else None, B, L, D, Dv, heads, int(bool(causal)), int(bool(partial)),
                _DTYPE_CODES[dtype], _stream(x.device))
        elif train:
            code = lib.flyp_attention_block_fwd_train(*ptrs, lse.data_ptr(), B, L, D, heads, int(bool(causal)),
                                                      _DTYPE_CODES[dtype], _stream(x.device))
        else:
            code = lib.flyp_attention_block_fwd(*ptrs, B, L, D, heads, int(bool(causal)), _DTYPE_CODES[dtype],
                                                _stream(x.device))
    _kernels.check(lib, code, "attention-block kernel launch")
    if not train:
        attention_block_inference.launches += 1
        attention_block_inference.launches_by_head_dim[Dv // heads] += 1
        return out
    attention_block.fwd_launches += 1
    attention_block.fwd_launches_by_head_dim[Dv // heads] += 1
    return out, o, qkv[0], qkv[1], qkv[2], lse


def _bwd_kernel_call(g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, heads, causal,
                     add_g=True):
    """B2 -> (dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout); ``add_g=False``
    leaves ``+ g`` out of ``dx`` (a head shard's part).  ``dwout = o^T g``
    and ``dbout = colsum(g)`` read ``o`` and ``g`` as they are, so ``g``
    must come in ``x.dtype``: the op's output type, which autograd hands
    back."""
    B, L, D = x.shape
    Dv = qkv_kernel.shape[-1]
    dtype = x.dtype
    if g.dtype != dtype:
        raise TypeError(f"the attention-block backward kernel takes g in x's type {dtype}, got {g.dtype}")
    if L > _MAX_TRAIN_LEN:
        raise ValueError(f"the attention-block backward kernel takes L <= {_MAX_TRAIN_LEN}, got L={L}")
    shard = Dv != D or not add_g
    _check_head_dim("the attention-block backward kernel", dtype, L, D, Dv, heads, shard)
    if D > 1024 and Dv // heads != _WIDE_HEAD_DIM:
        raise ValueError(f"the attention-block backward kernel takes D <= 1024 at head_dim {_HEAD_DIM} (D <= 1280 "
                         f"at head_dim {_WIDE_HEAD_DIM}); got D={D}")
    lib = _bwd_lib()
    if shard:
        nbytes = lib.flyp_attention_block_bwd_shard_workspace(B, L, D, Dv, heads, _DTYPE_CODES[dtype])
    else:
        nbytes = lib.flyp_attention_block_bwd_workspace(B, L, D, heads, _DTYPE_CODES[dtype])
    if nbytes < 0:
        raise ValueError(f"the attention-block backward kernel does not take B={B} L={L} D={D} Dv={Dv} "
                         f"heads={heads}")
    dev = x.device
    tensors = [t.contiguous() for t in (x, g, o, q, k, v, lse)]
    ln = [t.detach().to(torch.float32).contiguous() for t in (ln_scale, ln_bias)]
    wqkv = qkv_kernel.detach().to(dtype).contiguous()
    wout = out_kernel.detach().to(dtype).contiguous()
    dx = torch.empty_like(tensors[0])
    dwqkv = torch.empty((3, D, Dv), dtype=torch.float32, device=dev)
    dbqkv = torch.empty((3, Dv), dtype=torch.float32, device=dev)
    dln = torch.empty((2, D), dtype=torch.float32, device=dev)
    dwout = torch.empty((Dv, D), dtype=torch.float32, device=dev)
    dbout = torch.empty((D,), dtype=torch.float32, device=dev)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ptrs = [*(t.data_ptr() for t in tensors), ln[0].data_ptr(), ln[1].data_ptr(), wqkv.data_ptr(), wout.data_ptr(),
            dx.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dln.data_ptr(), dwout.data_ptr(), dbout.data_ptr(),
            workspace.data_ptr()]
    with torch.cuda.device(dev), _span("attn.block_bwd", x, Dv, heads, causal):
        if shard:
            code = lib.flyp_attention_block_bwd_shard(*ptrs, B, L, D, Dv, heads, int(bool(causal)), int(bool(add_g)),
                                                      _DTYPE_CODES[dtype], _stream(dev))
        else:
            code = lib.flyp_attention_block_bwd(*ptrs, B, L, D, heads, int(bool(causal)), _DTYPE_CODES[dtype],
                                                _stream(dev))
    _kernels.check(lib, code, "attention-block backward kernel launch")
    attention_block.bwd_launches += 1
    attention_block.bwd_launches_by_head_dim[Dv // heads] += 1
    return dx, dln[0], dln[1], dwqkv, dbqkv, dwout, dbout


def _device_route(x, op: str) -> bool:
    """True for the kernels (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{op} runs on cuda or cpu tensors, got {x.device}")


def _train_forward(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal, partial=False):
    args = (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal)
    if _device_route(x, "attention_block"):
        return _fwd_kernel_call(*args, train=True, partial=partial)
    return attention_block_reference(*args, partial=partial)


def _train_backward(g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, heads, causal, add_g=True):
    """(dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout)."""
    if not _device_route(x, "attention_block"):
        return attention_block_backward_reference(
            g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, heads, causal, add_g=add_g)
    # B2 computes the out-projection's grads too, from the saved o.
    return _bwd_kernel_call(g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, heads, causal,
                            add_g=add_g)


def _param_grads(grads, params):
    """The grads in the parameters' own types (dx in x's)."""
    return tuple(gr.to(p.dtype) for gr, p in zip(grads, params))


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal):
        out, o, q, k, v, lse = _train_forward(
            x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal)
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, o, q, k, v, lse)
        ctx.heads, ctx.causal = heads, causal
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, o, q, k, v, lse = ctx.saved_tensors
        dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout = _train_backward(
            g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, ctx.heads, ctx.causal)
        grads = _param_grads((dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout),
                             (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias))
        return (*grads, None, None)


class _AttentionBlockInference(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal):
        args = (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal)
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(*args[:7])
            ctx.heads, ctx.causal = heads, causal
        if _device_route(x, "attention_block_inference"):
            return _fwd_kernel_call(*args, train=False)
        return attention_block_inference_reference(*args)

    @staticmethod
    def backward(ctx, g):
        # The residuals were never kept: re-run the training forward, then
        # its backward (dbout = sum g does not depend on bout's value).
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias = ctx.saved_tensors
        _, o, q, k, v, lse = _train_forward(
            x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, ctx.heads, ctx.causal)
        grads = _train_backward(g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, ctx.heads,
                                ctx.causal)
        return (*_param_grads(grads, (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias)), None, None)


def attention_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int,
                    causal: bool = False):
    """``x + LN -> QKV -> attention -> out-proj`` for ``x [B, L, D]``, the
    training op: its forward (B1) keeps q, k, v, o and lse for the backward
    (B2).

    Weights follow the JAX param tree: ``qkv_kernel [3, D, D]`` (q|k|v on
    the leading axis, head-major output features), ``qkv_bias [3, D]``,
    ``out_kernel [D, D]``, fp32 LN ``ln_scale``/``ln_bias`` and
    ``out_bias [D]``.  Matrices are cast to ``x.dtype`` inside; LN params
    and biases stay fp32.  Grads come back in the parameters' own types
    (``dx`` in ``x.dtype``).  ``causal`` masks the upper triangle (text
    tower)."""
    return _AttentionBlock.apply(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal)


def attention_block_inference(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int, causal: bool = False
):
    """The inference op (B3): :func:`attention_block` without the residual
    writes.  Still differentiable: its backward re-runs the training forward
    (B1) and then the training backward (B2)."""
    return _AttentionBlockInference.apply(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads,
                                          causal)


class _TPAttentionBlock(torch.autograd.Function):
    """The sub-block over one head shard, summed over the model axis: the
    counterpart of ``_partitioned``'s TP lowering, with its rounding points.
    Forward: the shard's fp32 out-projection (B1, or B3 when ``train`` is
    False), its sum over ``group``, then ``T(x + proj + bout)``.  Backward:
    the shard's ``T(dx_ln)`` (B2, ``add_g=False``) summed over ``group``,
    then ``T(g + dx_ln)``; ``dscale``/``dbias`` summed over ``group``;
    ``dWqkv``, ``dbqkv`` and ``dWout`` stay the shard's, ``dbout`` is whole
    on every rank.  The batch axes are the train step's to reduce."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal, group, train):
        from flyp_tpu_torch.parallel.comm import all_reduce_

        args = (x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal)
        ctx.heads, ctx.causal, ctx.group, ctx.train = heads, causal, group, train
        ctx.dtypes = tuple(t.dtype for t in args[:7])
        if train:
            partial, o, q, k, v, lse = _train_forward(*args, partial=True)
            ctx.save_for_backward(x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse)
        else:
            if any(ctx.needs_input_grad[:7]):
                ctx.save_for_backward(*args[:7])
            if _device_route(x, "attention_block_inference"):
                partial = _fwd_kernel_call(*args, train=False, partial=True)
            else:
                partial = attention_block_inference_reference(*args, partial=True)
        proj = all_reduce_(partial, group)
        return ((x.float() + proj) + out_bias.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from flyp_tpu_torch.parallel.comm import all_reduce_

        if ctx.train:
            x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse = ctx.saved_tensors
        else:
            # The residuals were never kept: re-run the shard's training
            # forward first, as the inference op does.
            x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias = ctx.saved_tensors
            _, o, q, k, v, lse = _train_forward(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias,
                                                ctx.heads, ctx.causal, partial=True)
        dx_ln, dscale, dbias, dwqkv, dbqkv, dwout, dbout = _train_backward(
            g, x, ln_scale, ln_bias, qkv_kernel, out_kernel, o, q, k, v, lse, ctx.heads, ctx.causal, add_g=False)
        dx_ln = all_reduce_(dx_ln, ctx.group)
        dx = (g.float() + dx_ln.float()).to(x.dtype)
        dln = all_reduce_(torch.stack([dscale, dbias]), ctx.group)
        grads = (dx, dln[0], dln[1], dwqkv, dbqkv, dwout, dbout)
        return (*(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)), None, None, None, None)


def tp_attention_block(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads: int,
                       causal: bool = False, group=None, train: bool = True):
    """The attention sub-block under head-group tensor parallelism: this
    rank holds ``heads`` heads, ``qkv_kernel [3, D, Dv]``, ``qkv_bias [3,
    Dv]``, ``out_kernel [Dv, D]``; ``x``, the LN params and ``out_bias`` are
    whole.  ``group`` is the model axis's process group.  ``train`` picks
    the training kernels (B1 and B2), else the inference forward (B3) with a
    backward that re-runs B1.  Returns ``T(x + sum_shards(o Wout) + bout)``
    on every rank of the group."""
    return _TPAttentionBlock.apply(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, heads, causal,
                                   group, train)


# Kernel launches since the counts were last reset (one per call on CUDA),
# and the same by head width.
attention_block_inference.launches = 0
attention_block.fwd_launches = 0
attention_block.bwd_launches = 0
attention_block_inference.launches_by_head_dim = {_HEAD_DIM: 0, _WIDE_HEAD_DIM: 0}
attention_block.fwd_launches_by_head_dim = {_HEAD_DIM: 0, _WIDE_HEAD_DIM: 0}
attention_block.bwd_launches_by_head_dim = {_HEAD_DIM: 0, _WIDE_HEAD_DIM: 0}
