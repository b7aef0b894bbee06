"""Measurements for the MFU levers, on the card.

Counterpart of ``tools/mfu_levers.py``.  Isolated experiments, each timed
with CUDA events and ending in a host fetch of one element
(``flyp_tpu_torch/tools/_timing.py``):

1. ``matmul_ceiling``: achievable bf16 TFLOP/s of the library's products for
   (a) a deep-K matmul chain at the ViT-B MLP shapes, the practical ceiling,
   (b) the attention kernels' per-head score product geometry ([Lp, 64] x
   [64, Lp] batched over B*H), (c) the PV product ([Lp, Lp] x [Lp, 64]) and
   (d) the score product with two heads merged (K=128).  (b)-(d) write fp32,
   as the JAX tool asks XLA to (``torch.bmm(..., out_dtype=torch.float32)``;
   a torch without it writes bf16), and each line says which.
2. ``pallas_score_depth``: the same question inside a kernel (T2,
   ``csrc/score_depth.cu`` on ``csrc/gemm_sm90.cuh``): per item, the sum
   over heads of [Lp, hd] x [hd, Lp] score products, one fp32 accumulator,
   hd = 64, 128, 256 features a step.  The output traffic is the same at
   every hd, so a time difference is the contraction depth's.  On the
   H100 the sum is one D-deep product whose schedule does not depend on hd
   (``wgmma`` steps 16 deep, the ring stages 64), so the three should agree.
3. ``row_quant``: the QKV projection [R, 768] @ [768, 2304] per item (T3,
   ``csrc/probe_gemm.cu`` on ``csrc/gemm_sm90.cuh``) for R in 197 (exact
   ViT-B/16), 200, 208, 256: does the time follow R, or the 128-row tiles
   R is padded to?  The TPU's per-item blocks pad; on the H100 the items'
   rows are tiled flat as one [B R, 768] product, so time follows B R.
4. ``adamw_tail``: the isolated 150M-parameter AdamW update in plain PyTorch
   (the XLA chain's counterpart), fp32 against bf16 moments, against the
   memory-bandwidth floor.
5. ``adamw_pallas``: the same update as one kernel (T4, ``csrc/adamw.cu``),
   reading p, m, v, g and writing p, m, v in place.
6. ``zeroshot_imagenet``: the per-epoch zero-shot head rebuild at ImageNet
   scale (1000 classes x 80 templates) through the full ViT-B/16 text tower,
   random weights from seed 0, bf16 on the card (B3 in every block).

``--device cpu`` runs the plain versions: a functional check, not a
measurement.

Usage: python -m flyp_tpu_torch.tools.mfu_levers [matmul|depth|row_quant|adamw|adamw_pallas|zeroshot|all] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.ops.attention_block import _DTYPE_CODES, _device_route, _stream
from flyp_tpu_torch.tools._timing import fetch, normal, time_call
from flyp_tpu_torch.tools.int8_matmul_probe import has_out_dtype, probe_gemm_lib

ITERS = 30
ADAMW_ITERS = 20
ADAMW_COUNT = 10  # the step count the TPU probe fixes
LR, B1, B2, EPS, WD = 1e-5, 0.9, 0.999, 1e-8, 0.1
SCORE_DEPTHS = (64, 128, 256)
ROW_COUNTS = (197, 200, 208, 256)
_TILE_N = 128
_TMA_ROW = 8  # bf16 elements in the 16 bytes TMA needs a row to be a multiple of


# ---------------------------------------------------------------------------
# T2: the per-head score sum.


def score_depth_reference(q, k, hd):
    """Plain version: ``o[b] = sum_h q[b, :, h] k[b, :, h]^T`` over heads of
    ``hd`` features, each head's product in fp32 added into one fp32
    accumulator, as the TPU kernel's body adds."""
    B, L, D = q.shape
    acc = torch.zeros((B, L, L), dtype=torch.float32, device=q.device)
    for h in range(D // hd):
        qh = q[:, :, h * hd:(h + 1) * hd].float()
        kh = k[:, :, h * hd:(h + 1) * hd].float()
        acc += torch.matmul(qh, kh.transpose(1, 2))
    return acc


@functools.lru_cache(maxsize=None)
def _score_lib() -> ctypes.CDLL:
    lib = _kernels.load("score_depth")
    lib.flyp_score_depth.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.flyp_score_depth.restype = ctypes.c_int
    return lib


def score_depth(q, k, hd, out=None):
    """T2: q, k bf16 [B, L, D] -> fp32 [B, L, L], ``hd`` (64, 128 or 256)
    features a step.  ``out`` (optional, contiguous fp32 [B, L, L]) takes
    the result.  A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version."""
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or q.dim() != 3 or q.shape != k.shape:
        raise TypeError(f"score_depth takes bfloat16 q, k [B, L, D] of one shape, got {q.dtype} {tuple(q.shape)}, "
                        f"{k.dtype} {tuple(k.shape)}")
    B, L, D = q.shape
    if hd not in SCORE_DEPTHS or D % hd:
        raise ValueError(f"score_depth: hd={hd} must be one of {SCORE_DEPTHS} and divide D={D}")
    if B < 1 or L < 1:
        raise ValueError(f"score_depth: B={B} and L={L} must be positive")
    if k.device != q.device:
        raise ValueError(f"score_depth: k is on {k.device}, q on {q.device}")
    _kernels.check_out("score_depth: out", out, (B, L, L), torch.float32, q.device)
    if not _device_route(q, "score_depth"):
        res = score_depth_reference(q, k, hd)
        return res if out is None else out.copy_(res)
    q, k = q.contiguous(), k.contiguous()
    if out is None:
        out = torch.empty((B, L, L), dtype=torch.float32, device=q.device)
    _aligned("score_depth", q, k, out)
    lib = _score_lib()
    with torch.cuda.device(q.device):
        code = lib.flyp_score_depth(q.data_ptr(), k.data_ptr(), out.data_ptr(), B, L, D, hd, _stream(q.device))
    _kernels.check(lib, code, "score-depth kernel launch")
    score_depth.launches += 1
    return out


score_depth.launches = 0


def _aligned(name, *tensors):
    """The kernels read and write through TMA or 16-byte vector accesses,
    which need 16-byte aligned addresses."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernel needs 16-byte aligned tensors")


# ---------------------------------------------------------------------------
# T3: the row-count GEMM.


def row_gemm_reference(x, w):
    """Plain version: ``T(x[b] @ w)`` with fp32 products of the bf16 operands
    summed in fp32, rounded to bf16."""
    return torch.matmul(x.float(), w.float()).to(torch.bfloat16)


def row_gemm(x, w, out=None):
    """T3: x [B, R, D] @ w [D, N] per item, bf16 in and out, fp32
    accumulate.  ``out`` (optional, contiguous bf16 [B, R, N]) takes the
    result.  A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version.  The kernel tiles N in 128 columns and reads rows by
    TMA (D a multiple of 8); other shapes raise ``ValueError`` on both
    devices."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or x.dim() != 3 or w.dim() != 2 \
            or x.shape[2] != w.shape[0]:
        raise TypeError(f"row_gemm takes bfloat16 x [B, R, D] and w [D, N], got {x.dtype} {tuple(x.shape)}, "
                        f"{w.dtype} {tuple(w.shape)}")
    B, R, D = x.shape
    N = w.shape[1]
    if N < _TILE_N or N % _TILE_N:
        raise ValueError(f"row_gemm: N={N} is not a multiple of {_TILE_N}, the kernel's output tile width")
    if D < _TMA_ROW or D % _TMA_ROW:
        raise ValueError(f"row_gemm: D={D} is not a multiple of {_TMA_ROW}: TMA reads rows of 16 bytes")
    if B < 1 or R < 1 or B * R >= 2 ** 31:
        raise ValueError(f"row_gemm: B={B} and R={R} must be positive, B*R below 2^31")
    if w.device != x.device:
        raise ValueError(f"row_gemm: w is on {w.device}, x on {x.device}")
    _kernels.check_out("row_gemm: out", out, (B, R, N), torch.bfloat16, x.device)
    if not _device_route(x, "row_gemm"):
        res = row_gemm_reference(x, w)
        return res if out is None else out.copy_(res)
    x, w = x.contiguous(), w.contiguous()
    if out is None:
        out = torch.empty((B, R, N), dtype=torch.bfloat16, device=x.device)
    _aligned("row_gemm", x, w, out)
    lib = probe_gemm_lib()
    with torch.cuda.device(x.device):
        code = lib.flyp_row_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, R, D, N, _stream(x.device))
    _kernels.check(lib, code, "row GEMM launch")
    row_gemm.launches += 1
    return out


row_gemm.launches = 0


# ---------------------------------------------------------------------------
# T4: the fused AdamW update.


def adamw_update_reference(p, m, v, g, count, lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD):
    """Plain version -> new ``(p, m, v)``: every operation in fp32, in the
    TPU kernel's order, Python-float constants rounded to fp32 once (as JAX
    rounds weak-typed floats); the moments round to their own type.  Also
    the counterpart of the JAX ``adamw_tail``'s ``update``.  The bias
    corrections divide as tensors: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, one rounding more."""
    g32 = g.float()
    m32 = m.float() * b1 + (1 - b1) * g32
    v32 = v.float() * b2 + (1 - b2) * g32 * g32
    bc1, bc2 = (torch.tensor(c, dtype=torch.float32, device=p.device) for c in (1 - b1 ** count, 1 - b2 ** count))
    mhat = m32 / bc1
    vhat = v32 / bc2
    newp = p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    return newp, m32.to(m.dtype), v32.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _adamw_lib() -> ctypes.CDLL:
    lib = _kernels.load("adamw")
    lib.flyp_adamw_update.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_float] * 9
                                      + [ctypes.c_int, ctypes.c_void_p])
    lib.flyp_adamw_update.restype = ctypes.c_int
    return lib


def adamw_update(p, m, v, g, count, lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD):
    """T4: one AdamW step, in place -> ``(p, m, v)``.  p fp32; m, v fp32 or
    bf16 (one type); g bf16; one shape, contiguous.  A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version and copies it back."""
    if p.dtype != torch.float32 or g.dtype != torch.bfloat16 or m.dtype != v.dtype or m.dtype not in _DTYPE_CODES:
        raise TypeError(f"adamw_update takes p float32, m and v float32 or bfloat16 (one type), g bfloat16; got "
                        f"{p.dtype}, {m.dtype}, {v.dtype}, {g.dtype}")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"adamw_update: {name} is {tuple(t.shape)} on {t.device}, p {tuple(p.shape)} on "
                             f"{p.device}")
    tensors = (p, m, v, g)
    if any(not t.is_contiguous() for t in tensors) or p.numel() == 0:
        raise ValueError("adamw_update updates contiguous, non-empty tensors in place")
    if not _device_route(p, "adamw_update"):
        for t, new in zip((p, m, v), adamw_update_reference(p, m, v, g, count, lr, b1, b2, eps, wd)):
            t.copy_(new)
        return p, m, v
    _aligned("adamw_update", *tensors)
    f32 = [float(np.float32(c)) for c in (b1, 1 - b1, b2, 1 - b2, 1 - b1 ** count, 1 - b2 ** count, lr, eps, wd)]
    lib = _adamw_lib()
    with torch.cuda.device(p.device):
        code = lib.flyp_adamw_update(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(), *f32,
                                     _DTYPE_CODES[m.dtype], _stream(p.device))
    _kernels.check(lib, code, "AdamW kernel launch")
    adamw_update.launches += 1
    return p, m, v


adamw_update.launches = 0


# ---------------------------------------------------------------------------
# The probes.


def _bmm_fp32(a, b):
    """Batched ``a @ b`` of bf16 operands into fp32 (the JAX tool's
    ``preferred_element_type=float32``), where the installed torch has
    ``torch.bmm(..., out_dtype=)`` on the card, else into bf16; on the CPU,
    which has no such kernel, the product of the fp32 operands."""
    if a.device.type != "cuda":
        return torch.bmm(a.float(), b.float())
    if has_out_dtype("bmm"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b)


def matmul_ceiling(*, M=50432, K=768, N=3072, BH=3072, Lp=208, hd=64, iters=ITERS, device="cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    dt = torch.bfloat16

    # (a) deep-K chain at ViT-B MLP shapes — the practical matmul ceiling.
    a = normal(rng, (M, K), dt, device)
    b = normal(rng, (K, N), dt, device)
    c = normal(rng, (N, K), dt, device)
    t = time_call(lambda a, b, c: torch.matmul(torch.matmul(a, b), c), a, b, c, iters=iters)
    fl = 2 * M * K * N * 2
    print(f"deep-K chain [{M}x{K}x{N}]x2:    {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s")

    # (b) the score-product geometry: B*H independent [Lp, hd] x [hd, Lp]
    # products (vision tower, batch 256: Lp=208, B*H=3072).
    q = normal(rng, (BH, Lp, hd), dt, device)
    k = normal(rng, (BH, Lp, hd), dt, device)
    out = "float32" if device.type != "cuda" or has_out_dtype("bmm") else "bfloat16"

    def scores(q, k):
        return _bmm_fp32(q, k.mT)

    t = time_call(scores, q, k, iters=iters)
    fl = 2 * BH * Lp * Lp * hd
    print(f"score mm  [{Lp}x{hd}]x[{hd}x{Lp}] x{BH}: {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s  ({out} out)")

    # (c) the PV product: K=Lp (deep), N=hd (narrow output).
    p = normal(rng, (BH, Lp, Lp), dt, device)
    v = normal(rng, (BH, Lp, hd), dt, device)
    t = time_call(_bmm_fp32, p, v, iters=iters)
    fl = 2 * BH * Lp * Lp * hd
    print(f"pv mm     [{Lp}x{Lp}]x[{Lp}x{hd}] x{BH}: {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s  ({out} out)")

    # (d) the score product with K=2*hd (two heads fused): does doubling the
    # contraction depth double throughput?
    q2 = normal(rng, (BH // 2, Lp, 2 * hd), dt, device)
    k2 = normal(rng, (BH // 2, Lp, 2 * hd), dt, device)
    t = time_call(scores, q2, k2, iters=iters)
    fl = 2 * (BH // 2) * Lp * Lp * (2 * hd)
    print(f"score mm K={2 * hd} (2 heads merged):  {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s  ({out} out)")


def pallas_score_depth(*, B=256, Lp=208, D=768, iters=ITERS, device="cuda"):
    """T2 at hd = 64, 128, 256 on the same q, k: the total work and the
    output traffic do not depend on hd."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    q = normal(rng, (B, Lp, D), torch.bfloat16, device)
    k = normal(rng, (B, Lp, D), torch.bfloat16, device)
    for hd in SCORE_DEPTHS:
        t = time_call(score_depth, q, k, hd, iters=iters)
        fl = 2 * B * Lp * Lp * D  # depth-invariant total
        print(f"pallas score depth hd={hd:3d}: {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s")


def row_quant(*, B=256, D=768, N=2304, rows=ROW_COUNTS, iters=ITERS, device="cuda"):
    """T3 at each row count R: if time follows R, exact-length row blocks
    are a real lever; if it follows the 128-row tiles, they buy only bytes.
    On the H100 the kernel tiles the B R rows flat, so no item is padded and
    time follows B R."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    w = normal(rng, (D, N), torch.bfloat16, device)
    for R in rows:
        x = normal(rng, (B, R, D), torch.bfloat16, device)
        t = time_call(row_gemm, x, w, iters=iters)
        fl = 2 * B * R * D * N
        print(f"row_quant R={R:3d}: {t*1e3:7.2f} ms  {fl/t/1e12:6.1f} TFLOP/s  ({t/B*1e6:6.1f} us/program)")


def _adamw_loop(update, n_params, cols, iters, device, tag):
    rng = np.random.default_rng(0)
    p_host = rng.standard_normal((n_params // cols, cols), dtype=np.float32)
    g_host = rng.standard_normal((n_params // cols, cols), dtype=np.float32)
    n = p_host.size
    for mdtype, name in ((torch.float32, "fp32 moments"), (torch.bfloat16, "bf16 moments")):
        state = [torch.from_numpy(p_host).to(device), torch.zeros(p_host.shape, dtype=mdtype, device=device),
                 torch.zeros(p_host.shape, dtype=mdtype, device=device)]
        g = torch.from_numpy(g_host).to(device).to(torch.bfloat16)

        def step():
            state[:] = update(*state, g, ADAMW_COUNT)
            return state[0]

        t = time_call(step, iters=iters)
        msz = torch.finfo(mdtype).bits // 8
        bytes_moved = n * (4 + msz + msz + 2 + 4 + msz + msz)  # r: p,m,v,g  w: p,m,v
        print(f"{tag} {name}: {t*1e3:6.2f} ms  ({bytes_moved/t/1e9:5.0f} GB/s apparent)")
        del state, g


def adamw_tail(n_params=150_000_000, *, cols=1024, iters=ADAMW_ITERS, device="cuda"):
    """The AdamW update as plain PyTorch ops on ``[n_params // cols, cols]``."""
    _adamw_loop(adamw_update_reference, n_params, cols, iters, resolve_device(device), "adamw")


def adamw_pallas(n_params=150_000_000, *, cols=1024, block=2048, iters=ADAMW_ITERS, device="cuda"):
    """The AdamW update as one kernel, in place.  The parameter count is the
    TPU probe's: ``n_params`` cut to whole blocks of ``block`` rows."""
    rows = n_params // cols // block * block
    _adamw_loop(adamw_update, rows * cols, cols, iters, resolve_device(device), "adamw pallas")


def zeroshot_imagenet(*, num_classes=1000, config=None, encode_batch=2048, device="cuda"):
    """The head rebuild for ``num_classes`` classes x 80 templates; ``config``
    replaces ViT-B/16's (the CPU tests run a tiny one).  Returns the head."""
    from flyp_tpu_torch.evaluation.zeroshot import get_zeroshot_classifier
    from flyp_tpu_torch.models import build_clip_model
    from flyp_tpu_torch.templates import get_template
    from flyp_tpu_torch.tokenizer import tokenize

    device = resolve_device(device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype=dtype, seed=0)
    model = build_clip_model(cfg, config_override=config, device=device)
    template = get_template("openai_imagenet_template")
    classnames = [f"class number {i}" for i in range(num_classes)]

    t0 = time.perf_counter()
    head = get_zeroshot_classifier(model, classnames, template, encode_batch=encode_batch)
    fetch(head.weight)
    t_total = time.perf_counter() - t0
    # Second build reuses the cached tokens and the built kernels: the
    # steady-state per-epoch cost.
    t0 = time.perf_counter()
    head = get_zeroshot_classifier(model, classnames, template, encode_batch=encode_batch)
    fetch(head.weight)
    t_steady = time.perf_counter() - t0
    # Tokenize-only share (host-side, cached nothing), from the first 100 classes.
    sample = classnames[:100]
    t0 = time.perf_counter()
    tokenize([t(n) for n in sample for t in template])
    t_tok = (time.perf_counter() - t0) * len(classnames) / len(sample)
    print(
        f"zero-shot head {num_classes}x{len(template)} (ViT-B/16): first {t_total:.1f} s (incl first-use builds), "
        f"steady {t_steady:.1f} s/epoch, of which host tokenize ~{t_tok:.1f} s"
    )
    return head


PROBES = {
    "matmul": matmul_ceiling,
    "depth": pallas_score_depth,
    "row_quant": row_quant,
    "adamw": adamw_tail,
    "adamw_pallas": adamw_pallas,
    "zeroshot": zeroshot_imagenet,
}


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="all", choices=[*PROBES, "all"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    ns = parser.parse_args(argv)
    resolve_device(ns.device)
    for name, probe in PROBES.items():
        if ns.which in (name, "all"):
            probe(device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
