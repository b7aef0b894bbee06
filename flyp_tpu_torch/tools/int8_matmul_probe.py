"""Is int8 worth building a quantized serving path for on the H100?

Counterpart of ``tools/int8_matmul_probe.py``.  The H100's dense int8 peak
(1,979 TOP/s) is twice its bf16 peak (989 TFLOP/s).  Before building weight
and activation quantization into the serving forward, measure whether the
2x survives at the exact matmul shapes the ViT-B/16 serving path runs, and
how much dynamic activation quantization (abs-max scale + round + cast, the
cheapest scheme) eats:

* ``main``: the library's products (``torch.mm`` into fp32 for bf16,
  ``torch._int_mm`` for int8, and the dynamic-quant recipe around it), the
  counterparts of the JAX tool's XLA ``dot``s;
* ``main_pallas``: the package's own probe GEMM (T1, ``csrc/probe_gemm.cu``:
  one design on ``csrc/gemm_sm90.cuh``'s TMA + ``wgmma`` pipeline for both
  types, bf16 into fp32 and int8 into int32), at the best (qkv) and worst
  (out-proj) serving shapes and one large square, the ceiling.

Rates are effective TOP/s = 2*M*N*K / time, so bf16 and int8 columns are
directly comparable.  ``--device cpu`` runs the plain versions: a functional
check, not a measurement.

Usage: python -m flyp_tpu_torch.tools.int8_matmul_probe [pallas] [batch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import numpy as np
import torch

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.ops.attention_block import _device_route, _stream
from flyp_tpu_torch.tools._timing import integers, normal, time_call

ITERS = 50
SEQ = 208  # ViT-B/16's 197 tokens padded to 16
# (operand type, output type) -> (kernel, contraction multiple): the TPU
# probe's block depths, kept as the op's contract (the kernel takes any
# multiple of 8 bf16 or 16 int8).
_KINDS = {(torch.bfloat16, torch.float32): ("bf16", 32), (torch.int8, torch.int32): ("int8", 64)}
_TILE_N = 128
_MAX_M = 65535 * 128


def probe_mm_reference(a, b, out_dtype):
    """Plain version: ``a @ b`` with fp32 products of the bf16 operands
    (exact) summed in fp32, or the exact int32 product of int8 operands
    (int32 on the CPU; float64 on the card, exact while 127^2 K < 2^53)."""
    if out_dtype == torch.int32:
        if a.device.type == "cpu":
            return torch.matmul(a.to(torch.int32), b.to(torch.int32))
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.float(), b.float())


def check_shape(M: int, K: int, N: int, kind: str) -> None:
    """Raise ``ValueError`` naming the dimension for a shape the kernel cannot
    tile: every output element of an accepted shape is computed, never a
    truncated grid."""
    depth = dict(_KINDS.values())[kind]
    if not 1 <= M <= _MAX_M:
        raise ValueError(f"probe_mm: M={M} is outside the kernel's 1..{_MAX_M} rows")
    if N < _TILE_N or N % _TILE_N:
        raise ValueError(f"probe_mm: N={N} is not a multiple of {_TILE_N}, the kernel's output tile width")
    if K < depth or K % depth:
        raise ValueError(f"probe_mm: K={K} is not a multiple of {depth}, the {kind} probe's block depth")


@functools.lru_cache(maxsize=None)
def probe_gemm_lib() -> ctypes.CDLL:
    """``csrc/probe_gemm.cu``, built and bound once: T1's two entry points
    and T3's (``mfu_levers.row_gemm``)."""
    lib = _kernels.load("probe_gemm")
    lib.flyp_probe_mm_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.flyp_probe_mm_int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.flyp_probe_mm_bf16, lib.flyp_probe_mm_int8):
        fn.restype = ctypes.c_int
    lib.flyp_row_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.flyp_row_gemm.restype = ctypes.c_int
    return lib


def probe_mm(a, b, out_dtype, out=None):
    """T1: ``a [M, K] @ b [K, N]``, bf16 into fp32 or int8 into int32, over
    the full depth.  ``out`` (optional, contiguous, of the output type) takes
    the result.  A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version.  Shapes the kernel cannot tile raise ``ValueError`` on
    both devices.  int8 transposes ``b`` into a ``[N, K]`` scratch inside the
    call (``wgmma`` takes 8-bit operands K-major only)."""
    kind = _KINDS.get((a.dtype, out_dtype), (None,))[0]
    if kind is None or b.dtype != a.dtype:
        raise TypeError(f"probe_mm takes bfloat16 -> float32 or int8 -> int32, got {a.dtype}, {b.dtype} -> {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"probe_mm: a [M, K] and b [K, N], got {tuple(a.shape)} and {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    check_shape(M, K, N, kind)
    _kernels.check_out("probe_mm: out", out, (M, N), out_dtype, a.device)
    if b.device != a.device:
        raise ValueError(f"probe_mm: b is on {b.device}, a on {a.device}")
    if not _device_route(a, "probe_mm"):
        res = probe_mm_reference(a, b, out_dtype)
        return res if out is None else out.copy_(res)
    a, b = a.contiguous(), b.contiguous()
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    lib = probe_gemm_lib()
    with torch.cuda.device(a.device):
        if kind == "bf16":
            code = lib.flyp_probe_mm_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, _stream(a.device))
        else:
            bt = torch.empty((N, K), dtype=torch.int8, device=a.device)
            code = lib.flyp_probe_mm_int8(a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, K,
                                          _stream(a.device))
    _kernels.check(lib, code, f"probe GEMM ({kind}) launch")
    if kind == "bf16":
        probe_mm.bf16_launches += 1
    else:
        probe_mm.int8_launches += 1
    return out


probe_mm.bf16_launches = 0
probe_mm.int8_launches = 0


@functools.lru_cache(maxsize=None)
def has_out_dtype(op: str) -> bool:
    """Whether the installed torch has ``torch.<op>(..., out_dtype=)``."""
    return any(s.overload_name == "dtype" for s in torch._C._jit_get_schemas_for_operator(f"aten::{op}"))


def library_mm(a, b, out_dtype):
    """One PyTorch call computing T1's function, timed only (the port never
    calls it): ``torch.mm`` into fp32 for bf16 (bf16 out where the
    installed torch has no ``out_dtype``), ``torch._int_mm`` for int8.  On
    the CPU, where neither exists for these types, the plain version."""
    if a.device.type != "cuda":
        return probe_mm_reference(a, b, out_dtype)
    if out_dtype == torch.int32:
        return torch._int_mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32) if has_out_dtype("mm") else torch.mm(a, b)


def dynamic_quant_mm(a, b8, scale_b):
    """Per-tensor dynamic abs-max quant of the activation, int8 matmul, fp32
    dequant: the cheapest serving-quant recipe (``torch.round`` rounds half
    to even, as ``jnp.round`` does)."""
    s = a.abs().max().float() / 127.0
    a_q = torch.clamp(torch.round(a.float() / s), -127, 127).to(torch.int8)
    acc = library_mm(a_q, b8, torch.int32)
    return acc.float() * (s * scale_b)


def _serving_shapes(M: int, D: int):
    return [
        (f"qkv  [M,{D}]x[{D},{3 * D}]", M, D, 3 * D),
        (f"out  [M,{D}]x[{D},{D}]", M, D, D),
        (f"mlp1 [M,{D}]x[{D},{4 * D}]", M, D, 4 * D),
        (f"mlp2 [M,{4 * D}]x[{4 * D},{D}]", M, 4 * D, D),
    ]


def main(batch=256, *, seq=SEQ, width=768, iters=ITERS, device="cuda"):
    """The library's bf16 and int8 products (and the dynamic-quant recipe)
    at the ViT-B/16 serving shapes, M = batch * padded sequence."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    print(f"{'shape':28s} {'bf16':>10s} {'int8':>10s} {'int8+dq':>10s}   (TOP/s; dq = dynamic act quant)")
    for name, m, k, n in _serving_shapes(batch * seq, width):
        a16 = normal(rng, (m, k), torch.bfloat16, device)
        b16 = normal(rng, (k, n), torch.bfloat16, device)
        a8 = integers(rng, (m, k), device)
        b8 = integers(rng, (k, n), device)
        scale_b = torch.tensor(0.01, dtype=torch.float32, device=device)
        flops = 2.0 * m * k * n
        t_bf16 = time_call(library_mm, a16, b16, torch.float32, iters=iters)
        t_int8 = time_call(library_mm, a8, b8, torch.int32, iters=iters)
        t_dq = time_call(dynamic_quant_mm, a16, b8, scale_b, iters=iters)
        print(
            f"{name:28s} {flops / t_bf16 / 1e12:10.1f} {flops / t_int8 / 1e12:10.1f}"
            f" {flops / t_dq / 1e12:10.1f}   (ms: {t_bf16*1e3:.2f} / {t_int8*1e3:.2f} / {t_dq*1e3:.2f})",
            flush=True,
        )


def main_pallas(batch=256, *, seq=SEQ, width=768, big=(16384, 4096, 4096), iters=ITERS, device="cuda"):
    """int8 vs bf16 through the package's probe GEMM at the best (qkv) and
    worst (out-proj) shapes of ``main``, and the large square ``big``."""
    device = resolve_device(device)
    cpu = device.type == "cpu"
    if cpu:
        # Functional check only: plain GEMMs at probe scale take minutes.
        batch = min(batch, 2)
    M = batch * seq
    rng = np.random.default_rng(0)
    print(f"{'shape':28s} {'bf16-pallas':>12s} {'int8-pallas':>12s}   (TOP/s)")
    # big-square is the ceiling probe: if 2x int8 is reachable at ALL on this
    # card, it shows here; the serving shapes then tell how much survives.
    bm, bk, bn = big
    shapes = _serving_shapes(M, width)[:2] + [(f"big  [{bm},{bk}]x[{bk},{bn}]", bm, bk, bn)]
    if cpu:
        shapes = shapes[:2]
    for name, m, k, n in shapes:
        a16 = normal(rng, (m, k), torch.bfloat16, device)
        b16 = normal(rng, (k, n), torch.bfloat16, device)
        a8 = integers(rng, (m, k), device)
        b8 = integers(rng, (k, n), device)
        flops = 2.0 * m * k * n
        # correctness guard (tiny slice, exact in int32)
        ref = probe_mm_reference(a8[:8], b8[:, :128], torch.int32)
        got = probe_mm(a8, b8, torch.int32)[:8, :128]
        if not torch.equal(ref.cpu(), got.cpu()):
            raise AssertionError("probe int8 GEMM mismatch")
        t16 = time_call(probe_mm, a16, b16, torch.float32, iters=iters)
        t8 = time_call(probe_mm, a8, b8, torch.int32, iters=iters)
        print(f"{name:28s} {flops / t16 / 1e12:12.1f} {flops / t8 / 1e12:12.1f}"
              f"   (ms: {t16*1e3:.2f} / {t8*1e3:.2f})", flush=True)


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("args", nargs="*", metavar="[pallas] [batch]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    ns = parser.parse_args(argv)
    pos = list(ns.args)
    if pos and pos[0] == "pallas":
        main_pallas(int(pos[1]) if len(pos) > 1 else 256, device=ns.device)
    else:
        main(int(pos[0]) if pos else 256, device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
