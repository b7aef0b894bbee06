"""The attention block's five bf16 products (G1-G5), each on its own.

``csrc/gemm_sm90.cuh`` is the GEMM the package's kernels run in bf16 (and
the probe T1 in int8): TMA loads into a ring of shared-memory stages,
``wgmma`` products, fp32 accumulate, the epilogue of ``common.cuh``'s
``gemm_store``.  B1 and B3 (``csrc/attention_block.cu``) launch G1 and G2,
B2 (``csrc/attention_block_bwd.cu``) G3, G4 and G5; B4
(``csrc/mlp_block.cu``) its own two.  This module exposes the
products alone (``csrc/gemm_sm90.cu``), so that each can be held against its
plain version and timed; the main path reaches them only through the
attention-block ops.

For ``M`` rows, width ``D`` (a multiple of 128) and a head shard's width
``Dv`` (a multiple of 64 up to ``D``; ``Dv = D`` for the whole block, read
from the operands' shapes), all bf16 but the fp32 biases and the fp32
outputs of G4 and G5:

* G1 :func:`qkv_product`: ``qkv[t] = T(y @ wqkv[t] + bqkv[t])`` -> ``[3, M, Dv]``;
* G2 :func:`out_product`: ``T(x + o @ wout + bout)`` -> ``[M, D]``;
* G3 :func:`grad_out_product`: ``T(g @ wout^T)`` -> ``[M, Dv]``;
* G4 :func:`weight_grad_product`: ``y^T d[t]`` -> fp32 ``[3, D, Dv]``, partial
  sums over fixed row chunks added in a fixed order;
* G5 :func:`input_grad_product`: ``sum_t d[t] @ wqkv[t]^T`` -> fp32 ``[M, D]``.

An odd number of heads (``Dv`` = 192, 320) makes G1's, G3's and G4's
column count an odd multiple of 64, which the GEMM tiles 64 wide.

A CPU tensor takes the plain version (fp32 products of the bf16 operands,
rounded as the epilogue rounds); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flyp_tpu_torch.ops import _kernels

_TILE = 128
_SHARD_TILE = 64  # a head shard's width: whole heads of 64


# ---------------------------------------------------------------------------
# Plain PyTorch versions: fp32 products of the bf16 operands (exact
# products, fp32 sums), then the epilogue's adds in its order and one
# rounding.


def qkv_product_reference(y, wqkv, bqkv):
    prod = torch.matmul(y.float(), wqkv.float())  # [3, M, D]
    return (prod + bqkv.float()[:, None, :]).to(y.dtype)


def out_product_reference(o, wout, bout, x):
    return ((x.float() + torch.matmul(o.float(), wout.float())) + bout.float()).to(o.dtype)


def grad_out_product_reference(g, wout):
    return torch.matmul(g.float(), wout.float().T).to(g.dtype)


def weight_grad_product_reference(y, d):
    return torch.matmul(y.float().T, d.float())  # [3, D, Dv]


def input_grad_product_reference(d, wqkv):
    return torch.matmul(d.float(), wqkv.float().transpose(1, 2)).sum(dim=0)


# ---------------------------------------------------------------------------
# The kernels.


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("gemm_sm90")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptrs in (("flyp_gemm_qkv", 4), ("flyp_gemm_out", 5), ("flyp_gemm_grad_out", 3),
                         ("flyp_gemm_weight_grad", 4), ("flyp_gemm_input_grad", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptrs + [i, i, i, p]
        fn.restype = ctypes.c_int
    lib.flyp_gemm_weight_grad_workspace.argtypes = [i, i, i]
    lib.flyp_gemm_weight_grad_workspace.restype = ctypes.c_longlong
    return lib


def _check(name, tensors: dict, shapes: dict):
    """Every operand bf16 (biases fp32), of its shape, on one device."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        want = torch.float32 if key.startswith("b") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, the operands on {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must have shape {shapes[key]}, got {tuple(t.shape)}")


def _dims(name, M, D, Dv):
    """D a multiple of 128, Dv a multiple of 64 up to D and M >= 1, else a
    ValueError naming the dimension."""
    if D % _TILE or D < _TILE:
        raise ValueError(f"{name}: the kernel tiles D in multiples of {_TILE}; got D={D}")
    if Dv % _SHARD_TILE or not _SHARD_TILE <= Dv <= D:
        raise ValueError(f"{name}: the kernel takes whole heads of {_SHARD_TILE} up to D={D}; got Dv={Dv}")
    if M < 1:
        raise ValueError(f"{name}: M={M} rows")


def _route(t) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"the products run on cuda or cpu tensors, got {t.device}")


def _launch(fn_name, counter, ptrs, M, D, Dv, device):
    lib = _lib()
    with torch.cuda.device(device):
        code = getattr(lib, fn_name)(*ptrs, M, D, Dv, torch.cuda.current_stream(device).cuda_stream)
    _kernels.check(lib, code, f"{fn_name} launch")
    counter.launches += 1


def _output(out, shape, dtype, device):
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != shape or out.dtype != dtype or out.device != device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape {shape} on {device}")
    return out


def qkv_product(y, wqkv, bqkv, out=None):
    """G1: ``[3, M, Dv]`` bf16 ``T(y @ wqkv[t] + bqkv[t])``."""
    (M, D), Dv = y.shape, wqkv.shape[-1]
    _dims("G1", M, D, Dv)
    _check("G1", {"y": y, "wqkv": wqkv, "bqkv": bqkv}, {"y": (M, D), "wqkv": (3, D, Dv), "bqkv": (3, Dv)})
    if not _route(y):
        return qkv_product_reference(y, wqkv, bqkv)
    y, wqkv, bqkv = (t.contiguous() for t in (y, wqkv, bqkv))
    out = _output(out, *product_output("G1", M, D, Dv), y.device)
    _launch("flyp_gemm_qkv", qkv_product, [y.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), out.data_ptr()], M, D,
            Dv, y.device)
    return out


def out_product(o, wout, bout, x, out=None):
    """G2: ``[M, D]`` bf16 ``T(x + o @ wout + bout)``."""
    (M, Dv), D = o.shape, wout.shape[-1]
    _dims("G2", M, D, Dv)
    _check("G2", {"o": o, "wout": wout, "bout": bout, "x": x},
           {"o": (M, Dv), "wout": (Dv, D), "bout": (D,), "x": (M, D)})
    if not _route(o):
        return out_product_reference(o, wout, bout, x)
    o, wout, bout, x = (t.contiguous() for t in (o, wout, bout, x))
    out = _output(out, *product_output("G2", M, D, Dv), o.device)
    _launch("flyp_gemm_out", out_product, [o.data_ptr(), wout.data_ptr(), bout.data_ptr(), x.data_ptr(),
                                           out.data_ptr()], M, D, Dv, o.device)
    return out


def grad_out_product(g, wout, out=None):
    """G3: ``[M, Dv]`` bf16 ``T(g @ wout^T)``."""
    (M, D), Dv = g.shape, wout.shape[0]
    _dims("G3", M, D, Dv)
    _check("G3", {"g": g, "wout": wout}, {"g": (M, D), "wout": (Dv, D)})
    if not _route(g):
        return grad_out_product_reference(g, wout)
    g, wout = g.contiguous(), wout.contiguous()
    out = _output(out, *product_output("G3", M, D, Dv), g.device)
    _launch("flyp_gemm_grad_out", grad_out_product, [g.data_ptr(), wout.data_ptr(), out.data_ptr()], M, D, Dv,
            g.device)
    return out


def weight_grad_product(y, d, out=None):
    """G4: fp32 ``[3, D, Dv]`` ``y^T d[t]``."""
    (M, D), Dv = y.shape, d.shape[-1]
    _dims("G4", M, D, Dv)
    _check("G4", {"y": y, "d": d}, {"y": (M, D), "d": (3, M, Dv)})
    if not _route(y):
        return weight_grad_product_reference(y, d)
    y, d = y.contiguous(), d.contiguous()
    out = _output(out, *product_output("G4", M, D, Dv), y.device)
    workspace = torch.empty(_lib().flyp_gemm_weight_grad_workspace(M, D, Dv), dtype=torch.uint8, device=y.device)
    _launch("flyp_gemm_weight_grad", weight_grad_product,
            [y.data_ptr(), d.data_ptr(), workspace.data_ptr(), out.data_ptr()], M, D, Dv, y.device)
    return out


def input_grad_product(d, wqkv, out=None):
    """G5: fp32 ``[M, D]`` ``sum_t d[t] @ wqkv[t]^T``."""
    (_, M, Dv), D = d.shape, wqkv.shape[1]
    _dims("G5", M, D, Dv)
    _check("G5", {"d": d, "wqkv": wqkv}, {"d": (3, M, Dv), "wqkv": (3, D, Dv)})
    if not _route(d):
        return input_grad_product_reference(d, wqkv)
    d, wqkv = d.contiguous(), wqkv.contiguous()
    out = _output(out, *product_output("G5", M, D, Dv), d.device)
    _launch("flyp_gemm_input_grad", input_grad_product, [d.data_ptr(), wqkv.data_ptr(), out.data_ptr()], M, D, Dv,
            d.device)
    return out


# name -> (kernel op, plain version, operand names)
PRODUCTS = {
    "G1": (qkv_product, qkv_product_reference, ("y", "wqkv", "bqkv")),
    "G2": (out_product, out_product_reference, ("o", "wout", "bout", "x")),
    "G3": (grad_out_product, grad_out_product_reference, ("g", "wout")),
    "G4": (weight_grad_product, weight_grad_product_reference, ("y", "d")),
    "G5": (input_grad_product, input_grad_product_reference, ("d", "wqkv")),
}


def product_output(name: str, M: int, D: int, Dv: int = None) -> tuple:
    """(shape, dtype) of product ``name``'s output at ``M`` rows, width ``D``
    and shard width ``Dv`` (default ``D``)."""
    Dv = D if Dv is None else Dv
    return {"G1": ((3, M, Dv), torch.bfloat16), "G2": ((M, D), torch.bfloat16), "G3": ((M, Dv), torch.bfloat16),
            "G4": ((3, D, Dv), torch.float32), "G5": ((M, D), torch.float32)}[name]


def product_operands(name: str, M: int, D: int, device, seed: int = 0, Dv: int = None) -> tuple:
    """Seeded operands of product ``name`` at ``M`` rows, width ``D`` and
    shard width ``Dv`` (default ``D``): unit-normal activations, weights of
    scale ``D**-0.5``, biases of 0.1."""
    Dv = D if Dv is None else Dv
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen)).to(dtype).to(device)

    shapes = {"y": (M, D), "o": (M, Dv), "g": (M, D), "x": (M, D), "d": (3, M, Dv),
              "wqkv": (3, D, Dv), "wout": (Dv, D), "bqkv": (3, Dv), "bout": (D,)}
    out = []
    for key in PRODUCTS[name][2]:
        if key.startswith("b"):
            out.append(r(*shapes[key], scale=0.1, dtype=torch.float32))
        elif key.startswith("w"):
            out.append(r(*shapes[key], scale=D ** -0.5))
        else:
            out.append(r(*shapes[key]))
    return tuple(out)


def product_flops(name: str, M: int, D: int, Dv: int = None) -> int:
    """2 M D Dv a product, three of them in G1, G4 and G5."""
    Dv = D if Dv is None else Dv
    return 2 * M * D * Dv * (1 if name in ("G2", "G3") else 3)


def product_bytes(name: str, M: int, D: int, Dv: int = None) -> int:
    """Each input read once and each output written once."""
    Dv = D if Dv is None else Dv
    el = 2
    md, mv, dv = M * D, M * Dv, D * Dv
    return {
        "G1": (md + 3 * dv) * el + 3 * Dv * 4 + 3 * mv * el,
        "G2": (mv + dv + md) * el + D * 4 + md * el,
        "G3": (md + dv) * el + mv * el,
        "G4": (md + 3 * mv) * el + 3 * dv * 4,
        "G5": (3 * mv + 3 * dv) * el + md * 4,
    }[name]


for _op in (qkv_product, out_product, grad_out_product, weight_grad_product, input_grad_product):
    _op.launches = 0  # kernel launches since the count was last reset (one per call on CUDA)
