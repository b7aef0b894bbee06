"""Tolerances that hold the attention kernels (B5, B6) to their plain
versions, the bf16 probe GEMM (T1) and the fp32 products of the attention
block's GEMM (G4, G5) to the exact product, its bf16 products (G1-G3) to
their plain versions' rounding, and the MLP block's hidden activations
(B4's ``h``) to the GELU of its own ``h_pre`` (:func:`check_mlp_hidden`).

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use :func:`check_attention`
on the forward's ``o`` and on each of ``dq``, ``dk``, ``dv``.  Kernel and
plain version round at the same points, so they differ only where an fp32
sum in another order flips a rounding: rarely, and by an ulp of the value.
Three bounds, each of which a wrong kernel breaks:

- relative norm ``||got - ref|| / ||ref||``: 1e-5 in fp32, 1e-2 in bf16;
- elementwise ``|got - ref| <= atol + ulp |ref|``: fp32 1e-5 (no relative
  term); bf16 1.5e-2 (about twice the worst error seen on the card,
  0.0078) plus one bf16 ulp of the value (2^-7), so a flip in a grad of
  magnitude 2-4 still passes;
- mean absolute error: 1e-6 in fp32, 2e-3 in bf16;
- bf16 only: the share of elements whose bits differ from the plain
  version's, at most 1%.  A flipped rounding is rare (a summation order
  that differs flips about 0.01-0.02% of the outputs), while a rounding
  point moved flips a quarter to a half of them, though by an ulp only,
  which the three bounds above let pass.

Typical outputs at CLIP's shapes are 0.05-0.12 (grads) and ~0.1 (``o``).
The planted faults the tests hold the bounds against:
:func:`backward_without_delta` (``delta = rowsum(p dp)`` dropped from
``ds``: ``dq`` and ``dk`` move by about a tenth of their size; the first
three bounds catch it), :func:`forward_cast_before_normalising` (``p`` cast
to bf16 before it is normalised) and :func:`backward_delta_from_o`
(``delta = rowsum(do T(o))``); the last two move a quarter to a half of
the bf16 outputs by an ulp, and only the fourth bound catches them.  At
long rows, :func:`forward_without_last_tile` (each row's sum without its
last 64-key tile) on :func:`edge_key_qkv`'s inputs, whose last key carries
most of each row's weight, moves ``o`` far past every bound.

:func:`reference_stand_in` is the source of a stand-in for the upstream
``clip/model.py`` that ``tools/validate_checkpoint.py::activation_crosscheck``
loads, for the tests and for ``chip_smoke.py``, where no upstream checkout
is at hand.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flyp_tpu_torch.ops.attention_block import _NEG
from flyp_tpu_torch.ops.flash_attention import _probs

# dtype -> (relative norm, elementwise absolute, elementwise relative, mean
# absolute, share of elements unequal to the plain version's, or None).
ATTENTION_TOL = {
    torch.float32: (1e-5, 1e-5, 0.0, 1e-6, None),
    torch.bfloat16: (1e-2, 1.5e-2, 2.0 ** -7, 2e-3, 0.01),
}


def attention_errors(got, ref) -> dict:
    """Max abs, relative-norm and mean abs error of ``got`` against ``ref``,
    and the share of its elements that differ from ``ref``'s."""
    got, ref = got.detach(), ref.detach()
    err = (got.float() - ref.float()).abs()
    return {"max_abs": float(err.max()), "rel_norm": float(err.norm() / ref.float().norm()),
            "mean_abs": float(err.mean()), "unequal_share": float((got != ref).float().mean())}


def check_attention(name: str, got, ref, where=None) -> dict:
    """Raise ``AssertionError`` unless ``got`` is finite and within
    :data:`ATTENTION_TOL` of ``ref`` for its type; return its errors."""
    rel, atol, ulp, mean, unequal = ATTENTION_TOL[ref.dtype]
    errs = attention_errors(got, ref)
    over = int(((got.float() - ref.float()).abs() > atol + ulp * ref.float().abs()).sum())
    if (not bool(torch.isfinite(got).all()) or over or errs["rel_norm"] > rel or errs["mean_abs"] > mean
            or (unequal is not None and errs["unequal_share"] > unequal)):
        raise AssertionError(f"{name} disagrees with its plain version at {where}: {errs}, {over} elements past "
                             f"{atol} + {ulp}|ref| (bounds: relative norm {rel}, mean abs {mean}, unequal share "
                             f"{unequal})")
    return errs


def check_gemm(name: str, got, a, b, where=None) -> dict:
    """Hold ``got``, a bf16 ``a [M, K] @ b [K, N]`` summed in fp32 on the
    tensor cores, to the exact product (float64: the bf16 products are
    exact, and so is their sum to far below the bound).  Each
    ``mma.sync`` step adds 16 exact products into the fp32 accumulator,
    rounding (on the tensor cores, truncating) at most about twice an ulp
    of what it holds, so the block-FMA bound is, elementwise,
    ``|got - a b| <= (K / 16 + 1) 2^-23 (|a| @ |b|)``.  A wrong fragment,
    tile or k-step, or an element left unwritten (non-finite), breaks it.
    Returns the max abs error and the largest share of the bound used."""
    K = a.shape[-1]
    exact = torch.matmul(a.double(), b.double())
    bound = (K / 16 + 1) * 2.0 ** -23 * torch.matmul(a.float().abs(), b.float().abs()).double()
    err = (got.double() - exact).abs()
    errs = {"max_abs": float(err.max()), "bound_share": float((err / bound.clamp_min(1e-30)).max())}
    if not bool(torch.isfinite(got).all()) or errs["bound_share"] > 1.0:
        raise AssertionError(f"{name} is not the product of its operands at {where}: {errs}")
    return errs


def check_rounded_product(name: str, got, ref, pairs, where=None) -> dict:
    """Hold ``got``, a bf16 product ``T(epilogue(a @ b))`` (G1-G3 of
    ``ops/gemm_sm90.py``), to ``ref``, the plain version's rounding of the
    same epilogue over an fp32 product.  Both fp32 sums are within the
    block-FMA bound ``e = (K / 16 + 1) 2^-23 (|a| @ |b|)`` of the exact
    product (:func:`check_gemm`), so the two roundings differ by at most a
    bf16 ulp of the value (``2^-7 |ref|``) plus ``2 e``: elementwise
    ``|got - ref| <= 2^-7 |ref| + 2 e``.  ``pairs`` are the ``(a, b)`` whose
    products make ``got``'s leading slices (one for ``[M, N]``, three for
    G1's ``[3, M, N]``).  A wrong fragment, tile or epilogue step, or an
    element left unwritten (non-finite), breaks it.  Returns the max abs
    error, the largest share of the bound used and the share of elements
    unequal to ``ref``."""
    got3, ref3 = (t.reshape(len(pairs), *t.shape[-2:]).float() for t in (got, ref))
    used, max_abs = 0.0, 0.0
    for i, (a, b) in enumerate(pairs):
        e = (a.shape[-1] / 16 + 1) * 2.0 ** -23 * torch.matmul(a.float().abs(), b.float().abs())
        err = (got3[i] - ref3[i]).abs()
        used = max(used, float((err / (2.0 ** -7 * ref3[i].abs() + 2 * e).clamp_min(1e-30)).max()))
        max_abs = max(max_abs, float(err.max()))
    errs = {"max_abs": max_abs, "bound_share": used, "unequal_share": float((got != ref).float().mean())}
    if not bool(torch.isfinite(got).all()) or used > 1.0:
        raise AssertionError(f"{name} is not its plain version's rounding at {where}: {errs}")
    return errs


def check_gemm_product(name: str, got, ops, where=None) -> dict:
    """Hold ``got``, product ``name`` (G1-G5 of ``ops/gemm_sm90.py``) of the
    operands ``ops``: G1-G3 (bf16 out) to the plain version's rounding
    (:func:`check_rounded_product`), G4 and G5 (fp32 out) to the exact
    product (:func:`check_gemm`: G4 per tower over the rows, G5 over its
    three terms' contraction at once).  Returns the errors, with the max abs
    error against the plain version."""
    from flyp_tpu_torch.ops import gemm_sm90

    ref = gemm_sm90.PRODUCTS[name][1](*ops)
    if name == "G4":
        y, d = ops
        errs = [check_gemm(f"{name}[{t}]", got[t], y.t(), d[t], where) for t in range(3)]
        out = {"max_abs": max(e["max_abs"] for e in errs), "bound_share": max(e["bound_share"] for e in errs)}
    elif name == "G5":
        d, w = ops
        out = check_gemm(name, got, d.permute(1, 0, 2).reshape(d.shape[1], -1),
                         w.transpose(1, 2).reshape(-1, w.shape[1]), where)
    else:
        a, w = ops[0], ops[1]
        pairs = [(a, w[t]) for t in range(3)] if name == "G1" else [(a, w if name == "G2" else w.t())]
        out = check_rounded_product(name, got, ref, pairs, where)
    out["max_abs_vs_plain"] = float((got.float() - ref.float()).abs().max())
    return out


def backward_without_delta(q, k, v, do, causal: bool = False):
    """A planted fault: ``flash_attention_backward_reference`` with ``delta``
    dropped from ``ds`` (``ds = T(p dp scale)``), to show the bounds catch it."""
    dtype = q.dtype
    p = _probs(q, k, causal)
    do32 = do.to(dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do32).to(dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = (p * dp * q.shape[-1] ** -0.5).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dtype)
    return dq, dk, dv


def forward_cast_before_normalising(q, k, v, causal: bool = False):
    """A planted fault: ``flash_attention_reference`` with the unnormalised
    ``e = exp(s - m)`` cast and ``o`` divided by ``l`` afterwards
    (``o = T((T(e) v) / l)``, the training forward's rounding), where the
    op normalises ``p`` in fp32 before its cast."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        L = q.shape[1]
        s = torch.where(torch.ones(L, L, dtype=torch.bool, device=q.device).tril(), s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True).permute(0, 2, 1, 3)  # [B, L, H, 1]
    return (torch.einsum("bhqk,bkhd->bqhd", e.to(q.dtype).float(), v.float()) / l).to(q.dtype)


def backward_delta_from_o(q, k, v, do, causal: bool = False):
    """A planted fault: ``flash_attention_backward_reference`` with ``delta =
    rowsum(do T(o))`` (the rounded forward output) in place of
    ``rowsum(p dp)``."""
    dtype = q.dtype
    p = _probs(q, k, causal)
    do32 = do.to(dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), v.float()).to(dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do32).to(dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    delta = (do32 * o).sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # [B, H, L, 1]
    ds = ((p * (dp - delta)) * q.shape[-1] ** -0.5).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dtype)
    return dq, dk, dv


def forward_without_last_tile(q, k, v, causal: bool = False):
    """A planted fault: ``flash_attention_reference`` with each row's sum
    ``l`` taken without the keys of the last 64-key tile (keys ``64
    floor((L - 1) / 64)`` on; all keys at ``L <= 64``), while ``p = exp(s -
    m) / l`` still covers every key: what a streamed softmax that drops its
    last tile from the sum computes."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    L = q.shape[1]
    if causal:
        s = torch.where(torch.ones(L, L, dtype=torch.bool, device=q.device).tril(), s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    last = (L - 1) // 64 * 64
    l = e[..., :last].sum(dim=-1, keepdim=True) if last else e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", (e / l).to(q.dtype).float(), v.float()).to(q.dtype)


# The last key's score in the edge-key inputs, and its value: every row that
# sees it gives it ~0.97-0.99 of its weight at L <= 1024.
EDGE_SCORE, EDGE_VALUE = 10.0, 3.0


def edge_key_qkv(B: int, L: int, H: int, seed: int):
    """numpy float32 q, k, v ``[B, L, H, 64]`` and a cotangent in which the
    last key carries most of each row's weight: q = 1 + 0.1 N(0, 1), k =
    0.1 N(0, 1) but 1.25 on key ``L - 1`` (a score of ~10 against the
    others' ~0.1 at scale 1/8), v = N(0, 1) but 3 on key ``L - 1``.  At L =
    257, 321 or 577 that key sits alone in its 64-key tile; a kernel that
    drops it or masks it wrongly moves ``o`` by ~3, where random inputs
    would move it by ~0.4% (inside the bf16 bounds)."""
    rng = np.random.default_rng(seed)
    shape = (B, L, H, 64)
    q = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    k = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    k[:, L - 1] = EDGE_SCORE / 8.0
    v = rng.standard_normal(shape).astype(np.float32)
    v[:, L - 1] = EDGE_VALUE
    return q, k, v, rng.standard_normal(shape).astype(np.float32)


def edge_key_block_inputs(B: int, L: int, D: int, seed: int, head_dim: int = 64):
    """numpy float32 inputs of the attention block ``(x, ln_scale, ln_bias,
    qkv_kernel, qkv_bias, out_kernel, out_bias)`` and a cotangent in which,
    in every head, the last row's key carries most of each row's weight:
    row ``L - 1`` of x is a balanced +-1 pattern s (so LN(x) keeps it), LN
    is the identity, q = bq = 1, and every column of k is ``c (y . s) / D``
    with ``c = 10 / sqrt(head_dim)``: c on row ``L - 1`` (a score of ~10
    after the ``head_dim ** -0.5`` scale; c = 1.25 at 64), ``c N(0, 1/D)``
    on the others."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, L, D)).astype(f32)
    sign = np.repeat(np.array([1.0, -1.0], dtype=f32), D // 2)
    x[:, L - 1] = rng.permutation(sign)
    wqkv = np.zeros((3, D, D), dtype=f32)
    wqkv[1] = np.repeat(x[0, L - 1][:, None] * (EDGE_SCORE / math.sqrt(head_dim)) / D, D, axis=1)
    wqkv[2] = rng.standard_normal((D, D)) * D ** -0.5
    bqkv = np.zeros((3, D), dtype=f32)
    bqkv[0] = 1.0
    bqkv[2] = 0.1 * rng.standard_normal(D)
    return ((x, np.ones(D, f32), np.zeros(D, f32), wqkv, bqkv, (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
             (0.1 * rng.standard_normal(D)).astype(f32)), rng.standard_normal((B, L, D)).astype(f32))


def check_mlp_hidden(h, h_pre, where=None) -> dict:
    """Hold ``h``, the hidden activations the bf16 B4 kernel keeps in device
    memory for its second product, to ``T(quick_gelu(fp32(h_pre)))``
    computed from the kernel's own ``h_pre``: equal in at least 99.9% of elements (an fp32 GELU whose last
    bit differs from PyTorch's may flip a rounding, rarely), and within one
    ulp of the type everywhere.  A GELU taken of the fp32 sum before it is
    rounded to ``h_pre`` (:func:`mlp_hidden_from_unrounded`) moves a large
    share of the elements by an ulp and fails the first bound; a wrong
    element, or one left unwritten (non-finite), fails the second.  Returns
    the share of elements unequal and the largest error in ulps."""
    from flyp_tpu_torch.ops.mlp_block import mlp_hidden

    ref = mlp_hidden(h_pre).float()
    got = h.float()
    mag = torch.maximum(got.abs(), ref.abs())
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.full_like(mag, torch.finfo(h.dtype).eps), exp - 1)  # of |v| = m 2^exp, m in [0.5, 1)
    errs = {"unequal_share": float((got != ref).float().mean()),
            "max_ulps": float(((got - ref).abs() / ulp).max()) if got.numel() else 0.0}
    if not bool(torch.isfinite(got).all()) or errs["unequal_share"] > 1e-3 or errs["max_ulps"] > 1.0:
        raise AssertionError(f"B4's h is not the GELU of its own h_pre at {where}: {errs}")
    return errs


def mlp_hidden_from_unrounded(x, ln_scale, ln_bias, fc_kernel, fc_bias):
    """A planted fault: B4's ``h = T(quick_gelu(y W1 + b1))`` taken of the
    fp32 sum, where the op (and the TPU kernel) rounds it to ``h_pre``
    first."""
    from flyp_tpu_torch.ops.attention_block import _layer_norm
    from flyp_tpu_torch.ops.mlp_block import _quick_gelu32

    dtype = x.dtype
    _, _, y32 = _layer_norm(x.float(), ln_scale, ln_bias)
    hpre32 = torch.matmul(y32.to(dtype).float(), fc_kernel.to(dtype).float()) + fc_bias.float()
    return _quick_gelu32(hpre32).to(dtype)


_STAND_IN = '''"""Stands in for the upstream clip/model.py: the port's own model on the
CPU, its residual blocks wrapped to run [L, B, D] as the upstream blocks
do.  FEATURES keeps the features it returned."""
import torch

from flyp_tpu_torch.models import CLIPModel, convert

PERTURB = None  # or (tower, block) whose first weight is moved
FEATURES = []


class _LND(torch.nn.Module):
    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x.transpose(0, 1).contiguous()).transpose(0, 1)


class _Stack(torch.nn.Module):
    def __init__(self, transformer):
        super().__init__()
        self.resblocks = torch.nn.ModuleList(_LND(getattr(transformer, f"block_{i}"))
                                             for i in range(transformer.layers))

    def forward(self, x):
        x = x.transpose(0, 1)
        for blk in self.resblocks:
            x = blk(x)
        return x.transpose(0, 1).contiguous()


class _Ref(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        model.visual.transformer = _Stack(model.visual.transformer)
        model.text.transformer = _Stack(model.text.transformer)
        self.model, self.visual, self.transformer = model, model.visual, model.text.transformer

    def encode_image(self, x):
        FEATURES.append(self.model.encode_image(x.permute(0, 2, 3, 1).contiguous()).numpy())
        return torch.from_numpy(FEATURES[-1])

    def encode_text(self, tokens):
        FEATURES.append(self.model.encode_text(tokens.to(torch.int32)).numpy())
        return torch.from_numpy(FEATURES[-1])


def build_model(state_dict):
    port_state, config = convert.convert_clip_state_dict(state_dict)
    model = CLIPModel(config)
    model.load_state_dict(port_state, strict=True)
    if PERTURB is not None:
        tower, i = PERTURB
        with torch.no_grad():
            next(getattr(getattr(model, tower).transformer, f"block_{i}").parameters()).add_(0.05)
    return _Ref(model)
'''


def reference_stand_in(perturb=None) -> str:
    """The stand-in reference's source (module docstring): ``perturb``
    ``(tower, block)`` moves that block's first weight by 0.05, so a
    crosscheck must report that block first."""
    return _STAND_IN.replace("PERTURB = None", f"PERTURB = {perturb!r}", 1)
