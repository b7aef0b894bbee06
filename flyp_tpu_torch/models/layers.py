"""Shared transformer layers with the JAX package's dtype policy.

Counterpart of ``flyp_tpu/models/layers.py``: LayerNorm runs in float32
whatever the activation type (the "fp32 island"), the MLP uses QuickGELU,
and ``FLYP_ATTENTION_IMPL`` (``ops/attention.py``) picks each block's route
as the JAX block does:

* ``pallas_block`` (the default) and ``pallas_block_mlp``: the attention
  sub-block (LN1 + QKV + attention + out-projection + residual) is one fused
  op, the CUDA kernels on the card: the training op (forward B1, backward
  B2) in training mode, the inference op (B3) in eval mode;
  ``pallas_block_mlp`` also runs the MLP sub-block as the fused MLP op (B4);
* ``pallas_qkv``: ``x + MHA(LN1(x))`` with attention straight from the
  fused projection (B5);
* ``pallas``: the same with attention over split heads by B6;
* ``xla`` (and any other value): the same with plain attention.

Outside the fused ops the projections are plain matmuls in the activation
type, as the JAX package leaves them to XLA.  Parameter names and shapes
follow the JAX param tree under every impl (``ln_1.scale``,
``attn.qkv_kernel [3, D, D]``, ``mlp.fc_kernel [D, 4D]``...), so carrying
weights across is a rename and a checkpoint loads under any impl.

Head-group tensor parallelism (``parallel/tp.py::shard_params``) gives a
block a model-axis process group (``ResidualBlock.tp_group``) and replaces
its ``attn`` and ``mlp`` weights by this rank's shard, as the JAX package's
``_spec_for`` shards them: ``qkv_kernel [3, D, Dv]``, ``qkv_bias [3, Dv]``
and ``out_kernel [Dv, D]`` hold ``Dv / 64`` whole heads; ``fc`` is column
parallel, ``proj`` row parallel.  The residual stream stays whole on every
rank.  On ``pallas_block`` the attention sub-block runs the per-shard
kernels through ``ops/attention_block.py::tp_attention_block``; on ``xla``
the plain attention runs over the local heads; either way the
out-projection's partial sum is all-reduced over the model axis before
``+ out_bias``.  The MLP is Megatron's: the identity forward with an
all-reduce backward at its entry, one all-reduce after ``proj``, then
``+ proj_bias``.  ``pallas_qkv`` and ``pallas`` run their kernels (B5, B6)
on the local heads (attention is independent per head, so the numbers are
those of the JAX package, whose partitioning gathers the heads first).
``pallas_block_mlp`` runs the attention sub-block as ``pallas_block`` does
and the MLP sub-block as the whole fused MLP op (B4) on the weights
gathered over the model axis (``parallel/comm.py::gather_shards``), as
GSPMD runs the JAX kernel, which has no partitioning rule: every model
rank computes the same whole sub-block, and keeps its own slice of the
weight gradients.

``remat`` (``--remat``) recomputes activations in the backward
(``torch.utils.checkpoint``) as the JAX ``remat`` policy does: under the
fused routes only the MLP sub-block is recomputed (JAX saves the fused
attention block's residuals by name), under the others the whole block (no
names to save, so JAX's policy becomes full per-block remat).  The values,
and so the gradients, are those of the run without it.
"""

from __future__ import annotations

import os

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from flyp_tpu_torch.ops.attention import _default_impl, multi_head_attention
from flyp_tpu_torch.ops.attention_block import attention_block, attention_block_inference, tp_attention_block
from flyp_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
from flyp_tpu_torch.ops.mlp_block import mlp_block

# Matmul output policy (JAX's ``FLYP_MATMUL_OUT``): "native" multiplies in
# the activation type; "fp32" multiplies the same operands with fp32 outputs
# and casts the result to the activation type.
_MATMUL_OUT = os.environ.get("FLYP_MATMUL_OUT", "native")


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``x``'s type: JAX's ``_einsum``."""
    w = w.to(x.dtype)
    if _MATMUL_OUT == "fp32":
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


class LayerNormFp32(nn.Module):
    """LayerNorm computed in float32, the result cast back to the input type."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused QKV projection, laid out as the JAX tree
    holds it: q|k|v on the leading axis of ``qkv_kernel [3, D, D]`` and
    head-major output features on the last.  Its forward is the unfused
    route (``pallas_qkv``, ``pallas``, ``xla``); the fused sub-block op reads
    the same parameters."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        D = width
        self.heads = heads
        self.causal = causal
        self.qkv_kernel = nn.Parameter(torch.empty(3, D, D))
        self.qkv_bias = nn.Parameter(torch.zeros(3, D))
        self.out_kernel = nn.Parameter(torch.empty(D, D))
        self.out_bias = nn.Parameter(torch.zeros(D))

    def reset_parameters(self, generator: torch.Generator) -> None:
        D = self.out_kernel.shape[0]
        _normal_(self.qkv_kernel, D ** -0.5, generator)
        _normal_(self.out_kernel, D ** -0.5, generator)
        with torch.no_grad():
            self.qkv_bias.zero_()
            self.out_bias.zero_()

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """With ``tp_group`` the weights are a head shard (``Dv < D``
        columns of each tower): the plain attention over the local heads,
        and the out-projection's partial products summed over the group."""
        B, L, D = x.shape
        Dv = self.qkv_kernel.shape[-1]
        hd = D // self.heads
        dtype = x.dtype
        # One [B*L, D] @ [D, 3Dv] product: JAX's [B, L, 3, Dv] held as [B, L, 3Dv].
        w = self.qkv_kernel.permute(1, 0, 2).reshape(D, 3 * Dv)
        qkv = _matmul(x, w) + self.qkv_bias.reshape(3 * Dv).to(dtype)
        if _default_impl() == "pallas_qkv":
            o = fused_qkv_attention(qkv, Dv // hd, self.causal)
        else:
            q, k, v = (qkv[..., t * Dv:(t + 1) * Dv].reshape(B, L, Dv // hd, hd) for t in range(3))
            o = multi_head_attention(q, k, v, self.causal).reshape(B, L, Dv)
        proj = _matmul(o, self.out_kernel)
        if tp_group is not None:
            from flyp_tpu_torch.parallel.comm import reduce_from_group

            proj = reduce_from_group(proj, tp_group)
        return proj + self.out_bias.to(dtype)


class MLP(nn.Module):
    """c_fc -> QuickGELU -> c_proj (4x expansion).  Plain matmuls in the
    activation type, as the JAX package leaves the MLP outside any kernel."""

    def __init__(self, width: int):
        super().__init__()
        hidden = 4 * width
        self.fc_kernel = nn.Parameter(torch.empty(width, hidden))
        self.fc_bias = nn.Parameter(torch.zeros(hidden))
        self.proj_kernel = nn.Parameter(torch.empty(hidden, width))
        self.proj_bias = nn.Parameter(torch.zeros(width))

    def reset_parameters(self, generator: torch.Generator) -> None:
        width = self.fc_kernel.shape[0]
        _normal_(self.fc_kernel, (2 * width) ** -0.5, generator)
        _normal_(self.proj_kernel, width ** -0.5, generator)
        with torch.no_grad():
            self.fc_bias.zero_()
            self.proj_bias.zero_()

    def forward(self, x: torch.Tensor, tp_group=None) -> torch.Tensor:
        """With ``tp_group`` ``fc`` holds a column shard and ``proj`` the
        matching row shard: the partial products are summed over the group
        before ``+ proj_bias``."""
        dtype = x.dtype
        h = quick_gelu(_matmul(x, self.fc_kernel) + self.fc_bias.to(dtype))
        proj = _matmul(h, self.proj_kernel)
        if tp_group is not None:
            from flyp_tpu_torch.parallel.comm import reduce_from_group

            proj = reduce_from_group(proj, tp_group)
        return proj + self.proj_bias.to(dtype)


class ResidualBlock(nn.Module):
    """Pre-LN transformer block: the attention sub-block, then the MLP
    sub-block, each on the route ``FLYP_ATTENTION_IMPL`` picks (module
    docstring).  Under the fused routes the module's ``training`` flag picks
    the attention op (JAX's ``train`` argument): the training op keeps the
    forward's residuals for the backward; the inference op does not.  With
    ``remat`` a forward that records gradients recomputes the MLP sub-block
    (fused routes) or the whole block (other routes) in the backward.
    ``tp_group`` (set by ``parallel/tp.py``) makes it a tensor-parallel
    block over that model-axis group (module docstring)."""

    tp_group = None

    def __init__(self, width: int, heads: int, causal: bool = False, remat: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.remat = remat
        self.ln_1 = LayerNormFp32(width)
        self.attn = MultiHeadAttention(width, heads, causal)
        self.ln_2 = LayerNormFp32(width)
        self.mlp = MLP(width)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` plus the attention sub-block."""
        group = self.tp_group
        if group is not None:
            from flyp_tpu_torch.parallel.comm import copy_to_group, group_size

            a = self.attn
            if _default_impl() in ("pallas_block", "pallas_block_mlp"):
                heads = self.heads // group_size(group)
                return tp_attention_block(
                    x, self.ln_1.scale, self.ln_1.bias, a.qkv_kernel, a.qkv_bias, a.out_kernel, a.out_bias,
                    heads, self.causal, group=group, train=self.training,
                )
            return x + a(copy_to_group(self.ln_1(x), group), tp_group=group)
        if _default_impl() in ("pallas_block", "pallas_block_mlp"):
            a = self.attn
            block_fn = attention_block if self.training else attention_block_inference
            return block_fn(
                x, self.ln_1.scale, self.ln_1.bias, a.qkv_kernel, a.qkv_bias, a.out_kernel, a.out_bias,
                self.heads, self.causal,
            )
        return x + self.attn(self.ln_1(x))

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` plus the MLP sub-block."""
        group = self.tp_group
        m = self.mlp
        if _default_impl() == "pallas_block_mlp":
            fc_kernel, fc_bias, proj_kernel = m.fc_kernel, m.fc_bias, m.proj_kernel
            if group is not None:
                from flyp_tpu_torch.parallel.comm import gather_shards

                fc_kernel, fc_bias = gather_shards(fc_kernel, group, 1), gather_shards(fc_bias, group, 0)
                proj_kernel = gather_shards(proj_kernel, group, 0)
            return mlp_block(x, self.ln_2.scale, self.ln_2.bias, fc_kernel, fc_bias, proj_kernel, m.proj_bias)
        if group is not None:
            from flyp_tpu_torch.parallel.comm import copy_to_group

            return x + m(copy_to_group(self.ln_2(x), group), tp_group=group)
        return x + m(self.ln_2(x))

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        return self.feed_forward(self.attention(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x)
        if _default_impl() in ("pallas_block", "pallas_block_mlp"):
            return checkpoint(self.feed_forward, self.attention(x), use_reentrant=False)
        return checkpoint(self._block, x, use_reentrant=False)


class Transformer(nn.Module):
    """Stack of residual blocks named ``block_{i}`` as in the JAX tree."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False, remat: bool = False):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", ResidualBlock(width, heads, causal, remat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return x
