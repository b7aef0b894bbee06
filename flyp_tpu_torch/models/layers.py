"""Shared transformer layers with the JAX package's dtype policy.

Counterpart of ``flyp_tpu/models/layers.py``: LayerNorm runs in float32
whatever the activation type (the "fp32 island"), the MLP uses QuickGELU,
and the attention sub-block (LN1 + QKV + attention + out-projection +
residual) is one fused op, the CUDA kernels on the card: the training op
(forward B1, backward B2) in training mode, the inference op (B3) in eval
mode, as the JAX block chooses by its ``train`` argument.  Parameter names and
shapes follow the JAX param tree (``ln_1.scale``, ``attn.qkv_kernel
[3, D, D]``, ``mlp.fc_kernel [D, 4D]``...), so carrying weights across is a
rename.
"""

from __future__ import annotations

import torch
from torch import nn

from flyp_tpu_torch.ops.attention_block import attention_block, attention_block_inference


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


class AttentionParams(nn.Module):
    """The attention sub-block's weights, laid out as the JAX tree holds
    them: q|k|v on the leading axis of ``qkv_kernel`` and head-major output
    features on the last."""

    def __init__(self, width: int):
        super().__init__()
        D = width
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        h = quick_gelu(torch.matmul(x, self.fc_kernel.to(dtype)) + self.fc_bias.to(dtype))
        return torch.matmul(h, self.proj_kernel.to(dtype)) + self.proj_bias.to(dtype)


class ResidualBlock(nn.Module):
    """Pre-LN transformer block: the fused attention sub-block, then
    ``x + MLP(LN2(x))``.  The module's ``training`` flag picks the attention
    op (JAX's ``train`` argument): the training op keeps the forward's
    residuals for the backward; the inference op does not (per-block
    rematerialisation, the JAX ``remat`` option, is not ported yet)."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.ln_1 = LayerNormFp32(width)
        self.attn = AttentionParams(width)
        self.ln_2 = LayerNormFp32(width)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn
        block_fn = attention_block if self.training else attention_block_inference
        x = block_fn(
            x, self.ln_1.scale, self.ln_1.bias, a.qkv_kernel, a.qkv_bias, a.out_kernel, a.out_bias,
            self.heads, self.causal,
        )
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Stack of residual blocks named ``block_{i}`` as in the JAX tree."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", ResidualBlock(width, heads, causal))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return x
