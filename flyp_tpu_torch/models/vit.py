"""Vision Transformer image tower.

Counterpart of ``flyp_tpu/models/vit.py``: patchify, class token, learned
positional embedding, pre-LN, transformer, post-LN on the class token and a
linear projection.  Images are NHWC at the public API, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from flyp_tpu_torch.models.configs import VisionConfig
from flyp_tpu_torch.models.layers import LayerNormFp32, Transformer, _normal_


class VisionTransformer(nn.Module):
    def __init__(self, config: VisionConfig, embed_dim: int, remat: bool = False):
        super().__init__()
        self.config = config
        cfg = config
        p, W = cfg.patch_size, cfg.width
        self.patch_kernel = nn.Parameter(torch.empty(p, p, 3, W))  # HWIO, as the JAX conv kernel
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, W))
        self.ln_pre = LayerNormFp32(W)
        self.transformer = Transformer(W, cfg.layers, cfg.heads, causal=False, remat=remat)
        self.ln_post = LayerNormFp32(W)
        self.proj = nn.Parameter(torch.empty(W, embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: lecun-normal patch kernel (truncated at 2 sigma),
        ``normal(width**-0.5)`` embeddings and projection."""
        scale = self.config.width ** -0.5
        fan_in = self.patch_kernel.shape[0] * self.patch_kernel.shape[1] * 3
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.patch_kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
        for t in (self.class_embedding, self.positional_embedding, self.proj):
            _normal_(t, scale, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] (NHWC) in the compute type -> [B, embed_dim]."""
        cfg = self.config
        dtype = images.dtype
        B, Hh, Ww, C = images.shape
        p = cfg.patch_size
        gh, gw = Hh // p, Ww // p
        # Patchify as a reshape plus one matmul with the [p*p*3, W] kernel
        # (exact, where a cuDNN conv would run TF32 on the card).
        patches = images[:, : gh * p, : gw * p].reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(B, gh * gw, p * p * C)
        x = torch.matmul(patches, self.patch_kernel.to(dtype).reshape(p * p * C, cfg.width))
        cls = self.class_embedding.to(dtype).expand(B, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0, :])
        return torch.matmul(x.float(), self.proj.to(dtype).float()).to(dtype)
