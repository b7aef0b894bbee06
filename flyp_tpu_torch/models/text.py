"""Causal text transformer tower.

Counterpart of ``flyp_tpu/models/text.py``: token embedding, learned
positional embedding, causal transformer, final LN, pooling at the
end-of-text position (the highest token id, so ``argmax`` finds it) and the
text projection.
"""

from __future__ import annotations

import torch
from torch import nn

from flyp_tpu_torch.models.configs import TextConfig
from flyp_tpu_torch.models.layers import LayerNormFp32, Transformer, _normal_


class TextTransformer(nn.Module):
    def __init__(self, config: TextConfig, embed_dim: int, remat: bool = False):
        super().__init__()
        self.config = config
        cfg = config
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads, causal=True, remat=remat)
        self.ln_final = LayerNormFp32(cfg.width)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.token_embedding, 0.02, generator)
        _normal_(self.positional_embedding, 0.01, generator)
        _normal_(self.text_projection, self.config.width ** -0.5, generator)

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """tokens: [B, <= context_length] integer ids -> [B, embed_dim]."""
        x = self.token_embedding[tokens.long()].to(dtype)
        # Contexts shorter than the trained length are exact: positions past
        # a row's EOT cannot reach its pooled feature in a causal tower.
        x = x + self.positional_embedding[: tokens.shape[1]].to(dtype)
        x = self.transformer(x)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return torch.matmul(pooled.float(), self.text_projection.to(dtype).float()).to(dtype)
