"""Classification head: a linear probe over encoder features.

Counterpart of ``flyp_tpu/models/head.py``: optional L2 normalisation of
the input in fp32, then ``W x + b`` accumulated in fp32; logits are fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class ClassificationHead(nn.Module):
    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, normalize: bool = True):
        super().__init__()
        weight = torch.as_tensor(weight)
        if bias is None:
            bias = torch.zeros(weight.shape[0], dtype=weight.dtype, device=weight.device)
        self.weight = nn.Parameter(weight, requires_grad=False)  # [num_classes, embed_dim]
        self.bias = nn.Parameter(torch.as_tensor(bias), requires_grad=False)  # [num_classes]
        self.normalize = normalize

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            x32 = features.float()
            features = (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)).to(features.dtype)
        w = self.weight.to(features.dtype)
        return (torch.matmul(features.float(), w.float().T) + self.bias).float()

    @classmethod
    def zeros(cls, num_classes: int = 1000, embed_dim: int = 512, normalize: bool = True) -> "ClassificationHead":
        """An all-zero head (a placeholder where only the features are read)."""
        return cls(torch.zeros((num_classes, embed_dim), dtype=torch.float32), normalize=normalize)
