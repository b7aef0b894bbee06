"""Two-tower CLIP model.

Counterpart of ``flyp_tpu/models/clip.py``: both towers embed into a shared
space, features are L2-normalised in fp32, and the learned ``logit_scale``
is returned exponentiated.  Single-tower calls return unnormalised features.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from flyp_tpu_torch.models.configs import CLIPConfig
from flyp_tpu_torch.models.resnet import ModifiedResNet
from flyp_tpu_torch.models.text import TextTransformer
from flyp_tpu_torch.models.vit import VisionTransformer


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Norm in float32 for stability with bf16 features."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True) + eps)
    return (x32 / norm).to(x.dtype)


class CLIPModel(nn.Module):
    """Parameters are float32 (the JAX tree's storage type); matrices are
    cast to ``compute_dtype`` where they are used.  The image tower is a ViT,
    or a ModifiedResNet when ``config.vision.resnet_layers`` is set; the
    latter's BatchNorm running statistics are the model's buffers.
    ``remat`` recomputes activations of the transformer blocks in the
    backward (``models/layers.py``), as the JAX package's ``remat`` does."""

    def __init__(self, config: CLIPConfig, compute_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.remat = remat
        if config.vision.is_vit:
            self.visual = VisionTransformer(config.vision, config.embed_dim, remat=remat)
        else:
            self.visual = ModifiedResNet(config.vision, config.embed_dim)
        self.text = TextTransformer(config.text, config.embed_dim, remat=remat)
        self.logit_scale = nn.Parameter(torch.tensor(config.logit_scale_init, dtype=torch.float32))

    def init_parameters(self, seed: int = 0) -> "CLIPModel":
        """CLIP's init distributions (those of the JAX package) drawn from a
        ``torch.Generator`` seeded with ``seed``, in a fixed module order."""
        generator = torch.Generator(device="cpu").manual_seed(int(seed))
        if any(p.device.type != "cpu" for p in self.parameters()):
            raise ValueError("init_parameters draws on the CPU; initialise before moving the model")
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.logit_scale.fill_(self.config.logit_scale_init)
        return self

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, images: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        feats = self.visual(images.to(self.compute_dtype))
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        feats = self.text(tokens, self.compute_dtype)
        return l2_normalize(feats) if normalize else feats

    def forward(self, images: Optional[torch.Tensor], tokens: Optional[torch.Tensor]):
        """Dual-tower forward: L2-normalised features and exp(logit_scale).
        With one input None, the other tower's unnormalised features."""
        if images is None:
            return self.encode_text(tokens)
        if tokens is None:
            return self.encode_image(images)
        image_features = self.encode_image(images, normalize=True)
        text_features = self.encode_text(tokens, normalize=True)
        return image_features, text_features, torch.exp(self.logit_scale)
