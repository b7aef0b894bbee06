"""Model configurations for the CLIP family.

Shape parameters mirror the published OpenAI/open_clip checkpoints the
reference loads (`clip/model.py:405-443` sniffs these from
state dicts; here they are explicit configs).  The reference's model-name
convention is preserved: a slash name ("ViT-B/16") selects OpenAI weights, a
dash name ("ViT-B-16") selects open_clip LAION weights
(`src/models/modeling.py:10-23`) — both map to the same
architecture config here, the spelling only routes checkpoint conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    width: int = 768
    # ViT when `patch_size` is set; ModifiedResNet when `resnet_layers` is set.
    patch_size: Optional[int] = 16
    layers: int = 12
    heads: int = 12
    resnet_layers: Optional[Tuple[int, int, int, int]] = None
    # ModifiedResNet stem execution layout — NOT an architecture change.
    # "reference": the literal 3-conv stem (`clip/model.py:99-110`);
    # "s2d": the numerically-identical space-to-depth fold (models/resnet.py)
    # that feeds the 128-lane MXU dense operands.  Params/checkpoints are
    # identical either way.
    stem_impl: str = "reference"

    @property
    def is_vit(self) -> bool:
        return self.resnet_layers is None

    @property
    def seq_len(self) -> int:
        assert self.is_vit
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    # log(1/0.07), the CLIP-pretraining init (`clip/model.py:299`).
    logit_scale_init: float = 2.6592600369589688


def _vit(embed_dim, image_size, patch, width, layers, heads, text_width, text_heads, text_layers):
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(image_size=image_size, width=width, patch_size=patch, layers=layers, heads=heads),
        text=TextConfig(width=text_width, heads=text_heads, layers=text_layers),
    )


def _resnet(embed_dim, image_size, width, blocks, text_width, text_heads, text_layers):
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(
            image_size=image_size,
            width=width,
            patch_size=None,
            layers=0,
            heads=width * 32 // 64,
            resnet_layers=blocks,
        ),
        text=TextConfig(width=text_width, heads=text_heads, layers=text_layers),
    )


MODEL_CONFIGS = {
    "ViT-B/32": _vit(512, 224, 32, 768, 12, 12, 512, 8, 12),
    "ViT-B/16": _vit(512, 224, 16, 768, 12, 12, 512, 8, 12),
    "ViT-L/14": _vit(768, 224, 14, 1024, 24, 16, 768, 12, 12),
    "ViT-L/14@336px": _vit(768, 336, 14, 1024, 24, 16, 768, 12, 12),
    # open_clip's ViT-H-14-quickgelu (model_configs/ViT-H-14-quickgelu.json):
    # the image tower's head_width is 80, 16 heads of 1280; DFN5B's weights.
    "ViT-H/14": _vit(1024, 224, 14, 1280, 32, 16, 1024, 16, 24),
    "RN50": _resnet(1024, 224, 64, (3, 4, 6, 3), 512, 8, 12),
    "RN101": _resnet(512, 224, 64, (3, 4, 23, 3), 512, 8, 12),
    "RN50x4": _resnet(640, 288, 80, (4, 6, 10, 6), 640, 10, 12),
    "RN50x16": _resnet(768, 384, 96, (6, 8, 18, 8), 768, 12, 12),
    "RN50x64": _resnet(1024, 448, 128, (3, 15, 36, 10), 1024, 16, 12),
}


def resolve_model_name(name: str) -> tuple[str, str]:
    """Map a CLI model name to (config key, weight source).

    Dash-spelled ViT names ("ViT-B-16", "ViT-L-14") select open_clip
    LAION-400M weights; "ViT-H-14-quickgelu" selects Apple's DFN5B weights
    (Data Filtering Networks, arXiv:2309.17425) for open_clip's QuickGELU
    ViT-H/14; everything else selects OpenAI weights, matching the
    reference's spelling convention.
    """
    if name in ("ViT-B-16", "ViT-L-14", "ViT-B-32"):
        return name.replace("ViT-B-", "ViT-B/").replace("ViT-L-", "ViT-L/"), "openclip_laion400m"
    if name == "ViT-H-14-quickgelu":
        return "ViT-H/14", "dfn5b"
    if name in MODEL_CONFIGS:
        return name, "openai"
    raise ValueError(f"Unknown model {name!r}; known: {sorted(MODEL_CONFIGS)} and dash-spelled open_clip variants")
