from . import convert
from .clip import CLIPModel, l2_normalize
from .configs import MODEL_CONFIGS, CLIPConfig, TextConfig, VisionConfig, resolve_model_name
from .factory import build_clip_model
from .head import ClassificationHead
from .modes import pinned_mode

__all__ = [
    "CLIPConfig",
    "TextConfig",
    "VisionConfig",
    "MODEL_CONFIGS",
    "resolve_model_name",
    "CLIPModel",
    "l2_normalize",
    "ClassificationHead",
    "build_clip_model",
    "convert",
    "pinned_mode",
]
