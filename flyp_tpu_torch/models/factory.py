"""Model construction from an experiment config.

Counterpart of ``flyp_tpu/models/factory.py``: ``cfg.clip_load`` names a
torch ``.pt``/``.bin`` checkpoint (OpenAI layout, loaded through the
converter); without one, weights are drawn from CLIP's init distributions
with a ``torch.Generator`` seeded from ``cfg.seed``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from flyp_tpu_torch.models import convert
from flyp_tpu_torch.models.clip import CLIPModel
from flyp_tpu_torch.models.configs import MODEL_CONFIGS, CLIPConfig, resolve_model_name

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    runs on the CPU only when asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def build_clip_model(cfg, config_override: Optional[CLIPConfig] = None, device="cuda") -> CLIPModel:
    """The model ``cfg`` names (``model``, ``clip_load``, ``compute_dtype``,
    ``seed``), on ``device``, in eval mode and forward-only
    (``training/train_state.py::create_train_state`` makes it trainable)."""
    device = resolve_device(device)
    compute_dtype = _DTYPES[cfg.compute_dtype]
    load_path = cfg.clip_load
    if load_path and (load_path.endswith(".pt") or load_path.endswith(".bin")):
        state, config = convert.convert_clip_state_dict(convert.load_torch_checkpoint(load_path), config_override)
        model = CLIPModel(config, compute_dtype)
        model.load_state_dict(state, strict=True)
    elif load_path:
        if os.path.isdir(load_path):
            raise NotImplementedError(
                f"{load_path!r} is a checkpoint directory; the torch-native checkpoint format is not "
                "ported yet (ROADMAP.md, item A7: checkpoint/resume).  Export it to a .pt with "
                "flyp_tpu.models.convert.export_clip_state_dict + save_torch_checkpoint."
            )
        raise FileNotFoundError(f"checkpoint path {load_path!r} is not a torch .pt/.bin file")
    else:
        if config_override is not None:
            config = config_override
        else:
            key, _source = resolve_model_name(cfg.model)
            config = MODEL_CONFIGS[key]
        model = CLIPModel(config, compute_dtype).init_parameters(getattr(cfg, "seed", 0))
    return model.to(device).eval().requires_grad_(False)
