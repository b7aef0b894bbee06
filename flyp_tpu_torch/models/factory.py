"""Model construction from an experiment config.

Counterpart of ``flyp_tpu/models/factory.py``: ``cfg.clip_load`` names a
torch ``.pt``/``.bin`` checkpoint (OpenAI layout, loaded through the
converter) or a checkpoint directory of ``utils/checkpoint.py`` (a trainer
checkpoint or a bare ``save_params`` tree); without one, weights are drawn
from CLIP's init distributions with a ``torch.Generator`` seeded from
``cfg.seed``.  A ModifiedResNet carries its BatchNorm running statistics
as buffers: a fresh one's are zeros and ones, a loaded one's come with the
checkpoint.
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
    remat = getattr(cfg, "remat", False)
    load_path = cfg.clip_load
    if load_path and (load_path.endswith(".pt") or load_path.endswith(".bin")):
        state, config = convert.convert_clip_state_dict(convert.load_torch_checkpoint(load_path), config_override)
        model = CLIPModel(config, compute_dtype, remat=remat)
        model.load_state_dict(state, strict=True)
        return model.to(device).eval().requires_grad_(False)
    if config_override is not None:
        config = config_override
    else:
        key, _source = resolve_model_name(cfg.model)
        config = MODEL_CONFIGS[key]
    model = CLIPModel(config, compute_dtype, remat=remat)
    if load_path:
        if not os.path.isdir(load_path):
            raise FileNotFoundError(
                f"--clip_load path {load_path!r} is neither a torch .pt/.bin file nor a checkpoint directory")
        _load_checkpoint_dir(load_path, cfg.model, model)
    else:
        model.init_parameters(getattr(cfg, "seed", 0))
    return model.to(device).eval().requires_grad_(False)


def _load_checkpoint_dir(load_path: str, model_name: str, model: CLIPModel,
                         batch_stats: Optional[dict] = None) -> None:
    """Load a checkpoint directory's params and running statistics into
    ``model``: a trainer checkpoint (whose moments are never read) or a bare
    ``save_params`` tree.  The saved names and shapes are checked against
    the model first (a ViT-B/32 checkpoint has a B/16 model's names but not
    its shapes), and a model with BatchNorm statistics (``batch_stats``, by
    default its buffers) refuses a checkpoint that carries none.

    Port of ``flyp_tpu/models/factory.py::_load_checkpoint_dir``."""
    from flyp_tpu_torch.utils import checkpoint

    checkpoint.wait_for_saves()  # a just-written checkpoint must be committed first
    checkpoint.read_meta(load_path)
    saved = checkpoint.load_tensors(load_path, mmap=True)  # names and shapes; data read on copy
    want = dict(model.named_parameters())
    if set(saved) != set(want):
        raise ValueError(f"--clip_load checkpoint at {load_path} does not match model {model_name}: "
                         "parameter tree structures differ")
    mismatches = [f"{k}: saved {tuple(saved[k].shape)} vs model {tuple(v.shape)}"
                  for k, v in want.items() if tuple(saved[k].shape) != tuple(v.shape)]
    if mismatches:
        raise ValueError(f"--clip_load checkpoint at {load_path} does not match model {model_name}: "
                         "parameter shapes differ — " + "; ".join(mismatches[:5]))
    stats_path = os.path.join(load_path, checkpoint.STATS_FILE)
    saved_stats = checkpoint.load_tensors(load_path, checkpoint.STATS_FILE, mmap=True) \
        if os.path.isfile(stats_path) else {}
    if batch_stats is None:
        batch_stats = dict(model.named_buffers())
    if batch_stats and not saved_stats:
        raise ValueError(
            f"--clip_load checkpoint at {load_path} carries no batch_stats but model {model_name} has "
            "BatchNorm towers: serving trained conv weights with fresh running statistics would be silently "
            "wrong. Load a trainer checkpoint or a torch .pt (both carry BN stats).")
    checkpoint._check_names(load_path, "running statistics", saved_stats, dict(model.named_buffers()))
    model.load_state_dict({**saved, **saved_stats}, strict=True)
