"""WiSE-FT weight-space ensembling.

Counterpart of ``flyp_tpu/training/wise.py``: interpolate a zero-shot and a
fine-tuned model's parameters, uniformly or Fisher-weighted (Wortsman et
al., 2022).  Both take flat state dicts with the port's parameter names
(``model.state_dict()``, or a JAX tree through
``models/convert.py::from_jax_params``, which also flattens a Fisher pickle
of either package), and return a new dict; nothing is updated in place.
"""

from __future__ import annotations

from typing import Mapping

import torch


def interpolate(zeroshot: Mapping[str, torch.Tensor], finetuned: Mapping[str, torch.Tensor],
                alpha: float) -> dict:
    """theta = (1 - alpha) * zeroshot + alpha * finetuned."""
    return {k: (1.0 - alpha) * z + alpha * finetuned[k] for k, z in zeroshot.items()}


def fisher_interpolate(
    zeroshot: Mapping[str, torch.Tensor],
    finetuned: Mapping[str, torch.Tensor],
    fisher_zeroshot: Mapping[str, torch.Tensor],
    fisher_finetuned: Mapping[str, torch.Tensor],
    alpha: float = 0.5,
    fisher_floor: float = 1e-8,
) -> dict:
    """Fisher-weighted merge: a per-parameter convex combination with
    weights proportional to the (floored) Fisher information."""
    out = {}
    for k, z in zeroshot.items():
        wz = (1.0 - alpha) * torch.clamp_min(fisher_zeroshot[k], fisher_floor)
        wf = alpha * torch.clamp_min(fisher_finetuned[k], fisher_floor)
        out[k] = (wz * z + wf * finetuned[k]) / (wz + wf)
    return out
