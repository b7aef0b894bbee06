"""Shared pieces of the research trainers' parity tests: the port's config
and models from ``tests/test_research_trainers.py``'s, on the CPU."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from flyp_tpu_torch.config import ExperimentConfig
from flyp_tpu_torch.models import CLIPModel, convert
from tests.test_research_trainers import make_cfg
from tests.test_torch_flyp_trainer import port_config


def port_cfg(corpus, tmp_path, **overrides) -> ExperimentConfig:
    """``make_cfg``'s fields (JAX's) as the port's config, on the CPU."""
    fields = dataclasses.asdict(make_cfg(corpus, tmp_path, **overrides))
    fields.pop("device")
    return ExperimentConfig(device="cpu", **fields)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(jmodel, variables) -> CLIPModel:
    """The port's CLIP with JAX's weights (and BatchNorm statistics)."""
    model = CLIPModel(port_config(jmodel.config))
    model.load_state_dict(convert.from_jax_params(host(variables["params"]), host(variables.get("batch_stats", {}))),
                          strict=True)
    return model
