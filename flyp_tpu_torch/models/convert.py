"""Checkpoint conversion: CLIP state dicts and JAX param trees -> the port.

Counterpart of ``flyp_tpu/models/convert.py``.  The port's ``state_dict``
uses the JAX param tree's names joined by dots (``visual.transformer.
block_0.attn.qkv_kernel``) and its layouts, so:

* :func:`from_jax_params` flattens a JAX Flax param tree (numpy leaves)
  and, for a ModifiedResNet, its ``batch_stats`` tree (the BatchNorm
  buffers ``mean``/``var``);
* :func:`from_jax_train_state` carries a JAX train state (params, optax's
  Adam moments and count, step) onto a port model and its AdamW state;
* :func:`convert_clip_state_dict` reads the OpenAI torch key layout (what
  real OpenAI ``.pt`` files and the JAX package's ``export_clip_state_dict``
  + ``save_torch_checkpoint`` hold): Linear ``[out, in]`` -> ``[in, out]``,
  Conv ``[out, in, kh, kw]`` -> HWIO, ``in_proj_weight [3D, D]`` ->
  ``qkv_kernel [3, D, D]``, LayerNorm and BatchNorm ``weight`` ->
  ``scale``, BatchNorm ``running_mean``/``running_var`` -> the buffers
  ``mean``/``var``;
* :func:`export_clip_state_dict` is the inverse, for
  :func:`save_torch_checkpoint`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig

_META_KEYS = ("input_resolution", "context_length", "vocab_size")
_ATTNPOOL_PROJS = ("q_proj", "k_proj", "v_proj", "c_proj")
# A BatchNorm's torch names and the port's (JAX's ``params`` and ``batch_stats``).
_BN_FIELDS = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy, 0-d kept 0-d


def _as_stored(x) -> torch.Tensor:
    """A host array as a CPU tensor of its own dtype; bfloat16 (numpy's
    ``ml_dtypes`` type, which torch cannot take) through its bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping[str, Any], leaf=_f32) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            out[prefix] = leaf(node)

    walk(tree, "")
    return out


def from_jax_params(params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A JAX CLIP param tree (nested dicts of arrays), and the ``batch_stats``
    tree of a ModifiedResNet, -> the port's state dict."""
    return {**_flatten(params), **_flatten(batch_stats or {})}


def _adam_state(node):
    """The first node of an optax state tree with ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``, inside ``inject_hyperparams`` and a
    chain for the bf16-moment optimizer)."""
    if all(hasattr(node, f) for f in ("mu", "nu", "count")):
        return node
    children = node.values() if isinstance(node, Mapping) else node if isinstance(node, (tuple, list)) else ()
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def from_jax_train_state(params: Mapping[str, Any], opt_state, step, model, batch_stats=None):
    """A JAX ``TrainState``'s parts (host arrays) -> a port ``TrainState``
    over ``model``: the params (and ``batch_stats``) loaded into the model (``from_jax_params``),
    optax's ``mu``/``nu`` trees flattened the same way and laid out in
    ``model.parameters()`` order in their stored dtype, and the update
    count as an int32 scalar, all on the model's device."""
    from flyp_tpu_torch.training.train_state import AdamWState, TrainState

    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments (mu, nu, count)")
    model.load_state_dict(from_jax_params(params, batch_stats), strict=True)
    names = [name for name, _ in model.named_parameters()]
    device = model.logit_scale.device
    moments = []
    for tree in (adam.mu, adam.nu):
        flat = _flatten(tree, leaf=_as_stored)
        if set(flat) != set(names):
            raise ValueError(f"the moments' names differ from the model's: {sorted(set(flat) ^ set(names))[:5]}")
        moments.append([flat[n].to(device) for n in names])
    count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device)
    model.train().requires_grad_(True)
    return TrainState(step=int(np.asarray(step)), model=model, opt_state=AdamWState(count, *moments))


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pt``/``.bin`` checkpoint (TorchScript archive or plain state
    dict, optionally under ``state_dict`` with ``module.`` prefixes)."""
    try:
        state = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state["state_dict"].items()}
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


# Head widths of the ViT image towers the port runs whose heads are not 64
# wide, by tower width (open_clip's ViT-H-14 ``head_width`` 80).  A state
# dict holds no head count, so the width decides it; every other tower's
# heads are 64 wide.
_VISION_HEAD_WIDTHS = {1280: 80}


def vision_heads(width: int) -> int:
    """Heads of a ViT image tower ``width`` wide (its published head width)."""
    return width // _VISION_HEAD_WIDTHS.get(width, 64)


def sniff_config(state: Mapping[str, Any]) -> CLIPConfig:
    """Infer the architecture from OpenAI-layout state-dict shapes; a ViT
    image tower's head count from its published head width
    (:func:`vision_heads`).  Pass a config to
    :func:`convert_clip_state_dict` to override what is inferred."""
    shapes = {k: tuple(np.shape(v)) for k, v in state.items() if k not in _META_KEYS}
    if "visual.proj" in shapes:
        vision_width = shapes["visual.conv1.weight"][0]
        patch = shapes["visual.conv1.weight"][-1]
        grid = round((shapes["visual.positional_embedding"][0] - 1) ** 0.5)
        vision = VisionConfig(
            image_size=patch * grid,
            width=vision_width,
            patch_size=patch,
            layers=len([k for k in shapes if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]),
            heads=vision_heads(vision_width),
        )
    else:
        blocks = tuple(len({k.split(".")[2] for k in shapes if k.startswith(f"visual.layer{b}.")}) for b in (1, 2, 3, 4))
        vision_width = shapes["visual.layer1.0.conv1.weight"][0]
        out_grid = round((shapes["visual.attnpool.positional_embedding"][0] - 1) ** 0.5)
        vision = VisionConfig(
            image_size=out_grid * 32,
            width=vision_width,
            patch_size=None,
            layers=0,
            heads=vision_width * 32 // 64,
            resnet_layers=blocks,
        )
    text_width = shapes["ln_final.weight"][0]
    text = TextConfig(
        context_length=shapes["positional_embedding"][0],
        vocab_size=shapes["token_embedding.weight"][0],
        width=text_width,
        heads=text_width // 64,
        layers=len({k.split(".")[2] for k in shapes if k.startswith("transformer.resblocks")}),
    )
    return CLIPConfig(embed_dim=shapes["text_projection"][1], vision=vision, text=text)


def _convert_block(state, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    w = state[f"{src}.attn.in_proj_weight"]
    D = w.shape[1]
    out[f"{dst}.ln_1.scale"] = state[f"{src}.ln_1.weight"]
    out[f"{dst}.ln_1.bias"] = state[f"{src}.ln_1.bias"]
    out[f"{dst}.ln_2.scale"] = state[f"{src}.ln_2.weight"]
    out[f"{dst}.ln_2.bias"] = state[f"{src}.ln_2.bias"]
    out[f"{dst}.attn.qkv_kernel"] = w.reshape(3, D, D).transpose(1, 2).contiguous()
    out[f"{dst}.attn.qkv_bias"] = state[f"{src}.attn.in_proj_bias"].reshape(3, D)
    out[f"{dst}.attn.out_kernel"] = state[f"{src}.attn.out_proj.weight"].T.contiguous()
    out[f"{dst}.attn.out_bias"] = state[f"{src}.attn.out_proj.bias"]
    out[f"{dst}.mlp.fc_kernel"] = state[f"{src}.mlp.c_fc.weight"].T.contiguous()
    out[f"{dst}.mlp.fc_bias"] = state[f"{src}.mlp.c_fc.bias"]
    out[f"{dst}.mlp.proj_kernel"] = state[f"{src}.mlp.c_proj.weight"].T.contiguous()
    out[f"{dst}.mlp.proj_bias"] = state[f"{src}.mlp.c_proj.bias"]


def _convert_resnet(state, config: VisionConfig, out: Dict[str, torch.Tensor]) -> None:
    """The ModifiedResNet tower: conv weights OIHW -> HWIO ``kernel``, each
    BatchNorm's weight/bias -> ``scale``/``bias`` and its running statistics
    -> the buffers ``mean``/``var``; ``num_batches_tracked`` is dropped."""

    def conv(src, dst):
        out[f"{dst}.kernel"] = state[f"{src}.weight"].permute(2, 3, 1, 0).contiguous()

    def bn(src, dst):
        for a, b in _BN_FIELDS:
            out[f"{dst}.{b}"] = state[f"{src}.{a}"]

    for i in (1, 2, 3):
        conv(f"visual.conv{i}", f"visual.conv{i}")
        bn(f"visual.bn{i}", f"visual.bn{i}")
    for stage, blocks in enumerate(config.resnet_layers):
        for b in range(blocks):
            src, dst = f"visual.layer{stage + 1}.{b}", f"visual.layer{stage + 1}_{b}"
            for i in (1, 2, 3):
                conv(f"{src}.conv{i}", f"{dst}.conv{i}")
                bn(f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample.0.weight" in state:
                conv(f"{src}.downsample.0", f"{dst}.downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    out["visual.attnpool.positional_embedding"] = state["visual.attnpool.positional_embedding"]
    for proj in _ATTNPOOL_PROJS:
        out[f"visual.attnpool.{proj}.kernel"] = state[f"visual.attnpool.{proj}.weight"].T.contiguous()
        out[f"visual.attnpool.{proj}.bias"] = state[f"visual.attnpool.{proj}.bias"]


def convert_clip_state_dict(
    state: Mapping[str, Any], config: Optional[CLIPConfig] = None
) -> Tuple[Dict[str, torch.Tensor], CLIPConfig]:
    """OpenAI-layout CLIP state dict -> ``(port state dict, config)``; a
    ModifiedResNet's state dict carries its BatchNorm running statistics."""
    state = {k: _f32(v) for k, v in state.items() if k not in _META_KEYS}
    config = config or sniff_config(state)
    out: Dict[str, torch.Tensor] = {
        "text.token_embedding": state["token_embedding.weight"],
        "text.positional_embedding": state["positional_embedding"],
        "text.ln_final.scale": state["ln_final.weight"],
        "text.ln_final.bias": state["ln_final.bias"],
        "text.text_projection": state["text_projection"],
        "logit_scale": state["logit_scale"].reshape(()),
    }
    if config.vision.is_vit:
        out.update({
            "visual.patch_kernel": state["visual.conv1.weight"].permute(2, 3, 1, 0).contiguous(),
            "visual.class_embedding": state["visual.class_embedding"],
            "visual.positional_embedding": state["visual.positional_embedding"],
            "visual.ln_pre.scale": state["visual.ln_pre.weight"],
            "visual.ln_pre.bias": state["visual.ln_pre.bias"],
            "visual.ln_post.scale": state["visual.ln_post.weight"],
            "visual.ln_post.bias": state["visual.ln_post.bias"],
            "visual.proj": state["visual.proj"],
        })
        for i in range(config.vision.layers):
            _convert_block(state, f"visual.transformer.resblocks.{i}", f"visual.transformer.block_{i}", out)
    else:
        _convert_resnet(state, config.vision, out)
    for i in range(config.text.layers):
        _convert_block(state, f"transformer.resblocks.{i}", f"text.transformer.block_{i}", out)
    return out, config


def _export_block(sd, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    w = sd[f"{src}.attn.qkv_kernel"]
    D = w.shape[1]
    out[f"{dst}.ln_1.weight"] = sd[f"{src}.ln_1.scale"]
    out[f"{dst}.ln_1.bias"] = sd[f"{src}.ln_1.bias"]
    out[f"{dst}.ln_2.weight"] = sd[f"{src}.ln_2.scale"]
    out[f"{dst}.ln_2.bias"] = sd[f"{src}.ln_2.bias"]
    out[f"{dst}.attn.in_proj_weight"] = w.transpose(1, 2).reshape(3 * D, D)
    out[f"{dst}.attn.in_proj_bias"] = sd[f"{src}.attn.qkv_bias"].reshape(3 * D)
    out[f"{dst}.attn.out_proj.weight"] = sd[f"{src}.attn.out_kernel"].T
    out[f"{dst}.attn.out_proj.bias"] = sd[f"{src}.attn.out_bias"]
    out[f"{dst}.mlp.c_fc.weight"] = sd[f"{src}.mlp.fc_kernel"].T
    out[f"{dst}.mlp.c_fc.bias"] = sd[f"{src}.mlp.fc_bias"]
    out[f"{dst}.mlp.c_proj.weight"] = sd[f"{src}.mlp.proj_kernel"].T
    out[f"{dst}.mlp.c_proj.bias"] = sd[f"{src}.mlp.proj_bias"]


def _export_resnet(sd, config: VisionConfig, out: Dict[str, torch.Tensor]) -> None:
    """The inverse of :func:`_convert_resnet`; every BatchNorm also gets the
    ``num_batches_tracked`` counter (0, int64) that torch's strict load needs."""

    def conv(src, dst):
        out[f"{dst}.weight"] = sd[f"{src}.kernel"].permute(3, 2, 0, 1)

    def bn(src, dst):
        for a, b in _BN_FIELDS:
            out[f"{dst}.{a}"] = sd[f"{src}.{b}"]
        out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    for i in (1, 2, 3):
        conv(f"visual.conv{i}", f"visual.conv{i}")
        bn(f"visual.bn{i}", f"visual.bn{i}")
    for stage, blocks in enumerate(config.resnet_layers):
        for b in range(blocks):
            src, dst = f"visual.layer{stage + 1}_{b}", f"visual.layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                conv(f"{src}.conv{i}", f"{dst}.conv{i}")
                bn(f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample_conv.kernel" in sd:
                conv(f"{src}.downsample_conv", f"{dst}.downsample.0")
                bn(f"{src}.downsample_bn", f"{dst}.downsample.1")
    out["visual.attnpool.positional_embedding"] = sd["visual.attnpool.positional_embedding"]
    for proj in _ATTNPOOL_PROJS:
        out[f"visual.attnpool.{proj}.weight"] = sd[f"visual.attnpool.{proj}.kernel"].T
        out[f"visual.attnpool.{proj}.bias"] = sd[f"visual.attnpool.{proj}.bias"]


def export_clip_state_dict(state_dict: Mapping[str, torch.Tensor], config: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the OpenAI torch key layout (float32, CPU),
    the inverse of :func:`convert_clip_state_dict`."""
    sd = {k: _f32(v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    if config.vision.is_vit:
        out.update({
            "visual.conv1.weight": sd["visual.patch_kernel"].permute(3, 2, 0, 1),
            "visual.class_embedding": sd["visual.class_embedding"],
            "visual.positional_embedding": sd["visual.positional_embedding"],
            "visual.ln_pre.weight": sd["visual.ln_pre.scale"],
            "visual.ln_pre.bias": sd["visual.ln_pre.bias"],
            "visual.ln_post.weight": sd["visual.ln_post.scale"],
            "visual.ln_post.bias": sd["visual.ln_post.bias"],
            "visual.proj": sd["visual.proj"],
        })
        for i in range(config.vision.layers):
            _export_block(sd, f"visual.transformer.block_{i}", f"visual.transformer.resblocks.{i}", out)
    else:
        _export_resnet(sd, config.vision, out)
    out.update({
        "token_embedding.weight": sd["text.token_embedding"],
        "positional_embedding": sd["text.positional_embedding"],
        "ln_final.weight": sd["text.ln_final.scale"],
        "ln_final.bias": sd["text.ln_final.bias"],
        "text_projection": sd["text.text_projection"],
        "logit_scale": sd["logit_scale"].reshape(()),
    })
    for i in range(config.text.layers):
        _export_block(sd, f"text.transformer.block_{i}", f"transformer.resblocks.{i}", out)
    return {k: v.contiguous() for k, v in out.items()}


def save_torch_checkpoint(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """Write a state dict as a plain ``.pt`` file (contiguous CPU tensors,
    float32 but for integer counters such as ``num_batches_tracked``)."""
    def stored(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu() if not v.is_floating_point() else _f32(v)
        return torch.from_numpy(np.array(v)) if np.issubdtype(np.asarray(v).dtype, np.integer) else _f32(v)

    torch.save({k: stored(v).contiguous() for k, v in state.items()}, path)
