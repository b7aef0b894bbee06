"""The port's entry points (``flyp_tpu_torch/entry.py``) against
``__graft_entry__.py``, on the CPU.

``entry(device="cpu")`` at the tiny config gives JAX's loss from the same
weights; ``dryrun_multichip(4, device="cpu")`` passes its eight checks on 4
``gloo`` ranks (spawned once); both entry points ask for the GPU unless
told otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from flyp_tpu.models import CLIPModel as JaxCLIPModel
from flyp_tpu.models import init_clip_params
from flyp_tpu.ops import clip_loss as jax_clip_loss
from flyp_tpu_torch import entry as port_entry
from flyp_tpu_torch.models import convert
from flyp_tpu_torch.models.configs import MODEL_CONFIGS
from flyp_tpu_torch.ops import attention_block as ab
from tests.test_torch_serving import port_config

torch.set_num_threads(1)


@pytest.mark.parametrize("real_text", [False, True])
def test_tiny_config_is_jax_tiny_config(real_text):
    assert dataclasses.asdict(port_entry._tiny_config(real_text)) == dataclasses.asdict(graft._tiny_config(real_text))


def test_entry_matches_jax_loss(monkeypatch):
    """The flagship's forward and mean contrastive loss, in eval mode, at the
    tiny config (the entry reads ``MODEL_CONFIGS["ViT-B/16"]``): JAX's loss
    from the same weights on the same batch, within 1e-4."""
    jcfg = graft._tiny_config(real_text=True)
    monkeypatch.setitem(MODEL_CONFIGS, "ViT-B/16", port_config(jcfg))
    fn, (model, images, tokens) = port_entry.entry(device="cpu")
    assert images.shape == (port_entry.ENTRY_BATCH, 64, 64, 3) and images.dtype == torch.float32
    assert tokens.shape == (port_entry.ENTRY_BATCH, 77) and tokens.dtype == torch.int32
    jmodel = JaxCLIPModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_clip_params(jmodel, 0))
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    model.train()  # the entry pins eval mode whatever the caller left
    launches = ab.attention_block_inference.launches
    ours = float(fn(model, images, tokens))
    img_f, txt_f, scale = jmodel.apply({"params": params}, jnp.asarray(images.numpy()), jnp.asarray(tokens.numpy()))
    ref = float(jnp.mean(jax_clip_loss(img_f, txt_f, scale)))
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-4 * max(1.0, abs(ref)), (ours, ref)
    assert all(m.training for m in model.modules())
    assert ab.attention_block_inference.launches == launches  # CPU tensors take the plain version


def test_dryrun_multichip_passes_its_checks():
    out = port_entry.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"model": 2, "data": 2} and out["backend"] == "gloo" and not out["shared_card"]
    assert out["head"] == [2, 64]
    losses = ("loss", "resumed_loss", "fsdp_loss", "replica_loss", "pallas_block_loss", "grad_cache_loss")
    assert all(np.isfinite(out[k]) for k in losses), out
    for k in ("pallas_block_loss", "grad_cache_loss"):  # JAX's 1e-3 bounds
        assert abs(out[k] - out["loss"]) < 1e-3, out
    # step 7's gradients (B2's, on the card) against step 1's: the global norm
    assert np.isfinite(out["grad_norm"]) and out["grad_norm"] > 0
    assert abs(out["pallas_block_grad_norm"] - out["grad_norm"]) <= 1e-3 * out["grad_norm"], out
    assert set(out["seconds"]) == {"tp_dp_step", "head", "eval", "checkpoint", "fsdp", "replica", "pallas_block",
                                   "grad_cache"}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun_multichip(2)
