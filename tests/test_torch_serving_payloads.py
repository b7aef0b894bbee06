"""``ClipServer.from_checkpoint`` and ``cli/serve.py`` on the port's own
training artifacts: a trainer epoch checkpoint, a step checkpoint and bare
``save_params`` trees, each served bit-equal to a server built from the same
weights in memory (``tests/test_serving.py::
test_from_checkpoint_serves_trainer_payloads`` on the port).

The tiny ModifiedResNet carries running statistics, moved off their init
by one train step, so a loader that dropped them would serve other
numbers.  Port only, fp32 on the CPU.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flyp_tpu_torch.cli import serve as port_cli
from flyp_tpu_torch.entry import _tiny_config
from flyp_tpu_torch.models import build_clip_model
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.tokenizer import tokenize
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
from flyp_tpu_torch.utils.checkpoint import StepCursor, save_checkpoint, save_params
from tests.test_torch_concurrency import _rn_config

torch.set_num_threads(1)


def _images(n, px, seed=9):
    return np.random.default_rng(seed).standard_normal((n, px, px, 3)).astype(np.float32)


def _trained(name, config):
    """A random-init model after one train step, and its training state."""
    model = build_clip_model(SimpleNamespace(model=name, clip_load=None, compute_dtype="float32", seed=0),
                             config_override=config, device="cpu")
    opt = make_optimizer(warmup_cosine_lr(1e-3, 1, 10), weight_decay=0.1)
    state = create_train_state(model, opt)
    px = config.vision.image_size
    tokens = torch.from_numpy(tokenize(["a photo of a cat", "a dog", "a bird", "a fish"]))
    state, _ = make_train_step(model, opt)(state, torch.from_numpy(_images(4, px, seed=1)), tokens)
    return model.eval().requires_grad_(False), state


def _serve(path, name, config, **kw):
    return ClipServer.from_checkpoint(path, model=name, compute_dtype="float32", config_override=config,
                                      device="cpu", image_buckets=(4,), **kw)


def _cli_features(path, name, config, img_dir, out):
    assert port_cli.main(["--checkpoint", path, "--model", name, "--images", str(img_dir), "--features", str(out),
                          "--image-buckets", "4", "--compute-dtype", "float32", "--device", "cpu"],
                         config_override=config) == 0
    with np.load(out) as z:
        return z["features"]


def test_from_checkpoint_serves_trainer_payloads(tmp_path):
    from PIL import Image

    from flyp_tpu_torch.data.transforms import eval_transform

    cfg = _rn_config()
    model, state = _trained("RN50", cfg)
    assert any(not torch.equal(b, torch.zeros_like(b)) for n, b in model.named_buffers() if n.endswith(".mean"))
    p_epoch = save_checkpoint(str(tmp_path / "checkpoint_0"), state)
    p_step = save_checkpoint(str(tmp_path / "checkpoint_0_step_2"), state, mid=StepCursor())
    p_module = save_params(str(tmp_path / "bare_module"), model)  # parameters and running statistics
    p_bare = save_params(str(tmp_path / "bare"), dict(model.named_parameters()))  # parameters alone

    imgs = _images(3, cfg.vision.image_size)
    want = ClipServer(model, image_buckets=(4,)).encode_images(imgs)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 44, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
    tf = eval_transform(cfg.vision.image_size)
    decoded = np.stack([tf(Image.open(img_dir / f"{i}.png")) for i in range(3)])
    want_cli = ClipServer(model, image_buckets=(4,)).encode_images(decoded)
    for path in (p_epoch, p_step, p_module):
        srv = _serve(path, "RN50", cfg)
        for k, v in model.state_dict().items():  # running statistics included
            assert torch.equal(srv.model.state_dict()[k], v), (path, k)
        np.testing.assert_array_equal(srv.encode_images(imgs), want)
        np.testing.assert_array_equal(_cli_features(path, "RN50", cfg, img_dir, tmp_path / "f.npz"), want_cli)

    # A bare parameter tree has no running statistics: serving a BatchNorm
    # model from it would pair trained weights with fresh statistics.
    with pytest.raises(ValueError, match="batch_stats"):
        _serve(p_bare, "RN50", cfg)
    with pytest.raises(FileNotFoundError):
        _serve(str(tmp_path / "nope"), "RN50", cfg)

    # The classnames shortcut builds the zero-shot head in the same call.
    srv = _serve(p_step, "RN50", cfg, classnames=["cat", "dog"])
    assert srv.classify(imgs).shape == (3, 2)


def test_from_checkpoint_serves_bare_vit_params(tmp_path):
    """A ViT has no running statistics: its bare parameter tree serves."""
    cfg = _tiny_config(real_text=True)
    model, _ = _trained("ViT-B/16", cfg)
    path = save_params(str(tmp_path / "bare"), dict(model.named_parameters()))
    imgs = _images(3, cfg.vision.image_size)
    np.testing.assert_array_equal(_serve(path, "ViT-B/16", cfg).encode_images(imgs),
                                  ClipServer(model, image_buckets=(4,)).encode_images(imgs))
    assert dataclasses.asdict(_serve(path, "ViT-B/16", cfg).model.config) == dataclasses.asdict(cfg)
