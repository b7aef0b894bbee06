"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor ``flyp_tpu``, so on the machine with the card it
runs without the repo's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from flyp_tpu_torch.models import MODEL_CONFIGS, convert
from flyp_tpu_torch.ops import attention_block as tab
from flyp_tpu_torch.serving import ClipServer

pytestmark = pytest.mark.cuda

CLASSNAMES = ["cat", "dog", "school bus"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.standard_normal((B, L, D)).astype(f32),
        (1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
        (rng.standard_normal((3, D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal((3, D))).astype(f32),
        (rng.standard_normal((D, D)) * D ** -0.5).astype(f32),
        (0.1 * rng.standard_normal(D)).astype(f32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 197, 768, 12, False), (4, 77, 512, 8, True), (3, 13, 128, 2, True)])
def test_kernel_matches_plain_on_card(card, shape, dtype):
    """fp32 (TF32 off) at 1e-4: only the fp32 summation order differs.
    bf16 at 2e-2 absolute + relative: the kernel rounds where the plain
    version rounds, and another summation order may flip one bf16
    rounding inside q/k/v, p or o (a few ulps of the O(1) outputs)."""
    B, L, D, H, causal = shape
    dt = getattr(torch, dtype)
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(B, L, D, seed=L))
    x = x.to(dt)
    before = tab.attention_block_inference.launches
    with torch.inference_mode():
        out = tab.attention_block_inference(x, *params, H, causal)
        torch.cuda.synchronize()
        ref = tab.attention_block_inference_reference(x, *params, H, causal)
    assert tab.attention_block_inference.launches == before + 1
    assert out.dtype == dt and out.shape == x.shape
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_refuses_what_it_does_not_take(card):
    x, *params = (torch.from_numpy(a).to(card) for a in _inputs(2, 9, 128, seed=0))
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tab.attention_block_inference(x.half(), *params, 2, False)
        with pytest.raises(ValueError, match="head_dim 64"):
            tab.attention_block_inference(x, *params, 4, False)
        with pytest.raises(ValueError, match="is on cpu"):
            tab.attention_block_inference(x, params[0].cpu(), *params[1:], 2, False)


def test_tiny_server_on_card_matches_cpu(card, tmp_path):
    """One tiny CLIP served on the card (kernel) and on the CPU (plain
    version), fp32: logits at 1e-3 (O(10) logits after exp(logit_scale);
    fp32 sums in another order over 2 layers), and the kernel launched
    once per block per chunk."""
    base = MODEL_CONFIGS["ViT-B/16"]
    tiny = dataclasses.replace(
        base, embed_dim=64,
        vision=dataclasses.replace(base.vision, image_size=32, width=128, layers=2, heads=2),
        text=dataclasses.replace(base.text, width=128, heads=2, layers=2),
    )
    cpu = ClipServer.from_checkpoint(None, classnames=CLASSNAMES, compute_dtype="float32", config_override=tiny,
                                     device="cpu", image_buckets=(4, 8), seed=1)
    path = str(tmp_path / "tiny.pt")
    convert.save_torch_checkpoint(path, convert.export_clip_state_dict(cpu.model.state_dict(), tiny))
    before = tab.attention_block_inference.launches
    gpu = ClipServer.from_checkpoint(path, classnames=CLASSNAMES, compute_dtype="float32", config_override=tiny,
                                     device=card, image_buckets=(4, 8))
    images = np.random.default_rng(0).standard_normal((11, 32, 32, 3)).astype(np.float32)
    logits = gpu.classify(images)  # chunks of 8 and a 4-bucket tail
    assert tab.attention_block_inference.launches == before + 2 + 2 * 2
    np.testing.assert_allclose(logits, cpu.classify(images), atol=1e-3, rtol=1e-3)
    caps = ["a photo of a cat.", "a dog", "the school bus"]
    np.testing.assert_allclose(gpu.encode_texts(caps), cpu.encode_texts(caps), atol=1e-4, rtol=1e-4)
