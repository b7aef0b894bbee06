"""bf16-compute training drift against fp32, on the card.

Counterpart of ``tools/bf16_drift.py``.  The reference trains in mixed
fp16/fp32; the port trains with bf16 compute and fp32 master weights.  This
tool runs the same synthetic FLYP trajectory twice (the same init, data,
schedule and optimizer; only ``compute_dtype`` differs) and reports:

* the loss curves at every ``every``-th step,
* the largest and the final absolute loss divergence,
* image->text retrieval accuracy (the zero-shot head's analogue on the
  learned association task) for both legs.

Both legs run the plain route (``FLYP_ATTENTION_IMPL=xla``, set here for
the run and restored after it), as the JAX tool runs both on ``xla``, so
the measured delta is the compute type alone; the kernels' agreement with
the plain route is ``chip_smoke.py``'s and ``convergence_check``'s to show.

The model is the JAX tool's tiny CLIP (64-px images, 16-px patches, both
towers 256 wide, 4 layers, 4 heads; 32-token context, 4,096 ids), from seed
0 or from a given state dict.  ``--device cpu`` runs the same on the CPU.

Usage: python -m flyp_tpu_torch.tools.bf16_drift [steps] [batch] [pool] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from flyp_tpu_torch.models import MODEL_CONFIGS, build_clip_model
from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.models.modes import pinned_mode
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
from flyp_tpu_torch.utils.profiling import plain_route


def tool_config():
    """The JAX tools' tiny CLIP: ViT-B/16's config cut to 256-wide, 4-layer
    towers on 64-px images and a 32-token, 4,096-id text context."""
    cfg = MODEL_CONFIGS["ViT-B/16"]
    return dataclasses.replace(
        cfg,
        embed_dim=64,
        vision=dataclasses.replace(cfg.vision, image_size=64, patch_size=16, width=256, layers=4, heads=4),
        text=dataclasses.replace(cfg.text, context_length=32, vocab_size=4096, width=256, heads=4, layers=4),
    )


def build(compute_dtype: str, steps: int, batch: int, device="cuda", state_dict=None):
    """(model, state, step_fn): the tiny CLIP from seed 0 (params fp32 in
    both legs) or ``state_dict``, AdamW on ``warmup_cosine_lr(3e-4, 10,
    steps)`` with weight decay 0.1."""
    cfg = SimpleNamespace(model="ViT-B/16", clip_load=None, compute_dtype=compute_dtype, seed=0)
    model = build_clip_model(cfg, config_override=tool_config(), device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    optimizer = make_optimizer(warmup_cosine_lr(3e-4, 10, steps), weight_decay=0.1)
    state = create_train_state(model, optimizer)
    return model, state, make_train_step(model, optimizer)


def data(n: int, device="cuda"):
    """``n`` images and captions, drawn as the JAX tools draw them: each
    image pairs with a distinct caption, learnable to ~0 loss."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((n, 64, 64, 3)).astype(np.float32)
    tokens = np.zeros((n, 32), dtype=np.int32)
    tokens[:, 0] = 1
    tokens[:, 1:6] = rng.integers(2, 4000, (n, 5))
    tokens[:, 6] = 4095
    return torch.from_numpy(images).to(device), torch.from_numpy(tokens).to(device)


def retrieval_acc(model, images, tokens) -> float:
    """Image->text top-1 on the learned association (the zero-shot head's
    analogue: each image against the caption bank), in eval mode."""
    with torch.no_grad(), pinned_mode(model, train=False):
        img_f, txt_f, _ = model(images, tokens)
    logits = img_f.float() @ txt_f.float().T
    return float((logits.argmax(dim=1).cpu() == torch.arange(logits.shape[0])).float().mean())


def run_leg(dtype_name: str, steps: int, batch: int, pool: int, every: int = 10, device="cuda", state_dict=None):
    """``pool`` > batch: each step trains on a fresh sample of a fixed
    ``pool``-pair corpus (the same sequence in both legs), so the loss
    stays in the learning regime; ``pool == batch`` is the pure convergence
    task.  Returns ({step: loss}, retrieval accuracy)."""
    model, state, step_fn = build(dtype_name, steps, batch, device, state_dict)
    images, tokens = data(pool, device)
    order_rng = np.random.default_rng(42)  # the same batch sequence in both legs
    curve = {}
    t0 = time.perf_counter()
    for i in range(steps):
        if pool > batch:
            idx = torch.from_numpy(order_rng.choice(pool, size=batch, replace=False)).to(images.device)
            bi, bt = images[idx], tokens[idx]
        else:
            bi, bt = images, tokens
        state, metrics = step_fn(state, bi, bt)
        if i % every == 0 or i == steps - 1:
            curve[i] = float(metrics["loss"])
            print(f"  [{dtype_name}] step {i}: loss {curve[i]:.5f}", flush=True)
    acc = retrieval_acc(model, images[:batch], tokens[:batch])
    print(f"  [{dtype_name}] retrieval acc {acc:.4f}, {time.perf_counter() - t0:.1f}s", flush=True)
    return curve, acc


def main(steps: int = 300, batch: int = 64, pool: int = 64, device="cuda", state_dict=None) -> dict:
    device = resolve_device(device)
    print(f"device={device} steps={steps} batch={batch} pool={pool}", flush=True)
    with plain_route():
        curve32, acc32 = run_leg("float32", steps, batch, pool, device=device, state_dict=state_dict)
        curve16, acc16 = run_leg("bfloat16", steps, batch, pool, device=device, state_dict=state_dict)

    diffs = {i: abs(curve16[i] - curve32[i]) for i in curve32}
    max_step = max(diffs, key=diffs.get)
    result = {
        "metric": f"bf16-vs-fp32 training drift ({steps}-step synthetic FLYP, pool {pool})",
        "final_loss_fp32": round(curve32[steps - 1], 5),
        "final_loss_bf16": round(curve16[steps - 1], 5),
        "final_abs_divergence": round(diffs[steps - 1], 5),
        "max_abs_divergence": round(diffs[max_step], 5),
        "max_divergence_step": max_step,
        "retrieval_acc_fp32": acc32,
        "retrieval_acc_bf16": acc16,
        "acc_delta": round(acc16 - acc32, 4),
    }
    print(json.dumps(result))
    return result


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", nargs="*", type=int, metavar="[steps] [batch] [pool]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return main(*args.sizes[:3], device=args.device)


if __name__ == "__main__":
    cli()
