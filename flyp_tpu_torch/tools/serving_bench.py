"""Serving throughput and latency on one card.

Counterpart of ``tools/serving_bench.py``.  The training path has its own
tools; this measures the product's other hot loop, the serving forward
(``serving/engine.py::ClipServer``: the image tower in eval mode, every
block on the inference kernel B3, then the zero-shot head's logits), which
the trainer also runs over its evaluation suites every epoch.

Per batch size: images/s, forward-only MFU (the products of one forward,
``utils/profiling.py::clip_flops``, over the card's bf16 peak) and ms a
batch, over ``iters`` forwards of one device-resident batch after one
warm-up, timed with CUDA events (``tools/_timing.py``).  One JSON line at
the end, with the JAX tool's keys.  ``--device cpu`` runs the plain
versions at one batch of at most 8 for 2 iterations, as the JAX tool
shrinks off the TPU: a functional check, its MFU null (no peak is claimed
for a CPU).

Usage: python -m flyp_tpu_torch.tools.serving_bench [model] [batch,batch,...] [--device cuda|cpu]
Default: ViT-B/16 at 8, 256, 1024.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from flyp_tpu_torch.models import build_clip_model
from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.ops.attention import _default_impl
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.tools._bench import compute_dtype, random_head
from flyp_tpu_torch.tools._timing import time_call
from flyp_tpu_torch.utils.profiling import clip_flops, mfu


def main(model_name="ViT-B/16", batch_sizes=(8, 256, 1024), classes=1000, iters=30, device="cuda", model=None):
    """Rows by batch size; ``model`` (built from seed 0 when None) lets a
    caller reuse a model it holds."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if not on_card:
        batch_sizes, iters = [min(b, 8) for b in batch_sizes][:1], 2
    if model is None:
        cfg = SimpleNamespace(model=model_name, clip_load=None, compute_dtype=compute_dtype(device), seed=0)
        model = build_clip_model(cfg, device=device)
    config = model.config
    rng = np.random.default_rng(0)
    head = random_head(config.embed_dim, classes, rng, device)
    px = config.vision.image_size
    impl = _default_impl()
    rows = {}

    for bs in batch_sizes:
        srv = ClipServer(model, head, image_buckets=(bs,))
        images = torch.from_numpy(rng.standard_normal((bs, px, px, 3)).astype(np.float32))
        images = images.to(device).to(model.compute_dtype)
        flops = clip_flops(model, images, head_classes=classes)
        with torch.inference_mode():
            dt = time_call(srv._logits_fn, images, iters=iters)
        util = mfu(flops, dt, device)
        rows[bs] = {
            "img_per_s": round(bs / dt, 1),
            "latency_ms": round(dt * 1e3, 2),
            "fwd_mfu": None if util is None else round(util, 4),
            "fwd_tflops": round(flops / 1e12, 3),
        }
        mfu_text = "not measured" if util is None else f"{util * 100:5.1f}%"
        print(f"batch {bs:5d}: {bs / dt:8.1f} img/s   {dt * 1e3:7.2f} ms/batch   fwd MFU {mfu_text}",
              file=sys.stderr, flush=True)

    best = max(rows.values(), key=lambda r: r["img_per_s"])
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(json.dumps({
        "metric": f"serving images/sec/chip {model_name} zero-shot classification ({classes} classes)",
        "value": best["img_per_s"],
        "unit": "img/s",
        "vs_baseline": None if best["fwd_mfu"] is None else round(best["fwd_mfu"] / 0.45, 4),
        "extra": {"per_batch": rows, "device": name, "attn_impl": impl},
    }))
    return rows


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", nargs="?", default="ViT-B/16")
    parser.add_argument("batches", nargs="?", default="8,256,1024")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    return main(args.model, tuple(int(v) for v in args.batches.split(",")), device=args.device)


if __name__ == "__main__":
    cli()
