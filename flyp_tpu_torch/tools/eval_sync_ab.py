"""Evaluation-loop host sync A/B: a logits fetch after every batch against
the one-batch-lagged pipeline.

Counterpart of ``tools/eval_sync_ab.py``.  ``evaluation/evaluator.py``
launches batch i+1's forward before it fetches batch i's logits
(``Classifier.predict_logits_device`` and the lagged drain), so the
``[B, classes]`` copy to the host and the host's metric work overlap the
card's.  This times both loop shapes around ``Classifier`` (the image tower
in eval mode, B3 in every block, then the head), in turns in one process.
Host clock; each block ends in a fetch.

``--device cpu`` runs the plain versions at batch 8, one block of 2
batches: a functional check.

Usage: python -m flyp_tpu_torch.tools.eval_sync_ab [model] [batch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from flyp_tpu_torch.evaluation import Classifier
from flyp_tpu_torch.models import build_clip_model
from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tools._bench import compute_dtype, random_head


def main(model_name="ViT-B/16", batch=256, blocks=2, steps=6, classes=1000, device="cuda") -> list:
    """[{"sync_ms", "lagged_ms", "ratio"}] a block."""
    device = resolve_device(device)
    if device.type != "cuda":
        batch, blocks, steps = min(batch, 8), 1, 2

    cfg = SimpleNamespace(model=model_name, clip_load=None, compute_dtype=compute_dtype(device), seed=0)
    model = build_clip_model(cfg, device=device)
    config = model.config
    rng = np.random.default_rng(0)
    head = random_head(config.embed_dim, classes, rng, device)
    clf = Classifier(model, head, batch_size=batch)
    px = config.vision.image_size
    images = np.asarray(rng.standard_normal((batch, px, px, 3)), np.float32)

    clf.predict_logits(images)  # warm

    def host_work(logits, labels):
        # Representative per-batch metric work (argmax and tally).
        preds = logits.argmax(axis=1)
        return float((preds == labels).sum())

    labels = rng.integers(0, classes, batch)

    def sync_block(n):
        t0 = time.perf_counter()
        acc = 0.0
        for _ in range(n):
            logits = clf.predict_logits(images)  # launch and fetch, in series
            acc += host_work(logits, labels)
        return (time.perf_counter() - t0) / n

    def lagged_block(n):
        t0 = time.perf_counter()
        acc, pend = 0.0, None
        for _ in range(n):
            dev, nv = clf.predict_logits_device(images)  # launch only
            if pend is not None:
                acc += host_work(pend[0][: pend[1]].float().cpu().numpy(), labels)
            pend = (dev, nv)
        acc += host_work(pend[0][: pend[1]].float().cpu().numpy(), labels)
        return (time.perf_counter() - t0) / n

    out = []
    for b in range(blocks):
        ts, tl = sync_block(steps), lagged_block(steps)
        out.append({"sync_ms": ts * 1e3, "lagged_ms": tl * 1e3, "ratio": ts / tl})
        print(
            f"block {b}: sync {ts*1e3:7.2f} ms/batch ({batch/ts:7.1f} img/s)   "
            f"lagged {tl*1e3:7.2f} ms/batch ({batch/tl:7.1f} img/s)   sync/lagged {ts/tl:6.4f}",
            flush=True,
        )
    return out


def cli(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", nargs="?", default="ViT-B/16")
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    return main(args.model, args.batch, device=args.device)


if __name__ == "__main__":
    cli()
