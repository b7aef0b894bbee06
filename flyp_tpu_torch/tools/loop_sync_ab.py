"""Trainer-loop host sync A/B: a loss fetch after every step against the
fetch one step late.

Counterpart of ``tools/loop_sync_ab.py``.  The train loop's one per-step
host synchronisation is the loss's conversion to a Python float (the NaN
guard and the metric sink need it, as the reference's per-step ``.item()``
does).  Fetching right after the launch leaves the card idle from the
step's end until the host has the value and launches the next step;
holding step i's metrics until step i+1 is launched overlaps the fetch
with the card's work.  This times both loop shapes around the bench step
(``tools/_bench.py``), in turns in one process; the lagged shape is what
``training/flyp.py`` runs.  Host clock; each block ends in a fetch.

``--device cpu`` runs the plain versions at batch 8, one block of 2
steps: a functional check.

Usage: python -m flyp_tpu_torch.tools.loop_sync_ab [batch] [model] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tools._bench import build_bench_step


def main(batch_size=256, model_name="ViT-B/16", blocks=3, steps=15, device="cuda") -> list:
    """[{"sync_ms", "lagged_ms", "ratio"}] a block."""
    device = resolve_device(device)
    if device.type != "cuda":
        batch_size, blocks, steps = min(batch_size, 8), 1, 2

    step_fn, state, images, tokens, _ = build_bench_step(batch_size, model_name, False, device)
    for _ in range(3):
        state, m = step_fn(state, images, tokens)
    float(m["loss"])

    def sync_block(n):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step_fn(state, images, tokens)
            float(m["loss"])  # a fetch every step (the reference's shape)
        return (time.perf_counter() - t0) / n

    def lagged_block(n):
        nonlocal state
        pend = None
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step_fn(state, images, tokens)
            if pend is not None:
                float(pend["loss"])  # the previous step's, after this one is launched (the trainer's shape)
            pend = m
        float(pend["loss"])
        return (time.perf_counter() - t0) / n

    out = []
    for b in range(blocks):
        ts, tl = sync_block(steps), lagged_block(steps)
        out.append({"sync_ms": ts * 1e3, "lagged_ms": tl * 1e3, "ratio": ts / tl})
        print(
            f"block {b}: sync {ts*1e3:7.2f} ms/step ({batch_size/ts:7.1f} img/s)   "
            f"lagged {tl*1e3:7.2f} ms/step ({batch_size/tl:7.1f} img/s)   sync/lagged {ts/tl:6.4f}",
            flush=True,
        )
    return out


def cli(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("model", nargs="?", default="ViT-B/16")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    return main(args.batch, args.model, device=args.device)


if __name__ == "__main__":
    cli()
