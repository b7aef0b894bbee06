"""The chunked (GradCache) step beside the direct step, on the card.

Counterpart of ``tools/grad_cache_bench.py``.  The chunked step's pitch is
the exact big-batch InfoNCE objective past the batch whose direct step fits
the card's memory.  This tool measures it:

1. **Direct attempt** at the target batch (default ViT-L/14 at 512 with
   remat, FLYP's ImageNet recipe at twice its batch): build, run one step,
   fetch its loss.  ``torch.cuda.OutOfMemoryError`` there, and there
   alone, is recorded as "does not fit", as the JAX tool records
   ``RESOURCE_EXHAUSTED``; any other error fails.
2. **Chunked run** at the same global batch (default 8 chunks of 64), in
   the same process after the direct attempt's memory is released
   (``torch.cuda.empty_cache()``): img/s over ``--steps`` steps after
   ``--warmup``, the host clock around work that ends in a synchronise.

``--device cpu`` (or the JAX tool's ``--cpu``) runs the plain versions at
batch 8 in 2 chunks for 2 steps, as the JAX tool shrinks off the TPU: a
functional check only.  One JSON line at the end, with the JAX tool's keys.

Usage: python -m flyp_tpu_torch.tools.grad_cache_bench [--model ViT-L/14] [--batch 512]
           [--chunks 8] [--steps 10] [--skip-direct] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tools._bench import build_bench_parts, build_bench_step
from flyp_tpu_torch.tools._timing import sync


def build_chunked(batch_size: int, model_name: str, remat: bool, chunks: int, device="cuda"):
    """The bench step with the direct step swapped for the chunked one: the
    same model, optimizer, state and inputs (``_bench.build_bench_parts``),
    so the comparison is like for like."""
    from flyp_tpu_torch.training.grad_cache import make_chunked_train_step

    model, optimizer, state, images, tokens, config = build_bench_parts(batch_size, model_name, remat, device)
    chunked = make_chunked_train_step(model, optimizer, chunks=chunks)
    return chunked, state, images, tokens, config


def direct_step(batch_size: int, model_name: str, remat: bool, device="cuda") -> dict:
    """One direct step at ``batch_size``, timed from its launch to its
    loss on the host; any error raises."""
    step_fn, state, images, tokens, _ = build_bench_step(batch_size, model_name, remat, device)
    sync(device)
    t0 = time.perf_counter()
    state, metrics = step_fn(state, images, tokens)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    return {"fits": True, "first_step_s": round(dt, 2), "loss": round(loss, 4)}


def try_direct(batch_size: int, model_name: str, remat: bool, device="cuda") -> dict:
    """:func:`direct_step`, with running out of the card's memory recorded
    as "does not fit" and the memory released after either outcome."""
    try:
        return direct_step(batch_size, model_name, remat, device)
    except torch.cuda.OutOfMemoryError as e:
        return {"fits": False, "oom": True, "error": str(e)[:300]}
    finally:
        release(device)


def release(device) -> None:
    """Free what the last run left: its tensors (the frames of a caught
    error hold them in a cycle) and the allocator's cached blocks."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def chunked_run(batch_size: int, model_name: str, remat: bool, chunks: int, steps: int, warmup: int,
                device="cuda") -> dict:
    """Steady-state time of the chunked step at ``batch_size``."""
    step_fn, state, images, tokens, _ = build_chunked(batch_size, model_name, remat, chunks, device)
    for _ in range(warmup):
        state, metrics = step_fn(state, images, tokens)
    float(metrics["loss"])
    sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, images, tokens)
    loss = float(metrics["loss"])
    sync(device)
    dt = (time.perf_counter() - t0) / steps
    return {"step_time_s": round(dt, 4), "img_per_s": round(batch_size / dt, 2), "loss": round(loss, 4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-L/14")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-direct", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu (the JAX tool's flag)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else args.device)
    if device.type != "cuda":  # a functional check on the CPU
        args.batch, args.chunks, args.steps = 8, 2, 2
    # At least one warm-up step, so the timed steps exclude the first
    # launch's set-up (kernel loads, the allocator's first blocks).
    args.warmup = max(args.warmup, 1)
    remat = args.model.startswith("ViT-L") and not args.no_remat
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    result = {"model": args.model, "batch": args.batch, "chunks": args.chunks, "remat": remat, "device": name}
    if not args.skip_direct:
        print(f"[direct] {args.model} bs{args.batch} remat={remat} ...", file=sys.stderr, flush=True)
        result["direct"] = try_direct(args.batch, args.model, remat, device)
        print(f"[direct] {result['direct']}", file=sys.stderr, flush=True)

    print(f"[chunked] {args.chunks}x{args.batch // args.chunks} ...", file=sys.stderr, flush=True)
    result["chunked"] = chunked_run(args.batch, args.model, remat, args.chunks, args.steps, args.warmup, device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
