"""Per-stage RN50 train-step breakdown on the card.

Counterpart of ``tools/rn50_breakdown.py``.  Times each piece of the port's
own ModifiedResNet tower (``models/resnet.py``, the modules the trainer
runs: convolutions through cuDNN on channels-last activations, BatchNorm in
training mode with its running statistics written), forward + backward to
the piece's parameters at batch 256 in bf16, each with CUDA events after a
warm-up (``tools/_timing.py``), and divides each piece's FLOPs
(``utils/profiling.py::compiled_flops`` on a meta copy of the piece) by its
time: a per-stage share-of-peak map.  The pieces are the JAX tool's: the
3-conv stem with its average pool, the four stages of bottlenecks, and the
attention pool.  Where the JAX tool defines flax modules for the pieces,
this one slices the tower the trainer runs, so the breakdown times the
same modules.

``--device cpu`` runs the plain versions, a functional check (call
:func:`main` with a small ``batch``; its share of peak is not measured).

Usage: python -m flyp_tpu_torch.tools.rn50_breakdown [batch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from flyp_tpu_torch.models import build_clip_model
from flyp_tpu_torch.models.factory import resolve_device
from flyp_tpu_torch.tools._bench import compute_dtype
from flyp_tpu_torch.tools._timing import normal, time_call
from flyp_tpu_torch.utils.profiling import compiled_flops, device_peak_flops, meta_twin


def stem(tower, x):
    """The 3-conv stem and its average pool (``ModifiedResNet.forward``'s
    first lines)."""
    x = F.relu(tower.bn1(tower.conv1(x)))
    x = F.relu(tower.bn2(tower.conv2(x)))
    x = F.relu(tower.bn3(tower.conv3(x)))
    return F.avg_pool2d(x, 2)


def stage(tower, index: int):
    """Stage ``index`` (1-4) of the tower: its bottlenecks in order."""
    names = [n for n in tower.blocks if n.startswith(f"layer{index}_")]

    def run(t, x):
        for n in names:
            x = getattr(t, n)(x)
        return x
    return run, names


def pieces(tower, batch: int):
    """(label, fn(tower, x), parameter names, input ``[B, H, W, C]``) of
    piece (labels at RN50's 224-px shapes)."""
    width, px = tower.config.width, tower.config.image_size
    out = [("stem  224->56, 3->64ch", stem, ["conv1", "bn1", "conv2", "bn2", "conv3", "bn3"], (batch, px, px, 3))]
    shapes = ((px // 4, width), (px // 4, width * 4), (px // 8, width * 8), (px // 16, width * 16))
    for i, ((hw, cin), label) in enumerate(zip(shapes, ("stage1 3x @56^2 pl64", "stage2 4x @56->28 pl128",
                                                         "stage3 6x @28->14 pl256", "stage4 3x @14->7 pl512"))):
        fn, names = stage(tower, i + 1)
        out.append((label, fn, names, (batch, hw, hw, cin)))
    out.append(("attnpool 50tok d2048", lambda t, x: t.attnpool(x), ["attnpool"],
                (batch, px // 32, px // 32, width * 32)))
    return out


def _params(tower, names):
    return [p for n in names for p in getattr(tower, n).parameters()]


def piece_grads(tower, fn, names, x):
    """The piece's forward in training mode and the backward to its
    parameters from ``sum(out^2)``."""
    out = fn(tower, x)
    return torch.autograd.grad(out.float().square().sum(), _params(tower, names))


def main(batch: int = 256, device="cuda", iters: int = 20, model=None) -> list:
    """Rows of ``{"name", "ms", "gflop", "tflops", "peak_share"}`` and the
    tower's total; ``model`` (RN50 from seed 0 when None) lets a caller pass
    one it holds."""
    device = resolve_device(device)
    if model is None:
        cfg = SimpleNamespace(model="RN50", clip_load=None, compute_dtype=compute_dtype(device), seed=0)
        model = build_clip_model(cfg, device=device)
    if model.config.vision.is_vit:
        raise ValueError("rn50_breakdown takes a ModifiedResNet image tower")
    tower = model.visual.train().requires_grad_(True)
    twin = meta_twin(model).visual.train()
    dtype = model.compute_dtype
    peak = device_peak_flops(device)
    rng = np.random.default_rng(0)

    rows, total_t, total_f = [], 0.0, 0.0
    print(f"batch={batch} dtype={str(dtype).split('.')[-1]} device={device}")
    for name, fn, names, shape in pieces(tower, batch):
        x = normal(rng, shape, dtype, device).permute(0, 3, 1, 2)  # a channels-last NCHW view, as the tower's
        meta_x = torch.empty(shape, dtype=dtype, device="meta").permute(0, 3, 1, 2)
        flops = compiled_flops(piece_grads, twin, fn, names, meta_x)
        t = time_call(piece_grads, tower, fn, names, x, iters=iters)
        total_t += t
        total_f += flops
        tfs = flops / t / 1e12
        share = None if peak is None else tfs * 1e12 / peak
        rows.append({"name": name, "ms": t * 1e3, "gflop": flops / 1e9, "tflops": tfs, "peak_share": share})
        share_text = "not measured" if share is None else f"{share * 100:5.1f}% peak"
        print(f"  {name:28s} {t * 1e3:7.2f} ms  {flops / 1e9:8.1f} GF  {tfs:6.1f} TF/s  {share_text}")
    tfs = total_f / total_t / 1e12
    share = None if peak is None else tfs * 1e12 / peak
    rows.append({"name": "TOWER fwd+bwd total", "ms": total_t * 1e3, "gflop": total_f / 1e9, "tflops": tfs,
                 "peak_share": share})
    share_text = "not measured" if share is None else f"{share * 100:5.1f}% peak"
    print(f"  {'TOWER fwd+bwd total':28s} {total_t * 1e3:7.2f} ms  {total_f / 1e9:8.1f} GF  {tfs:6.1f} TF/s  "
          f"{share_text}", flush=True)
    return rows


def cli(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    return main(args.batch, device=args.device)


if __name__ == "__main__":
    cli()
