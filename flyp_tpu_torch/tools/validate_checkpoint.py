"""Validate a real CLIP checkpoint end to end: load -> zero-shot eval.

Counterpart of ``flyp_tpu/tools/validate_checkpoint.py``.  Usage (a CLIP
``.pt`` or a checkpoint directory of the port's trainer, and a dataset
root)::

    python -m flyp_tpu_torch.tools.validate_checkpoint \\
        --checkpoint ViT-B-16.pt --train-dataset ImageNet \\
        --template openai_imagenet_template \\
        --eval-datasets ImageNet,ImageNetV2 --data-location datasets/data

This is the accuracy-parity gate that CI cannot run (no network to fetch
weights): zero-shot ImageNet top-1 for OpenAI ViT-B/16 should land at
~68.3%, and a converted FLYP fine-tune at the paper numbers (BASELINE.md).
It runs ``cli/zeroshot_eval.py`` on ``--device`` (the card unless asked for
the CPU).  ``--crosscheck --reference-root DIR`` also compares the
activations, block by block, with the upstream CLIP torch implementation
checked out at ``DIR`` (``DIR/clip/model.py``).  The port has
no downloader (it would need the network), so ``--download_pretrained`` is
refused.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import torch


def activation_crosscheck(checkpoint_path: str, reference_root: str, device) -> float:
    """Max abs diff of image/text features against the upstream torch model
    (``<reference_root>/clip/model.py``), after printing the diff of every
    residual block's output, so a conversion or numerics fault points at a
    layer.  The port's model runs in fp32 on ``device`` (on the card, the
    kernel path that serving and evaluation run); the reference runs on the
    CPU.  Raises ``FileNotFoundError`` where the reference is absent."""
    ref_file = os.path.join(reference_root, "clip", "model.py")
    if not os.path.isfile(ref_file):
        raise FileNotFoundError(f"the reference CLIP model {ref_file!r} is not there; check the upstream "
                                "implementation out there or pass its root")
    spec = importlib.util.spec_from_file_location("ref_clip_model", ref_file)
    ref_model_mod = importlib.util.module_from_spec(spec)
    sys.modules["ref_clip_model"] = ref_model_mod
    spec.loader.exec_module(ref_model_mod)

    from flyp_tpu_torch.models import CLIPModel, convert
    from flyp_tpu_torch.models.factory import resolve_device

    device = resolve_device(device)
    state = convert.load_torch_checkpoint(checkpoint_path)
    port_state, config = convert.convert_clip_state_dict(state)
    model = CLIPModel(config)
    model.load_state_dict(port_state, strict=True)
    model.to(device).eval()
    ref = ref_model_mod.build_model({k: v.clone() for k, v in state.items()}).float().eval()

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, 3, config.vision.image_size, config.vision.image_size)).astype(np.float32)
    vocab = config.text.vocab_size
    toks = np.zeros((2, config.text.context_length), dtype=np.int64)
    toks[:, 0] = vocab - 2  # SOT
    toks[:, 1:4] = rng.integers(1, vocab - 2, (2, 3))
    toks[:, 4] = vocab - 1  # EOT (highest id -> pooling position)

    ref_acts, our_acts = {}, {}

    def hook(store, name):
        def fn(_m, _i, out):
            store[name] = out.detach().float().cpu().numpy()
        return fn

    towers = [("text", ref.transformer.resblocks, model.text.transformer, config.text.layers)]
    if config.vision.is_vit:
        towers.insert(0, ("visual", ref.visual.transformer.resblocks, model.visual.transformer, config.vision.layers))
    for tower, ref_blocks, ours, layers in towers:
        for i in range(layers):
            ref_blocks[i].register_forward_hook(hook(ref_acts, f"{tower}.block_{i}"))
            getattr(ours, f"block_{i}").register_forward_hook(hook(our_acts, f"{tower}.block_{i}"))

    with torch.no_grad():
        ref_img = ref.encode_image(torch.from_numpy(imgs)).numpy()
        ref_txt = ref.encode_text(torch.from_numpy(toks)).numpy()
        our_img = model.encode_image(torch.from_numpy(imgs.transpose(0, 2, 3, 1).copy()).to(device))
        our_txt = model.encode_text(torch.from_numpy(toks.astype(np.int32)).to(device))
        our_img, our_txt = our_img.float().cpu().numpy(), our_txt.float().cpu().numpy()

    report = {}
    for name, ours in our_acts.items():  # [B, L, D]
        theirs = ref_acts[name]
        if theirs.shape != ours.shape:  # the reference's blocks run LND
            theirs = theirs.transpose(1, 0, 2)
        report[name] = float(np.abs(ours - theirs).max())
    report["image_features"] = float(np.abs(our_img - ref_img).max())
    report["text_features"] = float(np.abs(our_txt - ref_txt).max())
    for name, diff in report.items():
        print(f"  {name:>20s}: max abs diff {diff:.3e}")
    return max(report["image_features"], report["text_features"])


def main(argv=None):
    from flyp_tpu_torch.config import ExperimentConfig, build_parser

    p = build_parser()
    p.add_argument("--checkpoint", default=None,
                   help="torch .pt checkpoint or checkpoint directory of the port's trainer to validate")
    p.add_argument("--crosscheck", action="store_true", help="also diff activations vs the reference torch model")
    p.add_argument("--reference-root", dest="reference_root", default=None,
                   help="checkout of the upstream implementation (DIR/clip/model.py) for --crosscheck")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the evaluation (default cuda; cpu runs the plain path)")
    ns = p.parse_args(argv)

    if ns.checkpoint is None:
        if not ns.download_pretrained:
            p.error("pass --checkpoint or --download_pretrained")
        p.error("--download_pretrained needs the JAX package's downloader (models/download.py), which the port "
                "leaves out because it needs the network; pass --checkpoint")
    if ns.crosscheck and ns.reference_root is None:
        p.error("--crosscheck needs --reference-root")

    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    cfg = ExperimentConfig(**{k: v for k, v in vars(ns).items() if k in known})
    cfg.clip_load = ns.checkpoint

    if ns.crosscheck:
        diff = activation_crosscheck(ns.checkpoint, ns.reference_root, ns.device)
        print(f"max activation diff vs reference torch model: {diff:.2e}")

    from flyp_tpu_torch.cli.zeroshot_eval import main as zs_main

    stats = zs_main(cfg)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
