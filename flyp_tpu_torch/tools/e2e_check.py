"""End-to-end check: the real trainer on the card, through the command line.

Counterpart of ``tools/tpu_e2e_check.py``.  Where the other tools time the
step alone, this drives the whole product path as a user runs it:
``cli/main.py`` with a CSV corpus the tool writes (the loader), the epoch
loop of ``training/flyp.py``, the per-epoch zero-shot head rebuild, the
evaluation harness, the stats TSVs and a torch-native checkpoint, with a
random-init model (full-size ViT-B/16 by default) in bf16 on the card, or
in fp32 with ``--device cpu`` (slowly).

It fails (a non-zero exit) on a non-finite epoch loss, an accuracy outside
[0, 1], a missing stats row or a missing final checkpoint.

Usage: python -m flyp_tpu_torch.tools.e2e_check [--epochs 2] [--batch-size 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import tempfile

import numpy as np

CLASSNAMES = ["lymph node", "lymph node containing metastatic tumor tissue"]


def make_corpus(root: str, n_per_class: int = 32, px: int = 224) -> str:
    """A synthetic 2-class PatchCamelyon tree (train and val) and the
    contrastive TSV over its train split, at full image resolution (the
    JAX tool's corpus)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for split in ("train", "val"):
        for ci in range(2):
            d = os.path.join(root, "patchcamelyon", split, f"class_{ci}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_per_class):
                base = np.full((px, px, 3), 50 + 140 * ci, np.uint8)
                noise = rng.integers(0, 60, (px, px, 3), dtype=np.uint8)
                path = os.path.join(d, f"{i}.png")
                Image.fromarray(base + noise).save(path)
                if split == "train":
                    rows.append((f"this is a photo of {CLASSNAMES[ci]}", path, ci))
    train_csv = os.path.join(root, "train.tsv")
    with open(train_csv, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(("title", "filepath", "label"))
        w.writerows(rows)
    return train_csv


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--images-per-class", type=int, default=32)
    ap.add_argument("--model", default="ViT-B/16",
                    help="any MODEL_CONFIGS key; RN50 drives the BatchNorm running statistics")
    ap.add_argument("--device", default="cuda", help="cuda (default, bf16) or cpu (fp32)")
    args = ap.parse_args(argv)

    from flyp_tpu_torch.cli import main as cli_main
    from flyp_tpu_torch.data.csv_dataset import read_table
    from flyp_tpu_torch.models.factory import resolve_device

    device = resolve_device(args.device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    print(f"device: {device}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        train_csv = make_corpus(tmp, n_per_class=args.images_per_class)
        ckpt_dir = os.path.join(tmp, "ckpt")
        argv = ["--train-dataset", "PatchCamelyonVal", "--template", "patchcamelyon_template",
                "--eval-datasets", "PatchCamelyonVal", "--data-location", tmp, "--ft_data", train_csv,
                "--ft_data_test", train_csv, "--batch-size", str(args.batch_size), "--lr", "1e-5", "--wd", "0.1",
                "--warmup_length", "2", "--epochs", str(args.epochs), "--workers", "4", "--debug",
                "--compute_dtype", dtype, "--model", args.model, "--save", ckpt_dir, "--exp_name", "e2e",
                "--device", device.type]
        os.chdir(tmp)  # cli/main.py writes expt_logs/ under the working directory
        try:
            cfg = cli_main.parse_main_arguments(argv)
            last = cli_main.main(cfg)
        finally:
            os.chdir(cwd)

        stats = read_table(os.path.join(tmp, cfg.log_dir, "stats.tsv"), "\t")
        losses = [float(v) for v in stats["Avg ID FLYP Loss"]]
        accs = [float(v) for v in stats["PatchCamelyonVal Accuracy"]]
        final = os.path.join(cfg.save, f"checkpoint_{args.epochs - 1}")
        if len(losses) != args.epochs:
            raise RuntimeError(f"expected {args.epochs} epoch rows, got {len(losses)}")
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"non-finite epoch losses: {losses}")
        if not all(0 <= a <= 1 for a in accs):
            raise RuntimeError(f"bad accuracies: {accs}")
        if not os.path.isdir(final) or os.path.abspath(last) != os.path.abspath(final):
            raise RuntimeError(f"missing final checkpoint {final} (the trainer returned {last})")
        print(f"epoch losses: {losses}  eval accs: {accs}")
        print("full-trainer e2e check OK")
    return {"losses": losses, "accs": accs, "checkpoint": os.path.basename(final)}


if __name__ == "__main__":
    main()
