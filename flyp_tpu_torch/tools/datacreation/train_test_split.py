"""60/20/20 ImageFolder splitter (`datacreation_scripts/traintestsplit.py`)."""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def split_folder(data_path: str, out_root: str, fractions=(0.6, 0.2, 0.2), seed: int = 0, move: bool = False):
    rng = np.random.default_rng(seed)
    names = ("train", "val", "test")
    copied = {n: 0 for n in names}
    for cat in sorted(os.listdir(data_path)):
        src_dir = os.path.join(data_path, cat)
        if not os.path.isdir(src_dir):
            continue
        for split in names:
            os.makedirs(os.path.join(out_root, split, cat), exist_ok=True)
        files = sorted(os.listdir(src_dir))
        choices = rng.choice(len(names), size=len(files), p=list(fractions))
        for f, c in zip(files, choices):
            dest = os.path.join(out_root, names[c], cat, f)
            src = os.path.join(src_dir, f)
            (shutil.move if move else shutil.copy)(src, dest)
            copied[names[c]] += 1
    return copied


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True, help="flat ImageFolder root to split")
    p.add_argument("--out-root", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--move", action="store_true")
    args = p.parse_args(argv)
    print(split_folder(args.data_path, args.out_root, seed=args.seed, move=args.move))


if __name__ == "__main__":
    main()
