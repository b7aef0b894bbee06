"""PatchCamelyon h5 release -> ImageFolder trees + few-shot subsets
(`datacreation_scripts/patchcamelyon.py`): each split's ``*_x.h5`` images
are written as ``class_{label}/{i}.png``, and ``train_shot_{k}`` folders
take the first k images per class.  h5py is imported where it is used: a
machine without it can import the package."""

from __future__ import annotations

import argparse
import os

import numpy as np


def convert_split(x_h5: str, y_h5: str, out_dir: str, limit: int | None = None) -> int:
    import h5py
    from PIL import Image

    with h5py.File(x_h5, "r") as fx, h5py.File(y_h5, "r") as fy:
        xs = fx["x"]
        ys = np.asarray(fy["y"]).reshape(-1)
        n = len(ys) if limit is None else min(limit, len(ys))
        for cls in np.unique(ys[:n]):
            os.makedirs(os.path.join(out_dir, f"class_{int(cls)}"), exist_ok=True)
        for i in range(n):
            img = np.asarray(xs[i])
            Image.fromarray(img).save(os.path.join(out_dir, f"class_{int(ys[i])}", f"{i}.png"))
    return n


def make_k_shot(train_dir: str, out_dir: str, k: int) -> int:
    copied = 0
    for cls in sorted(os.listdir(train_dir)):
        src = os.path.join(train_dir, cls)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out_dir, cls)
        os.makedirs(dst, exist_ok=True)
        for fname in sorted(os.listdir(src))[:k]:
            with open(os.path.join(src, fname), "rb") as fin, open(os.path.join(dst, fname), "wb") as fout:
                fout.write(fin.read())
            copied += 1
    return copied


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--x-h5", required=True)
    p.add_argument("--y-h5", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--k-shot", type=int, nargs="*", default=[], help="also emit train_shot_{k} dirs")
    args = p.parse_args(argv)
    n = convert_split(args.x_h5, args.y_h5, args.out_dir, args.limit)
    print(f"wrote {n} images to {args.out_dir}")
    for k in args.k_shot:
        out = os.path.join(os.path.dirname(args.out_dir.rstrip("/")), f"train_shot_{k}")
        print(f"k={k}: {make_k_shot(args.out_dir, out, k)} images")


if __name__ == "__main__":
    main()
