"""FMoW training CSV from the WILDS v1.1 metadata
(`datacreation_scripts/fmow_csv_creator.py`): ID-train rows (original
'train' split, pre-2013 years, 'seq' rows dropped) with one caption per
fmow_template prompt."""

from __future__ import annotations

import argparse
import os

import numpy as np

from flyp_tpu_torch.data.classnames import fmow_classnames
from flyp_tpu_torch.templates import get_template


def build_csv(data_root: str, output_csv: str, separator: str = "\t") -> int:
    import pandas as pd

    template = get_template("fmow_template")
    meta = pd.read_csv(os.path.join(data_root, "rgb_metadata.csv"))
    years = pd.to_datetime(meta["timestamp"], utc=True, format="mixed").dt.year
    ood = years >= 2013
    seq = meta["split"] == "seq"
    train_mask = (meta["split"] == "train") & ~ood & ~seq
    idxs = np.where(train_mask.to_numpy())[0]

    os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
    n = 0
    with open(output_csv, "w") as out:
        out.write(separator.join(["title", "filepath", "label"]) + "\n")
        for idx in idxs:
            name = meta["category"].iloc[idx]
            label = fmow_classnames.index(name)
            path = os.path.join(data_root, "images", f"rgb_img_{idx}.png")
            for t in template:
                out.write(separator.join([t(name), path, str(label)]) + "\n")
                n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", required=True, help="fmow_v1.1 directory")
    p.add_argument("--output-csv", required=True)
    args = p.parse_args(argv)
    n = build_csv(args.data_root, args.output_csv)
    print(f"wrote {n} rows to {args.output_csv}")


if __name__ == "__main__":
    main()
