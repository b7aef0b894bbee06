"""iWildCam contrastive/curriculum CSV writer
(`datacreation_scripts/iwildcam.py`).

Modes:
  * ``train``: original camera-trap crops (guidance 100) plus optional
    diffusion-augmented folders ``<species>/Strength{n}_*/*.jpg`` whose
    strength ``n`` maps to ``guidance = 100 - n``; optional CLIP-score
    filtering (keep pairs with score >= threshold from a pickle of
    ``{category: {species: [img_id, ...]}}``).
  * ``test``: evaluation crops at guidance 100.

Rows: ``title\tfilepath\tlabel\tguidance\timg_id`` with two caption columns
(``title``, ``title_1``) from the iwildcam template, and ``img_id`` assigned
to images that appear under more than two guidance values (the curriculum
progress-tracking set, `iwildcam.py:190-196`).
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

from flyp_tpu_torch.templates import get_template


def _species_label_map(labels_csv: str) -> Dict[str, int]:
    import pandas as pd

    df = pd.read_csv(labels_csv)
    df = df[df["y"] < 99999]
    return {str(name): int(y) for name, y in zip(df["name"], df["y"])}


def _load_clip_filter(path: Optional[str]):
    if not path:
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def collect_rows(
    input_folder: str,
    labels_csv: str,
    mode: str = "train",
    strength_folders: bool = False,
    clip_filter: Optional[str] = None,
) -> "pd.DataFrame":
    import pandas as pd

    name_to_y = _species_label_map(labels_csv)
    filt = _load_clip_filter(clip_filter)
    rows: List[list] = []

    for species_dir in sorted(os.listdir(input_folder)):
        species = species_dir.replace("_", " ")
        if species not in name_to_y:
            continue
        y = name_to_y[species]
        sp_path = os.path.join(input_folder, species_dir)
        for entry in sorted(os.listdir(sp_path)):
            full = os.path.join(sp_path, entry)
            if strength_folders and os.path.isdir(full) and entry.startswith("Strength"):
                strength = int(entry.split("_")[0].replace("Strength", ""))
                for img in sorted(os.listdir(full)):
                    if not img.endswith(".jpg"):
                        continue
                    img_id = img[:-4]
                    if filt is not None:
                        ok = entry in filt and species_dir in filt[entry] and img_id in filt[entry][species_dir]
                        if not ok:
                            continue
                    rows.append([y, os.path.join(full, img), strength])
            elif entry.endswith(".jpg"):
                rows.append([y, full, 0])

    df = pd.DataFrame(rows, columns=["y", "filename", "strength"])
    df["guidance"] = df["strength"].apply(lambda s: 100 - int(s))
    df["img_name"] = df["filename"].apply(lambda p: os.path.basename(p).replace(".jpg", ""))
    counts = df.groupby("img_name")["guidance"].count()
    tracked = list(counts[counts > 2].index)
    id_map = {name: i for i, name in enumerate(tracked)}
    df["img_id"] = df["img_name"].map(lambda n: id_map.get(n, -1))
    return df


def write_csv(df: "pd.DataFrame", labels_csv: str, output_csv: str, separator: str = "\t") -> int:
    import pandas as pd

    template = get_template("iwildcam_template")
    y_to_name = {y: name for name, y in _species_label_map(labels_csv).items()}
    english = pd.read_csv(labels_csv)
    english = english[english["y"] < 99999]
    y_to_english = {int(y): str(e) for y, e in zip(english["y"], english["english"])}

    os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
    with open(output_csv, "w") as out:
        out.write(separator.join(["title", "title_1", "filepath", "label", "guidance", "img_id"]) + "\n")
        for _, row in df.iterrows():
            name = y_to_english.get(int(row["y"]), y_to_name.get(int(row["y"]), ""))
            out.write(
                separator.join([
                    template[0](name), template[1](name), str(row["filename"]),
                    str(int(row["y"])), str(int(row["guidance"])), str(int(row["img_id"])),
                ]) + "\n"
            )
    return len(df)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input-folder", required=True)
    p.add_argument("--labels-csv", required=True, help="iwildcam labels.csv (packaged copy works)")
    p.add_argument("--output-csv", required=True)
    p.add_argument("--mode", choices=["train", "test"], default="train")
    p.add_argument("--strength-folders", action="store_true", help="scan Strength{n}_* curriculum folders")
    p.add_argument("--clip-filter", default=None, help="pickle of CLIP-score-passing ids")
    args = p.parse_args(argv)

    df = collect_rows(args.input_folder, args.labels_csv, args.mode, args.strength_folders, args.clip_filter)
    n = write_csv(df, args.labels_csv, args.output_csv)
    print(f"wrote {n} rows to {args.output_csv}")


if __name__ == "__main__":
    main()
