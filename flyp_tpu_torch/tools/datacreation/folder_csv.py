"""ImageFolder tree -> contrastive CSV with prompt-templated captions.

Generalizes `datacreation_scripts/{imagenet_csv_creator,caltech101,
flowers102,stanfordCars,sst2}.py`: one row per (image, template prompt),
caption built from the class name.  Class names come from a registered list
(``--classnames``) or the folder names themselves.
"""

from __future__ import annotations

import argparse
import os

from flyp_tpu_torch.data.datasets.base import scan_image_folder
from flyp_tpu_torch.templates import get_template


def build_csv(
    input_folder: str,
    output_csv: str,
    template_name: str,
    classnames=None,
    with_labels: bool = True,
    separator: str = "\t",
) -> int:
    template = get_template(template_name)
    folders, samples = scan_image_folder(input_folder)
    names = list(classnames) if classnames else [f.replace("_", " ") for f in folders]
    assert len(names) == len(folders), f"{len(names)} classnames vs {len(folders)} folders"

    os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
    n = 0
    with open(output_csv, "w") as out:
        header = ["title", "filepath"] + (["label"] if with_labels else [])
        out.write(separator.join(header) + "\n")
        for path, label in samples:
            for t in template:
                row = [t(names[label]), path] + ([str(label)] if with_labels else [])
                out.write(separator.join(row) + "\n")
                n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input-folder", required=True, help="ImageFolder root (class subdirs)")
    p.add_argument("--output-csv", required=True)
    p.add_argument("--template", required=True, help="template registry name")
    p.add_argument("--classnames", default=None, help="registered classname list module attr, e.g. 'openai'")
    p.add_argument("--no-labels", action="store_true")
    args = p.parse_args(argv)

    classnames = None
    if args.classnames:
        from flyp_tpu_torch.data import classnames as cn

        classnames = (
            cn.get_classnames(args.classnames)
            if args.classnames in ("openai",)
            else getattr(cn, args.classnames)
        )
    n = build_csv(args.input_folder, args.output_csv, args.template, classnames, not args.no_labels)
    print(f"wrote {n} rows to {args.output_csv}")


if __name__ == "__main__":
    main()
