"""Validate a real on-disk dataset tree against a registry dataset.

Counterpart of ``flyp_tpu/tools/validate_data.py``, over the port's readers
(``flyp_tpu_torch/data/datasets/``): the same report, messages and exit
codes.

The WILDS / ObjectNet / VidRobust / ImageNet readers in this repo are
value-tested on synthetic fixtures (no real data ships in CI), so a schema
mismatch against a real ``iwildcam_v2.0/`` or ``objectnet-1.0/`` layout
would otherwise surface only at a user's first training run.  This tool is
the pre-flight a deployer runs against the real tree — no labels, weights,
or network needed::

    python -m flyp_tpu_torch.tools.validate_data --dataset IWildCamOOD --root /data
    python -m flyp_tpu_torch.tools.validate_data --dataset ImageNet --root /data --probe 8

It resolves the dataset exactly as training/eval would
(``data/registry.get_dataset_class``, the upstream FLYP code's
``getattr(src.datasets, name)`` pattern — `src/models/flyp_loss.py:309`,
`eval.py:392`), constructs it against ``--root`` (the
construction IS the schema check: metadata files are read, split columns
parsed, file lists built), then:

* reports split sizes, batch counts, and the classname count (cross-checked
  against the packaged static classnames when those exist),
* scans every discoverable sample path for existence (fast stat, no
  decode) and reports missing files,
* decodes ``--probe`` samples spread across the test split end to end
  (PIL -> transform -> array) and reports the tensor shape.

Exit code 0 = the tree loads exactly as the evaluator would load it;
1 = a named schema/layout problem (message says what and where).

Upstream readers being validated against real trees:
`src/datasets/iwildcam.py:12-38`, `fmow.py`,
`objectnet.py:16-43`, `imagenet_vid_robust.py`, `imagenet.py`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _sample_paths(dataset) -> list:
    """Best-effort list of this dataset's on-disk sample paths."""
    for attr in ("paths", "samples"):
        val = getattr(dataset, attr, None)
        if val:
            out = []
            for item in val:
                p = item[0] if isinstance(item, (tuple, list)) else item
                if isinstance(p, (str, os.PathLike)):
                    out.append(str(p))
            if out:
                return out
    inner = getattr(dataset, "dataset", None)  # SubsetDataset wrapping
    if inner is not None:
        return _sample_paths(inner)
    return []


def _probe_decode(dataset, count: int, rng: np.random.Generator) -> tuple:
    """Decode ``count`` samples spread across the set; returns (n, shape)."""
    n = len(dataset)
    if n == 0:
        return 0, None
    idxs = sorted({0, n - 1, *rng.integers(0, n, size=max(count - 2, 0)).tolist()})[:count]
    shape = None
    for i in idxs:
        sample = dataset.get(int(i), rng) if hasattr(dataset, "get") else dataset[int(i)]
        img = sample["image"] if isinstance(sample, dict) else sample[0]
        arr = np.asarray(img)
        if shape is not None and arr.shape != shape:
            raise ValueError(f"sample {i} decoded to {arr.shape}, expected {shape}")
        shape = arr.shape
    return len(idxs), shape


def validate(name: str, root: str, batch_size: int = 32, probe: int = 4, workers: int = 2):
    """Run the full validation; returns a report dict, raises on failure."""
    from flyp_tpu_torch.data.registry import get_classnames_for, get_dataset_class

    if not os.path.isdir(root):
        raise FileNotFoundError(f"--root {root!r} is not a directory")
    cls = get_dataset_class(name)  # raises with the known-names list

    try:
        ds = cls(location=root, batch_size=batch_size, num_workers=workers)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{name} could not load from {root!r}: {e}\n"
            f"  (the reader expects the dataset's standard layout under the "
            f"root — see flyp_tpu_torch/data/datasets/{cls.__module__.rsplit('.', 1)[-1]}.py)"
        ) from e

    report: dict = {"dataset": name, "root": root, "class": type(ds).__name__}

    test_ds = getattr(ds, "test_dataset", None)
    if test_ds is None or len(test_ds) == 0:
        raise ValueError(f"{name} built an empty test split from {root!r}")
    report["test_samples"] = len(test_ds)
    report["test_batches"] = len(ds.test_loader)
    train_ds = getattr(ds, "train_dataset", None)
    report["train_samples"] = len(train_ds) if train_ds is not None else None

    classnames = getattr(ds, "classnames", None)
    report["num_classes"] = len(classnames) if classnames else None
    try:
        static = get_classnames_for(name)
    except KeyError:
        static = None
    if static is not None and classnames and len(static) != len(classnames):
        raise ValueError(
            f"{name}: the tree yields {len(classnames)} classes but the packaged "
            f"classnames (what the zero-shot head is built from) have {len(static)} "
            "— the head and the labels would disagree"
        )

    # Effective test set: honor subset indices (the rows eval actually scores).
    indices = ds.get_test_indices() if hasattr(ds, "get_test_indices") else None
    paths = _sample_paths(test_ds)
    if indices is not None and paths:
        paths = [paths[i] for i in indices]
        report["test_samples"] = len(indices)
    report["paths_discovered"] = len(paths)
    missing = [p for p in paths if not os.path.isfile(p)]
    report["paths_missing"] = len(missing)
    if missing:
        raise FileNotFoundError(
            f"{name}: {len(missing)}/{len(paths)} test sample files are missing, "
            f"first: {missing[0]!r}"
        )

    rng = np.random.default_rng(0)
    eff = test_ds if indices is None else type(
        "_Sub", (), {"__len__": lambda s: len(indices),
                     "get": lambda s, i, r: test_ds.get(int(indices[i]), r)}
    )()
    n_probed, shape = _probe_decode(eff, probe, rng)
    report["probed"] = n_probed
    report["sample_shape"] = shape
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True, help="registry name, e.g. IWildCamOOD, ObjectNet")
    p.add_argument("--root", required=True, help="data root (the trainer's --data-location)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--probe", type=int, default=4, help="samples to fully decode (default 4)")
    p.add_argument("--workers", type=int, default=2)
    args = p.parse_args(argv)

    try:
        report = validate(args.dataset, args.root, args.batch_size, args.probe, args.workers)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"FAIL {args.dataset} @ {args.root}\n  {e}", file=sys.stderr)
        return 1

    print(f"OK {report['dataset']} @ {report['root']}")
    print(f"  reader:          {report['class']}")
    print(f"  test samples:    {report['test_samples']} ({report['test_batches']} batches of {args.batch_size})")
    if report["train_samples"] is not None:
        print(f"  train samples:   {report['train_samples']}")
    if report["num_classes"] is not None:
        print(f"  classes:         {report['num_classes']}")
    if report["paths_discovered"]:
        print(f"  files checked:   {report['paths_discovered']} (all present)")
    print(f"  decode probe:    {report['probed']} samples -> shape {report['sample_shape']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
