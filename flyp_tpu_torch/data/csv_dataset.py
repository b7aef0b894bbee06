"""CSV/TSV contrastive dataset: (image, caption) pairs with curriculum
sidecar columns.

Counterpart of ``flyp_tpu/data/csv_dataset.py``, read without pandas:

* TSV columns: ``filepath``, ``title`` (caption), optional ``label``,
  ``guidance`` (curriculum strength), ``img_id``, and extra caption columns
  ``title_1..title_k``.
* ``guidance=g`` filters rows to that curriculum strength; ``datalimit``
  subsamples them.
* ``ori_proportion`` mixes in guidance-100 ("original data") rows at the
  requested fraction of the final set.
* ``list_selection`` keeps rows whose label is in the set.
* Items return the transformed image, tokenized caption, and whichever of
  label / path / guidance / img_id / multi-caption stack were requested.

Images may be image files or ``.npy`` HWC uint8/float arrays.

What pandas did, done here with the standard ``csv`` module and numpy:

* ``read_csv(sep=...)``: the default ``"`` quoting, blank lines skipped, and
  each column typed as pandas types it (:func:`_column`): all-integer
  columns are ints, all-numeric ones floats, ``True``/``False`` ones bools,
  the rest strings, with pandas' NA spellings (an empty field, ``NA``,
  ``None``, ``nan``...) read as NaN, so ``str()`` of an empty caption is
  ``"nan"`` as in the JAX package;
* ``sort_values(by="img_id")``: ``np.argsort(kind="quicksort")`` of the
  int64 column, which is not stable, NaNs last;
* ``sample(n, replace=False, random_state=seed)``:
  ``np.random.RandomState(seed).permutation(len)[:n]``.
"""

from __future__ import annotations

import csv
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from flyp_tpu_torch.tokenizer import tokenize

# pandas' default NA spellings (``pandas.io.parsers`` STR_NA_VALUES).
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)


def _column(raw: List[str]) -> list:
    """One column's fields as pandas types them: a list of ints, floats
    (NaN for NA), bools, or strings (NaN for NA)."""
    values = [v for v in raw if v not in _NA]
    has_na = len(values) < len(raw)
    if values and all(_INT.fullmatch(v) for v in values):
        return [float("nan") if v in _NA else float(int(v)) for v in raw] if has_na else [int(v) for v in raw]
    if values and all(_FLOAT.fullmatch(v) for v in values):
        return [float("nan") if v in _NA else float(v) for v in raw]
    if values and not has_na and all(v in _TRUE or v in _FALSE for v in values):
        return [v in _TRUE for v in raw]
    return [float("nan") if v in _NA else v for v in raw]


def read_table(path: str, sep: str) -> Dict[str, list]:
    """``pd.read_csv(path, sep=sep)`` as a dict of typed columns."""
    if len(sep) != 1:
        raise ValueError(f"the CSV separator must be one character, got {sep!r}")
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r and not (len(r) == 1 and not r[0].strip())]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the header {len(header)}")
    return {name: _column([r[j] if j < len(r) else "" for r in body]) for j, name in enumerate(header)}


def _sort_order(values: list) -> np.ndarray:
    """``Series.sort_values()``'s order: an unstable quicksort of the int64
    (or float64) column, NaNs last in their order."""
    if all(isinstance(v, int) for v in values):
        return np.argsort(np.asarray(values, dtype=np.int64), kind="quicksort")
    arr = np.asarray(values, dtype=np.float64)
    nan = np.isnan(arr)
    idx = np.arange(len(arr))
    return np.concatenate([idx[~nan][arr[~nan].argsort(kind="quicksort")], idx[nan]])


def _sample(rows: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``df.sample(n, replace=False, random_state=seed)``'s rows."""
    return rows[np.random.RandomState(seed).permutation(len(rows))[:n]]


class CsvContrastiveDataset:
    def __init__(
        self,
        input_filename: str,
        transform: Callable,
        img_key: str = "filepath",
        caption_key: str = "title",
        sep: str = "\t",
        label_key: Optional[str] = None,
        guidance: Optional[int] = None,
        datalimit: int = -1,
        list_selection: Optional[Sequence[int]] = None,
        ori_proportion: Optional[float] = None,
        return_guidance: bool = False,
        return_img_id: bool = False,
        only_img_id: bool = False,
        seed: int = 0,
    ):
        table = read_table(input_filename, sep)
        rng = np.random.default_rng(seed)

        def where(rows: np.ndarray, key: str, keep: Callable) -> np.ndarray:
            col = table[key]
            return rows[np.fromiter((bool(keep(col[i])) for i in rows), dtype=bool, count=len(rows))]

        rows = np.arange(len(next(iter(table.values()))))
        if only_img_id:
            rows = where(rows, "img_id", lambda v: v != -1)
            rows = rows[_sort_order([table["img_id"][i] for i in rows])]

        rows_ori = where(rows, "guidance", lambda v: v == 100) if ori_proportion is not None else None

        if guidance is not None:
            rows = where(rows, "guidance", lambda v: v == guidance)
            if datalimit != -1 and len(rows) > datalimit:
                rows = _sample(rows, datalimit, seed)

        if ori_proportion is not None:
            num_ori = min(len(rows_ori), int(len(rows) / (1.0 - ori_proportion) * ori_proportion))
            rows = np.concatenate([rows, _sample(rows_ori, num_ori, seed)])

        if list_selection is not None:
            selected = set(list_selection)
            rows = where(rows, "label", lambda v: v in selected)

        def column(key: str) -> list:
            col = table[key]
            return [col[i] for i in rows]

        self.images = column(img_key)
        self.captions = column(caption_key)

        caption_cols = [c for c in table if caption_key in c]
        self.extra_captions = [column(f"{caption_key}_{k}") for k in range(1, len(caption_cols))]

        self.return_guidance = return_guidance
        self.guidance = column("guidance") if return_guidance else None
        self.return_img_id = return_img_id
        self.img_id = column("img_id") if return_img_id else None

        self.return_label = label_key is not None
        if self.return_label:
            self.labels = [int(v) for v in column(label_key)]
            self.paths = column("filepath")

        self.transform = transform
        self._rng = rng

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, idx: int) -> dict:
        return self.get(idx, np.random.default_rng(self._rng.integers(0, 2**63)))

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        path = str(self.images[idx])
        if not path.endswith(".npy") and hasattr(self.transform, "from_path"):
            # Native C++ decode+transform path (GIL-free end to end).
            image = self.transform.from_path(path, rng)
        elif path.endswith(".npy"):
            arr = np.load(path)
            if np.issubdtype(arr.dtype, np.floating):
                # torchvision ToPILImage semantics for float arrays: [0,1]
                # scales by 255 with a truncating byte cast
                # (`pic.mul(255).byte()`); a plain uint8 cast would
                # truncate [0,1] floats to black.
                arr = arr * 255
            arr = arr.astype(np.uint8)
            if hasattr(self.transform, "from_rgb"):
                image = self.transform.from_rgb(arr, rng)
            else:
                from PIL import Image

                image = self.transform(Image.fromarray(arr), rng)
        else:
            from PIL import Image

            image = self.transform(Image.open(path), rng)

        sample = {
            "image": image.astype(np.float32),
            "tokens": tokenize(str(self.captions[idx]))[0],
        }

        if self.extra_captions:
            stack = [tokenize(str(col[idx]))[0] for col in self.extra_captions]
            stack.append(sample["tokens"])
            stack = np.stack(stack, axis=0)
            sample["tokens_multi"] = stack[rng.permutation(stack.shape[0])]

        if self.return_label:
            sample["label"] = np.int32(self.labels[idx])
            sample["path"] = self.paths[idx]
        if self.return_guidance:
            sample["guidance"] = np.int32(self.guidance[idx])
        if self.return_img_id:
            sample["img_id"] = np.int64(self.img_id[idx])
        return sample
