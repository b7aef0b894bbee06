"""Trainer-facing CSV data plumbing: build train/eval loaders from
``cfg.ft_data`` / ``cfg.ft_data_test`` with curriculum parameters threaded
through.

Counterpart of ``flyp_tpu/data/csv_data.py``, with the same backend
dispatch: ``data_backend="native"`` takes the C++ decode and transform
(``native_decode.py``), every other backend the Pillow transforms.  Where
the JAX package quietly falls back to Pillow when the native library is
unavailable, the port raises the library's build error.
"""

from __future__ import annotations

from typing import Optional, Sequence

from flyp_tpu_torch.data.csv_dataset import CsvContrastiveDataset
from flyp_tpu_torch.data.loader import DataLoader
from flyp_tpu_torch.data.transforms import eval_transform, train_transform
from flyp_tpu_torch.parallel.multihost import local_batch_size


class CsvEvalData:
    """Wraps the eval CSV as a dataset object with a ``test_loader``, the
    shape the evaluation harness consumes."""

    def __init__(self, dataset: CsvContrastiveDataset, loader: DataLoader):
        self.dataset = dataset
        self.test_loader = loader


def get_csv_loader(
    cfg,
    is_train: bool,
    image_size: int = 224,
    guidance: Optional[int] = None,
    list_selection: Optional[Sequence[int]] = None,
    ori_proportion: Optional[float] = None,
    return_guidance: bool = False,
    return_img_id: bool = False,
    only_img_id: bool = False,
    preprocess=None,
    shard_by_process: bool = True,
):
    """``shard_by_process=False`` requests a replicated loader even for
    train: consumers that never assemble a global batch must see identical
    full batches on every process."""
    input_filename = cfg.ft_data if is_train else cfg.ft_data_test
    if not input_filename:
        raise ValueError("ft_data / ft_data_test must be set")

    # Train rows are unlabeled unless --get_labeled_csv; eval rows always
    # carry labels.
    label_key = "label" if (not is_train or cfg.get_labeled_csv) else None

    transform = preprocess
    if transform is None and getattr(cfg, "data_backend", "") == "native":
        from flyp_tpu_torch.data import native_decode

        transform = (native_decode.native_train_transform(image_size) if is_train
                     else native_decode.native_eval_transform(image_size))
    if transform is None:
        transform = train_transform(image_size) if is_train else eval_transform(image_size)
    dataset = CsvContrastiveDataset(
        input_filename,
        transform,
        img_key=cfg.csv_img_key,
        caption_key=cfg.csv_caption_key,
        sep=cfg.csv_separator,
        label_key=label_key,
        guidance=guidance,
        datalimit=cfg.datalimit if is_train else -1,
        list_selection=list_selection,
        ori_proportion=ori_proportion,
        return_guidance=return_guidance,
        return_img_id=return_img_id,
        only_img_id=only_img_id,
        seed=cfg.seed,
    )
    sharded = is_train and shard_by_process
    loader = DataLoader(
        dataset,
        # cfg.batch_size is the global batch: sharded train loaders each
        # yield their process's slice; replicated loaders the full batch.
        batch_size=local_batch_size(cfg.batch_size) if sharded else cfg.batch_size,
        shuffle=is_train,
        # Static shapes for the train step: trailing ragged train batches are
        # dropped (eval keeps them).
        drop_last=is_train,
        num_workers=cfg.workers,
        seed=cfg.seed,
        shard_by_process=sharded,
    )
    if is_train:
        return loader
    return CsvEvalData(dataset, loader)
