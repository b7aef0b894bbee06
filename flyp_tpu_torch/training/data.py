"""The FLYP trainer's data dispatch, taken out of the trainer.

Counterpart of the data half of ``flyp_tpu/training/flyp.py::flyp_train``:
which loader an epoch reads (:func:`train_loader`), the copy of its batches
to the card (:func:`device_iter`), and the check that step checkpoints can
resume exactly (:func:`check_resumable`).  The trainer
(``training/flyp.py``) calls these.

``--data_backend tfdata`` and ``grain`` are refused by name: the JAX
package reads CSV through ``tf.data`` or Grain there, with their own data
order, and mapping them onto the threaded loader would silently change the
batches a JAX run of the same command sees.  ``threads`` and ``native``
cover CSV input.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from flyp_tpu_torch.data.csv_data import get_csv_loader
from flyp_tpu_torch.data.loader import prefetch_to_device
from flyp_tpu_torch.data.webdataset import WebDatasetLoader, is_webdataset
from flyp_tpu_torch.parallel.multihost import input_shard_grid, local_batch_size

REFUSED_BACKENDS = ("tfdata", "grain")


def train_loader(cfg, image_size: int, guidance: Optional[int] = None, proportion: Optional[float] = None,
                 list_classes: Optional[Sequence[int]] = None, return_img_id: bool = False):
    """The loader of one training epoch: tar shards (``--ft_data`` a
    ``.tar`` or a brace pattern, or ``--dataset-type webdataset``) through
    :class:`WebDatasetLoader`, else the CSV through ``get_csv_loader`` with
    the curriculum's guidance, proportion and class filter.

    Port of the closure ``load_train_loader`` of
    ``flyp_tpu/training/flyp.py`` (:319-369), without its logging.
    """
    backend = getattr(cfg, "data_backend", "threads")
    if is_webdataset(cfg.ft_data, cfg.dataset_type):
        # guidance/curriculum semantics are CSV-only, as upstream.
        from flyp_tpu_torch.data.transforms import train_transform

        transform = train_transform(image_size)
        if backend == "native":
            from flyp_tpu_torch.data import native_decode

            transform = native_decode.native_train_transform(image_size)
        grid_rank, grid_count = input_shard_grid()
        return WebDatasetLoader(
            cfg.ft_data,
            transform,
            local_batch_size(cfg.batch_size),
            num_samples=cfg.train_num_samples,
            seed=cfg.seed,
            num_workers=cfg.workers,
            process_index=grid_rank,
            process_count=grid_count,
        )
    if backend in REFUSED_BACKENDS:
        raise ValueError(
            f"--data_backend {backend} is not ported: the threads and native backends cover CSV input "
            "(mapping it onto the threaded loader would change the data order a JAX run sees)")
    return get_csv_loader(
        cfg, is_train=True, image_size=image_size,
        guidance=guidance, list_selection=list_classes, ori_proportion=proportion,
        return_img_id=return_img_id,
    )


def device_iter(loader, device, compute_dtype: str) -> Iterator[dict]:
    """Batches of ``loader`` on ``device``, two staged ahead, images cast to
    bf16 on the host when the model computes in bf16 (half the bytes).

    Port of ``device_iter`` in ``flyp_tpu/training/flyp.py`` (:371-374)
    with its ``image_dtype`` rule (:315-317).
    """
    image_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
    return iter(prefetch_to_device(loader, device, size=2, image_dtype=image_dtype))


def check_resumable(cfg) -> None:
    """Step checkpoints (``--save_every_n_steps``/``--max_steps``) promise
    an exact resumed trajectory, which needs a batch-level fast-forward of a
    seeded order (``DataLoader.set_epoch(start_batch)``); tar streams and
    tf.data cannot replay "the rest of pass p" exactly.

    Port of the check in ``flyp_tpu/training/flyp.py`` (:296-313).
    """
    if cfg.save_every_n_steps or cfg.max_steps:
        if getattr(cfg, "data_backend", "threads") == "tfdata" or is_webdataset(cfg.ft_data, cfg.dataset_type):
            raise ValueError(
                "--save_every_n_steps/--max_steps need the threads/native "
                "CSV backends (deterministic mid-epoch fast-forward); "
                f"data_backend={cfg.data_backend!r} or webdataset streams are unsupported"
            )
