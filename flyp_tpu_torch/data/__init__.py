"""Host-side data: the input pipeline of training (CSV and tar-shard
loaders, the native decoder, the prefetch to the card), eval preprocessing,
the evaluation suites (``datasets``, ``registry``) and packaged class names
and metadata."""

from .transforms import train_transform, eval_transform, CLIP_MEAN, CLIP_STD
from .csv_dataset import CsvContrastiveDataset
from .loader import DataLoader, prefetch_to_device

__all__ = [
    "train_transform",
    "eval_transform",
    "CLIP_MEAN",
    "CLIP_STD",
    "CsvContrastiveDataset",
    "DataLoader",
    "prefetch_to_device",
]
