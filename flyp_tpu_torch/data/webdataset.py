"""Tar-shard streaming pipeline (webdataset semantics).

Counterpart of ``flyp_tpu/data/webdataset.py``: the reference's LAION-style
pipeline without the ``webdataset`` package:

* brace-expanded shard lists (``{00000..00099}.tar``) with ``sizes.json`` /
  ``__len__`` sample-count discovery;
* deterministic epoch-seeded shard shuffle (detshuffle2) or
  with-replacement shard resampling (ResampledShards2);
* input sharding: shards split across processes (``process_index``) then
  across loader worker threads (``split_by_node``/``split_by_worker``);
* error-tolerant tar iteration: corrupt members/duplicate keys are logged
  and skipped, never fatal;
* grouped (image, caption) samples -> decode -> transform -> tokenize ->
  fixed-size batches with ``with_epoch`` accounting.

Workers are threads of one process, so ``set_epoch`` is plain state.  The
native transform decodes from the tar's bytes (``from_bytes``); Pillow is
imported only for the Python transforms.
"""

from __future__ import annotations

import io
import json
import logging
import os
import queue
import re
import tarfile
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np

from flyp_tpu_torch.tokenizer import tokenize

log = logging.getLogger("flyp_tpu_torch.data.webdataset")

_IMG_EXTS = ("jpg", "jpeg", "png", "webp", "ppm", "bmp")
_TXT_EXTS = ("txt", "text", "caption")


def braceexpand(pattern: str) -> List[str]:
    """Shell-style brace expansion, leftmost group first: ``{A..B}``
    (zero-padded ranges) and ``{a,b,c}`` alternates."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    body = m.group(1)
    range_m = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if range_m:
        lo, hi = range_m.group(1), range_m.group(2)
        alts = [str(i).zfill(len(lo)) for i in range(int(lo), int(hi) + 1)]
    elif "," in body:
        alts = body.split(",")
    else:
        return [pattern]
    out: List[str] = []
    for alt in alts:
        out.extend(braceexpand(pattern[: m.start()] + alt + pattern[m.end() :]))
    return out


def expand_urls(urls) -> List[str]:
    if isinstance(urls, str):
        out: List[str] = []
        for part in urls.split("::"):
            out.extend(braceexpand(part))
        return out
    return list(urls)


def get_dataset_size(shards) -> Optional[int]:
    """Sample count from sizes.json or __len__ next to the shards."""
    shards_list = expand_urls(shards)
    if not shards_list:
        return None
    dirname = os.path.dirname(shards_list[0])
    sizes_path = os.path.join(dirname, "sizes.json")
    len_path = os.path.join(dirname, "__len__")
    if os.path.exists(sizes_path):
        with open(sizes_path) as f:
            sizes = json.load(f)
        return sum(int(sizes[os.path.basename(s)]) for s in shards_list if os.path.basename(s) in sizes)
    if os.path.exists(len_path):
        with open(len_path) as f:
            return int(f.read())
    return None


def _iter_tar_samples(path: str):
    """Yield {ext: bytes} dicts grouped by key; tolerant of corrupt members
    and repeated keys."""
    try:
        tf = tarfile.open(path)
    except Exception as exc:
        log.warning("Handling webdataset error (%r). Ignoring shard %s.", exc, path)
        return
    current_key = None
    sample: dict = {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            if "." not in base:
                continue
            key, ext = base.split(".", 1)
            ext = ext.lower()
            try:
                data = tf.extractfile(member).read()
            except Exception as exc:
                log.warning("Handling webdataset error (%r). Ignoring member %s.", exc, member.name)
                continue
            if key != current_key:
                if sample and current_key is not None:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            if ext in sample:
                # duplicate extension within a key: start a fresh sample
                yield sample
                sample = {"__key__": key}
            sample[ext] = data
        if sample and current_key is not None:
            yield sample
    except Exception as exc:
        log.warning("Handling webdataset error (%r). Truncating shard %s.", exc, path)
    finally:
        tf.close()


def _decode(sample: dict, transform: Callable, rng: np.random.Generator) -> Optional[dict]:
    img_bytes = next((sample[e] for e in _IMG_EXTS if e in sample), None)
    txt_bytes = next((sample[e] for e in _TXT_EXTS if e in sample), None)
    if img_bytes is None or txt_bytes is None:
        return None
    try:
        if hasattr(transform, "from_bytes"):
            # Native C++ decode+transform (GIL-free), PIL fallback inside.
            image = transform.from_bytes(img_bytes, rng).astype(np.float32)
        else:
            from PIL import Image

            img = Image.open(io.BytesIO(img_bytes))
            image = transform(img, rng).astype(np.float32)
        caption = txt_bytes.decode("utf-8", errors="replace")
    except Exception as exc:
        log.warning("Handling webdataset error (%r). Ignoring sample %s.", exc, sample.get("__key__"))
        return None
    return {"image": image, "tokens": tokenize(caption)[0]}


def is_webdataset(path: str, dataset_type: str = "auto") -> bool:
    """The reference's get_dataset_fn dispatch rule: an explicit
    --dataset-type wins; 'auto' routes tar shards (or brace-expanded shard
    patterns) to the webdataset pipeline and everything else to CSV."""
    if dataset_type == "webdataset":
        return True
    if dataset_type == "csv":
        return False
    return path.split(".")[-1] == "tar" or "{" in path


class WebDatasetLoader:
    """Iterable of collated batches from tar shards."""

    def __init__(
        self,
        urls,
        transform: Callable,
        batch_size: int,
        num_samples: Optional[int] = None,
        resampled: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ):
        self.shards = expand_urls(urls)
        self.transform = transform
        self.batch_size = batch_size
        self.num_samples = num_samples if num_samples is not None else get_dataset_size(urls)
        if self.num_samples is None:
            raise RuntimeError(
                "Currently, number of dataset samples must be specified for training dataset. "
                "Please specify via `--train-num-samples` if no dataset length info present."
            )
        self.resampled = resampled
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_process = self.num_samples // self.process_count
        return per_process // self.batch_size if self.drop_last else -(-per_process // self.batch_size)

    def _epoch_shards(self) -> List[str]:
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.resampled:
            # with-replacement shard sampling (ResampledShards2).
            idx = rng.integers(0, len(self.shards), len(self.shards))
            shards = [self.shards[i] for i in idx]
        else:
            shards = list(self.shards)
            rng.shuffle(shards)
        # split_by_node
        split = shards[self.process_index :: self.process_count]
        if not split and shards:
            # More hosts than shards: the strided split would leave this
            # host with NOTHING — it would emit 0 batches while __len__
            # promises num_samples/process_count/batch_size, hanging every
            # other host's collective train step mid-epoch.  Duplicating a
            # shard across hosts beats a distributed hang.
            split = [shards[self.process_index % len(shards)]]
        return split

    def __iter__(self) -> Iterator[dict]:
        shards = self._epoch_shards()
        # Cap the decoded-sample buffer in BATCHES (plus a little per-worker
        # slack), not workers x batches: decoded 224px float images are
        # ~600KB each, and a workers-proportional cap pins gigabytes of host
        # RAM beyond the pipelining it buys.
        out_q: queue.Queue = queue.Queue(
            maxsize=2 * self.batch_size + 4 * max(self.num_workers, 1)
        )
        stop = threading.Event()
        n_workers = min(self.num_workers, max(len(shards), 1))

        def worker(wid: int):
            rng = np.random.default_rng([self.seed, self.epoch, wid])
            my_shards = shards[wid::n_workers]  # split_by_worker
            # Cycle the worker's shards until the main loop hits its quota
            # (wds `with_epoch` semantics): `num_samples`
            # is a TARGET, and on multi-host runs the strided shard split can
            # hand hosts unequal sample counts — an epoch that simply
            # exhausted the local shards would yield fewer batches on some
            # hosts and hang the other hosts' collective step mid-epoch.
            while not stop.is_set():
                produced = False
                for shard in my_shards:
                    for raw in _iter_tar_samples(shard):
                        if stop.is_set():
                            return
                        sample = _decode(raw, self.transform, rng)
                        if sample is not None:
                            produced = True
                            out_q.put(sample)
                if not my_shards or not produced:
                    break  # nothing decodable: exit instead of spinning
            out_q.put(None)  # worker done marker

        threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(n_workers)]
        for t in threads:
            t.start()

        target_batches = len(self)  # with_epoch accounting
        emitted = 0
        done_workers = 0
        batch: List[dict] = []
        try:
            while emitted < target_batches and done_workers < n_workers:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield {
                        "image": np.stack([s["image"] for s in batch]),
                        "tokens": np.stack([s["tokens"] for s in batch]),
                    }
                    emitted += 1
                    batch = []
            if batch and not self.drop_last and emitted < target_batches:
                yield {
                    "image": np.stack([s["image"] for s in batch]),
                    "tokens": np.stack([s["tokens"] for s in batch]),
                }
        finally:
            stop.set()
            # drain so workers blocked on put() can observe stop
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
