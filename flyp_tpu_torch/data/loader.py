"""Host-side batched loader with threaded decode, and the prefetch to the
card.

Counterpart of ``flyp_tpu/data/loader.py``.  A thread pool replaces torch's
worker processes: the native decode and transform release the GIL, so
threads use the host's cores without pickling.  :func:`prefetch_to_device`
keeps copies to the card ahead of the train step.

Determinism: shuffling is seeded per epoch (``seed + epoch``), and each
sample draws its augmentation RNG from a per-epoch SeedSequence keyed by
its dataset index, so a run is reproducible whatever the worker count.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from flyp_tpu_torch.parallel.comm import max_int
from flyp_tpu_torch.parallel.multihost import process_count, resolve_process
from flyp_tpu_torch.tokenizer import shrink_context


def _collate(samples: list) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[key] = vals  # file paths stay host-side lists
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or hasattr(vals[0], "dtype"):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterable over batches of collated numpy dicts.

    ``dataset`` must implement ``__len__`` and ``get(idx, rng)`` (or
    ``__getitem__``).  Call ``set_epoch`` before each epoch to advance the
    shuffle/augmentation streams.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        prefetch_batches: int = 4,
        process_index: int | None = None,
        process_count: int | None = None,
        shard_by_process: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        self.start_batch = 0
        # Every process computes the same seeded global order, then takes its
        # batch-block stride of it (see _epoch_order); the grid is resolved
        # at iteration time.  Eval loaders pass shard_by_process=False so
        # every process scores the full test set.
        self.process_index = process_index
        self.process_count = process_count
        self.shard_by_process = shard_by_process

    def _proc(self) -> tuple[int, int]:
        return resolve_process(self.process_index, self.process_count, self.shard_by_process)

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Advance the shuffle stream; ``start_batch`` fast-forwards the next
        iteration past its first k batches without decoding them (the epoch
        order is seeded, so batch k is the same bytes whether or not 0..k-1
        were materialized): the mid-epoch resume hook.  Reset to 0 by any
        later plain ``set_epoch`` call."""
        self.epoch = epoch
        self.start_batch = start_batch

    def __len__(self) -> int:
        _, count = self._proc()
        # An equal floor share on every process: collective train steps need
        # every process to run the same number of batches per epoch.
        n = len(self.dataset) // count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        rank, count = self._proc()
        if count > 1:
            if self.drop_last:
                # Batch-block striding: global step k's assembled batch is
                # order[k*count*B : (k+1)*count*B], the same contiguous slice
                # of the seeded global order a single-process loader yields,
                # so N-process and 1-process runs see the same global batches.
                block = count * self.batch_size
                usable = block * (len(order) // block)
                order = (
                    order[:usable]
                    .reshape(-1, count, self.batch_size)[:, rank, :]
                    .reshape(-1)
                )
            else:
                order = order[: count * (len(order) // count)][rank::count]
        return order

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._epoch_order()
        n_batches = len(self)
        ss = np.random.SeedSequence([self.seed, self.epoch])
        # Augmentation seeds are keyed by dataset index (not position in the
        # epoch order), so a sample's augmentation stream is identical under
        # any process/worker layout.
        sample_seeds = ss.generate_state(len(self.dataset), dtype=np.uint64)

        get = getattr(self.dataset, "get", None)

        def fetch(i: int):
            idx = int(order[i])
            if get is not None:
                return get(idx, np.random.default_rng(sample_seeds[idx]))
            return self.dataset[idx]

        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            window = self.prefetch_batches * self.batch_size
            futures: collections.deque = collections.deque()
            total = n_batches * self.batch_size if self.drop_last else len(order)
            submitted = 0

            def top_up():
                nonlocal submitted
                while submitted < total and len(futures) < window:
                    futures.append(pool.submit(fetch, submitted))
                    submitted += 1

            skip = min(self.start_batch, n_batches) * self.batch_size
            submitted = done = skip
            top_up()
            while done < total:
                batch = []
                take = min(self.batch_size, total - done)
                for _ in range(take):
                    batch.append(futures.popleft().result())
                    top_up()
                done += take
                yield _collate(batch)
        finally:
            # cancel_futures: consumers that abandon the iterator mid-epoch
            # must not block on a full prefetch window of queued decodes.
            pool.shutdown(wait=True, cancel_futures=True)


class _Slot:
    """One entry of the pinned ring: a staging buffer per (key, shape,
    dtype), allocated once, and the event of the slot's last copy."""

    def __init__(self):
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, key: str, shape, dtype: torch.dtype) -> torch.Tensor:
        spec = (key, tuple(shape), dtype)
        if spec not in self.buffers:
            self.buffers[spec] = torch.empty(spec[1], dtype=dtype, pin_memory=True)
            prefetch_to_device.pinned_allocations += 1
        return self.buffers[spec]


def prefetch_to_device(iterator, device, size: int = 2, image_dtype: Optional[torch.dtype] = None):
    """Move batches to ``device`` ahead of consumption: ``size`` batches are
    staged while the consumer holds the current one.

    Numeric arrays become tensors on ``device``; ``tokens`` are cut by
    ``shrink_context`` first, and float arrays cast to ``image_dtype`` (e.g.
    ``torch.bfloat16``, round to nearest even as ``ml_dtypes``) on the host,
    halving the bytes copied for bf16 training.  Non-array entries (paths)
    stay on the host.

    On a CUDA device each batch is written into pinned staging buffers
    allocated once per key, shape and dtype, in a ring of ``size + 1``
    slots, and copied with ``non_blocking=True`` on a stream of its own,
    which records an event per slot.  The consumer's stream waits on that
    event when the batch is handed over, and each device tensor is marked
    used on the consumer's stream (``record_stream``); a slot is refilled
    only after its last copy's event has completed.  On the CPU the same
    function returns plain CPU tensors.

    With several processes each one stages its own rows (the rows of the
    global batch its mesh position computes on, ``parallel/mesh.py::
    shard_batch``), and ``tokens`` get one width across them: each
    process's ``shrink_context`` bucket can differ, so the widest is taken
    over all ranks (an all-reduce MAX of a CPU tensor over
    ``parallel/comm.py::host_group``, one a batch, in the same order on
    every rank; no rank waits for its device) and narrower ones are padded
    with zeros, the pad id (the tower pools at the EOT, so the tail changes
    nothing), as ``flyp_tpu/data/loader.py`` does.
    """
    device = torch.device(device)
    synced = process_count() > 1
    cuda = device.type == "cuda"
    ring = [_Slot() for _ in range(size + 1)] if cuda else None
    copy_stream = torch.cuda.Stream(device) if cuda else None
    staged = 0

    def stage(batch):
        nonlocal staged
        out, host = {}, {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype.kind not in "USO":
                if k == "tokens":
                    v = shrink_context(v)
                    if synced:
                        width = max_int(v.shape[1])
                        if width > v.shape[1]:
                            v = np.pad(v, ((0, 0), (0, width - v.shape[1])))
                t = torch.from_numpy(np.ascontiguousarray(v))
                host[k] = (t, image_dtype if image_dtype is not None and t.is_floating_point() else t.dtype)
            else:
                out[k] = v
        if not cuda:
            out.update({k: t.to(device, dtype) for k, (t, dtype) in host.items()})
            return out, None
        slot = ring[staged % len(ring)]
        staged += 1
        if slot.event is not None:
            slot.event.synchronize()  # the slot's last copy has left its buffers
            prefetch_to_device.slot_refills += 1
        else:
            slot.event = torch.cuda.Event()
        for k, (t, dtype) in host.items():
            buf = slot.buffer(k, t.shape, dtype)
            buf.copy_(t)  # the host cast, into pinned memory
            with torch.cuda.stream(copy_stream):
                out[k] = buf.to(device, non_blocking=True)
        slot.event.record(copy_stream)
        return out, slot.event

    def hand_over(item):
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return out

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for _ in range(size):
        batch = next(it, None)
        if batch is None:
            break
        queue.append(stage(batch))
    while queue:
        nxt = queue.popleft()
        batch = next(it, None)
        if batch is not None:
            queue.append(stage(batch))
        yield hand_over(nxt)


# Pinned staging buffers allocated, and ring slots refilled, by every
# prefetch_to_device to a CUDA device in this process.
prefetch_to_device.pinned_allocations = 0
prefetch_to_device.slot_refills = 0
