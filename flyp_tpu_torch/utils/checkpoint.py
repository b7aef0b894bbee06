"""Checkpoints: params, the AdamW state and the trainer's cursors, in a
torch-native format.

Counterpart of ``flyp_tpu/utils/checkpoint.py``, which writes orbax
directories.  A checkpoint here is a directory of files that
``torch.load(..., weights_only=True)`` reads, each a flat dict of tensors:

* ``params.pt``: the model's parameters (the port's parameter names);
* ``opt_state.pt`` (trainer checkpoints): ``count`` and ``mu/<name>``,
  ``nu/<name>`` for every parameter, each moment in its own dtype, so bf16
  moments round-trip bit for bit;
* ``batch_stats.pt``: a ModifiedResNet's BatchNorm running statistics (the
  model's buffers, ``visual.layer1_0.bn1.mean`` ...), empty for the ViT
  towers; a bare ``save_params`` of a model without buffers has none;
* ``meta.json``: the kind (``trainer`` or ``params``), the format version,
  the step, the curriculum cursor, the optional mid-epoch cursor and the
  optional trainer host state (a JSON string, as JAX encodes it).

Loading a model reads ``params.pt`` and ``batch_stats.pt``, never the moments.  Writes are
atomic: the files go into a temporary sibling directory whose name no
checkpoint scan parses (``<name>.tmp-<pid>-<n>``), which is then renamed into
place.  ``async_save=True`` stages a host copy of every tensor (a copy even on
the CPU, where the next step updates the parameters and moments in place)
and commits on a background thread; the next save, every restore and
:func:`wait_for_saves` wait for that commit first.

On a mesh (``parallel/``) a save is collective: every rank calls
:func:`save_checkpoint`, the tensor-parallel and FSDP shards are gathered
to their full shapes (the counterpart of the JAX trainer's
``_global_host_state``), and rank 0 alone writes, so a checkpoint's files
are those of a single-process run.  A restore reads the full tensors on
every rank and cuts them to the running layout (``TrainState.layout``), so
the same layout resumes bit for bit.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
PARAMS_FILE, OPT_FILE, STATS_FILE, META_FILE = "params.pt", "opt_state.pt", "batch_stats.pt", "meta.json"
ORBAX_MARKER = "_CHECKPOINT_METADATA"


@dataclasses.dataclass
class CurriculumCursor:
    epoch: int = 0
    cur_guidance: Optional[int] = None
    cur_str_times: int = 1
    cur_guidance_id: int = 0

    def to_dict(self) -> Dict[str, Any]:
        # None encodes as -1, as in the JAX package's numeric leaves.
        d = dataclasses.asdict(self)
        d["cur_guidance"] = -1 if d["cur_guidance"] is None else d["cur_guidance"]
        return {k: int(v) for k, v in d.items()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CurriculumCursor":
        out = {k: int(v) for k, v in d.items()}
        if out["cur_guidance"] == -1:
            out["cur_guidance"] = None
        return cls(**out)


@dataclasses.dataclass
class StepCursor:
    """Mid-epoch position for an exact resume from a step checkpoint: the
    loader's epoch order is seeded and its augmentation keyed by dataset
    index, so "skip the first k batches of pass p" reproduces the rest of
    the stream."""

    step_in_epoch: int = -1  # last completed step i within the epoch
    data_pass: int = 0  # the loader's shuffle-stream counter
    batch_in_pass: int = 0  # batches already consumed from the current pass
    id_flyp_loss_sum: float = 0.0  # epoch-partial loss sum (for stats.tsv)
    proportion: float = -1.0  # active loader's ori_proportion (-1: None)

    def to_dict(self) -> Dict[str, Any]:
        return {k: float(v) if isinstance(v, float) else int(v) for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StepCursor":
        return cls(**{f.name: float(d[f.name]) if f.type == "float" else int(d[f.name])
                      for f in dataclasses.fields(cls)})


def _encode_host_state(blob: Dict[str, Any]) -> np.ndarray:
    """The trainer's host state (last_perform, the exploration RNG's state,
    loss_pairs, progress moving averages) as JSON bytes, the JAX package's
    encoding: Python's json writes PCG64's 128-bit integers losslessly."""
    s = json.dumps(blob, default=lambda o: o.item() if hasattr(o, "item") else float(o))
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8).copy()


def _decode_host_state(arr) -> Dict[str, Any]:
    return json.loads(np.asarray(arr).tobytes().decode("utf-8"))


def _write_checkpoint_dir(path: str, files: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write ``files`` (name -> dict of host tensors) and ``meta.json`` into
    a temporary sibling of ``path``, then rename it into place (replacing
    an older checkpoint of that name).  A failure leaves nothing under
    ``path``'s name."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{next(_tmp_ids)}"
    try:
        os.makedirs(tmp)
        for name, tensors in files.items():
            torch.save(tensors, os.path.join(tmp, name))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            old = f"{path}.old-{os.getpid()}-{next(_tmp_ids)}"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


_tmp_ids = itertools.count()


class _Committer:
    """One background thread that commits staged checkpoints in order; a
    commit's error is raised by the next :meth:`wait`."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    def submit(self, path: str, files: Dict[str, Any], meta: Dict[str, Any]) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
            # The module's writer is looked up at commit time (so a caller may
            # wrap it, e.g. to time the commit).
            self._pending = self._pool.submit(lambda: _write_checkpoint_dir(path, files, meta))

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()


_committer = _Committer()


def wait_for_saves() -> None:
    """Block until the pending asynchronous commit (if any) is on disk, and
    raise its error if it failed."""
    _committer.wait()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that no later in-place update can reach: ``.cpu()`` of
    a CPU tensor is the tensor itself, so copy explicitly (a blocking copy
    from the card, complete when this returns)."""
    return t.detach().to("cpu", copy=True)


def _refuse_orbax(path: str) -> None:
    if os.path.exists(os.path.join(path, ORBAX_MARKER)):
        raise ValueError(
            f"{path!r} is an orbax checkpoint of the JAX package, which this package does not read: "
            "export its params with tools/export_checkpoint.py to a torch .pt (OpenAI layout), and load "
            "that with --clip_load")


def read_meta(path: str) -> Dict[str, Any]:
    """``meta.json`` of the checkpoint directory ``path``."""
    _refuse_orbax(path)
    meta_path = os.path.join(path, META_FILE)
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path!r} is not a checkpoint directory of this package (no {META_FILE})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path!r}: checkpoint format {meta.get('format')!r}, this package reads {FORMAT_VERSION}")
    return meta


def load_tensors(path: str, name: str = PARAMS_FILE, mmap: bool = False) -> Dict[str, torch.Tensor]:
    """One file of a checkpoint directory as a dict of CPU tensors;
    ``mmap=True`` maps it without reading the data (shapes only)."""
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True, mmap=mmap)


def _layout(state) -> dict:
    """``state.layout``; a state without one (a single process) holds whole
    tensors."""
    return getattr(state, "layout", None) or {}


def _shards(state):
    return getattr(state, "shards", None)


def _full_shape(state, name: str, local_shape) -> tuple:
    """The whole shape of parameter ``name`` whose piece on this rank has
    ``local_shape``."""
    if name not in _layout(state):
        return tuple(local_shape)
    if _shards(state) is not None:
        return tuple(state.full_shapes[name])
    axis, dim = state.layout[name]
    shape = list(local_shape)
    shape[dim] *= state.mesh.shape[axis]
    return tuple(shape)


def _local_sources(state):
    """(name, parameter piece, mu, nu) on this rank, in parameter order."""
    named = list(state.model.named_parameters())
    opt = state.opt_state
    pieces = _shards(state) if _shards(state) is not None else [p for _, p in named]
    return [(name, piece, m, v) for (name, _), piece, m, v in zip(named, pieces, opt.mu, opt.nu)]


def gather_state(state) -> tuple:
    """``(params, mu, nu)``: name -> the whole tensor on this rank's device,
    the shards of a mesh layout gathered over their axes.  Collective on a
    mesh: every rank calls it."""
    from flyp_tpu_torch.parallel.comm import all_gather

    params, mu, nu = {}, {}, {}
    for name, piece, m, v in _local_sources(state):
        if name in _layout(state):
            axis, dim = state.layout[name]
            group = state.mesh.group(axis)
            piece, m, v = (all_gather(t.detach(), group, dim=dim) for t in (piece, m, v))
        params[name], mu[name], nu[name] = piece.detach(), m, v
    return params, mu, nu


def save_checkpoint(
    path: str,
    state,
    cursor: Optional[CurriculumCursor] = None,
    async_save: bool = False,
    mid: Optional[StepCursor] = None,
    host: Optional[Dict[str, Any]] = None,
) -> str:
    """Save a ``TrainState`` (and the trainer's cursors) to the directory
    ``path``.

    ``mid`` marks a mid-epoch (step) checkpoint, restored with
    ``restore_checkpoint(..., mid=True)``; ``host`` adds the trainer's host
    state.  ``async_save=True`` returns once every tensor is copied to the
    host, and commits on a background thread.  On a mesh every rank calls
    it (the shards are gathered) and rank 0 alone writes."""
    from flyp_tpu_torch.parallel.multihost import is_primary

    path = os.path.abspath(path)
    wait_for_saves()  # commits land in order; the previous one is on disk first
    params, mu, nu = gather_state(state)
    if not is_primary():
        return path
    opt = state.opt_state
    opt_tensors = {"count": _host_copy(opt.count)}
    for name in params:
        opt_tensors[f"mu/{name}"] = _host_copy(mu[name])
        opt_tensors[f"nu/{name}"] = _host_copy(nu[name])
    files = {
        PARAMS_FILE: {k: _host_copy(t) for k, t in params.items()},
        OPT_FILE: opt_tensors,
        STATS_FILE: {k: _host_copy(t) for k, t in state.model.named_buffers()},
    }
    meta = {"kind": "trainer", "format": FORMAT_VERSION, "step": int(state.step),
            "cursor": (cursor or CurriculumCursor()).to_dict()}
    if mid is not None:
        meta["mid"] = mid.to_dict()
    if host is not None:
        meta["host_state"] = _encode_host_state(host).tobytes().decode("utf-8")
    if async_save:
        _committer.submit(path, files, meta)
    else:
        _write_checkpoint_dir(path, files, meta)
    return path


def _check_names(path: str, what: str, saved: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]) -> None:
    """Refuse a checkpoint whose tensor names or shapes differ from ``want``'s,
    naming the leaves."""
    if set(saved) != set(want):
        missing, extra = sorted(set(want) - set(saved)), sorted(set(saved) - set(want))
        raise ValueError(f"checkpoint at {path}: {what} names differ (missing {missing[:5]}, unexpected {extra[:5]})")
    bad = [f"{k}: saved {tuple(saved[k].shape)} vs model {tuple(want[k].shape)}"
           for k in want if tuple(saved[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"checkpoint at {path}: {what} shapes differ: " + "; ".join(bad[:5]))


@torch.no_grad()
def restore_checkpoint(path: str, state, mid: bool = False, host: bool = False):
    """Restore the checkpoint at ``path`` into ``state`` in place (the
    parameters and running statistics into its model, the moments and count
    into its AdamW state, each keeping its device and dtype).  On a mesh
    each rank takes its pieces of the whole tensors (``state.layout``).

    Returns ``(state, cursor)``, or ``(state, cursor, step_cursor)`` with
    ``mid=True``; ``host=True`` appends the decoded host state, or None when
    the checkpoint has none."""
    wait_for_saves()  # a just-written path must be committed first
    path = os.path.abspath(path)
    meta = read_meta(path)
    if meta["kind"] != "trainer":
        raise ValueError(f"{path!r} holds bare params (save_params), not a trainer checkpoint")
    if mid and "mid" not in meta:
        raise ValueError(f"{path!r} is an epoch checkpoint; it has no mid-epoch cursor")
    model = state.model
    params, stats = load_tensors(path), load_tensors(path, STATS_FILE)
    sources = _local_sources(state)
    full = {name: torch.empty(_full_shape(state, name, piece.shape), device="meta") for name, piece, _, _ in sources}
    _check_names(path, "parameter", params, full)
    _check_names(path, "running statistics", stats, dict(model.named_buffers()))
    opt_saved = load_tensors(path, OPT_FILE)
    for name, _, m, v in sources:
        for kind, dst in (("mu", m), ("nu", v)):
            src = opt_saved.get(f"{kind}/{name}")
            if src is None or tuple(src.shape) != tuple(full[name].shape) or src.dtype != dst.dtype:
                got = None if src is None else (tuple(src.shape), src.dtype)
                raise ValueError(f"checkpoint at {path}: moment {kind}/{name} is {got}, the optimizer holds "
                                 f"{(tuple(full[name].shape), dst.dtype)}")

    def piece_of(name, t):
        if name not in _layout(state):
            return t
        from flyp_tpu_torch.parallel.tp import take_shard

        axis, dim = state.layout[name]
        return take_shard(t, dim, state.mesh.shape[axis], state.mesh.coords()[axis])

    for name, piece, m, v in sources:
        piece.data.copy_(piece_of(name, params[name]))
        m.copy_(piece_of(name, opt_saved[f"mu/{name}"]))
        v.copy_(piece_of(name, opt_saved[f"nu/{name}"]))
    for name, buf in model.named_buffers():
        buf.copy_(stats[name])
    if _shards(state) is not None:
        state.materialized = False  # the model's whole parameters are stale
    state.opt_state.count.copy_(opt_saved["count"])
    state.step = int(meta["step"])
    out = [state, CurriculumCursor.from_dict(meta["cursor"])]
    if mid:
        out.append(StepCursor.from_dict(meta["mid"]))
    if host:
        blob = meta.get("host_state")
        out.append(None if blob is None else _decode_host_state(np.frombuffer(blob.encode("utf-8"), np.uint8)))
    return tuple(out)


def _split_state(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """A module's parameters and running statistics as the files that hold
    them (no statistics file for a module without buffers); a dict is all
    parameters."""
    if not isinstance(params, torch.nn.Module):
        return {PARAMS_FILE: dict(params)}
    files = {PARAMS_FILE: dict(params.named_parameters())}
    stats = dict(params.named_buffers())
    if stats:
        files[STATS_FILE] = stats
    return files


def save_params(path: str, params) -> str:
    """Save a bare parameter dict, or a module's parameters and (if it has
    any) running statistics: the zero-shot head's export."""
    path = os.path.abspath(path)
    wait_for_saves()
    files = {name: {k: _host_copy(torch.as_tensor(t)) for k, t in tensors.items()}
             for name, tensors in _split_state(params).items()}
    _write_checkpoint_dir(path, files, {"kind": "params", "format": FORMAT_VERSION})
    return path


def restore_params(path: str, template=None) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint directory (bare params or a trainer
    checkpoint's params) with its running statistics, if it holds any: a
    module's whole state dict.  With ``template`` (a dict or a module), the
    names and shapes must match it, the statistics those of the module's
    buffers."""
    wait_for_saves()
    path = os.path.abspath(path)
    read_meta(path)
    files = {PARAMS_FILE: load_tensors(path)}
    if os.path.isfile(os.path.join(path, STATS_FILE)):
        files[STATS_FILE] = load_tensors(path, STATS_FILE)
    if template is not None:
        want = _split_state(template)
        for name, what in ((PARAMS_FILE, "parameter"), (STATS_FILE, "running statistics")):
            _check_names(path, what, files.get(name, {}),
                         {k: torch.as_tensor(v) for k, v in want.get(name, {}).items()})
    return {k: v for tensors in files.values() for k, v in tensors.items()}
