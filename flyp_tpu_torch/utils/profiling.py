"""Profiling: a ``torch.profiler`` trace of a window of train steps, the
program's spans, and the FLOP count and MFU.

Counterpart of ``flyp_tpu/utils/profiling.py``:

* :func:`trace` profiles a block into a Chrome trace under ``log_dir``;
* :class:`StepWindowTrace` is ``--profile_dir``'s window of steps;
* :func:`span` marks a phase of the train step or of a serving request,
  and :func:`span_log` returns what the spans recorded;
* :func:`compiled_flops` counts the products of one call, :func:`mfu`
  divides a rate by :func:`device_peak_flops`, the card's peak from
  :data:`PEAKS`.

Spans.  A span records only while a ``torch.profiler`` session runs (this
module's :func:`trace` and :class:`StepWindowTrace`, or any other), on
every thread: the profiler's process-wide flag decides, not its per-thread
state, so a request answered on a worker thread records too.  With no
session a span costs one read of that flag.  With one, a span enters a
``torch.profiler.record_function`` of its name (so the Chrome trace shows
it on the device trace's clock, wherever the profiler sees the thread)
and appends one record to a bounded in-memory log: name, span id, parent
span id (a per-thread stack), root id (shared by one step's or one
request's spans), thread, host start and end (``time.perf_counter_ns``),
attributes, and for a span given ``stream_of`` a CUDA tensor, a pair of
timing events on that device's current stream, resolved to ``device_ms``
when the log is read.  :func:`trace` and :class:`StepWindowTrace` clear the
log when they start and record every thread where the installed torch
offers it (``_ExperimentalConfig(profile_all_threads=True)``).

What the count is.  The port's kernels are bound through ``ctypes``, so
``torch.utils.flop_counter.FlopCounterMode`` cannot see into them.
:func:`compiled_flops` therefore runs the call once on the plain route
(``FLYP_ATTENTION_IMPL=xla``, every product a PyTorch op) under
``FlopCounterMode``: matrix products, convolutions and attention products
at ``2 M N K`` each, forward and (when the call runs one) backward.  Fed
``meta`` tensors, as :func:`clip_flops` and :func:`meta_twin` arrange, it
does no arithmetic, so a full-width model costs nothing to count.  Three
differences from the JAX package's count, all stated where a number is
reported:

* XLA's cost analysis also counts elementwise work (LayerNorm, softmax,
  GELU, the optimizer); this count has products only.
* JAX's analytic count of the fused-block kernel pads L to a multiple of
  16 (``tools/serving_bench.py::fwd_attn_flops``, ``pad=16``); this count
  takes the unpadded L, the work the model needs.
* A remat model's recomputed forward is not counted (:func:`meta_twin`
  builds the twin without remat): the fused routes recompute the MLP
  sub-block, the others whole blocks, so the count is the model's FLOPs
  and :func:`mfu` is model-FLOP utilisation whatever the route.

Every CLIP path the tools count runs on ``meta``: the towers, the
contrastive loss and its backward, the ResNet's BatchNorm.  A host step
(the tokenizer, ``.item()``, numpy) cannot, so callers count the model on
tensors they already hold, never through a host-side wrapper.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler


# Dense peaks of one card (NVIDIA data sheets, at the full power limit):
# bf16 and int8 tensor cores, fp32 CUDA cores, HBM bytes a second.
PEAKS = {
    "sxm": {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12, "bytes": 3.35e12},
    "pcie": {torch.bfloat16: 756e12, torch.int8: 1513e12, torch.float32: 51e12, "bytes": 2.0e12},
}


def card_peaks(name: str) -> dict:
    """The peak table of a card by its name (``nvidia-smi`` or
    ``torch.cuda.get_device_name``): the PCIe part's, else the SXM part's."""
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def device_peak_flops(device=None, dtype=torch.bfloat16) -> Optional[float]:
    """Peak dense FLOP/s of ``device``'s card in ``dtype`` (bf16, as the
    JAX table's), or None for a CPU: no peak is claimed for it, so an MFU
    there is not measured."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return None
    return card_peaks(torch.cuda.get_device_name(device))[dtype]


def mfu(step_flops: float, step_time_s: float, device=None) -> Optional[float]:
    """Model-FLOP utilisation: ``step_flops`` a ``step_time_s`` against the
    card's bf16 peak; None off the card."""
    peak = device_peak_flops(device)
    if peak is None:
        return None
    return step_flops / step_time_s / peak if step_time_s > 0 else 0.0


@contextlib.contextmanager
def plain_route():
    """``FLYP_ATTENTION_IMPL=xla`` for the block, the process's choice
    restored after it (the route is read once and cached)."""
    from flyp_tpu_torch.ops import attention

    before = os.environ.get(attention._IMPL_ENV)
    os.environ[attention._IMPL_ENV] = "xla"
    attention._default_impl.cache_clear()
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(attention._IMPL_ENV, None)
        else:
            os.environ[attention._IMPL_ENV] = before
        attention._default_impl.cache_clear()


def compiled_flops(fn, *args, **kwargs) -> float:
    """FLOPs of the products in one call of ``fn(*args, **kwargs)`` on the
    plain route (module docstring).  Pass ``meta`` (or CPU) tensors: the
    call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with plain_route(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def meta_twin(model):
    """A ``meta`` copy of a ``CLIPModel``'s structure (config, compute type,
    mode; remat off, module docstring): no storage, no arithmetic."""
    from flyp_tpu_torch.models.clip import CLIPModel

    with torch.device("meta"):
        twin = CLIPModel(model.config, model.compute_dtype)
    return twin.train(model.training)


def _meta(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else torch.empty(t.shape, dtype=t.dtype, device="meta")


def clip_flops(model, images=None, tokens=None, *, train: bool = False, head_classes: int = 0) -> float:
    """FLOPs of one call of ``model`` at these inputs' shapes, counted on
    a meta twin.  ``train``: the train step's forward in training mode, the
    contrastive loss and the backward to every parameter (the update is
    elementwise and counts nothing).  Else the eval forward of the towers
    given; ``head_classes`` adds the zero-shot head's product over the
    image features (``Classifier``'s and ``ClipServer``'s logits)."""
    from flyp_tpu_torch.ops.losses import clip_loss

    twin = meta_twin(model).train(train)
    images, tokens = _meta(images), _meta(tokens)

    def call():
        if train:
            img_f, txt_f, scale = twin(images, tokens)
            loss = clip_loss(img_f, txt_f, scale).mean()
            return torch.autograd.grad(loss, list(twin.parameters()))
        with torch.no_grad():
            out = twin(images, tokens)
            if head_classes:
                w = torch.empty((head_classes, model.config.embed_dim), device="meta")
                out = out.float() @ w.T
            return out

    return compiled_flops(call)


# Records the span log keeps; past this many the oldest drop, and
# ``span_log()["dropped"]`` counts them.
SPAN_LOG_CAP = 1 << 16


class _SpanLog:
    """The closed spans, bounded and thread-safe."""

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=cap)
        self.dropped = 0

    def append(self, s: "_Span") -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def snapshot(self):
        with self._lock:
            return list(self._spans), self.dropped


_LOG = _SpanLog(SPAN_LOG_CAP)
_SPAN_IDS = itertools.count(1)
_OPEN = threading.local()  # .spans: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()


class _Span:
    """One span while it is open, and its record once closed (module
    docstring)."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "thread", "start_ns", "end_ns", "_stream", "_events",
                 "_range")

    def __init__(self, name: str, root, stream_of: Optional[torch.Tensor], attrs: dict):
        self.name, self.root, self.attrs = name, root, attrs
        self._stream = self._events = None
        if stream_of is not None and stream_of.is_cuda:
            self._stream = torch.cuda.current_stream(stream_of.device)
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> "_Span":
        stack = getattr(_OPEN, "spans", None)
        if stack is None:
            stack = _OPEN.spans = []
        parent = stack[-1] if stack else None
        self.id = next(_SPAN_IDS)
        self.parent = parent.id if parent is not None else None
        if self.root is None:
            self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        self._range.__exit__(*exc)
        self._range = None
        _OPEN.spans.pop()
        _LOG.append(self)
        return False

    def record(self) -> dict:
        out = {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root, "thread": self.thread,
               "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": dict(self.attrs)}
        if self._events is not None:
            self._events[1].synchronize()
            out["device_ms"] = self._events[0].elapsed_time(self._events[1])
        return out


def spans_on() -> bool:
    """Whether spans record now: a profiler session runs in this process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, *, root=None, stream_of: Optional[torch.Tensor] = None, **attrs):
    """``with span(name, **attrs) as s:`` records the body as a span while a
    profiler session runs (module docstring); otherwise it does nothing,
    and ``s`` is None.  ``root``: the root id, else the enclosing span's,
    else the span's own id.  ``stream_of``: a tensor whose device, if a
    GPU, the span times with events on its current stream."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, root, stream_of, attrs)


def span_log() -> dict:
    """The span log as it stands: ``{"spans": [record, ...], "dropped":
    n}``, the records in the order the spans opened.  A span that timed a
    stream has ``device_ms``, read here once its end event has passed; the
    others have none."""
    spans, dropped = _LOG.snapshot()
    return {"spans": [s.record() for s in sorted(spans, key=lambda s: (s.start_ns, s.id))], "dropped": dropped}


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    """The trace as ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace
    format, viewable in Perfetto or chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _all_threads():
    """The profiler option that records every thread's ops and ranges, or
    None on a torch without it."""
    from torch.profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _start_profile():
    """A started ``torch.profiler`` session over every thread, with the
    span log cleared."""
    from torch.profiler import profile

    config = _all_threads()
    prof = profile(activities=_activities(), **({} if config is None else {"experimental_config": config}))
    _LOG.clear()
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into a Chrome trace under ``log_dir``; the span
    log holds the block's spans afterwards."""
    prof = _start_profile()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        _export(prof, log_dir)


class StepWindowTrace:
    """Trace a window of train steps.

    Steps are counted per invocation (so a resumed run can be profiled
    too); the trace starts before step ``start`` is launched (skipping the
    warm-up steps) and stops after ``n`` steps.  ``close()`` is idempotent
    and is called on every exit path of the trainer, the raising ones
    included, so the trace is always written.  Nothing happens when
    ``log_dir`` is falsy."""

    def __init__(self, log_dir: Optional[str], start: int = 10, n: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.stop_after = start + max(1, n)
        self._prof = None
        self.path: Optional[str] = None

    def step(self, i: int) -> None:
        """Call with the 0-based step counter before launching step i."""
        if not self.log_dir:
            return
        if self._prof is None and i == self.start:
            try:
                prof = _start_profile()
            except RuntimeError as e:  # a long run must not die for a trace
                logging.getLogger("flyp_tpu_torch").warning(f"profiler trace unavailable: {e}")
                self.log_dir = None
                return
            self._prof = prof
        elif self._prof is not None and i >= self.stop_after:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        _sync()  # the traced steps' device work finishes inside the window
        prof.stop()
        self.path = _export(prof, self.log_dir)
