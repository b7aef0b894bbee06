"""Profiling: a ``torch.profiler`` trace of a window of train steps, and
synchronised step timing.

Counterpart of ``flyp_tpu/utils/profiling.py`` without its MFU half
(``compiled_flops`` reads XLA's cost analysis, ``mfu`` a TPU peak table):

* :func:`trace` profiles a block into a Chrome trace under ``log_dir``;
* :class:`StepWindowTrace` is ``--profile_dir``'s window of steps;
* :class:`StepTimer` times steps, each ending in a host fetch of a scalar.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import profile

    prof = profile(activities=_activities())
    prof.start()
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
            from torch.profiler import profile

            try:
                prof = profile(activities=_activities())
                prof.start()
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


class StepTimer:
    """Synchronised step timing: ``timer.sync(scalar)`` fetches a scalar
    to the host (which waits for the step that made it), then records the
    interval since the previous call."""

    def __init__(self):
        self._last = None
        self.times: list = []

    def sync(self, scalar) -> float:
        value = float(scalar)
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now
        return value

    @property
    def mean(self) -> Optional[float]:
        return sum(self.times) / len(self.times) if self.times else None
