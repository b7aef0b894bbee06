"""A profiled sub-window of a run, reduced to what the per-layer metrics
read: device intervals (kernels, copies, sets) by name, busy time as the
union of those intervals, the longest idle gaps named by the innermost host
op running at their middle, and the host's window around it."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LONGEST_GAPS = 200  # the idle gaps named by host op: the longest this many


class Window:
    """``with Window() as w:`` profiles its body with CPU and CUDA
    activities; the body's device work is finished inside it.  Afterwards
    ``w.window_s`` is the host's length of the body and :meth:`reduce` the
    trace's contents."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return False

    def reduce(self, device_index: int = 0) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events, self.window_s, device_index)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, window_s: float, device_index: int = 0) -> dict:
    """The trace's device intervals on ``device_index`` and host ops, with
    times in seconds; see the module docstring."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            if int(e.get("args", {}).get("device", device_index)) == device_index:
                dev.append((e.get("name", ""), float(e["ts"]), float(e["dur"]), cat))
        elif cat in HOST_CATS:
            host.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
    busy = _union([(ts, ts + dur) for _, ts, dur, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for name, _, dur, _ in dev:
        by_name[name] += dur / 1e6
    gaps = defaultdict(float)
    longest = sorted(((start - end, end, start) for (_, end), (start, _) in zip(busy, busy[1:])), reverse=True)
    for length, end, start in longest[:LONGEST_GAPS]:
        gaps[_host_at((end + start) / 2, host)] += length / 1e6
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernels": [(name, dur / 1e6) for name, _, dur, cat in dev if cat == "kernel"],
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
    }


def _host_at(t_us: float, host) -> str:
    """The innermost host op running at ``t_us``, or "(no host op)"."""
    best = None
    for name, ts, dur in host:
        if ts <= t_us <= ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "(no host op)"


def breakdown(t: dict) -> dict:
    """A reduced trace's ten longest device operations and idle gaps by
    host op: the result line's ``breakdown``."""
    return {"device_ops": [[name[:200], s] for name, s in t["device_ops"][:10]],
            "idle_gaps": [[name[:200], s] for name, s in t["idle_gaps"][:10]]}
