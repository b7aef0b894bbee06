"""The program's own spans of a traced run: the log that
``flyp_tpu_torch/utils/profiling.py::span`` keeps while a profiler session
runs, here the traced sub-window, the run's only session.  The
``program_span`` readers (``benchmark/metrics/``) reduce it with these:
mean device ms by span name, median host ms by span or by request.  Each
returns None where the run recorded nothing for it, as a program without
spans does."""

from __future__ import annotations

import statistics
from typing import Optional


def program_spans() -> Optional[list]:
    """The program's span records in the order they opened, or None where
    the program keeps no spans."""
    from flyp_tpu_torch.utils import profiling

    read = getattr(profiling, "span_log", None)
    return None if read is None else read()["spans"]


def host_ms(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) / 1e6


def mean_device_ms(spans, name: str) -> Optional[float]:
    """The mean device ms of the spans named ``name``; None where there are
    none or one has no device interval (a host-only run)."""
    found = [s for s in spans or () if s["name"] == name]
    if not found or any("device_ms" not in s for s in found):
        return None
    return sum(s["device_ms"] for s in found) / len(found)


def median_host_ms(spans, name: str) -> Optional[float]:
    """The median host ms of the spans named ``name``."""
    found = [host_ms(s) for s in spans or () if s["name"] == name]
    return statistics.median(found) if found else None


def median_request_ms(spans, names) -> Optional[float]:
    """Over the requests (the roots of ``serve.request`` spans), the median
    of the host ms that each request's spans named in ``names`` took
    together."""
    per = {s["root"]: 0.0 for s in spans or () if s["name"] == "serve.request"}
    for s in spans or ():
        if s["name"] in names and s["root"] in per:
            per[s["root"]] += host_ms(s)
    return statistics.median(per.values()) if per else None
