"""The ``program_span`` readers on synthetic span logs: the means of device
ms and medians of host ms they take, and None outside a traced run of their
kind, without spans, or where the spans carry no device interval."""

import pytest

from benchmark import harness
from benchmark.yardstick import spans

STEP = ["step", "step.forward", "step.backward", "step.update"]
TRAIN = {"kind": "train", "trace": {}}
SERVE = {"kind": "serve", "trace": {}}


def _span(name, root, start_ms, host_ms, device_ms=None, id_=None):
    s = {"name": name, "id": id_, "parent": None, "root": root, "thread": 1,
         "start_ns": int(start_ms * 1e6), "end_ns": int((start_ms + host_ms) * 1e6), "attrs": {}}
    if device_ms is not None:
        s["device_ms"] = device_ms
    return s


def _steps(device=True):
    out = []
    for n, times in enumerate([(400.0, 100.0, 200.0, 10.0), (400.0, 110.0, 220.0, 12.0), (400.0, 120.0, 240.0, 14.0)]):
        out += [_span(name, n, i, 1, t if device else None) for i, (name, t) in enumerate(zip(STEP, times))]
    return out


def _requests():
    """Three requests, prep 3+2+1, 6+1+1 and 2+0.5+0.5 host ms (median 6);
    four forwards, launches 4, 5, 9, 1 ms (median 4.5) after lock waits 0,
    30, 10, 0 ms (median 5)."""
    out = []
    for root, (cast, pad, h2d), chunks in [(1, (3, 2, 1), [(4, 0)]), (2, (6, 1, 1), [(5, 30), (9, 10)]),
                                            (3, (2, 0.5, 0.5), [(1, 0)])]:
        out += [_span("serve.request", root, 0, 50), _span("serve.cast", root, 0, cast)]
        for launch, wait in chunks:
            out += [_span("serve.pad", root, 10, pad / len(chunks)), _span("serve.h2d", root, 11, h2d / len(chunks)),
                    _span("serve.lock_wait", root, 12, wait), _span("serve.forward", root, 13, launch, 2.0),
                    _span("serve.d2h", root, 14, 7)]
    return out


@pytest.fixture
def log(monkeypatch):
    held = {"spans": None}
    monkeypatch.setattr(spans, "program_spans", lambda: held["spans"])
    return held


@pytest.mark.parametrize("name,want", [("fwd_ms.train", 110.0), ("bwd_ms.train", 220.0), ("update_ms.train", 12.0)])
def test_train_readers_take_the_mean_device_ms(log, name, want):
    log["spans"] = _steps()
    assert harness.read_metric(name, TRAIN) == pytest.approx(want)
    assert harness.read_metric(name, {"kind": "train"}) is None  # untraced
    assert harness.read_metric(name, SERVE) is None
    log["spans"] = _steps(device=False)  # a host-only run: no device number
    assert harness.read_metric(name, TRAIN) is None
    log["spans"] = None  # a program without spans
    assert harness.read_metric(name, TRAIN) is None
    log["spans"] = []
    assert harness.read_metric(name, TRAIN) is None


@pytest.mark.parametrize("name,want", [("prep_ms.serve", 6.0), ("launch_ms.serve", 4.5),
                                       ("lock_wait_ms.serve", 5.0)])
def test_serve_readers_take_medians_of_host_ms(log, name, want):
    log["spans"] = _requests()
    assert harness.read_metric(name, SERVE) == pytest.approx(want)
    assert harness.read_metric(name, {"kind": "serve"}) is None
    assert harness.read_metric(name, TRAIN) is None
    log["spans"] = None
    assert harness.read_metric(name, SERVE) is None
    log["spans"] = _steps()
    assert harness.read_metric(name, SERVE) is None


def test_a_request_without_prep_spans_counts_zero():
    log = [_span("serve.request", 1, 0, 5), _span("serve.request", 2, 0, 5), _span("serve.cast", 2, 0, 3),
           _span("serve.request", 3, 0, 5), _span("serve.cast", 3, 0, 8), _span("serve.cast", None, 0, 99)]
    assert spans.median_request_ms(log, ("serve.cast",)) == pytest.approx(3.0)


def test_program_spans_reads_the_programs_log(monkeypatch):
    from flyp_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_log", lambda: {"spans": [{"name": "x"}], "dropped": 0}, raising=False)
    assert spans.program_spans() == [{"name": "x"}]
    monkeypatch.delattr(profiling, "span_log")  # a program from before the spans
    assert spans.program_spans() is None
