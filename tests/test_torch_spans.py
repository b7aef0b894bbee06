"""The port's spans (``flyp_tpu_torch/utils/profiling.py::span``) on the
CPU: nothing recorded and no profiler range entered without a profiler
session; under one, the train step's and each serving request's spans with
their parents and shared ids, on every thread; the same numbers either way;
the bounded log; and ``trace()`` recording a worker thread's span."""

import copy
import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flyp_tpu_torch.models import CLIPModel, pinned_mode
from flyp_tpu_torch.models.configs import CLIPConfig, TextConfig, VisionConfig
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.serving import ClipServer
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
from flyp_tpu_torch.utils import profiling

STEP = ["step", "step.forward", "step.backward", "step.update"]
CHUNK = ["serve.pad", "serve.h2d", "serve.lock_wait", "serve.forward", "serve.d2h"]


@pytest.fixture(autouse=True)
def _fresh_log():
    profiling._LOG.clear()
    yield
    profiling._LOG.clear()


def _model(seed: int = 0) -> CLIPModel:
    cfg = CLIPConfig(embed_dim=32, vision=VisionConfig(image_size=32, width=64, patch_size=8, layers=2, heads=1),
                     text=TextConfig(context_length=77, vocab_size=100, width=64, heads=1, layers=2))
    return CLIPModel(cfg, torch.float32).init_parameters(seed)


def _batch(seed: int, rows: int = 4):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(rows, 32, 32, 3, generator=gen)
    tokens = torch.randint(1, 100, (rows, 8), generator=gen, dtype=torch.int32)
    tokens[:, -1] = 99  # the end token, highest id, pooled
    return images, tokens


def _train(model, steps: int = 2):
    optimizer = make_optimizer(warmup_cosine_lr(1e-3, 1, 10), weight_decay=0.1)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    losses = []
    for i in range(steps):
        state, metrics = step(state, *_batch(i))
        losses.append(metrics["loss"])
    return state, losses


def _server(model) -> ClipServer:
    head = ClassificationHead(torch.randn(7, 32, generator=torch.Generator().manual_seed(5)))
    return ClipServer(model, head=head, image_buckets=(4, 8), window=2)


def _images(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _names(spans):
    return [s["name"] for s in spans]


def test_nothing_recorded_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    model = _model()
    _train(model)
    _server(model).classify(_images(10))
    assert profiling.span_log() == {"spans": [], "dropped": 0}


def test_step_spans_under_a_profiler():
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]):
        _train(model, steps=2)
    spans = profiling.span_log()["spans"]
    assert _names(spans) == STEP * 2
    for n in range(2):
        root, *children = spans[4 * n: 4 * n + 4]
        assert root["parent"] is None and root["root"] == n
        assert [c["parent"] for c in children] == [root["id"]] * 3
        assert {c["root"] for c in children} == {n}
        assert [c["start_ns"] for c in children] == sorted(c["start_ns"] for c in children)
        assert all(c["end_ns"] <= d["start_ns"] for c, d in zip(children, children[1:]))
        assert root["start_ns"] <= children[0]["start_ns"] and children[-1]["end_ns"] <= root["end_ns"]
    # On the CPU a span has no device interval: absent, not zero.
    assert not any("device_ms" in s for s in spans)


def test_requests_on_two_threads_keep_their_ids():
    server = _server(_model())
    sizes = {"a": 19, "b": 6}
    out, barrier = {}, threading.Barrier(2)

    def request(key):
        barrier.wait(timeout=30)
        out[key] = (threading.get_ident(), server.classify(_images(sizes[key])))

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=request, args=(k,)) for k in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.span_log()["spans"]
    roots = {s["root"] for s in spans}
    assert len(roots) == 2
    for key, n in sizes.items():
        thread, logits = out[key]
        assert logits.shape == (n, 7)
        request = [s for s in spans if s["name"] == "serve.request" and s["thread"] == thread]
        assert len(request) == 1 and request[0]["attrs"] == {"rows": n}
        mine = [s for s in spans if s["root"] == request[0]["root"]]
        assert {s["thread"] for s in mine} == {thread}
        chunks = server._chunks(n)
        names = _names(mine)
        assert names.count("serve.cast") == 1
        for name in CHUNK:
            assert names.count(name) == len(chunks), name
        assert [s["attrs"]["bucket"] for s in mine if s["name"] == "serve.forward"] == [b for _, _, b in chunks]
        assert all(s["parent"] == request[0]["id"] for s in mine if s["name"] != "serve.request")


def test_a_held_lock_is_not_timed_again():
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]):
        with pinned_mode(model, train=False, wait_span="wait"), pinned_mode(model, train=False, wait_span="wait"):
            pass
        with pinned_mode(model, train=False):
            pass
    assert _names(profiling.span_log()["spans"]) == ["wait"]


def test_numbers_equal_with_and_without_a_profiler():
    plain = _model()
    traced = copy.deepcopy(plain)
    state_a, losses_a = _train(plain)
    assert all(torch.isfinite(x) for x in losses_a)
    with profile(activities=[ProfilerActivity.CPU]):
        state_b, losses_b = _train(traced)
        logits_b = _server(traced).classify(_images(13))
    logits_a = _server(plain).classify(_images(13))
    assert profiling.span_log()["spans"]
    assert [float(x) for x in losses_a] == [float(x) for x in losses_b]
    for a, b in zip(plain.parameters(), traced.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(state_a.opt_state.mu + state_a.opt_state.nu, state_b.opt_state.mu + state_b.opt_state.nu):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(logits_a, logits_b)


def test_the_log_drops_its_oldest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling._SpanLog(3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"s{i}", i=i):
                pass
    log = profiling.span_log()
    assert _names(log["spans"]) == ["s2", "s3", "s4"] and log["dropped"] == 2
    assert [s["attrs"] for s in log["spans"]] == [{"i": 2}, {"i": 3}, {"i": 4}]


def test_concurrent_spans_lose_no_record(monkeypatch):
    """Many threads, a short switch interval: every span is logged or
    counted as dropped, each with its own id and its own thread's parent."""
    import sys

    monkeypatch.setattr(profiling, "_LOG", profiling._SpanLog(1000))
    threads, per = 16, 100
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work():
                for i in range(per // 2):
                    with profiling.span("outer", i=i):
                        with profiling.span("inner"):
                            pass

            workers = [threading.Thread(target=work) for _ in range(threads)]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in workers)
    log = profiling.span_log()
    assert len(log["spans"]) == 1000 and log["dropped"] == threads * per - 1000
    assert len({s["id"] for s in log["spans"]}) == 1000
    by_id = {s["id"]: s for s in log["spans"]}
    for s in log["spans"]:
        if s["name"] == "inner" and s["parent"] in by_id:
            assert by_id[s["parent"]]["thread"] == s["thread"] and by_id[s["parent"]]["name"] == "outer"


def test_trace_records_a_worker_threads_span(tmp_path):
    if profiling._all_threads() is None:
        pytest.skip("this torch's profiler has no profile_all_threads option: trace() sees only its own thread")
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("stale"):
            pass
    idents = []

    def work():
        idents.append(threading.get_ident())
        with profiling.span("worker.span", rows=3):
            torch.ones(16, 16) @ torch.ones(16, 16)

    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    # trace() starts a fresh log: the earlier session's span is gone.
    assert [(s["name"], s["thread"]) for s in profiling.span_log()["spans"]] == [("worker.span", idents[0])]
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "worker.span" and e.get("ph") == "X" for e in events)
