"""Serving cells: zero-shot classification through
``flyp_tpu_torch.serving.ClipServer.classify`` under an open loop.

Set-up makes the model and the head from the seed, the image pool, the
requests and their arrival times (``inputs.py``), and warms every bucket
the requests reach.  In the window requests are sent at their arrival
times, at the mix's fixed ``rate``, whatever the state of earlier ones,
each to one of ``threads`` worker threads (a request waits for a free one
in a queue); arrivals stop when ``--seconds`` have passed and the requests
sent finish, a minute past the close at most (one that has not finished
then never came, and failed).  A request is timed from when it was due to
its logits on the host, so a stall counts against every request behind it.
``serve_img_per_s`` counts the images of the requests finished inside the
window (not padded rows) over its length; ``serve_p95_ms`` is the
nearest-rank 95th percentile over every request sent, a failed one
counting as infinitely late.  With ``--trace 1`` the profiler then sees
the next ``trace_requests`` requests sent at once and finished: a full
queue, so the card's idle time there is what the host costs it.  Afterwards a sample of the window's answers,
drawn from the seed with the longest request in it, is held against the
reference's logits of the same images.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import torch

from benchmark import harness, inputs, program, weights
from benchmark.reference import clip as ref_clip
from benchmark.yardstick import bounds, compare, flops
from benchmark.yardstick.peaks import card_peaks
from benchmark.yardstick.trace import breakdown

DRAIN_S = 60.0  # how long past the close the requests sent may take


class OpenLoop:
    """Requests sent at their arrival times to a pool of worker threads.
    Each call of :meth:`run` continues the request list where the last
    stopped."""

    def __init__(self, srv, pool, requests, times, threads: int):
        self.srv, self.pool, self.requests, self.times, self.threads = srv, pool, requests, times, threads
        self.next = 0

    def run(self, seconds: float) -> list:
        """Send for ``seconds``; one record a request: (index, offset, size,
        due_s, done_s or None, logits or None, error or None), times from
        the window's start.  ``self.late_s``: how late the sender was at
        worst."""
        first = self.next
        base = self.times[first - 1] if first else 0.0
        records, lock = [], threading.Lock()
        self.late_s = 0.0

        def serve(i, off, n, due, t0):
            try:
                out, err = self.srv.classify(self.pool[off:off + n]), None
            except Exception as e:  # a failed request is counted, not fatal
                out, err = None, repr(e)
            done = time.perf_counter() - t0 if err is None else None
            with lock:
                records.append((i, off, n, due, done, out, err))

        with ThreadPoolExecutor(max_workers=self.threads) as pool:
            futures, t0 = [], time.perf_counter()
            while True:
                i = self.next
                due = self.times[i % len(self.times)] - base + (i // len(self.times)) * self.times[-1]
                if due >= seconds:
                    break
                delay = due - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                self.late_s = max(self.late_s, time.perf_counter() - t0 - due)
                off, n = self.requests[i % len(self.requests)]
                futures.append(pool.submit(serve, i, off, n, due, t0))
                self.next += 1
            wait(futures, timeout=seconds + DRAIN_S - (time.perf_counter() - t0))
            self.elapsed = time.perf_counter() - t0
            pool.shutdown(wait=True, cancel_futures=True)
        sent = {r[0] for r in records}
        for i in range(first, self.next):  # never answered inside the drain
            if i not in sent:
                off, n = self.requests[i % len(self.requests)]
                records.append((i, off, n, None, None, None, "not answered"))
        return sorted(records, key=lambda r: r[0])

    def burst(self, count: int) -> list:
        """Send the next ``count`` requests at once, a full queue, and wait
        for them all; records as :meth:`run`'s."""
        records, lock, t0 = [], threading.Lock(), time.perf_counter()

        def serve(i, off, n):
            out = self.srv.classify(self.pool[off:off + n])
            with lock:
                records.append((i, off, n, 0.0, time.perf_counter() - t0, out, None))

        with ThreadPoolExecutor(max_workers=self.threads) as pool:
            futures = [pool.submit(serve, i, *self.requests[i % len(self.requests)])
                       for i in range(self.next, self.next + count)]
            for f in futures:
                f.result()
        self.next += count
        return sorted(records, key=lambda r: r[0])


def p95_ms(records) -> float:
    """Nearest-rank 95th percentile of the latencies, failures infinite."""
    lat = sorted(r[4] - r[3] if r[4] is not None else math.inf for r in records)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def chunk_buckets(srv, n: int) -> list:
    """The bucket of each forward a request of ``n`` images runs."""
    return [b for _, _, b in srv._chunks(n)]


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device=None) -> dict:
    """One run of a serving cell (module docstring); ``device``: the tests'
    CPU."""
    cfg, mix = cell.config, cell.mix
    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        program.build_kernels()
    flat = weights.make(cfg, seed, device)
    m = program.model(cfg, flat, device)
    del flat
    head_w = weights.head(cfg["embed_dim"], mix["classes"], seed, device)
    srv = program.server(m, head_w, mix["buckets"], mix["window"])
    pool = inputs.image_pool(cfg, mix, seed, device)
    requests = inputs.requests(mix, seed, mix["request_list"])
    times = inputs.arrival_times(mix, mix["request_list"])
    for b in sorted({b for _, n in requests for b in chunk_buckets(srv, n)}):
        for _ in range(mix["warmup_rounds"]):
            srv.classify(pool[:b])
    harness.sync(device)
    setup_s = time.perf_counter() - t0

    harness.reset_peak(device)
    loop = OpenLoop(srv, pool, requests, times, mix["threads"])
    records = loop.run(seconds)
    done = [r for r in records if r[4] is not None]
    in_window = sum(r[2] for r in done if r[4] <= seconds)
    name = harness.device_name(device)
    peaks = card_peaks(name) if device.type == "cuda" else None
    result = {
        "attempted": len(records), "failed": len(records) - len(done), "card": harness.power_limit(),
        "end_to_end": {"serve_img_per_s": in_window / seconds, "serve_p95_ms": p95_ms(records),
                       "setup_s": setup_s},
        "sender_late_ms": 1e3 * loop.late_s, "drain_s": loop.elapsed - seconds,
    }
    readings = {
        "kind": "serve", "peaks": peaks,
        "timed": {"seconds": seconds, "flops": flops.serve_images(cfg, in_window, mix["classes"])},
        "p50_ms": sorted(1e3 * (r[4] - r[3]) for r in done)[len(done) // 2] if done else None,
        "rows": {"sent": sum(r[2] for r in records),
                 "computed": sum(b for r in records for b in chunk_buckets(srv, r[2]))},
    }
    if trace:
        from benchmark.yardstick import kernels
        from benchmark.yardstick.trace import Window

        before = program.counters()
        with Window() as win:
            traced = loop.burst(mix["trace_requests"])
        t = win.reduce(device.index)
        forwards = [b for r in traced for b in chunk_buckets(srv, r[2])]
        readings.update(
            trace=t, counters={k: v - before[k] for k, v in program.counters().items()},
            port_kernels={k: sorted(v) for k, v in kernels.program_kernels().items()},
            expected_launches=len(forwards) * cfg["vision"]["layers"],
            bound_s=sum(bounds.serve_forward_s(cfg, b, peaks) for b in forwards),
            allowed_sources=["attention_block"],
        )
        result["breakdown"] = breakdown(t)
    result["device"] = {"platform": "gpu", "kind": name, "count": 1, "memory_peak_bytes": harness.peak_bytes(device)}
    if trace:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
    readings["peak_bytes"] = result["device"]["memory_peak_bytes"]
    result["readings"] = readings

    # The answers against the reference, with the program freed.
    sample = sample_requests(done, mix["check_requests"], seed)
    del srv, m, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = torch.cat([torch.from_numpy(r[5]) for r in sample])
    ref = reference_logits(cfg, mix, seed, device, pool, [(r[1], r[2]) for r in sample]).cpu()
    result["checks"] = compare.serve_numbers(prog, ref)
    result["correct"] = result["failed"] == 0 and compare.judge(result["checks"], cell.limits)
    return result


def sample_requests(done, count: int, seed: int) -> list:
    """The longest finished request and ``count - 1`` others drawn from the
    seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i][2], -i))
    rest = [i for i in range(len(done)) if i != longest]
    gen = torch.Generator().manual_seed((int(seed) + 23) % (2 ** 63))
    picked = [rest[i] for i in torch.randperm(len(rest), generator=gen)[: count - 1].tolist()]
    return [done[i] for i in sorted([longest] + picked)]


def reference_logits(cfg, mix, seed, device, pool, spans, precision: str = "float32") -> torch.Tensor:
    """The reference's logits of the pool's rows ``spans`` [(offset, n)],
    from weights and head made again from the seed, in blocks of rows."""
    ref_clip.no_tf32()
    w = weights.make(cfg, seed, device)
    head_w = weights.head(cfg["embed_dim"], mix["classes"], seed, device)
    prec = ref_clip.Precision(precision)
    rows = mix["reference_rows"]
    out = []
    with torch.no_grad():
        for off, n in spans:
            images = torch.from_numpy(pool[off:off + n]).to(device)
            for i in range(0, n, rows):
                out.append(ref_clip.zero_shot_logits(w, head_w, images[i:i + rows], cfg, prec))
    return torch.cat(out)
