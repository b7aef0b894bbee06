"""Training cells: FLYP's step (``flyp_tpu_torch.training.make_train_step``
on the default route) driven over device-resident batches.

Set-up builds one object, the step with its model and optimizer state, and
drives it from the seed through the mix's ``check_steps`` first steps on
distinct batches, through the same call and feed as the window; those are
the readings the reference checks, and the warm-up.  The window then runs
steps for ``--seconds``, the host at most two steps ahead of the card, and
ends with one synchronisation: ``train_img_per_s`` is every image of every
step over the whole time.  With ``--trace 1`` the mix's ``trace_steps``
further steps run under the profiler.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import torch

from benchmark import harness, inputs, program, weights
from benchmark.reference import clip as ref_clip
from benchmark.yardstick import bounds, compare, flops
from benchmark.yardstick.peaks import card_peaks
from benchmark.yardstick.trace import breakdown

ADAM_B1 = 0.9


def feed(cfg: dict, mix: dict, seed: int, device):
    """The program's batches, the tokens cut to the batch's width by the
    program's data path."""
    return [(images.contiguous(), program.shrink(tokens).contiguous())
            for images, tokens in inputs.train_batches(cfg, mix, seed, device, program.DTYPES[cfg["compute_dtype"]])]


def program_readings(step, state, m, batches, steps: int):
    """Drive ``steps`` steps of ``step`` over ``batches``, with the readings
    the reference checks: each step's loss, the first gradient as the
    optimizer holds it (its first moment over ``1 - beta1``), and the
    parameters' change over the steps, each leaf's norm."""
    names = [n for n, _ in m.named_parameters()]
    start = [p.detach().clone() for p in m.parameters()]
    losses, grad = [], None
    for i in range(steps):
        state, metrics = step(state, *batches[i % len(batches)])
        losses.append(metrics["loss"])
        if i == 0:
            grad = compare.leaf_norms((n, mu.float() / (1 - ADAM_B1)) for n, mu in zip(names, state.opt_state.mu))
    change = compare.leaf_norms((n, p.detach() - s) for n, p, s in zip(names, m.parameters(), start))
    del start
    return state, {"losses": [float(x) for x in losses], "grad": grad, "change": change}


def reference_readings(cfg: dict, mix: dict, seed: int, device, precision: str = "float32", rows=None) -> dict:
    """The reference's readings from the same weights and first batches
    (``rows`` keeps part of each batch: a planted fault)."""
    ref_clip.no_tf32()
    flat = weights.make(cfg, seed, device)
    w = {n: t.clone() for n, t in flat.items()}
    del flat
    batches = [(im.float(), tok) for im, tok in inputs.train_batches(
        cfg, mix, seed, device, program.DTYPES[cfg["compute_dtype"]], count=mix["check_steps"], rows=rows)]
    losses, grad, change = ref_clip.train_readings(w, batches, cfg, mix["optimizer"],
                                                   ref_clip.Precision(precision), rows=mix["reference_rows"])
    out = {"losses": losses, "grad": compare.leaf_norms(grad.items()),
           "change": compare.leaf_norms(change.items())}
    del w, batches, grad, change
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device=None) -> dict:
    """One run of a training cell: the driver's output for the result line
    (``harness.result_line``).  ``device``: the tests' CPU."""
    cfg, mix = cell.config, cell.mix
    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        program.build_kernels()
    flat = weights.make(cfg, seed, device)
    m = program.model(cfg, flat, device, remat=cfg.get("remat", False))
    del flat
    step, state = program.train_step(m, cfg, mix["optimizer"])
    batches = feed(cfg, mix, seed, device)
    n_check = mix["check_steps"]
    state, prog = program_readings(step, state, m, batches, n_check)
    harness.sync(device)
    setup_s = time.perf_counter() - t0

    harness.reset_peak(device)
    pending, n = deque(), 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        state, _ = step(state, *batches[(n_check + n) % len(batches)])
        n += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
    harness.sync(device)
    elapsed = time.perf_counter() - t_start
    text_len = int(batches[0][1].shape[1])
    name = harness.device_name(device)
    peaks = card_peaks(name) if device.type == "cuda" else None
    B = mix["batch"]
    result = {
        "attempted": n, "failed": 0, "card": harness.power_limit(),
        "end_to_end": {"train_img_per_s": n * B / elapsed, "setup_s": setup_s},
    }
    readings = {
        "kind": "train", "peaks": peaks,
        "timed": {"steps": n, "seconds": elapsed, "flops": n * flops.train_step(cfg, B, text_len)},
    }
    peak = harness.peak_bytes(device)
    if trace:
        from benchmark.yardstick import kernels
        from benchmark.yardstick.trace import Window

        k = mix["trace_steps"]
        before = program.counters()
        with Window() as win:
            for j in range(k):
                state, _ = step(state, *batches[(n_check + n + j) % len(batches)])
        t = win.reduce(device.index)
        peak = max(peak, harness.peak_bytes(device))
        readings.update(
            trace=t, counters={key: v - before[key] for key, v in program.counters().items()},
            port_kernels={key: sorted(v) for key, v in kernels.program_kernels().items()},
            expected_launches=k * sum(c[-1] for c in bounds.block_calls(cfg, B, text_len)),
            bound_s=k * bounds.train_step_s(cfg, B, text_len, peaks),
            allowed_sources=["attention_block", "attention_block_bwd"],
        )
        result["breakdown"] = breakdown(t)
    result["device"] = {"platform": "gpu", "kind": name, "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
    readings["peak_bytes"] = peak
    result["readings"] = readings
    del state, step, m, batches
    _free()
    # The outputs against the reference, after the window, with the
    # program's state freed.
    ref = reference_readings(cfg, mix, seed, device)
    result["checks"] = compare.train_numbers(prog, ref)
    result["correct"] = compare.judge(result["checks"], cell.limits)
    return result
