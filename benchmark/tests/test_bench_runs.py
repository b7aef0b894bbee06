"""Whole runs on the CPU at a tiny size, the card check skipped: the drivers'
set-up, window and check drive the program's plain route.  A sound run is
correct under the real cells' limits; the control (the reference one
precision below the configuration's) and each planted fault of the timed
path are not: a step that leaves the state unchanged, half of the batch
left out, an answer altered."""

import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.drivers import serve, train
from benchmark.yardstick import compare

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
SEEDS = [3, 2 ** 31 + 17]


def _run(root, name, seed, seconds=0.5, trace=False):
    cell = harness.Cell(name, root)
    out = cell.driver().run(cell, seed, seconds, trace, time.perf_counter(), device=CPU)
    line = harness.result_line(cell, out, trace)
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)
    return line


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["train.tiny", "serve.tiny"])
def test_sound_run_is_correct(tiny_root, name, seed):
    line = _run(tiny_root, name, seed)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"setup_s"} < set(line["metrics"])


@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_is_not_correct(tiny_root, seed):
    cell = harness.Cell("train.tiny", tiny_root)
    ref = train.reference_readings(cell.config, cell.mix, seed, CPU)
    ctl = train.reference_readings(cell.config, cell.mix, seed, CPU, precision="float8")
    assert not compare.judge(compare.train_numbers(ctl, ref), cell.limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_is_not_correct(tiny_root, seed):
    from benchmark import inputs

    cell = harness.Cell("serve.tiny", tiny_root)
    pool = inputs.image_pool(cell.config, cell.mix, seed, CPU)
    spans = [(0, 40), (100, 17)]
    ref = serve.reference_logits(cell.config, cell.mix, seed, CPU, pool, spans)
    ctl = serve.reference_logits(cell.config, cell.mix, seed, CPU, pool, spans, precision="float8")
    assert not compare.judge(compare.serve_numbers(ctl, ref), cell.limits)


def _unchanged_state(monkeypatch):
    from flyp_tpu_torch.training import train_state

    def update(self, params, grads, state, frozen=None):
        return torch.as_tensor(self.schedule(state.count), dtype=torch.float32)

    monkeypatch.setattr(train_state.AdamW, "update", update)


def _half_batch(monkeypatch):
    import flyp_tpu_torch.training as training

    real = training.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda state, images, tokens: step(state, images[: len(images) // 2], tokens[: len(tokens) // 2])

    monkeypatch.setattr(training, "make_train_step", make)


def _answer_altered(monkeypatch):
    import numpy as np
    from flyp_tpu_torch.serving.engine import ClipServer

    real = ClipServer.classify
    monkeypatch.setattr(ClipServer, "classify", lambda self, images: np.roll(real(self, images), 1, axis=0))


@pytest.mark.parametrize("name,fault", [
    ("train.tiny", _unchanged_state),
    ("train.tiny", _half_batch),
    ("serve.tiny", _answer_altered),
], ids=["state-unchanged", "half-batch", "answer-altered"])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(tiny_root, name, SEEDS[0])
    assert not line["correct"], line["checks"]
