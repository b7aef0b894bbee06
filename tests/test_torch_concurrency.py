"""The port under concurrent callers: ``ClipServer``'s request methods are
reentrant (the JAX server's contract, ``flyp_tpu/serving/engine.py``), and
a kernel library is compiled once however many threads reach its first use.

* ``tests/test_serving.py::test_concurrent_callers_match_sequential`` on the
  port: 8 mixed requests, 3 rounds on 4 threads, bit-equal to sequential
  calls, on a tiny ViT server and on a tiny ModifiedResNet server whose
  model was left in training mode (BatchNorm on batch statistics there, so
  a request run in that mode gives other numbers).
* A deterministic reproduction of the mode race that an unlocked
  ``models/modes.py::pinned_mode`` has: thread B's forward waits until
  thread A's call has returned.
* ``ops/_kernels.py::build``/``load`` from two threads with a stand-in
  ``nvcc``: one compile, one path, one library object.

Port only: no JAX needed, CPU tensors take the plain versions.
"""

import concurrent.futures as cf
import dataclasses
import os
import stat
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flyp_tpu_torch.entry import _tiny_config
from flyp_tpu_torch.models import build_clip_model
from flyp_tpu_torch.models.configs import MODEL_CONFIGS
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.ops import _kernels
from flyp_tpu_torch.serving import ClipServer

torch.set_num_threads(1)


def _rn_config():
    """The JAX tests' tiny ModifiedResNet (``tests/test_flyp_trainer.py::
    tiny_resnet``): 32 px, width 16, blocks 1-1-1-1, real vocabulary."""
    cfg = MODEL_CONFIGS["RN50"]
    return dataclasses.replace(
        cfg, embed_dim=32,
        vision=dataclasses.replace(cfg.vision, image_size=32, width=16, heads=2, resnet_layers=(1, 1, 1, 1)),
        text=dataclasses.replace(cfg.text, width=64, heads=1, layers=2),
    )


def _server(name, config, train_mode=False):
    model = build_clip_model(SimpleNamespace(model=name, clip_load=None, compute_dtype="float32", seed=3),
                             config_override=config, device="cpu")
    if train_mode:
        model.train()
    rng = np.random.default_rng(3)
    head = ClassificationHead(torch.from_numpy(rng.standard_normal((5, config.embed_dim)).astype(np.float32)),
                              normalize=True)
    return ClipServer(model, head=head, image_buckets=(4, 8))


def _images(n, px, seed):
    return np.random.default_rng(seed).standard_normal((n, px, px, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["vit", "rn_train_mode"])
def test_concurrent_callers_match_sequential(kind):
    if kind == "vit":
        srv = _server("ViT-B/16", _tiny_config(real_text=True))
    else:
        srv = _server("RN50", _rn_config(), train_mode=True)
    px = srv.model.config.vision.image_size
    requests = [
        ("classify", _images(6, px, 10)),
        ("encode_images", _images(11, px, 11)),
        ("classify", _images(3, px, 12)),
        ("encode_texts", ["a photo of a cat", "a photo of a dog sitting on a mat"]),
        ("encode_images", _images(8, px, 13)),
        ("classify", _images(8, px, 14)),
        ("encode_texts", ["one caption"]),
        ("encode_images", _images(2, px, 15)),
    ]

    def run(req):
        kind, payload = req
        return np.asarray(getattr(srv, kind)(payload))

    modes = [m.training for m in srv.model.modules()]
    sequential = [run(r) for r in requests]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, to shake out orders
    try:
        for _round in range(3):
            with cf.ThreadPoolExecutor(max_workers=4) as pool:
                concurrent = list(pool.map(run, requests, timeout=300))
            for s, c in zip(sequential, concurrent):
                np.testing.assert_array_equal(s, c)
    finally:
        sys.setswitchinterval(interval)
    assert [m.training for m in srv.model.modules()] == modes  # the caller's mode, restored


def test_pinned_mode_race_is_closed():
    """Thread A's request enters its forward (the model pinned to eval mode),
    then thread B's request starts; B's forward waits until A's call has
    returned.  With a pin that only flips flags, B finds nothing to flip, A
    restores training mode under B, and B runs on batch statistics.  With
    the pin's lock, B enters only after A has restored the flags (A's wait
    for B then times out), pins eval mode itself, and gets the sequential
    result."""
    srv = _server("RN50", _rn_config(), train_mode=True)
    imgs_a, imgs_b = _images(3, 32, 20), _images(3, 32, 21)
    want_b = srv.encode_images(imgs_b)
    a_in_forward, b_in_forward, a_returned = threading.Event(), threading.Event(), threading.Event()
    seen, out = {}, {}

    def hook(_module, _args):
        who = threading.current_thread().name
        if who == "A":
            a_in_forward.set()
            b_in_forward.wait(timeout=5)
        elif who == "B":
            b_in_forward.set()
            a_returned.wait(timeout=60)
            seen["B"] = {m.training for m in srv.model.modules()}

    def run_a():
        out["A"] = srv.encode_images(imgs_a)
        a_returned.set()

    def run_b():
        a_in_forward.wait(timeout=60)
        out["B"] = srv.encode_images(imgs_b)

    handle = srv.model.visual.register_forward_pre_hook(hook)
    try:
        threads = [threading.Thread(target=run_a, name="A"), threading.Thread(target=run_b, name="B")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        handle.remove()
    assert seen["B"] == {False}, "B's forward ran with modules in training mode"
    np.testing.assert_array_equal(out["B"], want_b)
    assert {m.training for m in srv.model.modules()} == {True}  # the caller's training mode, restored


_FAKE_NVCC = """#!{python}
# Stands in for nvcc: waits, counts the compile, then builds the source as C.
import subprocess, sys, time
args = sys.argv[1:]
time.sleep(0.5)
with open({count!r}, "a") as f:
    f.write("compile\\n")
out = args[args.index("-o") + 1]
subprocess.run(["gcc", "-shared", "-fPIC", "-x", "c", "-o", out, args[-1]], check=True)
"""


def test_kernel_build_runs_once_across_threads(tmp_path, monkeypatch):
    csrc, build, count = tmp_path / "csrc", tmp_path / "build", tmp_path / "compiles.txt"
    csrc.mkdir()
    (csrc / "fake.cu").write_text('const char *flyp_error_string(int code) { return code ? "bad" : "ok"; }\n')
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, count=str(count)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_kernels, "CSRC_DIR", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "_loaded", {}, raising=False)
    monkeypatch.setattr(_kernels, "build_logs", {})

    start = threading.Barrier(2)

    def first_use(fn):
        start.wait(timeout=30)
        return fn("fake")

    for fn in (_kernels.build, _kernels.load):
        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            got = list(pool.map(first_use, [fn, fn], timeout=60))
        assert got[0] is got[1] if fn is _kernels.load else got[0] == got[1]
        assert count.read_text().splitlines() == ["compile"]  # one compile, for build and load both
    assert _kernels.load("fake").flyp_error_string(1) == b"bad"
    assert sorted(os.listdir(build)) == [_kernels.library_path("fake").name]  # no temporary file left
