"""The port stands alone: no JAX-family, flyp_tpu or scikit-learn import
anywhere in ``flyp_tpu_torch`` or ``chip_smoke.py``, statically and at run
time."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "flyp_tpu", "sklearn")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_forbidden_imports_in_source():
    files = sorted((REPO / "flyp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(REPO)}:{line}: {root}"
        for f in files
        for root, line in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_no_forbidden_modules_loaded_at_run_time():
    code = """
import importlib, pkgutil, sys, types
import torch
import flyp_tpu_torch
for m in pkgutil.walk_packages(flyp_tpu_torch.__path__, "flyp_tpu_torch."):
    importlib.import_module(m.name)
from flyp_tpu_torch.models import MODEL_CONFIGS, build_clip_model
from flyp_tpu_torch.serving import ClipServer
cfg = MODEL_CONFIGS["ViT-B/16"]
import dataclasses
tiny = dataclasses.replace(cfg, embed_dim=64,
    vision=dataclasses.replace(cfg.vision, image_size=32, width=128, layers=1, heads=2),
    text=dataclasses.replace(cfg.text, width=128, heads=2, layers=1))
srv = ClipServer.from_checkpoint(None, classnames=["a", "b"], compute_dtype="float32",
                                 config_override=tiny, device="cpu", image_buckets=(2,))
import numpy as np
assert srv.classify(np.zeros((3, 32, 32, 3), np.float32)).shape == (3, 2)
from flyp_tpu_torch.evaluation import Classifier
from flyp_tpu_torch.training import create_train_state, make_optimizer, make_train_step, warmup_cosine_lr
model = srv.model
opt = make_optimizer(warmup_cosine_lr(1e-3, 1, 10), weight_decay=0.1, moment_dtype="bfloat16")
state = create_train_state(model, opt)
tokens = torch.zeros((2, 16), dtype=torch.int32)
tokens[:, 0], tokens[:, 5] = 49406, 49407
state, metrics = make_train_step(model, opt)(state, torch.zeros((2, 32, 32, 3)), tokens)
assert torch.isfinite(metrics["loss"])
model.eval()
assert Classifier(model, srv.head, batch_size=4).predict_logits(np.zeros((3, 32, 32, 3), np.float32)).shape == (3, 2)
bad = sorted(n for n in sys.modules if n.split(".")[0] in %r)
print("LOADED", bad)
""" % (FORBIDDEN,)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
