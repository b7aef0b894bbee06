"""The benchmark's CPU tests: the repository's root on the path, one torch
thread, and a tiny configuration with its cells written under a temporary
root (``tiny_root``) for the tests that drive a run."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_VISION = {"image_size": 32, "patch_size": 8, "width": 128, "layers": 2, "heads": 2}
TINY_TEXT = {"context_length": 77, "vocab_size": 49408, "width": 128, "heads": 2, "layers": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_config(dtype: str = "bfloat16") -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/vit-b16.json").read_text())
    cfg.update(embed_dim=64, vision=dict(TINY_VISION), text=dict(TINY_TEXT), compute_dtype=dtype)
    return cfg


def write_tiny_root(root: Path, dtype: str = "bfloat16") -> Path:
    """A checkout-shaped directory whose BENCHMARK.json holds the tiny
    cells: the real mixes with small batches and pools, the real limits of
    the cells they stand for."""
    bench = root / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    (bench / "configs/tiny.json").write_text(json.dumps(tiny_config(dtype)))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "tiny", "file": "benchmark/configs/tiny.json", "reduced": [],
                            "why": "tests"}]
    stands_for = {"train.tiny": ("train_b512", "train.vit-b16.b512", {"batch": 16, "reference_rows": 8}),
                  "serve.tiny": ("serve_mixed_sat", "serve.vit-l14.mixed-sat",
                                 {"pool_images": 300, "check_requests": 3, "reference_rows": 32})}
    manifest["workloads"] = []
    for name, (mix, cell, changes) in stands_for.items():
        traffic = json.loads((ROOT / f"benchmark/traffic/{mix}.json").read_text())
        traffic.update(changes)
        (bench / f"traffic/{name}.json").write_text(json.dumps(traffic))
        shutil.copy(ROOT / f"benchmark/limits/{cell}.json", bench / f"limits/{name}.json")
        manifest["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1, "why": "tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path)
