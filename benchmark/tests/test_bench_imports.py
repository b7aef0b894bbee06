"""What the benchmark loads: nothing of the JAX side in what a run imports,
nothing of the program in the reference, no result without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
FOREIGN = {"jax", "jaxlib", "flax", "flyp_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_the_jax_side(path):
    assert not _imports(path) & FOREIGN


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"flyp_tpu_torch", "benchmark"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "flyp_tpu_torch_lookalike", sys.modules[__name__])
    assert "flyp_tpu" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert harness.foreign_modules() == ["jax"]


def test_a_run_loads_nothing_of_the_jax_side():
    """Every module a run imports (the harness, both drivers, the program's
    paths they drive, every metric reader, the reference), loaded in a
    fresh interpreter."""
    code = (
        "import sys, json, importlib.util, pathlib\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import benchmark.run, benchmark.harness, benchmark.control\n"
        "from benchmark.drivers import train, serve\n"
        "from benchmark import program\n"
        "import flyp_tpu_torch.training, flyp_tpu_torch.serving, flyp_tpu_torch.parallel.mesh\n"
        "import flyp_tpu_torch.parallel.comm, flyp_tpu_torch.ops.flash_attention, flyp_tpu_torch.ops.mlp_block\n"
        "import flyp_tpu_torch.tokenizer, flyp_tpu_torch.ops._kernels\n"
        "for p in sorted((pathlib.Path(sys.argv[1]) / 'benchmark/metrics').glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "flyp_tpu_torch" in loaded
    assert not loaded & FOREIGN


def test_no_card_no_result():
    """Without CUDA (this machine) the command exits non-zero and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_outside_a_checkout(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run: the command exits non-zero, with no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.vit-b16.b512", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
