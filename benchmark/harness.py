"""What every cell shares: ``BENCHMARK.json`` and the files it names, the
card check, the per-layer metric readers, the guard against the JAX
package, and the result line.

A cell is found by its name: its ``config`` names a configuration entry
whose ``file`` holds the sizes; its ``traffic`` names
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/drivers/<kind>.py``; ``benchmark/limits/<workload>.json``
holds the limits of its comparison; each per-layer metric ``<name>`` is
read by ``benchmark/metrics/<name>.py``.  A new cell, mix, configuration or
metric is new files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FOREIGN = ("jax", "jaxlib", "flax", "flyp_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(by_name)}")
        self.name = name
        self.entry = by_name[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads((root / configs[self.entry["config"]]["file"]).read_text())
        self.mix = json.loads((root / "benchmark" / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text())
        self.chips = int(self.entry["chips"])
        self.end_to_end = _for_cell(manifest["end_to_end"], name)
        self.per_layer = _for_cell(manifest["per_layer"], name)

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.kind}")


def _for_cell(metrics, name):
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The per-layer metric ``name`` from a run's readings, by its reader
    ``benchmark/metrics/<name>.py``; None where it finds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def card_check(chips: int) -> Optional[str]:
    """Why the cards cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} present"
    return None


def sync(device) -> None:
    """Wait for ``device``'s work (a no-op on the CPU, where the tests run
    the drivers)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def foreign_modules() -> list:
    """Loaded modules of the JAX side, compared by whole top-level name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    """The result line from a driver's output ``out``: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
    ``breakdown``; the numbers compared, each with its limit, last."""
    if trace:
        specs, values = cell.per_layer, {}
        for m in specs:
            v = read_metric(m["name"], out["readings"])
            if v is not None:
                values[m["name"]] = v
    else:
        specs, values = cell.end_to_end, out["end_to_end"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in specs if m["name"] in values}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace:
        line["breakdown"] = out["breakdown"]
    for key in ("card", "sender_late_ms", "drain_s"):  # for the record: the card's power limit, the sender's lag
        if key in out:
            line[key] = out[key]
    line["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in out["checks"].items()}
    return line


def print_checks(cell: Cell, checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for k, v in checks.items():
        log(f"check {k} {v!r} limit {cell.limits[k]!r} {'ok' if v <= cell.limits[k] else 'FAIL'}")
