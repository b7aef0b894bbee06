"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``flyp_tpu_torch``, on a machine
with the cards the cell asks for.  Set-up (kernel libraries from the
checkout's build cache, weights and inputs from the seed, warm-up) runs
first; then the window measures for ``--seconds``; with ``--trace 1`` a
profiled sub-window follows and the per-layer metrics are printed instead
of the end-to-end ones.  The outputs of the timed path are checked against
the plain reference once the window has closed.  The last line of standard
output is one JSON object; the numbers compared, with their limits, are
the last lines of standard error.  Exit codes: 0 a result (correct or
not), 2 no usable card, 3 a module of the JAX side was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches of compiled kernels live at fixed paths inside the checkout, so that
# only a cell's first run there compiles.  The program builds its own CUDA
# libraries into build/flyp_tpu_torch_kernels/ (ops/_kernels.py).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    cell = harness.Cell(args.workload)
    why_not = harness.card_check(cell.chips)
    if why_not:
        harness.log(f"no result: {why_not}")
        return 2
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), T0)
    foreign = harness.foreign_modules()
    if foreign:
        harness.log(f"no result: modules of the JAX side are loaded: {', '.join(foreign)}")
        return 3
    line = harness.result_line(cell, out, bool(args.trace))
    harness.print_checks(cell, out["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
