"""The readings that the limits of ``benchmark/limits/<workload>.json`` are
set from, on the card at a cell's own sizes:

* the program: the numbers of ``yardstick/compare.py`` over many seeds,
  the same readings a run takes (training: the first steps of the step
  object; serving: a short window at the cell's load, then the sample);
* the control: the reference put in the program's place one precision
  below the configuration's (float8 products, ``reference/clip.py``);
* the planted faults: training, half of each batch left out (the loss's
  mean over the rest) and a step that leaves the state unchanged (its
  change reads 1 by the measure, no run); serving, an answer altered where
  it is produced (each row of a request given its neighbour's logits).

    python3 benchmark/control.py --workload <name> --seeds 1,2,... [--control-seeds 1,2,3] [--seconds 6]
    python3 benchmark/control.py --workload <serving cell> --sweep 4,6,8,10 --seconds 20

The second form finds the knee of a serving cell: the open loop at each
rate, and whether the backlog grows.

Prints one JSON line a seed and reading; ``--out`` also writes them to a
file.  Benchmark runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_readings(cell, seeds, control_seeds, out) -> None:
    import torch

    from benchmark import program, weights
    from benchmark.drivers import train
    from benchmark.yardstick import compare

    cfg, mix = cell.config, cell.mix
    device = torch.device("cuda", 0)
    program.build_kernels()
    m = None
    for seed in seeds:
        t = time.perf_counter()
        flat = weights.make(cfg, seed, device)
        if m is None:
            m = program.model(cfg, flat, device, remat=cfg.get("remat", False))
        else:
            m.load_state_dict(flat, strict=True)
        del flat
        step, state = program.train_step(m, cfg, mix["optimizer"])
        batches = train.feed(cfg, mix, seed, device)
        state, prog = train.program_readings(step, state, m, batches, mix["check_steps"])
        del state, step, batches
        torch.cuda.empty_cache()
        ref = train.reference_readings(cfg, mix, seed, device)
        rec = {"seed": seed, "reading": "program", **compare.train_numbers(prog, ref), "losses": prog["losses"],
               "ref_losses": ref["losses"], "seconds": time.perf_counter() - t}
        rec["worst"] = _worst(prog, ref)
        _emit(rec, out)
        if seed in control_seeds:
            ctl = train.reference_readings(cfg, mix, seed, device, precision="float8")
            _emit({"seed": seed, "reading": "control_float8", **compare.train_numbers(ctl, ref)}, out)
            half = train.reference_readings(cfg, mix, seed, device, rows=slice(0, mix["batch"] // 2))
            _emit({"seed": seed, "reading": "fault_half_batch", **compare.train_numbers(half, ref)}, out)
            still = dict(prog, change={k: 0.0 for k in prog["change"]})
            _emit({"seed": seed, "reading": "fault_state_unchanged", **compare.train_numbers(still, ref)}, out)


def _worst(prog, ref) -> dict:
    """The leaf behind each norm gap, for the record."""
    from benchmark.yardstick import compare

    out = {}
    for key in ("grad", "change"):
        med = compare.median(ref[key].values())
        keep = compare.moving_leaves(ref["grad"]) if key == "change" else set(ref[key])
        name = max(keep, key=lambda n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med))
        out[key] = [name, prog[key][name], ref[key][name], med]
    return out


def serve_readings(cell, seeds, control_seeds, seconds: float, out) -> None:
    import torch

    from benchmark import inputs, program, weights
    from benchmark.drivers import serve
    from benchmark.yardstick import compare

    cfg, mix = cell.config, cell.mix
    device = torch.device("cuda", 0)
    program.build_kernels()
    m = None
    for seed in seeds:
        t = time.perf_counter()
        flat = weights.make(cfg, seed, device)
        if m is None:
            m = program.model(cfg, flat, device)
        else:
            m.load_state_dict(flat, strict=True)
        del flat
        srv = program.server(m, weights.head(cfg["embed_dim"], mix["classes"], seed, device), mix["buckets"],
                             mix["window"])
        pool = inputs.image_pool(cfg, mix, seed, device)
        requests = inputs.requests(mix, seed, mix["request_list"])
        times = inputs.arrival_times(mix, mix["request_list"])
        for b in mix["buckets"][1:]:
            srv.classify(pool[:b])
        records = serve.OpenLoop(srv, pool, requests, times, mix["threads"]).run(seconds)
        done = [r for r in records if r[4] is not None]
        sample = serve.sample_requests(done, mix["check_requests"], seed)
        prog = torch.cat([torch.from_numpy(r[5]) for r in sample])
        spans = [(r[1], r[2]) for r in sample]
        ref = serve.reference_logits(cfg, mix, seed, device, pool, spans).cpu()
        _emit({"seed": seed, "reading": "program", **compare.serve_numbers(prog, ref), "requests": len(records),
               "failed": len(records) - len(done), "rows": int(prog.shape[0]), "seconds": time.perf_counter() - t},
              out)
        if seed in control_seeds:
            ctl = serve.reference_logits(cfg, mix, seed, device, pool, spans, precision="float8").cpu()
            _emit({"seed": seed, "reading": "control_float8", **compare.serve_numbers(ctl, ref)}, out)
            altered = torch.cat([torch.from_numpy(r[5]).roll(1, dims=0) for r in sample])
            _emit({"seed": seed, "reading": "fault_answer_altered", **compare.serve_numbers(altered, ref)}, out)
        del srv
        torch.cuda.empty_cache()


def sweep(cell, rates, seconds: float, out) -> None:
    """The open loop of a serving cell at each of ``rates`` requests a
    second for ``seconds``: images finished in the window a second, the 50th
    and 95th percentiles of latency, and those of the window's first and
    last thirds, which part where the backlog grows."""
    import torch

    from benchmark import inputs, program, weights
    from benchmark.drivers import serve

    cfg, mix = cell.config, cell.mix
    device = torch.device("cuda", 0)
    program.build_kernels()
    seed = 1
    m = program.model(cfg, weights.make(cfg, seed, device), device)
    srv = program.server(m, weights.head(cfg["embed_dim"], mix["classes"], seed, device), mix["buckets"],
                         mix["window"])
    pool = inputs.image_pool(cfg, mix, seed, device)
    requests = inputs.requests(mix, seed, mix["request_list"])
    for b in mix["buckets"][1:]:
        for _ in range(2):
            srv.classify(pool[:b])
    for rate in rates:
        times = inputs.arrival_times(dict(mix, rate=rate), mix["request_list"])
        loop = serve.OpenLoop(srv, pool, requests, times, mix["threads"])
        records = loop.run(seconds)
        done = [r for r in records if r[4] is not None]
        lat = sorted(1e3 * (r[4] - r[3]) for r in done)
        third = len(records) // 3
        _emit({"rate": rate, "sent": len(records), "failed": len(records) - len(done),
               "img_per_s": sum(r[2] for r in done if r[4] <= seconds) / seconds,
               "p50_ms": lat[len(lat) // 2], "p95_ms": serve.p95_ms(records),
               "p95_first_third_ms": serve.p95_ms(records[:third]), "p95_last_third_ms": serve.p95_ms(records[-third:]),
               "drain_s": loop.elapsed - seconds, "late_ms": 1e3 * loop.late_s}, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="comma-separated seeds of the program's readings")
    p.add_argument("--sweep", default="", help="a serving cell: comma-separated rates to sweep instead")
    p.add_argument("--control-seeds", default="", help="the seeds among them that also read the control and faults")
    p.add_argument("--seconds", type=float, default=6.0, help="a serving cell's short window")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import harness

    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    if args.sweep:
        sweep(cell, [float(r) for r in args.sweep.split(",")], args.seconds, args.out)
    elif cell.kind == "train":
        train_readings(cell, seeds, control, args.out)
    else:
        serve_readings(cell, seeds, control, args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
