"""Runs one cell of ``BENCHMARK.json`` on one card and prints its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison holds
against its limit, also the last lines of standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 1 and
prints no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(cell: dict, bench: dict, run, readings: dict, limits: dict,
                traced: bool, device: dict) -> dict:
    """The result's JSON object; ``device`` holds ``platform``, ``kind`` and
    ``count``."""
    from bench import judge, spec

    metrics = {}
    for m in spec.metrics(bench, cell["name"], traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {n: {"value": readings[n], "limit": limits[n]} for n in limits}
    correct = judge.correct(readings, limits)
    device = dict(device, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": correct, "attempted": run.queries,
           "failed": run.queries - run.answered, "metrics": metrics,
           "device": device}
    if traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    traced = bool(args.trace)
    run, readings = harness.run_cell(cfg, traffic, args.seed, args.seconds,
                                     traced, "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    out = result_line(cell, bench, run, readings, limits, traced, device)
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                              run.setup_parts.items()), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
