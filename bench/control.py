"""The control's and the program's readings of a cell, seed by seed.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

For each seed one full run of the cell at its own size (a short window),
then the reference one precision below the configuration's (fp8 for bf16
rows, int4 for SQ8 rows) put in the program's place on the same checked
batches.  Prints one JSON line a seed with both sets of readings: the
program's give each limit its lower reading, the control's its upper one
(``bench/limits/``).  The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        run, r = harness.run_cell(cfg, traffic, seed, args.seconds, False,
                                  "cuda", t0, control=True)
        print(json.dumps(dict(workload=cell["name"], seed=seed,
                              setup_s=run.setup_s, batches=run.batches,
                              **r)), flush=True)
        del run, r
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
