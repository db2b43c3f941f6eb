"""The readings that the limits of ``correct`` are set from.

    python -m portbench.control --workload efcn_async.clustered --seeds 101:113 --control 3

For each seed, in one process: the cell's engine runs a window of
``--seconds`` at the cell's own load, and its sampled outputs are held
against the reference (the program's readings: the lower end of each
limit).  For the first ``--control`` seeds the control, the reference in
the next lower precision (TF32 convolutions, bfloat16 surfaces), is held
against the reference on the same requests (the upper end).  One JSON
line a seed, then the largest program reading and the smallest control
reading of each number.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def seeds_arg(text: str) -> list:
    if ":" in text:
        a, b = text.split(":")
        return list(range(int(a), int(b)))
    return [int(s) for s in text.split(",")]


def readings(root: Path, name: str, seeds, n_control: int, seconds: float,
             device: str = "cuda", out=sys.stdout) -> dict:
    from portbench.run import Cell

    cell = Cell(root, name)
    lower: dict = {}
    upper: dict = {}
    for i, seed in enumerate(seeds):
        engine = cell.engine(seed, device)
        engine.warm_up()
        rec = engine.run(seconds)
        prog, ctrl = engine.compare(control=i < n_control)
        for key, v in prog.items():
            lower[key] = max(lower.get(key, 0.0), v)
        for key, v in (ctrl or {}).items():
            upper[key] = min(upper.get(key, float("inf")), v)
        print(json.dumps({"workload": name, "seed": seed, "requests": len(rec.requests),
                          "program": prog, "control": ctrl}), file=out, flush=True)
        del engine
    summary = {"workload": name, "seeds": len(seeds), "lower": lower, "upper": upper}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds_arg, required=True)
    p.add_argument("--control", type=int, default=3,
                   help="how many of the seeds (the first) also run the control")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    readings(Path.cwd(), args.workload, args.seeds, args.control, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
