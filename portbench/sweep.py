"""The open-loop rate sweep that finds the knee of a live cell.

    python -m portbench.sweep --workload efcn_full.live_s1 --rates 2.0e6,2.5e6,3.0e6 --seconds 6

In one process, for each rate (events/s) in turn: the cell's engine with
its mix at that rate, warmed up, measured for ``--seconds``.  One JSON line
a rate: the requests completed, the latency median and 95th percentile
(completion less due time), how late the generator ran (95th percentile)
and the backlog at the close (requests due in the window and never handed
over).  The knee is the highest rate at which the backlog stays 0 and the
generator keeps to its schedule; the cell runs at four fifths of it
(``rate_events_per_s`` in its traffic file).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def sweep(root: Path, name: str, rates, seconds: float, seed: int,
          device: str = "cuda", out=sys.stdout) -> list:
    from portbench.readers import p95
    from portbench.run import Cell

    cell = Cell(root, name)
    if cell.mix["loop"] != "open":
        raise SystemExit(f"{name} is not an open-loop cell")
    rows = []
    for rate in rates:
        engine = cell.engine(seed, device, dict(cell.mix, rate_events_per_s=rate))
        engine.warm_up()
        rec = engine.run(seconds)
        lat = [r.done - r.due for r in rec.completed()]
        row = {"rate_events_per_s": rate, "requests": len(rec.requests),
               "completed": len(lat), "backlog": rec.backlog,
               "latency_p50_ms": statistics.median(lat) * 1e3 if lat else None,
               "latency_p95_ms": p95(lat) * 1e3 if p95(lat) is not None else None,
               "lateness_p95_ms": (p95(rec.lateness_s) * 1e3
                                   if p95(rec.lateness_s) is not None else None)}
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
        del engine
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True,
                   type=lambda s: [float(r) for r in s.split(",")])
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sweep(Path.cwd(), args.workload, args.rates, args.seconds, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
