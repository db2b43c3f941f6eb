"""Run one cell of the benchmark once, and print its result line.

    python -m portbench.run --workload efcn_full.replay_s16 --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``: the cell names
its configuration and traffic mix there, and the harness reads them from
the files ``BENCHMARK.json`` names under ``portbench/``.  It builds the
engine, warms up the cell's own shapes (set-up), measures for ``--seconds``
and then holds a sample of the outputs against the plain reference.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a device trace of the same
window.  The last line of standard output is one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "async_ev_cnn_tpu")


def forbidden_modules(names) -> list:
    """The names whose top-level module (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded as a module: a
    metric's reader (``metrics``), an engine (``engines``) or an event
    source (``pixels``), each found by the name its data gives."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"portbench: no {kind} file {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path, name: str):
        bench = _json(root / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.root, self.name = root, name
        self.spec = work[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(root / configs[self.spec["config"]]["file"])
        self.mix = _json(root / "portbench" / "traffic" / f"{self.spec['traffic']}.json")
        limits = root / "portbench" / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.exists() else {}

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])

    def engine(self, seed: int, device, mix: dict | None = None):
        """The configuration's engine (``engines/<engine>.py``) on the
        traffic of ``mix`` (the cell's own by default) under ``seed``, its
        events drawn by the mix's source (``pixels/<pixels>.py``)."""
        import torch

        from portbench.inputs import Traffic

        cfg, mix = self.config, mix or self.mix
        events = load(self.root, "pixels", mix["pixels"]).events
        traffic = Traffic(mix, seed, cfg["frame_h"], cfg["frame_w"], events)
        engine = load(self.root, "engines", cfg["engine"]).Engine
        return engine(cfg, mix, seed, torch.device(device), traffic)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float = T0) -> tuple[dict, list]:
    """Run the cell once on ``device``; returns the result object and the
    lines of the numbers compared."""
    import torch

    from portbench.readers import on_schedule, traced_schedule
    from portbench.tracing import Tracer

    cell = Cell(root, name)
    dev = torch.device(device)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load(root, "metrics", m["name"]) for m in metrics}
    tracer = None
    if trace:
        tracer = Tracer([w for r in readers.values() for w in getattr(r, "WRAP", ())])
        tracer.install()
    try:
        engine = cell.engine(seed, dev)
        engine.warm_up()
        if tracer is not None:
            tracer.prepare()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rec = engine.run(seconds, tracer)
    finally:
        if tracer is not None:
            tracer.uninstall()
    rec.setup_s, rec.config, rec.mix = setup_s, cell.config, cell.mix
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)}
    breakdown = None
    if tracer is not None:
        if tracer.prof is None:
            raise RuntimeError("the window ended before its traced half began")
        rec.trace, rec.kept = tracer.events(), tracer.kept
        lo, hi = rec.trace.window()
        info["busy_s"] = rec.trace.busy_ns() / 1e9
        info["window_s"] = (hi - lo) / 1e9
        breakdown = {"device_ops": rec.trace.top_device_ops(),
                     "idle_gaps": rec.trace.idle_gaps()}
        unmatched = sum(d[3] is None for d in rec.trace.device)
        trace_line = (f"trace: {len(rec.trace.device)} device records, {unmatched} "
                      f"without their launch, {len(rec.trace.spans)} spans")
        sched = traced_schedule(rec)
        if sched is not None:
            trace_line += (f"; traced part: lateness p95 {sched[0] * 1e3:.4f} ms against "
                           f"an item's {sched[2] * 1e3:.4f} ms, backlog {sched[1]}, "
                           f"{'on' if on_schedule(rec) else 'behind'} schedule")
    out = {}
    for m in metrics:
        value = readers[m["name"]].read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    done = rec.completed()
    lat = sorted(r.done - r.due for r in rec.requests if r.done is not None)
    summary = (f"{name} seed {seed}: {len(rec.requests)} requests, {len(done)} completed "
               f"in the {seconds} s window, backlog {rec.backlog}"
               + (f", latency p50 {statistics.median(lat) * 1e3:.4f} ms" if lat else ""))
    rec.trace = rec.kept = tracer = None
    readings, _ = engine.compare()
    checks, lines = {}, [summary] + ([trace_line] if breakdown is not None else [])
    for key, value in readings.items():
        limit = cell.limits.get(key, {}).get("limit")
        checks[key] = {"value": value, "limit": limit}
        lines.append(f"check {key} = {value!r} (limit {limit!r})")
    correct = bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": len(rec.requests) + rec.backlog,
              "failed": rec.backlog + sum(r.done is None for r in rec.requests),
              "metrics": out, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    # every cache of the program lives at a fixed place in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)
    cell = Cell(root, args.workload)

    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
