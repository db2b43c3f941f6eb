"""Fixtures of the benchmark's tests: a tiny copy of the benchmark that the
CPU runs in seconds (the same harness, engines and reference; a network of
three convs on a 16 x 24 surface)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_LAYERS = {"conv1": [3, 3, 1, 4], "pool1": [2, 2], "conv2": [3, 3, 4, 8],
               "pool2": [2, 2], "conv3": [1, 1, 8, 7]}
TINY_CELLS = {"t.replay": ("tiny_full", "tiny_replay"), "t.live": ("tiny_full", "tiny_live"),
              "t.async": ("tiny_async", "tiny_clustered")}
# each of the repo's cells stands for one tiny cell here
STANDS_FOR = {"efcn_full.replay_s16": "t.replay", "efcn_full.live_s1": "t.live",
              "efcn_async.clustered": "t.async", "efcn_async.uniform": "t.async"}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_tiny_root(dest: Path) -> Path:
    """A checkout-like root: the benchmark's files, tiny configurations and
    mixes, limits, and a BENCHMARK.json of three tiny cells with the repo's
    metrics."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dest / "portbench"
    full = json.loads((pb / "configs" / "efcn_full.json").read_text())
    small = dict(frame_h=16, frame_w=24, layers=TINY_LAYERS, h_cells=4, w_cells=6,
                 num_classes=2, num_bbox=1, events_per_chunk=16)
    _dump(pb / "configs" / "tiny_full.json", dict(full, name="tiny_full", serve_chunks=4, **small))
    asyn = json.loads((pb / "configs" / "efcn_async.json").read_text())
    _dump(pb / "configs" / "tiny_async.json", dict(asyn, name="tiny_async", **small))
    _dump(pb / "traffic" / "tiny_replay.json",
          {"loop": "closed", "streams": 2, "chunks": 4, "events_per_chunk": 16,
           "pixels": "clustered", "radius": 3, "ts_gap_us": [1, 14], "pool": 3,
           "warmup_requests": 2})
    _dump(pb / "traffic" / "tiny_live.json",
          {"loop": "open", "streams": 1, "chunks": 4, "events_per_chunk": 16,
           "pixels": "uniform", "rate_events_per_s": 4000, "pool": 3, "warmup_requests": 2})
    _dump(pb / "traffic" / "tiny_clustered.json",
          {"loop": "closed", "streams": 1, "chunks": 1, "events_per_chunk": 16,
           "pixels": "clustered", "radius": 3, "ts_gap_us": [1, 14], "pool": 64,
           "warmup_requests": 2})
    for cell in TINY_CELLS:
        # the program agrees to rounding at this size; the control's bfloat16
        # surfaces are off by their 8-bit mantissa
        _dump(pb / "limits" / f"{cell}.json",
              {"out_gap": {"limit": 1e-4}, "surface_gap": {"limit": 1e-6}})
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": c, "source": "tests", "file": f"portbench/configs/{c}.json", "reduced": [],
         "why": "a tiny stand-in"} for c in ("tiny_full", "tiny_async")]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                          for n, (c, t) in TINY_CELLS.items()]
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "workloads" in m:
                m["workloads"] = sorted({STANDS_FOR[w] for w in m["workloads"]})
    _dump(dest / "BENCHMARK.json", bench)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
