"""The harness on the CPU: its checks, the files it finds by name, and
whole runs of tiny cells, sound, under the control and with the timed path
broken."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest
import torch

from portbench.harness import Record, Request
from portbench.run import Cell, forbidden_modules, load, run_cell

from .conftest import REPO, make_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "async_ev_cnn_tpu",
             "async_ev_cnn_tpu.ops", "async_ev_cnn_torch", "async_ev_cnn_torch.ops.conv",
             "jaxtyping", "flaxen", "async_ev_cnn_tpux", "torch"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "async_ev_cnn_tpu",
         "async_ev_cnn_tpu.ops"])


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] == 1
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert 0 < len(w["why"]) <= 200
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists() and all(NAME.match(k) for k in c["reduced"])
        engine = json.loads((REPO / c["file"]).read_text())["engine"]
        assert (REPO / "portbench" / "engines" / f"{engine}.py").exists()
    for w in bench["workloads"]:
        mix = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "pixels" / f"{mix['pixels']}.py").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    for cell in cells:  # each cell reports setup_s, another end-to-end metric, a layer
        reports = [m for m in metrics if cell in m.get("workloads", [cell])]
        assert len([m for m in reports if m["name"] in e2e]) >= 2
        assert any(m["name"] not in e2e for m in reports)
    assert bench["command"][:3] == ["python3", "-m", "portbench.run"]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copy(root / "portbench" / "traffic" / "tiny_replay.json",
                root / "portbench" / "traffic" / "tiny_more.json")
    (root / "portbench" / "metrics" / "requests_seen.more.py").write_text(
        "def read(rec):\n    return len(rec.requests)\n")
    bench["workloads"].append({"name": "t.more", "config": "tiny_full",
                               "traffic": "tiny_more", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "requests_seen.more", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving loop", "moves": "events_per_s",
                               "workloads": ["t.more"]})
    bench["end_to_end"][0]["workloads"].append("t.more")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell(root, "t.more")
    assert cell.mix["streams"] == 2 and cell.config["name"] == "tiny_full"
    assert [m["name"] for m in cell.per_layer] == ["requests_seen.more"]
    assert load(root, "metrics", "requests_seen.more").read(
        type("R", (), {"requests": [1, 2]})) == 2


def test_an_engine_and_an_event_source_added_as_files_are_found(tmp_path):
    root = make_tiny_root(tmp_path)
    pb = root / "portbench"
    shutil.copy(pb / "engines" / "step.py", pb / "engines" / "step_again.py")
    (pb / "pixels" / "diagonal.py").write_text(
        "import numpy as np\n\n\ndef events(rng, n, h, w, gaps, mix):\n"
        "    i = rng.integers(0, min(h, w), size=n)\n"
        "    ts = np.cumsum(rng.integers(gaps[0], gaps[1] + 1, size=n))\n"
        "    return np.stack([i, i, ts], axis=-1).astype(np.int64)\n")
    cfg = json.loads((pb / "configs" / "tiny_async.json").read_text())
    (pb / "configs" / "tiny_again.json").write_text(
        json.dumps(dict(cfg, name="tiny_again", engine="step_again")))
    mix = json.loads((pb / "traffic" / "tiny_clustered.json").read_text())
    (pb / "traffic" / "tiny_diagonal.json").write_text(json.dumps(dict(mix, pixels="diagonal")))
    shutil.copy(pb / "limits" / "t.async.json", pb / "limits" / "t.diag.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_again", "source": "tests",
                             "file": "portbench/configs/tiny_again.json", "reduced": [],
                             "why": "added"})
    bench["workloads"].append({"name": "t.diag", "config": "tiny_again",
                               "traffic": "tiny_diagonal", "chips": 1, "why": "added"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "t.async" in m.get("workloads", []):
            m["workloads"].append("t.diag")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    engine = Cell(root, "t.diag").engine(5, "cpu")
    assert type(engine).__module__ == "portbench_engines_step_again"
    ev = engine.traffic.item(0, 0)
    assert (ev[:, 0] == ev[:, 1]).all()
    result, lines = _run(root, "t.diag")
    assert result["correct"], lines
    assert {"events_per_s.async", "latency_p95_ms", "setup_s"} == set(result["metrics"])


class _Trace:  # a device trace of 10 ms with 4 ms busy
    device = [1]

    def window(self):
        return 0, 10_000_000

    def busy_ns(self):
        return 4_000_000


@pytest.mark.parametrize("lateness_s, backlog, reads", [
    (0.0001, 0, True), (0.002, 0, True), (0.02, 0, False), (0.0001, 3, False)])
def test_a_live_traced_part_behind_its_schedule_gives_no_idle_share(lateness_s, backlog, reads):
    # items of 4 x 16 events at 6,400 events/s: due 10 ms apart
    mix = {"loop": "open", "chunks": 4, "events_per_chunk": 16, "rate_events_per_s": 6400}
    rec = Record(seconds=1.0, t_start=0.0, mix=mix, trace=_Trace(), backlog=backlog,
                 lateness_s=[0.0] * 30 + [lateness_s] * 40, trace_from=30, trace_t0=0.5)
    value = load(REPO, "metrics", "device_idle_share.live").read(rec)
    assert (value == pytest.approx(60.0)) if reads else value is None
    # the untraced part and the other cells' readers are not gated
    assert load(REPO, "metrics", "device_idle_share.replay").read(rec) == pytest.approx(60.0)


def test_the_per_layer_rate_reads_the_untraced_part():
    # 30 requests of 100 events done in the first 0.5 s, 40 in the traced rest
    reqs = [Request(due=0.0, events=100, frames=1, done=0.01 * k) for k in range(30)]
    reqs += [Request(due=0.0, events=100, frames=1, done=0.51 + 0.01 * k) for k in range(40)]
    rec = Record(seconds=1.0, t_start=0.0, requests=reqs, trace_from=30, trace_t0=0.5)
    assert load(REPO, "metrics", "events_per_s.clustered").read(rec) == pytest.approx(6000.0)
    rec.trace_from = rec.trace_t0 = None
    assert load(REPO, "metrics", "events_per_s.clustered").read(rec) == pytest.approx(
        load(REPO, "metrics", "events_per_s.async").read(rec))


def _run(root, cell, trace=False, seconds=0.4):
    return run_cell(root, cell, 2**31 + 77, seconds, trace, "cpu", t0=time.perf_counter())


@pytest.mark.parametrize("cell", ["t.replay", "t.live", "t.async"])
def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny_root, cell):
    result, lines = _run(tiny_root, cell, seconds=1.0 if cell == "t.live" else 0.4)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks" and lines[-1].startswith("check surface_gap")
    want = {m["name"] for m in Cell(tiny_root, cell).end_to_end}
    assert set(result["metrics"]) == want


def test_a_traced_run_reads_its_counters(tiny_root):
    result, _ = _run(tiny_root, "t.async", trace=True)
    assert result["correct"]
    m = result["metrics"]
    # a CPU run writes no device metric
    assert "k3_ms_per_chunk.async" not in m and "device_idle_share.async" not in m
    assert m["flag_reads_per_chunk.async"]["value"] > 0
    assert 0 <= m["dense_fallback_share.async"]["value"] <= 100
    # the clustered cell's twins read the same counters
    for name in ("flag_reads_per_chunk", "dense_fallback_share"):
        assert m[f"{name}.clustered"] == m[f"{name}.async"]
    assert "k3_ms_per_chunk.clustered" not in m and "device_idle_share.clustered" not in m
    assert m["events_per_s.clustered"]["value"] > 0


def test_the_control_fails(tiny_root):
    from portbench.control import readings

    summary = readings(tiny_root, "t.async", [5, 6, 7], 3, 0.3, device="cpu",
                       out=open("/dev/null", "w"))
    limits = Cell(tiny_root, "t.async").limits
    assert any(summary["upper"][k] > limits[k]["limit"] for k in limits)
    assert all(summary["lower"][k] <= limits[k]["limit"] for k in limits)


def _fault(monkeypatch, kind: str, cell: str):
    """Break the timed path underneath the harness."""
    from async_ev_cnn_torch.layers import network
    from async_ev_cnn_torch.layers.types import EventChunk

    net = network.EventNetwork
    if cell == "t.async":
        step = net.step

        def broken(self, params, state, chunk):
            if kind == "half":  # half of the chunk's events left out
                valid = chunk.valid.clone()
                valid[valid.shape[0] // 2:] = False
                chunk = EventChunk(*chunk[:4], valid)
            new, out = step(self, params, state, chunk)
            if kind == "stale":
                new = state
            if kind == "altered":
                out = out.contiguous().clone()
                out.view(-1)[0] += 1.0
            return new, out

        monkeypatch.setattr(net, "step", broken)
        return
    scan = net.scan_parallel

    def broken(self, params, state, chunks, **kw):
        if kind == "half":  # half of the streams' events left out
            valid = chunks.valid.clone()
            valid[: max(1, valid.shape[0] // 2)] = False
            chunks = EventChunk(*chunks[:4], valid)
        new, outs = scan(self, params, state, chunks, **kw)
        if kind == "stale":
            new = state
        if kind == "altered":
            outs = outs.contiguous().clone()
            outs.view(-1)[0] += 1.0
        return new, outs

    monkeypatch.setattr(net, "scan_parallel", broken)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ["t.replay", "t.async"])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, kind):
    _fault(monkeypatch, kind, cell)
    result, lines = _run(tiny_root, cell)
    assert not result["correct"], lines


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["efcn_full.replay_s16", "efcn_async.clustered"])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run python -m pytest portbench/tests -m chip there")
    from portbench.control import readings

    summary = readings(REPO, cell, [11, 12, 13], 3, 2.0, out=open("/dev/null", "w"))
    limits = Cell(REPO, cell).limits
    assert any(summary["upper"][k] > limits[k]["limit"] for k in limits)
    assert all(summary["lower"][k] <= limits[k]["limit"] for k in limits)
