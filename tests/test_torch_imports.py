"""The port stands alone: importing async_ev_cnn_torch and every module of
it pulls in neither jax nor the JAX package, needs no compiler, and its
entry points never carry on quietly on the CPU when no device is given."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "async_ev_cnn_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)

torch.set_num_threads(2)


def test_port_imports_no_jax_and_no_jax_package():
    """In a fresh interpreter (this one has already imported jax)."""
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'async_ev_cnn_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 20


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    """chip_smoke.py imports neither jax nor the JAX package, and without a
    CUDA device it exits non-zero with nothing on standard output."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "async_ev_cnn_tpu")}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_entry_points_raise_without_a_device(monkeypatch):
    """With no device given and no CUDA device present, the entry points
    raise instead of running on the CPU; device='cpu' is the explicit way."""
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.models.yolo import YoloEventTorch, YoloFrameTorch
    from async_ev_cnn_torch.ops.integrate import integrate_frame, integrate_frame_chunked
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.scripts import test_correctness
    from async_ev_cnn_torch.utils.equivalence import make_stream, run_equivalence
    from async_ev_cnn_torch.utils.runner import pack_chunks
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ld = layers_dict("conv1=3,3,1,4 pool1=2,2")
    net = EventNetwork(ld, 8, 8, 1e-3, padding="SAME", conv_mode="full")
    params = {"w_conv1": torch.zeros(4, 1, 3, 3), "b_conv1": torch.zeros(4)}
    kw = dict(h_frame=8, w_frame=8, num_classes=1, cnn_layers=ld, cnn_padding="SAME",
              h_cells=4, w_cells=4, num_bbox=1, alpha=0.1, leak=1e-3, conv_mode="full")
    events = np.zeros((3, 3), np.int32)
    chunks = make_stream(np.random.RandomState(0), 3, 2, 8, 8, device="cpu")
    for call in (lambda: net.init_state(params),
                 lambda: StreamingPipeline(net, params),
                 lambda: YoloEventTorch(**kw),
                 lambda: YoloFrameTorch(**kw),
                 lambda: integrate_frame(events, 1e-3, 8, 8),
                 lambda: integrate_frame_chunked(events, 1e-3, 8, 8),
                 lambda: pack_chunks(events, 4),
                 lambda: make_stream(np.random.RandomState(0), 3, 2, 8, 8),
                 lambda: run_equivalence(net, params, chunks),
                 lambda: test_correctness.main(["--iterations", "3"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert net.init_state(params, "cpu")[0].surface.device.type == "cpu"
    assert StreamingPipeline(net, params, device="cpu").device.type == "cpu"
    assert YoloEventTorch(**kw, device="cpu").device.type == "cpu"
    assert YoloFrameTorch(**kw, device="cpu").device.type == "cpu"
    assert integrate_frame(events, 1e-3, 8, 8, device="cpu")[0].device.type == "cpu"
    assert chunks.y.device.type == "cpu"
    assert max(run_equivalence(net, params, chunks, device="cpu").max_diff.values()) == 0.0
    assert test_correctness.main(["--iterations", "20", "--device", "cpu",
                                  "--mode", "sparse_pallas"]) == 0


def test_serving_slice_entry_points_raise_without_a_device(monkeypatch, tmp_path):
    """The serving slice's entry points (the multi-stream pipeline, the
    runners, device_prefetch, pack_chunks_usec, the serve CLI) raise
    without a device given and no CUDA device present; device='cpu' runs
    them on the CPU."""
    from types import SimpleNamespace

    from async_ev_cnn_torch.data.prefetch import device_prefetch
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.scripts import serve
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.utils.runner import EventRunner, pack_chunks_usec
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = EventNetwork(layers_dict("conv1=3,3,1,4 pool1=2,2"), 8, 8, 1e-3, padding="SAME",
                       conv_mode="full")
    params = {"w_conv1": torch.zeros(4, 1, 3, 3), "b_conv1": torch.zeros(4)}
    reader = SimpleNamespace(num_classes=lambda: 1, label_to_idx=lambda: {"a": 0})
    events = np.zeros((3, 3), np.int32)
    for call in (lambda: StreamingPipeline(net, params, streams=3),
                 lambda: EventRunner(SimpleNamespace(), reader),
                 lambda: list(device_prefetch(iter([events]))),
                 lambda: pack_chunks_usec(events, 4, 10),
                 lambda: serve.main(["--mode", "full"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    pipe = StreamingPipeline(net, params, streams=3, device="cpu")
    assert pipe.state[0].surface.shape == (3, 1, 8, 8) and pipe.wire_tier == "ultra4"
    assert EventRunner(SimpleNamespace(), reader, device="cpu").device.type == "cpu"
    assert list(device_prefetch(iter([events]), device="cpu"))[0].device.type == "cpu"
    assert pack_chunks_usec(events, 4, 10, device="cpu").y.device.type == "cpu"
