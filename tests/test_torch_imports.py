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
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.utils.runner import pack_chunks
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ld = layers_dict("conv1=3,3,1,4 pool1=2,2")
    net = EventNetwork(ld, 8, 8, 1e-3, padding="SAME", conv_mode="full")
    params = {"w_conv1": torch.zeros(4, 1, 3, 3), "b_conv1": torch.zeros(4)}
    kw = dict(h_frame=8, w_frame=8, num_classes=1, cnn_layers=ld, cnn_padding="SAME",
              h_cells=4, w_cells=4, num_bbox=1, alpha=0.1, leak=1e-3, conv_mode="full")
    events = np.zeros((3, 3), np.int32)
    for call in (lambda: net.init_state(params),
                 lambda: StreamingPipeline(net, params),
                 lambda: YoloEventTorch(**kw),
                 lambda: pack_chunks(events, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert net.init_state(params, "cpu")[0].surface.device.type == "cpu"
    assert StreamingPipeline(net, params, device="cpu").device.type == "cpu"
    assert YoloEventTorch(**kw, device="cpu").device.type == "cpu"
