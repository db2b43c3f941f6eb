"""Topology fuzz of the port's async-vs-dense gate: the twin of
tests/test_equivalence_fuzz.py on async_ev_cnn_torch.

The same seeded draws build the same random layer stacks (kernel sizes,
widths, pool placement, SAME and VALID padding, leak and alpha) and the
same streams as the JAX file (the port's ``make_stream`` draws what the
JAX package's draws, call for call), and the port's lockstep harness
(``utils/equivalence.run_equivalence``) holds every layer of the
incremental engine against the dense oracle at each step.  The JAX
file's modes 'dense' and 'full' run here, and besides them the port's
'sparse_pallas' (K3/K4) and 'sparse_rows' (K5's update) through their
plain versions, the CPU's kernels.

Tolerances: every layer within 1e-4 of the dense oracle (the JAX file's
gate); the port's 'full' network outputs within 1e-4 of the JAX
package's on the same net and stream (float32 convs whose sums run in
another order).
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.utils.equivalence import make_stream, run_equivalence
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk

torch.set_num_threads(2)

TOL = 1e-4
MODES = ["dense", "full", "sparse_pallas", "sparse_rows"]


def _random_net(rs: np.random.RandomState):
    """tests/test_equivalence_fuzz.py's ``_random_net``, draw for draw,
    with the weights as numpy arrays (HWIO)."""
    h = int(rs.choice([8, 12, 16]))
    w = int(rs.choice([8, 12, 16, 20]))
    padding = str(rs.choice(["SAME", "VALID"]))
    layer_defs = OrderedDict()
    cin, ch, cw = 1, h, w
    n_layers = int(rs.randint(2, 5))
    conv_i = pool_i = 0
    for _ in range(n_layers):
        want_pool = rs.rand() < 0.35 and ch >= 4 and cw >= 4
        if want_pool:
            pool_i += 1
            layer_defs[f"pool{pool_i}"] = [2, 2]
            ch //= 2
            cw //= 2
            continue
        k = int(rs.choice([1, 3]))
        if padding == "VALID" and (ch < k or cw < k):
            k = 1
        cout = int(rs.choice([2, 4, 6]))
        conv_i += 1
        layer_defs[f"conv{conv_i}"] = [k, k, cin, cout]
        cin = cout
        if padding == "VALID":
            ch, cw = ch - k + 1, cw - k + 1
    if conv_i == 0:
        layer_defs["conv1"] = [3 if min(ch, cw) >= 3 else 1] * 2 + [cin, 4]
        k = layer_defs["conv1"][0]
        if padding == "VALID":
            ch, cw = ch - k + 1, cw - k + 1
    params = {}
    for name, size in layer_defs.items():
        if "conv" in name:
            kh, kw, ci, co = size
            params[f"w_{name}"] = rs.randn(kh, kw, ci, co).astype(np.float32) * 0.4
            params[f"b_{name}"] = rs.randn(co).astype(np.float32) * 0.2
    leak = float(rs.choice([0.01, 0.05, 0.1]))
    alpha = float(rs.choice([0.0, 0.1, 0.3]))
    return layer_defs, params, h, w, leak, alpha, padding


def _gate(seed, conv_mode, steps, events_per_step):
    rs = np.random.RandomState(1000 + seed)
    layer_defs, params, h, w, leak, alpha, padding = _random_net(rs)
    net = EventNetwork(layer_defs, h, w, leak=leak, alpha=alpha, padding=padding,
                       conv_mode=conv_mode)
    chunks = make_stream(rs, steps=steps, events_per_step=events_per_step, h=h, w=w,
                         device="cpu")
    report = run_equivalence(net, params_from_jax(params, "cpu"), chunks, device="cpu")
    for name, diff in report.max_diff.items():
        assert diff <= TOL, (
            f"seed {seed} mode {conv_mode} layer {name}: {diff:.2e} > {TOL}; "
            f"net={dict(layer_defs)} pad={padding} leak={leak} alpha={alpha}")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("conv_mode", MODES)
def test_random_topology_equivalence(seed, conv_mode):
    _gate(seed, conv_mode, steps=150, events_per_step=4)


@pytest.mark.parametrize("seed", range(6))
def test_random_topology_full_matches_jax(seed):
    """The port's 'full' network and the JAX package's on the same random
    net and stream: the outputs of every step within 1e-4."""
    rs = np.random.RandomState(1000 + seed)
    layer_defs, params, h, w, leak, alpha, padding = _random_net(rs)
    chunks = make_stream(rs, steps=150, events_per_step=4, h=h, w=w, device="cpu")
    kw = dict(leak=leak, alpha=alpha, padding=padding, conv_mode="full")
    tnet, jnet = EventNetwork(layer_defs, h, w, **kw), JNet(layer_defs, h, w, **kw)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, got = tnet.scan(tp, tnet.init_state(tp, "cpu"), TChunk(*chunks))
    _, want = jnet.scan(jp, jnet.init_state(jp), JChunk(*(jnp.asarray(f.numpy())
                                                          for f in chunks)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL,
                               err_msg=f"seed {seed} net={dict(layer_defs)} pad={padding}")


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6, 14))
def test_random_topology_equivalence_more(seed):
    """The JAX file's wider sweep: longer streams, every mode per seed."""
    for conv_mode in MODES:
        _gate(seed, conv_mode, steps=400, events_per_step=5)
