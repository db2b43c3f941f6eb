"""F7: the full-width eFCN 'dense' drift, in both packages on the CPU.

On the H100 the port's full-width eFCN in conv_mode 'dense' drifts 1.5e-4
from the dense oracle at 'highest' over 10,000 steps
(async_ev_cnn_torch/scripts/precision_drift.py), above the reference's
1e-4.  This test runs the same seeded stream (the drift script's: seed 7,
200 uniform events a step, max_dt 30) and the same seeded weights (scale
0.05) through both packages' lockstep harnesses (``run_equivalence``) on
the CPU at 'highest', and prints each package's max |async - dense| over
all steps and layers.

It holds the port to the rule that decides F7: the port's drift may exceed
1e-4 only where the JAX package's does too (then the drift is the
reference's, inherited).  Slow: 10,000 steps of two full-width networks
take tens of minutes on a CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_drift_f7.py -m slow -s
"""

import time

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.scripts.precision_drift import EFCN, efcn_net
from async_ev_cnn_torch.utils.equivalence import make_stream as t_make_stream
from async_ev_cnn_torch.utils.equivalence import run_equivalence as t_run_equivalence
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.utils.config import layers_dict as j_layers_dict
from async_ev_cnn_tpu.utils.equivalence import make_stream as j_make_stream
from async_ev_cnn_tpu.utils.equivalence import run_equivalence as j_run_equivalence

# steps of the stream; the drift script's default, so the stream is the
# one whose drift was measured on the H100
STEPS = 10_000
GATE = 1e-4


def _streams(make, steps, **kw):
    """The drift script's draws: the small gate net's stream first, then
    the eFCN's from the same generator."""
    rng = np.random.RandomState(7)
    make(rng, steps, 5, 8, 8, **kw)
    return make(rng, steps, 200, 160, 224, max_dt=30, **kw)


@pytest.mark.slow
def test_f7_full_width_dense_drift_both_packages():
    torch.set_num_threads(4)
    net, params = efcn_net("cpu", conv_mode="dense")
    t0 = time.perf_counter()
    rep_t = t_run_equivalence(net, params, _streams(t_make_stream, STEPS, device="cpu"),
                              device="cpu")
    sec_t = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    jparams = {}
    for name, (kh, kw, ci, co) in ((n, s) for n, s in j_layers_dict(EFCN).items()
                                   if "conv" in n):
        jparams[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.05
        jparams[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.05
    for k, v in jparams.items():  # the same weights in both packages
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        np.testing.assert_array_equal(params[k].numpy(), want)
    jnet = JNet(j_layers_dict(EFCN), 160, 224, leak=5e-5, alpha=0.1, padding="SAME",
                conv_mode="dense")
    t0 = time.perf_counter()
    rep_j = j_run_equivalence(jnet, jparams, _streams(j_make_stream, STEPS))
    sec_j = time.perf_counter() - t0

    drift_t, drift_j = max(rep_t.max_diff.values()), max(rep_j.max_diff.values())
    print(f"\nF7 drift over {STEPS} steps, eFCN 160x224 'dense' at 'highest' on the CPU: "
          f"port {drift_t:.6e} ({sec_t:.0f} s), JAX package {drift_j:.6e} ({sec_j:.0f} s)")
    print(f"per layer, port: {dict(rep_t.max_diff)}")
    print(f"per layer, JAX:  {dict(rep_j.max_diff)}")
    assert np.isfinite(drift_t) and np.isfinite(drift_j)
    assert drift_t <= GATE or drift_j > GATE, (
        f"port drifts {drift_t:.3e} > {GATE} where the JAX package stays at {drift_j:.3e}")
