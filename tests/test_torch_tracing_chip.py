"""On the card: the port's spans and a CUDA-only ``torch.profiler`` trace
(the benchmark's traced runs take no host operators) share one clock, and
such a session turns the recorder on.

No JAX here: the card's machine has none, so run it there without the
tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_tracing_chip.py
"""

import pytest
import torch

from async_ev_cnn_torch.utils import profiling


@pytest.mark.chip
def test_a_span_contains_its_launch_in_a_cuda_only_trace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    x.mul_(2)  # the kernel's first launch falls outside the trace
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("one.launch"):
            x.mul_(3)
        torch.cuda.synchronize()
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = [s for s in profiling.recorded() if s[0] == "one.launch"]
    assert len(spans) == 1
    _, t0, t1, _, _, _ = spans[0]
    events = list(prof.profiler.kineto_results.events())
    runtime = {e.correlation_id(): e for e in events if e.device_type() == DeviceType.CPU}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in runtime and "elementwise" in e.name()]
    assert len(kernels) == 1, [e.name() for e in events]
    launch = runtime[kernels[0].correlation_id()]
    assert t0 <= launch.start_ns() <= launch.end_ns() <= t1
    profiling.clear()
