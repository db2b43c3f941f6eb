"""async-ev-cnn-torch: the PyTorch/CUDA port of async_ev_cnn_tpu.

Module names and paths mirror the JAX package (``ops/integrate.py`` here is
the counterpart of ``async_ev_cnn_tpu/ops/integrate.py``), so a reader finds
each counterpart by name.  The port imports nothing of the JAX package and
never imports ``jax``; framework-free host code it needs (the config DSL,
the timestamp contract, the wire packer) is copied.

Every Pallas kernel of the JAX package on the ported path is a hand-written
CUDA kernel for Hopper (``csrc/``), built with ``nvcc`` at first use.  Each
kernel has a plain PyTorch version of the same arithmetic beside it; a
wrapper runs the plain version only for tensors that lie on the CPU.

Entry points (:class:`~async_ev_cnn_torch.models.yolo.YoloEventTorch`,
:class:`~async_ev_cnn_torch.utils.serving.StreamingPipeline`,
:meth:`~async_ev_cnn_torch.layers.network.EventNetwork.init_state`) run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given
and no GPU present they raise.
"""

__version__ = "0.1.0"

from async_ev_cnn_torch.layers.network import EventNetwork, dense_forward  # noqa: F401
from async_ev_cnn_torch.layers.types import (  # noqa: F401
    ConvState,
    EventChunk,
    IntegrationState,
    LayerIO,
    PoolState,
)
from async_ev_cnn_torch.models.yolo import YoloEventTorch  # noqa: F401
from async_ev_cnn_torch.ops.conv import set_matmul_precision  # noqa: F401
from async_ev_cnn_torch.utils.config import config, layers_dict  # noqa: F401
from async_ev_cnn_torch.utils.serving import StreamingPipeline  # noqa: F401
from async_ev_cnn_torch.utils.weights import params_from_jax  # noqa: F401
