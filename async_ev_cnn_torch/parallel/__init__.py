"""Data, model and time parallelism over ``torch.distributed`` (the JAX
package's ``parallel``), one process a device."""

from async_ev_cnn_torch.parallel.mesh import (  # noqa: F401
    Comm,
    init_world,
    make_mesh,
    make_time_mesh,
    world,
)
from async_ev_cnn_torch.parallel.streams import MultiStreamEngine  # noqa: F401
from async_ev_cnn_torch.parallel.time_shard import TimeShardEngine  # noqa: F401
