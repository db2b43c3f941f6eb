"""Host utilities of the port: config, wire, runner, serving, weights."""

from async_ev_cnn_torch.utils.checkpoint import (  # noqa: F401
    load_params,
    load_params_orbax,
    save_params,
    save_params_orbax,
)
