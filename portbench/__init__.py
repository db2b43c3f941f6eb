"""The benchmark of ``async_ev_cnn_torch`` on one NVIDIA H100 (see README.md)."""
