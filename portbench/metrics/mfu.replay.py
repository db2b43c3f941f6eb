"""The dense network's operations on every frame completed in the window,
as a share of the card's float32 peak (67 TFLOP/s)."""

from portbench.readers import mfu as read  # noqa: F401
