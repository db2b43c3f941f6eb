"""The least time of the gather-GEMM work K3's rulebooks need (the larger
of operations at 67 TFLOP/s and bytes at 3.35 TB/s, each call's active
sites) over K3's device time."""

from portbench.readers import K3, K3_SITES, k3_roofline as read  # noqa: F401

WRAP = [K3_SITES, K3]
