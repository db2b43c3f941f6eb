"""Ops of the port: numerics, convs, pools and the surface-scan kernels."""
