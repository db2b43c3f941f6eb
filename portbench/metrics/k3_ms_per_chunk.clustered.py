"""Device ms a chunk of the kernels launched inside K3's entry
(``ops/rulebook_gemm.rulebook_gather_gemm_blocks``)."""

from portbench.readers import K3, K3_SITES, k3_ms_per_chunk as read  # noqa: F401

WRAP = [K3_SITES, K3]
