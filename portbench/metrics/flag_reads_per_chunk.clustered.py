"""Host reads of device flags a chunk, summed over the conv layers
(``EventNetwork.layer_counts[...]["host_syncs"]``)."""

from portbench.readers import flag_reads_per_chunk as read  # noqa: F401
