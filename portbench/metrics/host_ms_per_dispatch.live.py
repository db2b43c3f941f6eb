"""Host ms between the serving loop's pulls of successive groups (its
median): the pipeline's own work a dispatch, the source's time left out."""

from portbench.readers import host_ms_per_dispatch as read  # noqa: F401
