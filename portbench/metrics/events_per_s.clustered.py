"""events_per_s.clustered: the incremental engine's work a second on the
clustered mix, the valid events of every chunk whose outputs were complete
on the card in the untraced part of the window, over that part's seconds.
A per-layer reading: on this cell the rate spreads too widely from run to
run for an end-to-end bound, and the cell's end-to-end metric is
``latency_p95_ms``."""

from portbench.readers import events_per_s_untraced as read  # noqa: F401
