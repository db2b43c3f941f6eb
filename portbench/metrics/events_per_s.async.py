"""events_per_s.async: the incremental engine's work a second, the valid
events of every chunk whose outputs were complete on the card inside the
window, over the window's seconds.  Apart from the serving cells' metric:
this host-bound path spreads some tens of times wider from run to run, and
its bound would hide the serving cells' regressions."""

from portbench.readers import events_per_s as read  # noqa: F401
