"""events_per_s: the valid events of every request whose outputs were
complete on the card inside the window, over the window's seconds."""

from portbench.readers import events_per_s as read  # noqa: F401
