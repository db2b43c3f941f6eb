"""Share of the traced window in which no kernel, copy or fill ran, read
only where the generator kept the cell's schedule while the profiler ran
(no backlog, lateness p95 under an item's interval): under CUPTI the host
is slower, and a traced part that fell behind is not at the cell's load."""

from portbench.readers import idle_share, on_schedule


def read(rec):
    return idle_share(rec) if on_schedule(rec) else None
