"""Share of the window's dispatches that the serving loop replayed as a
captured CUDA graph (the pipeline's ``graph_replays`` over those and its
``eager_dispatches``, counted from its start, warm-up included).  Nothing
where the program counts neither."""


def read(rec):
    replays, eager = rec.counters.get("graph_replays"), rec.counters.get("eager_dispatches")
    if replays is None or eager is None or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
