"""Events around a drifting centre, the mix's ``radius`` pixels wide: the
spatial statistics of a DVS camera watching a moving object (the generator
of ``chip_smoke.clustered_stream``, with its gaps drawn from the mix)."""

import numpy as np


def events(rng, n, h, w, gaps, mix):
    """``n`` events around a centre that drifts once a chunk of the mix's
    ``events_per_chunk``, ts gaps in ``[gaps[0], gaps[1]]`` µs."""
    radius = float(mix["radius"])
    ts = np.cumsum(rng.integers(gaps[0], gaps[1] + 1, size=n))
    t = np.arange(n) / int(mix["events_per_chunk"])
    cy = h / 2 + h / 3 * np.sin(t * 0.05)
    cx = w / 2 + w / 3 * np.cos(t * 0.04)
    y = np.clip(np.round(cy + rng.standard_normal(n) * radius), 0, h - 1)
    x = np.clip(np.round(cx + rng.standard_normal(n) * radius), 0, w - 1)
    return np.stack([y, x, ts], axis=-1).astype(np.int64)
