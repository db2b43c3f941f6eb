"""Every pixel alike: a moving camera over a textured scene (the generator
of ``chip_smoke.synth_stream``, with its gaps drawn from the mix)."""

import numpy as np


def events(rng, n, h, w, gaps, mix):
    """``n`` events on uniform pixels, ts gaps in ``[gaps[0], gaps[1]]`` µs."""
    ts = np.cumsum(rng.integers(gaps[0], gaps[1] + 1, size=n))
    y = rng.integers(0, h, size=n)
    x = rng.integers(0, w, size=n)
    return np.stack([y, x, ts], axis=-1).astype(np.int64)
