"""Everything the benchmark hands the program, made from ``--seed``: the
weights and the event traffic.

One general generator reads a traffic mix (``traffic/<mix>.json``):

* ``streams``, ``chunks`` and ``events_per_chunk`` size a request: each
  stream's item holds ``chunks * events_per_chunk`` events;
* ``pixels`` names the event source, ``pixels/<pixels>.py``, whose
  ``events(rng, n, frame_h, frame_w, gaps, mix)`` draws ``n`` events as
  int64 (y, x, ts) rows (``clustered``: around a drifting centre,
  ``radius`` pixels wide; ``uniform``: every pixel alike);
* ``loop`` is ``closed`` (the next request is handed over as soon as the
  system takes it; timestamps advance by gaps drawn from ``ts_gap_us``,
  both ends included) or ``open`` (events are due at
  ``rate_events_per_s``: event ``n`` of a stream carries the integer µs
  ``floor(n * 1e6 / rate)``, and a request is due when its last event is);
* ``pool`` requests a stream are drawn and replayed in turn, each turn
  shifted in time past the last, so every seed gives the same work at the
  same sizes whatever the length of the window;
* ``warmup_requests`` requests precede the measured window.

The harness finds the source by name (``run.Cell.engine``), so a mix
with new spatial statistics adds a file and edits none.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(seed: int, *purpose: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed (any whole number)."""
    return np.random.default_rng([seed % 2**64, *purpose])


class Traffic:
    """The requests of one mix under one seed: ``item(k, s)`` is stream
    ``s``'s share of request ``k`` (warm-up requests first), an int64
    ``[n, 3]`` array of (y, x, ts) rows; ``events`` is the mix's source
    (``pixels/<pixels>.py``)."""

    def __init__(self, mix: dict, seed: int, frame_h: int, frame_w: int, events):
        self.mix = mix
        self.streams = int(mix["streams"])
        self.chunks = int(mix["chunks"])
        self.events_per_chunk = int(mix["events_per_chunk"])
        self.per_item = self.chunks * self.events_per_chunk
        self.open_loop = mix["loop"] == "open"
        if mix["loop"] not in ("open", "closed"):
            raise ValueError(f"loop must be 'open' or 'closed', got {mix['loop']!r}")
        self.rate = float(mix["rate_events_per_s"]) if self.open_loop else None
        self.warmup = int(mix["warmup_requests"])
        self.pool = int(mix["pool"])
        n = self.pool * self.per_item
        self._pools = []
        for s in range(self.streams):
            rng = rng_for(seed, 1, s)
            self._pools.append(events(rng, n, frame_h, frame_w, self._gaps(), mix))
        # a closed loop's turn of the pool lasts its span plus one gap
        self._turn_us = [int(p[-1, 2]) + int(self._gaps()[0]) for p in self._pools]

    def _gaps(self):
        return self.mix["ts_gap_us"] if not self.open_loop else (1, 1)

    def item(self, k: int, s: int) -> np.ndarray:
        turn, j = divmod(k, self.pool)
        ev = self._pools[s][j * self.per_item:(j + 1) * self.per_item].copy()
        if self.open_loop:
            n = np.arange(k * self.per_item, (k + 1) * self.per_item, dtype=np.int64)
            ev[:, 2] = n * 1_000_000 // int(self.rate)
        else:
            ev[:, 2] += turn * self._turn_us[s]
        return ev

    def due_s(self, k: int) -> float:
        """Open loop: seconds from the first measured event's due time to
        request ``k``'s (its last event's)."""
        first = self.warmup * self.per_item * 1_000_000 // int(self.rate)
        last = ((k + 1) * self.per_item - 1) * 1_000_000 // int(self.rate)
        return (last - first) / 1e6


def make_weights(layers: dict, seed: int, device, scale: float = 0.05) -> dict:
    """Seeded float32 weights in the port's layout (``w_<name>`` OIHW,
    ``b_<name>``), made on ``device`` in one draw (the scale of
    ``chip_smoke.make_params``).  The same seed and device give the same
    weights, so the reference can make its own copy."""
    shapes = []
    for name, size in layers.items():
        if "conv" in name:
            kh, kw, cin, cout = size
            shapes += [(f"w_{name}", (cout, cin, kh, kw)), (f"b_{name}", (cout,))]
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32) * scale
    out, at = {}, 0
    for key, shape in shapes:
        n = int(np.prod(shape))
        out[key] = flat[at:at + n].view(shape)
        at += n
    return out
