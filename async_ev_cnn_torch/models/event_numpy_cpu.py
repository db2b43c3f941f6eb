"""CPU coordinate-list async engine: benchmark baseline and third oracle.

Copied from ``async_ev_cnn_tpu/models/event_numpy_cpu.py`` (host numpy, on
the port's ``ops/conv`` padding rules; held against the original by
tests/test_torch_frame.py).

A host-side implementation of the asynchronous algorithm in the
*reference's style* — explicit active-site coordinate lists, per-site
receptive-field gathers, GEMM over the gathered columns — rather than the
dense-mask formulation of the device engines.  Two purposes:

1. **Benchmark baseline**: a faithful, *vectorized* stand-in for the
   reference's Cython `im2col_event` path (cutils.pyx:26-134) on the same
   host — numpy's ``sliding_window_view`` gather + BLAS GEMM is at least as
   fast as the serial Cython loop, so events/sec ratios against it are
   conservative.
2. **Oracle triangulation**: a third independent implementation of the
   async semantics, cross-checked against the port's async network and
   the dense oracle in tests.
"""

from __future__ import annotations

import numpy as np

from async_ev_cnn_torch.ops.conv import conv_out_shape, conv_pads


def _snap(x):
    return np.float32(np.round(np.float32(x) * np.float32(2.0**20)) * np.float32(2.0**-20))


class AsyncEventNumpy:
    """Stateful CPU async net built from the same layer-DSL dict.

    API: ``step(events) -> [C, h, w] featuremap`` where ``events`` is
    ``[N, 3]`` rows of (y, x, ts); ``reset()`` restores the initial state.
    """

    def __init__(self, layer_defs, params, frame_h, frame_w, leak, alpha=0.1,
                 padding="SAME"):
        self.leak = np.float32(leak)
        self.alpha = np.float32(alpha)
        self.h, self.w = frame_h, frame_w
        self.layers = []
        prev_shape = (1, frame_h, frame_w)
        for name, size in layer_defs.items():
            if "conv" in name:
                kh, kw, ci, co = size
                kernel = np.asarray(params[f"w_{name}"], np.float32)  # HWIO
                kmat = kernel.transpose(3, 2, 0, 1).reshape(co, -1)   # O x (C kh kw)
                pads = conv_pads(prev_shape[1], prev_shape[2], kh, kw, 1, padding)
                oh, ow = conv_out_shape(prev_shape[1], prev_shape[2], kh, kw, 1, padding)
                self.layers.append(dict(
                    kind="conv", kmat=kmat, bias=np.asarray(params[f"b_{name}"], np.float32),
                    ksize=(kh, kw), pads=pads, out_shape=(co, oh, ow),
                    in_shape=prev_shape,
                ))
                prev_shape = (co, oh, ow)
            elif "pool" in name:
                kh, kw = size
                oh, ow = (prev_shape[1] - kh) // kh + 1, (prev_shape[2] - kw) // kw + 1
                self.layers.append(dict(
                    kind="pool", ksize=(kh, kw), out_shape=(prev_shape[0], oh, ow),
                    in_shape=prev_shape,
                ))
                prev_shape = (prev_shape[0], oh, ow)
        self.reset()

    # ---- state ------------------------------------------------------------

    def reset(self):
        self.surface = np.zeros((self.h, self.w), np.float32)
        self.prev_ts = 0
        # dense init chain (conv of zeros propagates biases,
        # conv2d.py:59-61 / maxpool.py:31-35 semantics)
        surf_prev = self.surface[None].copy()
        act_prev = (surf_prev > 0).astype(np.float32)
        fm_prev = surf_prev * act_prev
        for layer in self.layers:
            if layer["kind"] == "conv":
                layer["fm"] = self._dense_conv(layer, fm_prev)
                layer["cact"] = np.zeros(layer["out_shape"], np.float32)
                actfn = np.where(layer["fm"] > 0, np.float32(1), self.alpha)
                surf_prev = layer["fm"]
                fm_prev = layer["fm"] * actfn
                act_prev = actfn
            else:
                _, oh, ow = layer["out_shape"]
                surf_w = self._windows(layer, surf_prev)
                layer["idx"] = surf_w.argmax(-1).astype(np.int32)
                layer["recompute"] = np.zeros((oh, ow), bool)
                take = np.take_along_axis
                surf_prev = take(surf_w, layer["idx"][..., None], -1)[..., 0]
                act_w = self._windows(layer, act_prev)
                act_prev = take(act_w, layer["idx"][..., None], -1)[..., 0]
                fm_prev = surf_prev * act_prev

    @staticmethod
    def _windows(layer, array):
        kh, kw = layer["ksize"]
        c, oh, ow = layer["out_shape"]
        v = np.lib.stride_tricks.sliding_window_view(
            array[:, : oh * kh, : ow * kw], (kh, kw), axis=(1, 2)
        )[:, ::kh, ::kw]
        return v.reshape(c, oh, ow, kh * kw)

    def _dense_conv(self, layer, x):
        (pt, pb), (pl, pr) = layer["pads"]
        xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr)))
        kh, kw = layer["ksize"]
        win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(1, 2))
        out = np.einsum("cyxhw,ochw->oyx", win,
                        layer["kmat"].reshape(-1, x.shape[0], kh, kw),
                        optimize=True)
        return (out + layer["bias"][:, None, None]).astype(np.float32)

    # ---- async step ---------------------------------------------------------

    def step(self, events):
        events = np.asarray(events)
        if events.shape[0] == 0:
            # empty chunk: time does not advance and nothing lands — the
            # zero-delta step below is an exact no-op through every layer
            # (a bare ts.max() raised here where integrate_step's
            # TS_SENTINEL fallback is a no-op)
            y = x = ts = np.zeros(0, np.int64)
            last_ts = int(self.prev_ts)
        else:
            y, x, ts = events[:, 0], events[:, 1], events[:, 2]
            # clamp like integrate_step (ops/integrate.py): a chunk whose
            # events are older than prev_ts must not produce a NEGATIVE
            # leak delta (which grew every pixel and moved time backwards)
            last_ts = max(int(ts.max()), int(self.prev_ts))
        delta = _snap(np.float32(last_ts - self.prev_ts) * self.leak)

        # integration (coordinate semantics: last duplicate wins = the
        # (ts, index)-lexicographic max; a stable ts sort makes the
        # fancy-index assignment's last-occurrence-wins match it even
        # for unsorted input)
        order = np.argsort(ts, kind="stable")
        before_pos = self.surface > 0
        s = self.surface - delta
        leak_neg = s <= 0
        s[leak_neg] = 0
        add = np.zeros_like(s)
        contrib = np.float32(1) - _snap(
            (last_ts - ts).astype(np.float32) * self.leak)
        add[y[order], x[order]] = contrib[order]
        s = s + add
        ev_neg = s <= 0
        s[ev_neg] = 0
        self.surface = s
        self.prev_ts = last_ts
        mask = before_pos & (leak_neg | ev_neg)
        mask[y, x] = True
        coords = np.argwhere(mask)  # [K, 2] active input sites

        fm_prev = self.surface[None]
        actfn_prev = (self.surface[None] > 0).astype(np.float32)
        layer_act_prev = actfn_prev
        surf_prev = self.surface[None]

        for layer in self.layers:
            if layer["kind"] == "conv":
                coords, fm_prev, layer_act_prev, actfn_prev, surf_prev = (
                    self._conv_step(layer, coords, fm_prev, actfn_prev, delta)
                )
            else:
                coords, fm_prev, layer_act_prev, actfn_prev, surf_prev = (
                    self._pool_step(layer, coords, surf_prev, layer_act_prev, actfn_prev)
                )
        return fm_prev

    def _conv_step(self, layer, coords, fm_prev, cact_prev, delta):
        (pt, pb), (pl, pr) = layer["pads"]
        kh, kw = layer["ksize"]
        o, oh, ow = layer["out_shape"]
        before_sign = layer["fm"] >= 0
        layer["fm"] = layer["fm"] - _snap(layer["cact"] * delta)

        # active output sites: dedup'd covered set of the events
        if len(coords):
            ys = coords[:, 0] + pt
            xs = coords[:, 1] + pl
            dy, dx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
            cand_y = ys[:, None] - dy.reshape(-1)[None, :]
            cand_x = xs[:, None] - dx.reshape(-1)[None, :]
            keep = (cand_y >= 0) & (cand_y < oh) & (cand_x >= 0) & (cand_x < ow)
            sites = np.unique(cand_y[keep] * ow + cand_x[keep])
            sy, sx = sites // ow, sites % ow
        else:
            sy = sx = np.zeros(0, np.int64)

        if len(sy):
            fmp = np.pad(fm_prev, ((0, 0), (pt, pb), (pl, pr)))
            cap = np.pad(cact_prev, ((0, 0), (pt, pb), (pl, pr)))
            win_f = np.lib.stride_tricks.sliding_window_view(fmp, (kh, kw), axis=(1, 2))
            win_c = np.lib.stride_tricks.sliding_window_view(cap, (kh, kw), axis=(1, 2))
            patches_f = win_f[:, sy, sx].transpose(1, 0, 2, 3).reshape(len(sy), -1)
            patches_c = win_c[:, sy, sx].transpose(1, 0, 2, 3).reshape(len(sy), -1)
            layer["fm"][:, sy, sx] = (patches_f @ layer["kmat"].T).T + layer["bias"][:, None]
            layer["cact"][:, sy, sx] = (patches_c @ layer["kmat"].T).T

        after_sign = layer["fm"] >= 0
        changed = np.any(before_sign != after_sign, axis=0)
        changed[sy, sx] = True
        out_coords = np.argwhere(changed)

        actfn = np.where(layer["fm"] > 0, np.float32(1), self.alpha)
        fm = layer["fm"] * actfn
        cact = layer["cact"] * actfn
        return out_coords, fm, actfn, cact, layer["fm"]

    def _pool_step(self, layer, coords, surf_prev, layer_act_prev, cact_prev):
        kh, kw = layer["ksize"]
        c, oh, ow = layer["out_shape"]
        if len(coords):
            wy = coords[:, 0] // kh
            wx = coords[:, 1] // kw
            keep = (wy < oh) & (wx < ow)  # drop tail-row/col events, like the mask path
            wy, wx = wy[keep], wx[keep]
        else:
            wy = wx = np.zeros(0, np.int64)
        layer["recompute"][wy, wx] = False
        ry, rx = np.nonzero(layer["recompute"])
        ay = np.concatenate([wy, ry])
        ax = np.concatenate([wx, rx])
        if len(ay):
            flat = np.unique(ay * ow + ax)
            ay, ax = flat // ow, flat % ow

        surf_w = self._windows(layer, surf_prev)
        cact_w = self._windows(layer, cact_prev)
        if len(ay):
            sw = surf_w[:, ay, ax]     # [C, K, kk]
            cw = cact_w[:, ay, ax]
            m = sw.max(-1, keepdims=True)
            is_max = sw == m
            a = np.where(is_max, cw, np.inf).min(-1, keepdims=True)
            sel = is_max & (np.where(is_max, cw, np.inf) == a)
            idx = sel.argmax(-1).astype(np.int32)
            not_argmin = np.any(a[..., 0] != cw.min(-1), axis=0)
            layer["idx"][:, ay, ax] = idx
            layer["recompute"][ay[not_argmin], ax[not_argmin]] = True
        out_coords = np.stack([ay, ax], -1) if len(ay) else np.zeros((0, 2), np.int64)

        take = np.take_along_axis
        surf = take(surf_w, layer["idx"][..., None], -1)[..., 0]
        lact = take(self._windows(layer, layer_act_prev), layer["idx"][..., None], -1)[..., 0]
        cact = take(cact_w, layer["idx"][..., None], -1)[..., 0]
        return out_coords, surf * lact, lact, cact, surf
