"""The dataset engine: directory scanning, splits, shuffling, batched

Copied from ``async_ev_cnn_tpu/data/event_reader.py`` (host numpy, framework-free),
so the port reads the same files into the same arrays.
parallel reading with preprocessing, caching, and save/restore.

Capability parity with the reference's src/readers/event_reader.py (920 LoC
of queue plumbing) redesigned around a simple core:

* **Layout** (event_reader.py:27-47,855-934): either explicit
  ``train/ validation/ test`` split dirs each holding one directory per
  class, or class dirs at the root — in which case validation/test are
  carved out of train by **stratified** sampling per class
  (event_reader.py:822-853), seeded and reshuffled per epoch.
* **Batch API**: ``next_batch(batch_size, dataset=..., preprocessing_fn=...,
  threads=N)`` returns ``[lengths, feature0, feature1, ...]`` where each
  feature is ragged-padded to the batch max length and stacked
  (event_reader.py:581-610); for ``batch_size == 1`` the bare example
  arrays are returned (this is what the reference's runner actually
  consumes).  Unreadable/corrupt files are skipped with a warning and
  replaced by the next file (event_reader.py:524-551).
* **Parallelism**: a ``ThreadPoolExecutor`` maps examples in a batch
  (numpy decode releases the GIL for the bulk of the work); an optional
  persistent **process** prefetcher (``start_prefetch``) keeps a queue of
  ready batches using dill-pickled preprocessing functions — the analog of
  the reference's daemon worker pool (event_reader.py:230-276).
* **Preprocess cache**: per-example ``.npz`` keyed by relative path under
  ``tmp_dir`` (event_reader.py:498-506).
* **Save/restore** (event_reader.py:778-820): file lists + cursors round-
  trip through one npz; ``factory(path=...)`` auto-restores.
"""

from __future__ import annotations

import os
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from async_ev_cnn_torch.data import file_reader as ffmt

_SPLITS = ("train", "validation", "test")


def _one_hot(idx: int, n: int) -> np.ndarray:
    v = np.zeros(n, np.float32)
    v[idx] = 1.0
    return v


class EventDataset:
    """Classification dataset of event files in class directories."""

    def __init__(
        self,
        data_dir: str,
        file_format: str = "n-data",
        validation_frac: float = 0.1,
        test_frac: float = 0.2,
        seed: int = 1234,
        tmp_dir: str | None = None,
        _restore: dict | None = None,
    ):
        self._data_dir = data_dir
        self._file_format = file_format
        self._codec = ffmt.factory(file_format)
        self._tmp_dir = tmp_dir
        self._rng = np.random.RandomState(seed)
        self._seed = seed

        # serializes cursor advancement + epoch reshuffles: the reference
        # guards its cursors with a Lock (event_reader.py:20-21,154), and
        # the GIL does NOT make the read/advance/write sequence atomic —
        # concurrent Prefetcher workers produced duplicate batches and
        # silently skipped examples without it
        self._lock = threading.Lock()
        if _restore is not None:
            self._files = {s: list(_restore[f"files_{s}"]) for s in _SPLITS}
            self._labels = {s: list(_restore[f"labels_{s}"]) for s in _SPLITS}
            self._cursors = {s: int(_restore[f"cursor_{s}"]) for s in _SPLITS}
            self._label_to_idx = dict(_restore["label_to_idx"])
        else:
            self._scan(validation_frac, test_frac)
            self._cursors = {s: 0 for s in _SPLITS}
        self._epoch_order = {
            s: np.arange(len(self._files[s])) for s in _SPLITS
        }
        if _restore is not None and "epoch_order_train" in _restore:
            for s in _SPLITS:
                self._epoch_order[s] = np.asarray(
                    _restore[f"epoch_order_{s}"], np.int64)
            if "rng_state" in _restore:
                st = list(_restore["rng_state"])
                self._rng.set_state(
                    (str(st[0]), np.asarray(st[1], np.uint32), int(st[2]),
                     int(st[3]), float(st[4])))

    def __getstate__(self):
        # the cursor lock is process-local (process-mode prefetch ships
        # the dataset via dill); each process gets a fresh one
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    # ---- layout ------------------------------------------------------------

    def _scan(self, validation_frac: float, test_frac: float) -> None:
        root_entries = sorted(
            d for d in os.listdir(self._data_dir)
            if os.path.isdir(os.path.join(self._data_dir, d))
        )
        has_split_dirs = "train" in root_entries

        def class_files(split_dir):
            files, labels = [], []
            classes = sorted(
                d for d in os.listdir(split_dir)
                if os.path.isdir(os.path.join(split_dir, d))
            )
            for cls in classes:
                for fn in sorted(os.listdir(os.path.join(split_dir, cls))):
                    files.append(os.path.join(split_dir, cls, fn))
                    labels.append(cls)
            return files, labels, classes

        self._files = {s: [] for s in _SPLITS}
        self._labels = {s: [] for s in _SPLITS}
        if has_split_dirs:
            classes_all: set = set()
            for s in _SPLITS:
                split_dir = os.path.join(self._data_dir, s)
                if os.path.isdir(split_dir):
                    f, l, classes = class_files(split_dir)
                    order = self._rng.permutation(len(f))
                    self._files[s] = [f[i] for i in order]
                    self._labels[s] = [l[i] for i in order]
                    classes_all.update(classes)
            classes = sorted(classes_all)
        else:
            # class dirs at root: stratified split of every class into
            # train/validation/test (event_reader.py:822-853)
            f, l, classes = class_files(self._data_dir)
            by_class: dict = {}
            for fi, li in zip(f, l):
                by_class.setdefault(li, []).append(fi)
            for cls in classes:
                items = by_class[cls]
                order = self._rng.permutation(len(items))
                n_val = int(round(len(items) * validation_frac))
                n_test = int(round(len(items) * test_frac))
                val_idx = order[:n_val]
                test_idx = order[n_val : n_val + n_test]
                train_idx = order[n_val + n_test :]
                for split, idxs in (
                    ("validation", val_idx), ("test", test_idx), ("train", train_idx)
                ):
                    self._files[split].extend(items[i] for i in idxs)
                    self._labels[split].extend([cls] * len(idxs))
            for s in _SPLITS:
                order = self._rng.permutation(len(self._files[s]))
                self._files[s] = [self._files[s][i] for i in order]
                self._labels[s] = [self._labels[s][i] for i in order]
        self._label_to_idx = {cls: i for i, cls in enumerate(classes)}

    # ---- introspection -------------------------------------------------------

    def num_classes(self) -> int:
        return len(self._label_to_idx)

    def label_to_idx(self) -> dict:
        return dict(self._label_to_idx)

    def train_size(self) -> int:
        return len(self._files["train"])

    def validation_size(self) -> int:
        return len(self._files["validation"])

    def test_size(self) -> int:
        return len(self._files["test"])

    # ---- cursors -------------------------------------------------------------

    def _next_files(self, n: int, dataset: str):
        """Take n (file, label) pairs, wrapping + reshuffling at epoch end
        (event_reader.py:154-164)."""
        files, labels = self._files[dataset], self._labels[dataset]
        if not files:
            raise ValueError(f"split {dataset!r} is empty")
        out = []
        with self._lock:
            cur = self._cursors[dataset]
            order = self._epoch_order[dataset]
            for _ in range(n):
                if cur >= len(files):
                    order = self._rng.permutation(len(files))
                    self._epoch_order[dataset] = order
                    cur = 0
                out.append((files[order[cur]], labels[order[cur]]))
                cur += 1
            self._cursors[dataset] = cur
        return out

    # ---- example pipeline ------------------------------------------------------

    def _cache_path(self, filename: str, preprocessing_fn=None):
        if self._tmp_dir is None:
            return None
        import hashlib

        rel = os.path.relpath(filename, self._data_dir)
        # hash the relative path: a separator-substitution scheme
        # ('a/b__c' vs 'a__b/c') can collide two different files onto one
        # cache entry; keep the basename for debuggability only
        rel_key = hashlib.sha1(rel.encode()).hexdigest()[:12]
        # Key by a fingerprint of the preprocessing closure so changing the
        # transform invalidates the cache (the reference keys by path only,
        # event_reader.py:498-506, and silently serves stale entries).
        fp = self._preprocessing_fingerprint(preprocessing_fn)
        base = os.path.basename(rel)
        return os.path.join(self._tmp_dir, f"{base}.{rel_key}.{fp}.npz")

    @staticmethod
    def _preprocessing_fingerprint(preprocessing_fn) -> str:
        if preprocessing_fn is None:
            return "raw"
        import functools
        import hashlib

        # dill pickles importable module-level functions BY REFERENCE, so
        # editing such a function's body would not change the blob; mix in
        # the unwrapped function's code bytes + consts so body edits
        # invalidate the cache too
        payload = b""
        try:
            import dill

            payload = dill.dumps(preprocessing_fn, recurse=False)
        except Exception:
            payload = repr(preprocessing_fn).encode()  # id() varies per
            # process -> never a stale hit, just no cross-process reuse
        f = preprocessing_fn
        while isinstance(f, functools.partial):
            f = f.func
        code = getattr(f, "__code__", None)
        if code is not None:
            payload += code.co_code + repr(code.co_consts).encode()
        return hashlib.sha1(payload).hexdigest()[:10]

    def read_example(self, filename: str):
        return self._codec.read_example(filename)

    def _read_cache(self, cache):
        """The cached ``(length, features)`` of an example, or None on a
        miss.  A corrupt or truncated entry is a miss: it is dropped and
        recomputed (it used to be classified 'unreadable' and skipped on
        every epoch)."""
        if not (cache and os.path.exists(cache)):
            return None
        try:
            with np.load(cache, allow_pickle=False) as z:
                feats = [z[k] for k in sorted(z.files)]
            return int(feats[0]), feats[1:]
        except Exception:
            try:
                os.remove(cache)
            except OSError:
                pass
            return None

    def _write_cache(self, cache, length, feats) -> None:
        """Write a cache entry atomically, through a per-process and
        per-thread temporary file and ``os.replace``: a crash mid-write (or
        two workers racing on one entry) never leaves a truncated archive
        under the final name."""
        if not cache:
            return
        os.makedirs(self._tmp_dir, exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, **{f"{i:03d}": np.asarray(f) for i, f in
                                enumerate([np.int64(length), *feats])})
            os.replace(tmp, cache)
        except Exception:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _load_one(self, filename: str, label: str, preprocessing_fn):
        cache = self._cache_path(filename, preprocessing_fn)
        hit = self._read_cache(cache)
        if hit is not None:
            return hit
        length, x, y, ts, p = self.read_example(filename)
        label_vec = _one_hot(self._label_to_idx[label], self.num_classes())
        if preprocessing_fn is not None:
            out = preprocessing_fn(length, label_vec, x, y, ts, p)
            length, feats = out[0], list(out[1:])
        else:
            feats = [label_vec, x, y, ts, p]
        self._write_cache(cache, length, feats)
        return int(length), feats

    def _load_with_retry(self, dataset: str, filename: str, label: str, preprocessing_fn):
        """Skip unreadable examples, pulling replacements
        (event_reader.py:524-551)."""
        for _ in range(100):
            try:
                return self._load_one(filename, label, preprocessing_fn)
            except Exception:
                print(f"WARNING: skipping unreadable example {filename}:")
                traceback.print_exc()
                (filename, label), = self._next_files(1, dataset)
        raise RuntimeError("too many unreadable examples in a row")

    # ---- batching -----------------------------------------------------------

    @staticmethod
    def _pad_stack(features_per_example, lengths):
        """Ragged-pad each feature to the batch max length and stack
        (event_reader.py:581-610).  Features whose first axis doesn't match
        the example's length (e.g. one-hot labels) are stacked as-is."""
        n_feats = len(features_per_example[0])
        stacked = []
        for fi in range(n_feats):
            feats = [ex[fi] for ex in features_per_example]
            length_like = all(
                np.ndim(f) >= 1 and len(f) == l for f, l in zip(feats, lengths)
            )
            # also ragged-pad non-length features with differing first
            # axes (e.g. per-example bbox lists with different box
            # counts) — a bare np.stack over those raises; consumers
            # must treat all-zero pad rows as absent
            ragged = (
                not length_like
                and all(np.ndim(f) >= 1 for f in feats)
                and len({len(f) for f in feats}) > 1
            )
            if length_like or ragged:
                max_len = max(len(f) for f in feats)
                feats = [
                    np.pad(f, [(0, max_len - len(f))] + [(0, 0)] * (np.ndim(f) - 1))
                    for f in feats
                ]
            stacked.append(np.stack(feats))
        return stacked

    def next_batch(
        self,
        batch_size: int,
        dataset: str = "train",
        preprocessing_fn=None,
        concat_features: bool = False,
        threads: int = 1,
        multiple_examples: int = 1,
        features_to_pad_mask: bool = False,
    ):
        """Returns ``[lengths, feature0, ...]``; see module docstring.

        ``multiple_examples > 1`` merges that many consecutive examples into
        each batch item by concatenating their (post-preprocessing) features
        along the event axis (event_reader.py:305-309 in the reference).
        A merged item keeps the FIRST example's label — merge within one
        class when labels matter.

        ``features_to_pad_mask`` appends a bool ``[B, max_len]`` validity
        mask (True for real entries, False for ragged padding) as the last
        feature (the reference's pad-mask mode, event_reader.py:581-610).
        """
        if multiple_examples > 1:
            merged = []
            for _ in range(batch_size):
                parts = [
                    self.next_batch(1, dataset, preprocessing_fn, False, 1)
                    for _ in range(multiple_examples)
                ]
                length = int(sum(p[0][0] for p in parts))
                feats = []
                for fi in range(1, len(parts[0])):
                    vals = [p[fi] for p in parts]
                    if all(np.ndim(v) >= 1 and len(v) == int(p[0][0])
                           for v, p in zip(vals, parts)):
                        feats.append(np.concatenate(vals, axis=0))
                    else:  # non-length features (e.g. labels): keep the first
                        feats.append(vals[0])
                merged.append((length, feats))
            lengths = [m[0] for m in merged]
            if batch_size == 1:
                out = [np.asarray(lengths), *merged[0][1]]
                if features_to_pad_mask:
                    out.append(np.ones(lengths[0], bool))
                return out
            stacked = self._pad_stack([m[1] for m in merged], lengths)
            if features_to_pad_mask:
                max_len = max(lengths)
                mask = (np.arange(max_len)[None, :]
                        < np.asarray(lengths)[:, None])
                stacked.append(mask)
            return [np.asarray(lengths), *stacked]
        items = self._next_files(batch_size, dataset)
        if threads > 1 and batch_size > 1:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                results = list(
                    pool.map(
                        lambda it: self._load_with_retry(dataset, *it, preprocessing_fn),
                        items,
                    )
                )
        else:
            results = [
                self._load_with_retry(dataset, f, l, preprocessing_fn) for f, l in items
            ]
        lengths = [r[0] for r in results]
        feats = [r[1] for r in results]
        if batch_size == 1:
            out = [np.asarray(lengths), *feats[0]]
            if features_to_pad_mask:
                out.append(np.ones(lengths[0], bool))
            return out
        if concat_features:
            # reference semantics (event_reader.py:605): concatenate the
            # batch's EXAMPLES along the event axis per feature, no
            # padding — not a cross-feature concat (the old behavior
            # glued one-hot labels onto event coordinates)
            out = [np.asarray(lengths)]
            for fi in range(len(feats[0])):
                vals = [ex[fi] for ex in feats]
                if all(np.ndim(v) >= 1 and len(v) == l
                       for v, l in zip(vals, lengths)):
                    out.append(np.concatenate(vals, axis=0))
                else:  # non-length features (labels): stack per example
                    out.append(np.stack(vals))
            return out
        stacked = self._pad_stack(feats, lengths)
        if features_to_pad_mask:
            max_len = max(lengths)
            mask = np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]
            stacked.append(mask)
        return [np.asarray(lengths), *stacked]

    # ---- persistent prefetch --------------------------------------------------

    def start_prefetch(
        self, batch_size: int, dataset: str = "train", preprocessing_fn=None,
        num_workers: int = 2, queue_size: int = 4, mode: str = "thread",
    ):
        """Persistent background prefetcher (the reference's daemon-process
        queue, event_reader.py:230-276).  Returns a :class:`Prefetcher`
        whose ``get()`` yields ready batches.  ``mode='process'`` runs
        dill-shipped workers in subprocesses for CPU-bound preprocessing
        (previously unreachable from this public entry point)."""
        from async_ev_cnn_torch.data.prefetch import Prefetcher

        return Prefetcher(self, batch_size, dataset, preprocessing_fn,
                          num_workers, queue_size, mode=mode)

    # ---- save / restore ---------------------------------------------------------

    def save(self, path: str) -> None:
        blob = {"label_to_idx": np.array(list(self._label_to_idx.items()), dtype=object)}
        for s in _SPLITS:
            blob[f"files_{s}"] = np.array(self._files[s], dtype=object)
            blob[f"labels_{s}"] = np.array(self._labels[s], dtype=object)
            blob[f"cursor_{s}"] = np.int64(self._cursors[s])
            # the epoch permutation the cursor indexes INTO — restoring a
            # mid-epoch cursor against a fresh identity order re-served
            # seen examples and skipped unseen ones
            blob[f"epoch_order_{s}"] = np.asarray(self._epoch_order[s],
                                                  np.int64)
        st = self._rng.get_state()
        blob["rng_state"] = np.array(
            [st[0], np.asarray(st[1]), st[2], st[3], st[4]], dtype=object)
        blob["data_dir"] = np.array(self._data_dir)
        blob["file_format"] = np.array(self._file_format)
        np.savez(path, **blob)

    @classmethod
    def restore(cls, path: str, tmp_dir=None) -> "EventDataset":
        with np.load(path, allow_pickle=True) as z:
            restore = {k: z[k] for k in z.files}
        restore["label_to_idx"] = [
            (str(k), int(v)) for k, v in restore["label_to_idx"]
        ]
        return cls(
            data_dir=str(restore["data_dir"]),
            file_format=str(restore["file_format"]),
            tmp_dir=tmp_dir,
            _restore=restore,
        )


def factory(data_dir_or_save: str, file_format: str = "n-data", **kwargs) -> EventDataset:
    """Dataset from a directory, or auto-restore from a saved npz
    (event_reader.py:941-1022, 56-58)."""
    if os.path.isfile(data_dir_or_save):
        return EventDataset.restore(data_dir_or_save, tmp_dir=kwargs.get("tmp_dir"))
    return EventDataset(data_dir_or_save, file_format=file_format, **kwargs)
