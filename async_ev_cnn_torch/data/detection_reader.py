"""Detection dataset: events + bounding-box annotations.

Capability parity with the reference's src/readers/detection_reader.py:
flat ``train/ test/ validation`` dirs of event files, sibling
``annotations/<name>.npy`` boxes (detection_reader.py:22-29), and a
``params.npz`` at the root holding ``num_classes`` and ``label_to_idx``
(detection_reader.py:48-60).  ``next_batch`` threads the bboxes through the
user ``preprocessing_fn(length, x, y, ts, p, bboxes)`` and returns
``[lengths, features...]`` with no label feature (detection_reader.py:33-37).

Copied from ``async_ev_cnn_tpu/data/detection_reader.py``, with one fault
repaired (F4): there the preprocess cache is written with a bare
``np.savez`` and read without a guard, so a crash mid-write leaves a
truncated archive that fails every later read of the example.  Here the
cache goes through the base class's path: an atomic write (a temporary file
and ``os.replace``) and a read that treats a corrupt entry as a miss and
rewrites it.
"""

from __future__ import annotations

import os

import numpy as np

from async_ev_cnn_torch.data.event_reader import EventDataset, _SPLITS


class DetectionDataset(EventDataset):
    def __init__(self, data_dir, file_format="n-data", seed=1234, tmp_dir=None,
                 _restore=None, **kwargs):
        self._annotations_dir = os.path.join(data_dir, "annotations")
        params_path = os.path.join(data_dir, "params.npz")
        if os.path.exists(params_path):
            with np.load(params_path, allow_pickle=True) as z:
                self._num_classes = int(z["num_classes"])
                l2i = z["label_to_idx"]
                self._det_label_to_idx = (
                    dict(l2i.item()) if l2i.ndim == 0 else
                    {str(k): int(v) for k, v in l2i}
                )
        else:
            self._num_classes = 0
            self._det_label_to_idx = {}
        super().__init__(data_dir, file_format=file_format, seed=seed,
                         tmp_dir=tmp_dir, _restore=_restore, **kwargs)

    # flat split dirs without class subdirectories
    def _scan(self, validation_frac, test_frac) -> None:
        self._files = {s: [] for s in _SPLITS}
        self._labels = {s: [] for s in _SPLITS}
        for s in _SPLITS:
            split_dir = os.path.join(self._data_dir, s)
            if not os.path.isdir(split_dir):
                continue
            files = sorted(
                os.path.join(split_dir, f)
                for f in os.listdir(split_dir)
                if os.path.isfile(os.path.join(split_dir, f))
            )
            order = self._rng.permutation(len(files))
            self._files[s] = [files[i] for i in order]
            self._labels[s] = [None] * len(files)
        self._label_to_idx = self._det_label_to_idx

    def num_classes(self) -> int:
        return self._num_classes

    def label_to_idx(self) -> dict:
        return dict(self._det_label_to_idx)

    def _bboxes_for(self, filename: str) -> np.ndarray:
        name = os.path.splitext(os.path.basename(filename))[0]
        path = os.path.join(self._annotations_dir, name + ".npy")
        if os.path.exists(path):
            return np.load(path).astype(np.float32)
        return np.zeros((0, 6), np.float32)

    def _load_one(self, filename, label, preprocessing_fn):
        cache = self._cache_path(filename, preprocessing_fn)
        hit = self._read_cache(cache)  # F4: a corrupt entry is a miss
        if hit is not None:
            return hit
        length, x, y, ts, p = self.read_example(filename)
        bboxes = self._bboxes_for(filename)
        if preprocessing_fn is not None:
            out = preprocessing_fn(length, x, y, ts, p, bboxes)
            length, feats = out[0], list(out[1:])
        else:
            feats = [x, y, ts, p, bboxes]
        self._write_cache(cache, length, feats)  # F4: written atomically
        return int(length), feats


def factory(data_dir_or_save: str, file_format: str = "n-data", **kwargs) -> DetectionDataset:
    if os.path.isfile(data_dir_or_save):
        return DetectionDataset.restore(data_dir_or_save, tmp_dir=kwargs.get("tmp_dir"))
    return DetectionDataset(data_dir_or_save, file_format=file_format, **kwargs)
