"""The port's data plane: the JAX package's event-file codecs and dataset
readers, copied (host numpy), with the native decoder built at first use
(:mod:`async_ev_cnn_torch.data.native`) and device prefetching in torch
(:mod:`async_ev_cnn_torch.data.prefetch`)."""

from async_ev_cnn_torch.data import detection_reader, event_reader, file_reader  # noqa: F401
from async_ev_cnn_torch.data.file_reader import AerReader, NReader, NumpyReader  # noqa: F401
from async_ev_cnn_torch.data.event_reader import EventDataset  # noqa: F401
from async_ev_cnn_torch.data.detection_reader import DetectionDataset  # noqa: F401
