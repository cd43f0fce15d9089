"""Data for the DLRM trainer: the split-binary Criteo reader, synthetic
batches and the learning-rate schedule (PyTorch port of
``utils/data.py``)."""

from .data import (
    DummyDataset,
    RawBinaryCriteoDataset,
    categorical_dtype,
    dlrm_lr_schedule,
    write_dummy_criteo_split,
)

__all__ = ["DummyDataset", "RawBinaryCriteoDataset", "categorical_dtype",
           "dlrm_lr_schedule", "write_dummy_criteo_split"]
