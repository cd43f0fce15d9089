"""Data for the DLRM trainer: synthetic batches and the learning-rate
schedule (PyTorch port of ``utils/data.py``)."""

from .data import DummyDataset, categorical_dtype, dlrm_lr_schedule

__all__ = ["DummyDataset", "categorical_dtype", "dlrm_lr_schedule"]
