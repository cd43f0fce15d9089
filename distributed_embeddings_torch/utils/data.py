"""Datasets and the DLRM learning-rate schedule (PyTorch port of
``utils/data.py``).

:class:`RawBinaryCriteoDataset` reads the split-binary Criteo format
(``train/`` and ``test/`` directories of ``label.bin``, ``numerical.bin``
and ``cat_<id>.bin``) batch for batch as the JAX package's reader does:
the same per-rank slicing, trailing partial batch and empty rank slice,
through the native C++ loader (``cc/data_loader.cc``, the port's copy,
built at first use) or numpy memory maps. :func:`write_dummy_criteo_split`
writes a small split of that format. :class:`DummyDataset` draws the JAX
package's batches bit for bit (numpy from the same seed);
:func:`dlrm_lr_schedule` computes the JAX schedule's values in float32,
as ``jnp`` does, so a ``torch.optim`` optimizer fed ``schedule(step)``
before each step (``step`` counting from 0, as optax's count does)
follows the JAX trajectory. Everything here is numpy on the host.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np


def categorical_dtype(size: int) -> np.dtype:
  """Smallest integer dtype holding ids < size (reference `utils.py:117-123`)."""
  for t in (np.int8, np.int16, np.int32):
    if size < np.iinfo(t).max:
      return np.dtype(t)
  return np.dtype(np.int64)


class RawBinaryCriteoDataset:
  """Split-binary Criteo reader (the JAX package's reader).

  Args:
    data_path: directory containing ``train/`` and ``test/`` splits.
    batch_size: samples per yielded batch (per rank for dp input, global
      for mp input).
    numerical_features: how many numerical features to load (0 = skip).
    categorical_features: feature ids to read (mp input: this rank's
      tables; None = none).
    categorical_feature_sizes: global vocabulary sizes (for dtypes).
    valid: read the ``test`` split.
    rank / world_size: dp slicing — rank r reads slice r of each global
      batch of ``batch_size * world_size`` samples.
    prefetch_depth: batches to keep ready in the background.
    drop_last_batch: drop the trailing partial batch.
    backend: ``'native'`` (the C++ loader; raises if it does not build),
      ``'numpy'`` (memory maps and a prefetch thread) or ``'auto'`` (the
      native loader when it builds, else numpy). Both give the same
      batches bit for bit.

  Batches are ``(numerical [n, F] float32 or None, [ids [n] int32 per
  feature], labels [n] float32)`` numpy arrays; indexing reads one batch
  directly (numpy), iteration prefetches.
  """

  def __init__(self,
               data_path: str,
               batch_size: int,
               numerical_features: int = 0,
               categorical_features: Optional[Sequence[int]] = None,
               categorical_feature_sizes: Optional[Sequence[int]] = None,
               valid: bool = False,
               rank: int = 0,
               world_size: int = 1,
               prefetch_depth: int = 10,
               drop_last_batch: bool = True,
               backend: str = "auto"):
    if backend not in ("auto", "native", "numpy"):
      raise ValueError(f"backend must be auto|native|numpy, got {backend!r}")
    base = os.path.join(data_path, "test" if valid else "train")
    self._base = base
    self._backend = backend
    self._drop_last = drop_last_batch
    self.batch_size = batch_size
    self.numerical_features = numerical_features
    self.rank, self.world_size = rank, world_size

    labels = np.memmap(os.path.join(base, "label.bin"), dtype=np.uint8,
                       mode="r")
    self.num_samples = labels.shape[0]
    rounder = math.floor if drop_last_batch else math.ceil
    self.num_batches = rounder(self.num_samples / (batch_size * world_size)) \
        if world_size > 1 else rounder(self.num_samples / batch_size)
    self.labels = labels

    self.numerical = None
    if numerical_features > 0:
      raw = np.memmap(os.path.join(base, "numerical.bin"), dtype=np.float16,
                      mode="r")
      if raw.shape[0] != self.num_samples * numerical_features:
        raise ValueError(
            f"numerical.bin holds {raw.shape[0]} values, expected "
            f"{self.num_samples * numerical_features}")
      self.numerical = raw.reshape(self.num_samples, numerical_features)

    self.categorical: List[np.memmap] = []
    self.categorical_ids = list(categorical_features or [])
    if self.categorical_ids:
      if categorical_feature_sizes is None:
        raise ValueError("categorical_feature_sizes required with "
                         "categorical_features")
      for fid in self.categorical_ids:
        dtype = categorical_dtype(categorical_feature_sizes[fid])
        arr = np.memmap(os.path.join(base, f"cat_{fid}.bin"), dtype=dtype,
                        mode="r")
        if arr.shape[0] != self.num_samples:
          raise ValueError(
              f"cat_{fid}.bin holds {arr.shape[0]} ids, expected "
              f"{self.num_samples}")
        self.categorical.append(arr)
    self._prefetch_depth = prefetch_depth

  def __len__(self):
    return self.num_batches

  def _slice(self, idx: int):
    if self.world_size > 1:
      # dp: rank r takes the r-th contiguous slice of the global batch
      start = (idx * self.world_size + self.rank) * self.batch_size
    else:
      start = idx * self.batch_size
    end = min(start + self.batch_size, self.num_samples)
    return start, end

  def __getitem__(self, idx: int):
    if idx >= self.num_batches:
      raise IndexError(idx)
    start, end = self._slice(idx)
    labels = np.asarray(self.labels[start:end], np.float32)
    numerical = (np.asarray(self.numerical[start:end], np.float32)
                 if self.numerical is not None else None)
    cats = [np.asarray(arr[start:end], np.int32) for arr in self.categorical]
    return numerical, cats, labels

  def __iter__(self):
    """Background-prefetched iteration, native or numpy (``backend``)."""
    if self._backend == "numpy":
      yield from self._iter_numpy()
      return
    # lazy: a reader that never iterates natively builds nothing
    from ..cc import load_data_loader
    try:
      lib = load_data_loader()
    except (RuntimeError, OSError):
      if self._backend == "native":
        raise
      yield from self._iter_numpy()
      return
    yield from self._native_batches(lib)

  def _native_batches(self, lib):
    import ctypes

    n_cat = len(self.categorical_ids)
    cat_ids = (ctypes.c_int32 * n_cat)(*self.categorical_ids)
    itemsizes = (ctypes.c_int64 * n_cat)(
        *[arr.dtype.itemsize for arr in self.categorical])
    handle = lib.de_loader_open(
        self._base.encode(), self.numerical_features, n_cat, cat_ids,
        itemsizes, self.batch_size, self.rank, self.world_size,
        1 if self._drop_last else 0, self._prefetch_depth,
        min(8, max(2, self._prefetch_depth)))
    try:
      err = lib.de_loader_error(handle)
      if err:
        raise RuntimeError(f"native loader: {err.decode()}")
      lib.de_loader_start(handle)
      fptr = ctypes.POINTER(ctypes.c_float)
      iptr = ctypes.POINTER(ctypes.c_int32)
      while True:
        numerical = (np.empty((self.batch_size, self.numerical_features),
                              np.float32)
                     if self.numerical_features else None)
        cats = np.empty((n_cat, self.batch_size), np.int32)
        labels = np.empty(self.batch_size, np.float32)
        n = lib.de_loader_next(
            handle,
            numerical.ctypes.data_as(fptr) if numerical is not None else None,
            cats.ctypes.data_as(iptr) if n_cat else None,
            labels.ctypes.data_as(fptr))
        if n == -2:  # end of epoch (n == 0 is a real, empty rank slice)
          return
        if n < 0:
          err = lib.de_loader_error(handle)
          raise RuntimeError(
              f"native loader: {err.decode() if err else 'unknown error'}")
        yield (numerical[:n] if numerical is not None else None,
               [cats[f, :n] for f in range(n_cat)], labels[:n])
    finally:
      lib.de_loader_close(handle)

  def _iter_numpy(self):
    q: queue.Queue = queue.Queue(maxsize=self._prefetch_depth)
    stop = threading.Event()

    def producer():
      for i in range(self.num_batches):
        if stop.is_set():
          return
        q.put(self[i])
      q.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
      while True:
        item = q.get()
        if item is None:
          return
        yield item
    finally:
      stop.set()


def write_dummy_criteo_split(path: str, num_samples: int,
                             vocab_sizes: Sequence[int],
                             num_numerical: int = 13, seed: int = 0) -> None:
  """Write a small split-binary Criteo dataset (both splits), the JAX
  package's file for file from the same seed."""
  rng = np.random.default_rng(seed)
  for split in ("train", "test"):
    base = os.path.join(path, split)
    os.makedirs(base, exist_ok=True)
    rng.integers(0, 2, num_samples, dtype=np.uint8).tofile(
        os.path.join(base, "label.bin"))
    rng.uniform(0, 1, num_samples * num_numerical).astype(np.float16).tofile(
        os.path.join(base, "numerical.bin"))
    for fid, size in enumerate(vocab_sizes):
      rng.integers(0, size, num_samples).astype(
          categorical_dtype(size)).tofile(os.path.join(base, f"cat_{fid}.bin"))


class DummyDataset:
  """Synthetic Criteo-shaped data (reference ``DummyDataset``,
  `utils.py:126-154`): batch ``idx`` is drawn from
  ``np.random.default_rng(seed + idx)``, numerical features uniform in
  [0, 1) (float32), ids uniform per vocabulary (int32), labels 0 or 1
  (float32)."""

  def __init__(self, batch_size: int, num_numerical: int = 13,
               vocab_sizes: Sequence[int] = (), num_batches: int = 100,
               seed: int = 0):
    self.batch_size = batch_size
    self.num_numerical = num_numerical
    self.vocab_sizes = list(vocab_sizes)
    self.num_batches = num_batches
    self.seed = seed

  def __len__(self):
    return self.num_batches

  def __getitem__(self, idx: int):
    if idx >= self.num_batches:
      raise IndexError(idx)
    rng = np.random.default_rng(self.seed + idx)
    numerical = rng.uniform(0, 1, (self.batch_size, self.num_numerical)
                            ).astype(np.float32)
    cats = [rng.integers(0, v, self.batch_size).astype(np.int32)
            for v in self.vocab_sizes]
    labels = rng.integers(0, 2, self.batch_size).astype(np.float32)
    return numerical, cats, labels

  def __iter__(self):
    for i in range(self.num_batches):
      yield self[i]


def dlrm_lr_schedule(base_lr: float, warmup_steps: int, decay_start_step: int,
                     decay_steps: int):
  """Warmup + polynomial(2) decay schedule (reference
  ``LearningRateScheduler``, `examples/dlrm/utils.py:45-88`):
  ``schedule(step) -> np.float32``, every operation in float32 in the JAX
  schedule's order (a float64 schedule drifts from it over a run)."""
  f32 = np.float32
  lr = f32(base_lr)
  warm = f32(max(warmup_steps, 1))
  decay_end = f32(decay_start_step + decay_steps)
  span = f32(max(decay_steps, 1))

  def schedule(step) -> np.float32:
    step = f32(step)
    if step < warmup_steps:
      return f32(lr * (step + f32(1)) / warm)
    if step >= decay_start_step:
      frac = f32(np.clip(f32(decay_end - step) / span, f32(0), f32(1)))
      return f32(lr * f32(frac * frac))
    return lr

  return schedule
