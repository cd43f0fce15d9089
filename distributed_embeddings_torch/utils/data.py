"""Synthetic DLRM batches and the DLRM learning-rate schedule (PyTorch
port of ``utils/data.py``).

:class:`DummyDataset` draws the JAX package's batches bit for bit (numpy
from the same seed); :func:`dlrm_lr_schedule` computes the JAX schedule's
values in float32, as ``jnp`` does, so a ``torch.optim`` optimizer fed
``schedule(step)`` before each step (``step`` counting from 0, as
optax's count does) follows the JAX trajectory. Both are plain numpy.

Not ported yet: the split-binary Criteo reader (``RawBinaryCriteoDataset``)
and ``write_dummy_criteo_split`` (``ROADMAP.md`` open items, item 5).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def categorical_dtype(size: int) -> np.dtype:
  """Smallest integer dtype holding ids < size (reference `utils.py:117-123`)."""
  for t in (np.int8, np.int16, np.int32):
    if size < np.iinfo(t).max:
      return np.dtype(t)
  return np.dtype(np.int64)


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
