"""Count-min-sketch frequency admission for the dynamic vocabulary
(PyTorch port of ``distributed_embeddings_tpu/dynvocab/admission.py``:
host numpy, bit-equal counts).

A row is a scarce resource: the embedding-bag access skew measured in
"Dissecting Embedding Bag Performance in DLRM Inference" (PAPERS.md)
means most raw ids in a production stream are seen once and never again
— materializing a row (table + interleaved optimizer lanes) for each is
pure waste. The admission policy therefore requires an id to be OBSERVED
``admit_threshold`` times before it earns a row, and the observation
counts live in a count-min sketch: O(depth x width) memory regardless of
the raw id universe, with the classic one-sided error — the estimate
NEVER undercounts, and overcounts by at most the hash-collision mass in
an id's cells (so admission can only err toward admitting a little
early, never toward starving a genuinely hot id).

Host-side numpy, fixed-constant hashing (one splitmix64 finalizer per
depth row, seeded by the row index): deterministic across runs and
restores, no RNG (the sketch is checkpoint state — its counts persist
through the manifest's ``vocab`` section so admission decisions resume
exactly).
"""

from __future__ import annotations

import numpy as np

from .table import _mix


class CountMinSketch:
  """``depth`` rows of ``width`` int64 counters, min-of-rows estimates.

  ``width`` must be a power of two (masked indexing); the defaults hold
  ~1M-id working sets with small overcount at a few MiB of host RAM.
  """

  def __init__(self, width: int = 1 << 16, depth: int = 4):
    if width < 2 or width & (width - 1):
      raise ValueError(f"width must be a power of two >= 2, got {width}")
    if depth < 1:
      raise ValueError(f"depth must be >= 1, got {depth}")
    self.width = int(width)
    self.depth = int(depth)
    self.counts = np.zeros((depth, width), np.int64)
    # one fixed odd salt per depth row: the same id lands in independent
    # columns per row, which is what makes min-of-rows tighten
    self._salts = (np.arange(1, depth + 1, dtype=np.uint64)
                   * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)

  def _cols(self, ids: np.ndarray) -> np.ndarray:
    """[depth, n] column indices of ``ids`` (int64, any shape)."""
    x = np.ascontiguousarray(ids, np.int64).reshape(-1).astype(np.uint64)
    mask = np.uint64(self.width - 1)
    return np.stack([(_mix(x ^ s) & mask).astype(np.int64)
                     for s in self._salts])

  def update(self, ids: np.ndarray) -> None:
    """Count one OCCURRENCE per entry of ``ids`` (duplicates add)."""
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    if not ids.size:
      return
    cols = self._cols(ids)
    for j in range(self.depth):
      np.add.at(self.counts[j], cols[j], 1)

  def estimate(self, ids: np.ndarray) -> np.ndarray:
    """Per id, the count estimate (int64; >= the true count, always)."""
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    if not ids.size:
      return np.zeros((0,), np.int64)
    cols = self._cols(ids)
    ests = np.stack([self.counts[j][cols[j]] for j in range(self.depth)])
    return np.min(ests, axis=0)

  # ---- serialization ------------------------------------------------------
  def state(self) -> np.ndarray:
    return self.counts

  def load_state(self, counts: np.ndarray) -> None:
    if counts.shape != self.counts.shape:
      raise ValueError(
          f"sketch state shape {counts.shape} does not match this "
          f"sketch's ({self.counts.shape}) — width/depth differ from "
          "the saving run's.")
    self.counts = np.asarray(counts, np.int64).copy()
