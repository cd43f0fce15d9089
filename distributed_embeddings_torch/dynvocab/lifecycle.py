"""Row lifecycle: TTL eviction, freelist recycling, in-place re-zeroing
(PyTorch port of ``distributed_embeddings_tpu/dynvocab/lifecycle.py``).

Rows of a dynamic table cycle through three states — free (never
allocated, or reclaimed), live (mapped to a raw id), expired (live but
unobserved for ``evict_ttl`` steps). :class:`RowRecycler` owns the
host-side bookkeeping (``row_to_id`` inverse map, ``last_seen`` step
stamps, a FIFO freelist so the longest-reclaimed row is reused first —
deterministic), host numpy bit-equal to the JAX package's, and
:func:`zero_rows_update` is the device side: an evicted LOGICAL row's
lanes — the table row AND its interleaved optimizer-state lanes — are
written to zero inside the packed class buffer, in place (one
``index_put_``, f32 and bf16 buffers alike, no copy of the buffer),
before the row can be re-admitted, so a stale Adagrad accumulator never
leaks into a new id's first update. The JAX package computes this with
XLA's ``.at[].set`` outside any Pallas kernel; it has no kernel here
either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class RowRecycler:
  """Free/live/expired bookkeeping for one dynamic table's rows."""

  def __init__(self, capacity: int):
    self.capacity = int(capacity)
    self.row_to_id = np.full((self.capacity,), -1, np.int64)
    self.last_seen = np.full((self.capacity,), -1, np.int64)
    # FIFO freelist as a numpy ring would be overkill at eviction volume;
    # a plain int list keeps serialization trivial and order explicit
    self.freelist: list = []
    self.next_fresh = 0

  @property
  def occupancy(self) -> int:
    return int(np.sum(self.row_to_id >= 0))

  def allocate(self, raw_id: int, step: int) -> int:
    """A row for ``raw_id``: oldest freelist entry first, else the next
    never-used row; -1 when the capacity is exhausted (denied)."""
    if self.freelist:
      row = self.freelist.pop(0)
    elif self.next_fresh < self.capacity:
      row = self.next_fresh
      self.next_fresh += 1
    else:
      return -1
    self.row_to_id[row] = raw_id
    self.last_seen[row] = step
    return row

  def touch(self, rows: np.ndarray, step: int) -> None:
    if rows.size:
      self.last_seen[rows] = step

  def expired(self, step: int, ttl: int) -> np.ndarray:
    """Live rows unobserved for more than ``ttl`` steps (ascending)."""
    live = self.row_to_id >= 0
    return np.where(live & (step - self.last_seen > ttl))[0]

  def release(self, row: int) -> None:
    self.row_to_id[row] = -1
    self.last_seen[row] = -1
    self.freelist.append(int(row))

  # ---- serialization ------------------------------------------------------
  def state(self) -> dict:
    return {
        "row_to_id": self.row_to_id,
        "last_seen": self.last_seen,
        "freelist": np.asarray(self.freelist, np.int64),
        "next_fresh": np.asarray([self.next_fresh], np.int64),
    }

  def load_state(self, state: dict) -> None:
    row_to_id = np.asarray(state["row_to_id"], np.int64)
    if row_to_id.shape != self.row_to_id.shape:
      raise ValueError(
          f"recycler state has {row_to_id.shape[0]} rows, this table has "
          f"{self.capacity} — vocab_capacity differs from the saving run.")
    self.row_to_id = row_to_id.copy()
    self.last_seen = np.asarray(state["last_seen"], np.int64).copy()
    self.freelist = [int(r) for r in np.asarray(state["freelist"])]
    self.next_fresh = int(np.asarray(state["next_fresh"]).reshape(-1)[0])


def zero_rows_update(layout, buf: torch.Tensor, grp: np.ndarray,
                     sub: np.ndarray) -> torch.Tensor:
  """Zero logical rows ``(grp, sub)`` of one packed class buffer IN PLACE
  and return it.

  ``grp`` indexes the buffer's physical rows; ``sub`` is each row's slot
  within its physical row (``local_row % rows_per_phys``): lanes
  ``[sub * stride, (sub + 1) * stride)`` hold the table row and its
  interleaved optimizer state. Duplicate targets are harmless (the
  written value is a constant 0)."""
  n = int(np.asarray(grp).shape[0])
  if n == 0:
    return buf
  stride = int(layout.stride)
  dev = buf.device
  g = torch.as_tensor(np.asarray(grp, np.int64), device=dev)
  s = torch.as_tensor(np.asarray(sub, np.int64), device=dev)
  lanes = s[:, None] * stride + torch.arange(stride, device=dev)
  buf.index_put_((g[:, None].expand(-1, stride), lanes),
                 torch.zeros((), dtype=buf.dtype, device=dev))
  return buf


def zero_targets(recipe, rows: np.ndarray):
  """Evicted TABLE rows -> per-class zero targets.

  ``recipe``: the translator's per-table window list — entries
  ``(class_name, rank_phys_base, row_start, nrows, row_offset, rpp)``
  covering every shard that holds part of the table (column slices put
  the same table rows on several ranks; each copy must re-zero).
  Returns ``{class_name: (grp, sub)}`` int64 arrays."""
  out = {}
  for (name, base, row_start, nrows, row_offset, rpp) in recipe:
    m = (rows >= row_start) & (rows < row_start + nrows)
    if not np.any(m):
      continue
    local = rows[m] - row_start + row_offset
    grp = base + local // rpp
    sub = local % rpp
    if name in out:
      pg, ps = out[name]
      out[name] = (np.concatenate([pg, grp]), np.concatenate([ps, sub]))
    else:
      out[name] = (grp, sub)
  return out


def merge_zero_work(into: dict, work: dict) -> dict:
  """Accumulate per-class zero targets across tables."""
  for name, (grp, sub) in work.items():
    if name in into:
      pg, ps = into[name]
      into[name] = (np.concatenate([pg, grp]), np.concatenate([ps, sub]))
    else:
      into[name] = (grp, sub)
  return into


def dedupe_zero_work(work: dict) -> dict:
  """Sort + dedupe each class's (grp, sub) targets (deterministic
  scatter order; duplicates are idempotent but cost scatter rows)."""
  out = {}
  for name, (grp, sub) in work.items():
    pairs = np.unique(np.stack([grp, sub], axis=1), axis=0)
    out[name] = (pairs[:, 0], pairs[:, 1])
  return out


def apply_zero_work(layouts, fused: dict, work: dict,
                    rank: Optional[int] = None) -> Tuple[dict, int]:
  """Zero the accumulated targets in the fused buffers (in place);
  returns the dict and the number of logical rows zeroed.

  The targets index GLOBAL physical rows (every rank's block stacked).
  ``rank``: a world-N rank that holds only its own block zeroes the
  targets inside it (its local rows); None (one process holding every
  rank's blocks) zeroes them all. The count is the whole work's either
  way, the same on every rank."""
  if not work:
    return fused, 0
  total = 0
  for name, (grp, sub) in dedupe_zero_work(work).items():
    total += int(grp.shape[0])
    if rank is not None:
      rows = layouts[name].phys_rows
      mine = (grp >= rank * rows) & (grp < (rank + 1) * rows)
      grp, sub = grp[mine] - rank * rows, sub[mine]
    fused[name] = zero_rows_update(layouts[name], fused[name], grp, sub)
  return fused, total
