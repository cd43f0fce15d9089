"""Deduplicated row gradients (PyTorch port of ``ops/sparse_grad.py``).

:func:`dedup_rows` is the sort + segment-sum duplicate reduction that
the sparse apply's ``exact=True`` path and
``ops/embedding_lookup.py:csr_lookup``'s backward run (the reference's
sort/unique/segment-sum backward). :func:`unique_ids_map` and
:func:`expand_unique_rows` are the two halves of the deduplicated
exchange (``parallel/lookup_engine.py: DedupRouted``). Every shape is
static: no ``torch.unique``, ``nonzero`` or host read, so on the card
none of them waits for the device. ``SparseRows`` and the table-level
sparse optimizers are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def dedup_rows(ids: torch.Tensor, rows: torch.Tensor,
               sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sum the rows of duplicate ids, with static shapes.

  Args:
    ids: ``[k]`` int row ids; entries ``>= sentinel`` or ``< 0`` count as
      padding.
    rows: ``[k, width]`` gradient rows.
    sentinel: the first out-of-range id (the table's row count).

  Returns:
    ``(unique_ids [k], unique_rows [k, width])``: the unique ids in
    ascending order, then ``sentinel`` in the unused slots (the padding
    ids' summed rows sit on a sentinel slot, which an apply drops)."""
  k = ids.shape[0]
  ids = torch.where((ids < 0) | (ids >= sentinel),
                    torch.full_like(ids, sentinel), ids)
  sorted_ids, perm = torch.sort(ids, stable=True)
  rows_sorted = rows[perm]
  is_start = torch.ones((k,), dtype=torch.bool, device=ids.device)
  is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
  seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
  unique_rows = torch.zeros_like(rows).index_add_(0, seg, rows_sorted)
  unique_ids = torch.full_like(ids, sentinel)
  unique_ids[seg[is_start]] = sorted_ids[is_start]
  return unique_ids, unique_rows


def unique_ids_map(ids: torch.Tensor, sentinel: int, capacity: int,
                   with_count: bool = False) -> tuple:
  """Sort + unique with a static capacity and an inverse map, along the
  last dimension (leading dimensions are independent blocks).

  The dp-side half of the deduplicated exchange: the wire carries the
  sorted-unique id block, the receiver gathers each row once, and the
  sender keeps ``inv`` to re-expand the returned rows
  (:func:`expand_unique_rows`).

  Args:
    ids: ``[..., m]`` int ids in ``[0, sentinel]`` (``sentinel`` marks
      padding; anything outside the range is clamped to it).
    sentinel: the padding id (the class buffer's row count).
    capacity: static unique-slot count. Safe iff ``capacity >= min(m,
      sentinel + 1)``: the value range bounds the distinct count. A
      smaller capacity (the plan's ``dedup_capacity``) aliases the
      distinct values past it onto the last slot; a caller taking that
      trade surfaces the overflow (``with_count``).
    with_count: also return each block's distinct-value count (before
      the capacity clamp, the sentinel's run included), a device tensor.

  Returns:
    ``(uniq [..., capacity] int32, inv [..., m] int32)`` with ``uniq[inv]
    == ids`` (after clamping); ``uniq`` ascends with sentinel padding at
    the tail, so its padded slots gather zero rows as padded occurrences
    do. With ``with_count``, ``(uniq, inv, n_distinct [...] int32)``."""
  m = ids.shape[-1]
  clean = torch.where((ids < 0) | (ids > sentinel),
                      torch.full_like(ids, sentinel), ids).to(torch.int32)
  sorted_ids, perm = torch.sort(clean, dim=-1, stable=True)
  is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
  is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
  seg = torch.cumsum(is_start.to(torch.int32), dim=-1, dtype=torch.int32) - 1
  n_distinct = seg[..., m - 1] + 1 if with_count else None
  seg = seg.clamp(max=capacity - 1)  # a no-op under the safe capacity
  uniq = torch.full(ids.shape[:-1] + (capacity,), sentinel,
                    dtype=torch.int32, device=ids.device)
  uniq = uniq.scatter_reduce(-1, seg.long(), sorted_ids, "amin")
  inv = torch.zeros_like(sorted_ids).scatter_(-1, perm, seg)
  if with_count:
    return uniq, inv, n_distinct
  return uniq, inv


def expand_unique_rows(u_rows: torch.Tensor,
                       inv: torch.Tensor) -> torch.Tensor:
  """Per-unique rows ``[..., K, w]`` -> per-occurrence rows ``[..., m,
  w]`` (leading dimensions are independent blocks, as in
  :func:`unique_ids_map`).

  The dp-side re-expansion of a deduplicated exchange. Differentiable:
  its backward adds the per-occurrence cotangents into ``[..., K, w]``,
  so duplicate ids' cotangents are summed (in f32) before the reverse
  exchange, which ships one row per unique id."""
  idx = inv.long()[..., None].expand(inv.shape + (u_rows.shape[-1],))
  return torch.gather(u_rows, -2, idx)
