"""Deduplicated row gradients (PyTorch port of ``ops/sparse_grad.py``).

Only :func:`dedup_rows` is ported: the sort + segment-sum duplicate
reduction that the sparse apply's ``exact=True`` path and
``ops/embedding_lookup.py:csr_lookup``'s backward run (the reference's
sort/unique/segment-sum backward). ``SparseRows``,
``unique_ids_map`` and the table-level sparse optimizers are not ported
yet.
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
