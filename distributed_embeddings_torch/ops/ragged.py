"""Ragged (CSR) and sparse (COO) id containers (PyTorch port of
``ops/ragged.py``).

They carry what the reference's ``tf.RaggedTensor`` and
``tf.SparseTensor`` inputs carry:

- :class:`RaggedIds`: ``values[row_splits[i]:row_splits[i + 1]]`` are the
  ids of sample ``i``;
- :class:`SparseIds`: COO ids, ``indices [nnz, 2]`` (row, col) with the
  rows sorted, ``values [nnz]`` and a ``dense_shape``.

The port runs eagerly, so nothing requires their shapes to be static;
they keep the JAX package's fields so that the two compare field by
field.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RaggedIds:
  """CSR-format variable-hotness ids."""

  values: torch.Tensor  # [nnz] int
  row_splits: torch.Tensor  # [nrows + 1] int

  @property
  def nrows(self) -> int:
    return self.row_splits.shape[0] - 1

  @property
  def dtype(self):
    return self.values.dtype

  @property
  def shape(self):
    # 2-D logical shape with an unknown (ragged) second dim
    return (self.nrows, None)

  def row_lengths(self) -> torch.Tensor:
    return self.row_splits[1:] - self.row_splits[:-1]

  @classmethod
  def from_row_lengths(cls, values, row_lengths) -> "RaggedIds":
    row_lengths = torch.as_tensor(row_lengths)
    row_splits = torch.cat([row_lengths.new_zeros((1,)),
                            torch.cumsum(row_lengths, 0)])
    return cls(torch.as_tensor(values), row_splits)

  @classmethod
  def from_dense(cls, dense) -> "RaggedIds":
    """Every element kept: dense ``[B, H]`` -> ragged with hotness H."""
    dense = torch.as_tensor(dense)
    b, h = dense.shape
    row_splits = torch.arange(b + 1, dtype=torch.int32,
                              device=dense.device) * h
    return cls(dense.reshape(-1), row_splits)


@dataclasses.dataclass
class SparseIds:
  """COO-format ids: ``indices`` ``[nnz, 2]`` (row, col), rows ascending;
  ``values`` ``[nnz]``; ``dense_shape`` ``(nrows, ncols)``."""

  indices: torch.Tensor  # [nnz, 2] int
  values: torch.Tensor  # [nnz] int
  dense_shape: tuple  # (nrows, ncols)

  @property
  def nrows(self) -> int:
    return int(self.dense_shape[0])

  @property
  def dtype(self):
    return self.values.dtype

  @property
  def shape(self):
    return tuple(self.dense_shape)


def row_to_split(indices: torch.Tensor, nrows: int,
                 dtype=torch.int32) -> torch.Tensor:
  """COO sorted row ids -> CSR ``row_splits`` ``[nrows + 1]``
  (``row_splits[0] == 0``, ``row_splits[-1] == nnz``; empty trailing rows
  included): one binary search per split, as the reference's
  ``RowToSplit`` kernel and the JAX package's ``searchsorted``.

  ``indices`` is ``[nnz, 2]`` COO indices with sorted ``indices[:, 0]``,
  or the ``[nnz]`` rows."""
  rows = indices[:, 0] if indices.dim() == 2 else indices
  targets = torch.arange(nrows + 1, dtype=rows.dtype, device=rows.device)
  return torch.searchsorted(rows.contiguous(), targets, right=False) \
      .to(dtype)
