"""Embedding lookups with combiners (PyTorch port of
``ops/embedding_lookup.py``).

The reference's functional op ``embedding_lookup``: a plain gather, or a
gather and a per-sample reduce (``'sum'`` / ``'mean'``) over dense 2-D,
ragged (:class:`~.ragged.RaggedIds`) or sparse (:class:`~.ragged.SparseIds`)
ids. Out-of-range ids clamp to the table (``mode='clip'``), as in the JAX
package.

The ragged and sparse forms go through :func:`csr_lookup`, whose backward
is the reference's deduplicated gradient: sort the ids, segment-sum the
duplicates (:func:`sparse_dedup_grad`), then one scatter-add with no
duplicate index into a dense table gradient. Dense ids take autograd's own
gradient of the clamped gather, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ragged import RaggedIds, SparseIds, row_to_split
from .sparse_grad import dedup_rows

_COMBINERS = (None, "sum", "mean")


def _check_combiner(combiner) -> None:
  if combiner not in _COMBINERS:
    raise ValueError(f"combiner must be one of {_COMBINERS}, got {combiner!r}")


def _take_clip(params: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """``params[ids]`` with the ids clamped to ``[0, rows)`` (``mode='clip'``),
  differentiable."""
  return params[ids.long().clamp(0, params.shape[0] - 1)]


def _row_ids_from_splits(row_splits: torch.Tensor, nnz: int) -> torch.Tensor:
  """CSR ``row_splits`` -> the row of each of the ``nnz`` elements (``nrows``
  for elements past the last split)."""
  pos = torch.arange(nnz, dtype=row_splits.dtype, device=row_splits.device)
  return torch.searchsorted(row_splits.contiguous(), pos, right=True) - 1


def _csr_forward(params, values, row_splits, combiner) -> torch.Tensor:
  nnz = values.shape[0]
  nrows = row_splits.shape[0] - 1
  row_ids = _row_ids_from_splits(row_splits, nnz)
  live = row_ids < nrows
  rows = _take_clip(params, values)
  out = torch.zeros((nrows, params.shape[1]), dtype=params.dtype,
                    device=params.device)
  out.index_add_(0, row_ids[live], rows[live])
  if combiner == "mean":
    counts = (row_splits[1:] - row_splits[:-1]).to(out.dtype)
    out = out / counts.clamp(min=1)[:, None]
  return out


def sparse_dedup_grad(values: torch.Tensor, row_splits: torch.Tensor,
                      grad: torch.Tensor, combiner: Optional[str],
                      vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """Deduplicated sparse gradient of a CSR lookup.

  Per-element weights (1, or 1/count for ``'mean'``), the ids clamped as
  the forward clamps them, sorted; runs of equal ids segment-summed.

  Returns:
    ``(unique_ids, unique_grads)``: ``[nnz]`` int32 ids in ascending order
    and ``[nnz, D]`` rows; the unused slots hold ``vocab_size`` (out of
    range) and zero rows, so a scatter that drops out-of-range ids ignores
    them."""
  nnz = values.shape[0]
  nrows = row_splits.shape[0] - 1
  row_ids = _row_ids_from_splits(row_splits, nnz)
  live = row_ids < nrows
  at = row_ids.clamp(0, max(nrows - 1, 0))
  g_rows = torch.where(live[:, None], grad[at], grad.new_zeros(()))
  if combiner == "mean":
    counts = (row_splits[1:] - row_splits[:-1]).to(grad.dtype)
    inv = torch.where(counts > 0, 1.0 / counts.clamp(min=1),
                      torch.zeros_like(counts))
    g_rows = g_rows * inv[at][:, None]
  ids = values.long().clamp(0, vocab_size - 1)
  unique_ids, unique_grads = dedup_rows(ids, g_rows, vocab_size)
  return unique_ids.to(torch.int32), unique_grads


class _CsrLookup(torch.autograd.Function):
  """:func:`csr_lookup` with the deduplicated backward."""

  @staticmethod
  def forward(ctx, params, values, row_splits, combiner):
    ctx.save_for_backward(values, row_splits)
    ctx.combiner = combiner
    ctx.vocab = params.shape[0]
    return _csr_forward(params, values, row_splits, combiner)

  @staticmethod
  def backward(ctx, grad):
    values, row_splits = ctx.saved_tensors
    unique_ids, unique_grads = sparse_dedup_grad(
        values, row_splits, grad, ctx.combiner, ctx.vocab)
    keep = unique_ids < ctx.vocab
    d_params = torch.zeros((ctx.vocab, grad.shape[-1]), dtype=grad.dtype,
                           device=grad.device)
    # no duplicate index is left: one scatter-add
    d_params.index_add_(0, unique_ids[keep].long(), unique_grads[keep])
    return d_params, None, None, None


def csr_lookup(params: torch.Tensor, values: torch.Tensor,
               row_splits: torch.Tensor, combiner: str = "sum"
               ) -> torch.Tensor:
  """Variable-hotness lookup with a combiner: ``out[i] = reduce(params[
  values[row_splits[i]:row_splits[i + 1]]])``, ``[nrows, D]`` (the
  reference's ``EmbeddingLookupVariableHotness`` op)."""
  return _CsrLookup.apply(params, values, row_splits, combiner)


def embedding_lookup(params: torch.Tensor, ids, combiner=None
                     ) -> torch.Tensor:
  """Looks up embeddings for ``ids`` in ``params`` (the reference's
  ``embedding_lookup``, with its dispatch rules):

  - ``combiner is None``: plain gather, ``ids.shape + (D,)`` (the values of
    ragged or sparse ids);
  - dense 2-D ids and a combiner: fixed-hotness gather and reduce,
    ``[B, D]`` (hotness 1 is a plain gather);
  - :class:`RaggedIds` and a combiner: :func:`csr_lookup`, ``[B, D]``;
  - :class:`SparseIds` and a combiner: the COO rows to CSR splits
    (:func:`~.ragged.row_to_split`), then :func:`csr_lookup`."""
  _check_combiner(combiner)
  if not isinstance(params, torch.Tensor):
    raise TypeError("params must be a tensor")
  if isinstance(ids, RaggedIds):
    if combiner is None:
      return _take_clip(params, ids.values)
    return csr_lookup(params, ids.values, ids.row_splits, combiner)
  if isinstance(ids, SparseIds):
    if combiner is None:
      return _take_clip(params, ids.values)
    splits = row_to_split(ids.indices, ids.nrows, dtype=ids.values.dtype)
    return csr_lookup(params, ids.values, splits, combiner)
  ids = torch.as_tensor(ids, device=params.device)
  if ids.dtype not in (torch.int32, torch.int64):
    ids = ids.to(torch.int32)
  if combiner is None:
    return _take_clip(params, ids)
  if ids.dim() != 2:
    raise ValueError(
        f"Only 2D input is supported with a combiner, got {ids.dim()}D")
  if ids.shape[1] == 1:
    return _take_clip(params, ids[:, 0])
  out = _take_clip(params, ids)  # [B, H, D]
  if combiner == "sum":
    return out.sum(dim=1)
  return out.mean(dim=1)
