"""Row-sparse gradients and the table-level sparse optimizers (PyTorch
port of ``ops/sparse_grad.py``).

- :class:`SparseRows`: a row-sparse gradient ``(ids, rows)``, the
  reference's ``tf.IndexedSlices``, ids outside ``[0, rows)`` padding.
- :func:`dedup_rows` is the sort + segment-sum duplicate reduction that
  the sparse apply's ``exact=True`` path and
  ``ops/embedding_lookup.py:csr_lookup``'s backward run (the reference's
  sort/unique/segment-sum backward). :func:`unique_ids_map` and
  :func:`expand_unique_rows` are the two halves of the deduplicated
  exchange (``parallel/lookup_engine.py: DedupRouted``). Every shape is
  static: no ``torch.unique`` or ``nonzero``. On f32 rows nothing reads
  the host, so on the card none of them waits for the device; bf16 rows
  sum in order (:func:`add_rows_in_order`), which reads the count of
  each multiplicity level back once a call.
- :func:`sparse_sgd`, :func:`sparse_adagrad`, :func:`sparse_momentum` and
  :func:`sparse_adam` (by name, :func:`sparse_optimizer`): a
  :class:`SparseOptimizer` that applies a deduplicated :class:`SparseRows`
  gradient to a plain ``[rows, width]`` table and its optimizer state,
  touching only the gradient's rows, with ``optax.sgd`` / ``adagrad`` /
  ``sgd(momentum)`` / ``adam``'s update rules (Adam's untouched rows keep
  their moments: TF's lazy sparse Adam). They update the table and the
  state tensors in place (index ops: PyTorch's ``index_select`` and
  ``index_add_``; the JAX versions are XLA scatters, not kernels) and
  return them with the state's new count. A schedule is read at the
  count, as the JAX package's are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from .packed_table import _lr_at as _rule_lr_at
from .packed_table import _on


@dataclasses.dataclass
class SparseRows:
  """Row-sparse gradient for a 2-D table: ``table[ids[k]] += rows[k]``.

  ``ids`` entries outside ``[0, num_rows)`` are padding, which consumers
  ignore. After :func:`dedup_rows` the live ids are unique and ascending,
  the padding (sentinel) slots at the end. Unpacks as ``ids, rows``."""

  ids: torch.Tensor  # [k] int
  rows: torch.Tensor  # [k, width]

  def __iter__(self):
    return iter((self.ids, self.rows))


def dedup_rows(ids: torch.Tensor, rows: torch.Tensor,
               sentinel: int) -> SparseRows:
  """Sum the rows of duplicate ids, with static shapes.

  Args:
    ids: ``[k]`` int row ids; entries ``>= sentinel`` or ``< 0`` count as
      padding.
    rows: ``[k, width]`` gradient rows.
    sentinel: the first out-of-range id (the table's row count).

  Returns:
    :class:`SparseRows` ``(unique_ids [k], unique_rows [k, width])``: the
    unique ids in ascending order, then ``sentinel`` in the unused slots
    (the padding ids' summed rows sit on a sentinel slot, which an apply
    drops)."""
  k = ids.shape[0]
  ids = torch.where((ids < 0) | (ids >= sentinel),
                    torch.full_like(ids, sentinel), ids)
  sorted_ids, perm = torch.sort(ids, stable=True)
  rows_sorted = rows[perm]
  is_start = torch.ones((k,), dtype=torch.bool, device=ids.device)
  is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
  seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
  unique_ids = torch.full_like(ids, sentinel)
  unique_ids[seg[is_start]] = sorted_ids[is_start]
  # the padding's run (the sentinel's slot) is dropped by every apply
  unique_rows = add_rows_in_order(k, seg, rows_sorted,
                                  unique_ids != sentinel)
  return SparseRows(unique_ids, unique_rows)


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


def add_rows_in_order(n: int, dest: torch.Tensor, src: torch.Tensor,
                      in_order: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
  """``zeros([n, w]).index_add_(0, dest, src)`` with XLA's scatter
  arithmetic: each destination row adds its source rows one after another
  in ``src``'s order, from +0.0. f32 rows take ``index_add_`` itself (its
  f32 sums are the f32 class of any order); narrower rows (bf16) round
  every add to their dtype, as XLA's bf16 scatter does, where torch's
  ``index_add_`` and ``scatter_add_`` sum in f32 and round once. The adds
  go level by level, in place: the ``j``-th source row of every
  destination in one ``index_put_`` of ``out[d] + row`` (one add a
  destination, so one rounding, and no sort), which runs the largest
  multiplicity's count of times; the counts of the levels are the one
  host read. ``in_order`` ([n] bool) limits that to the destinations
  whose sums are read: a sentinel's, which every padded occurrence hits
  and nothing reads, takes all its rows in the first level, which
  accumulates."""
  out = src.new_zeros((n,) + tuple(src.shape[1:]))
  if src.dtype == torch.float32 or dest.numel() == 0:
    return out.index_add_(0, dest, src)
  dest = dest.reshape(-1).long()
  k = dest.shape[0]
  order = torch.argsort(dest, stable=True)
  sd = dest[order]
  at = torch.arange(k, device=dest.device)
  start = torch.ones_like(sd, dtype=torch.bool)
  start[1:] = sd[1:] != sd[:-1]
  first = torch.cummax(torch.where(start, at, torch.zeros_like(at)), 0).values
  level = torch.empty_like(at)
  level[order] = at - first
  if in_order is not None:
    level = torch.where(in_order[dest], level, torch.zeros_like(level))
  by_level = torch.argsort(level, stable=True)
  pos = 0
  for j, cnt in enumerate(torch.bincount(level).tolist()):
    idx = by_level[pos:pos + cnt]
    d = dest[idx]
    if j == 0:  # the unread slots' duplicates too
      out.index_put_((d,), src[idx], accumulate=True)
    else:
      out.index_put_((d,), out[d] + src[idx])
    pos += cnt
  return out


class _ExpandRows(torch.autograd.Function):
  """``u_rows[..., inv, :]`` whose backward sums each unique row's
  occurrence cotangents in occurrence order (:func:`add_rows_in_order`:
  f32 as ``index_add_``, bf16 with every add rounded, as the JAX
  expansion's transpose, a scatter-add, sums them), for the slots
  ``in_order`` marks."""

  @staticmethod
  def forward(ctx, u_rows, inv, in_order):
    ctx.save_for_backward(inv, in_order)
    ctx.k = u_rows.shape[-2]
    idx = inv.long()[..., None].expand(inv.shape + (u_rows.shape[-1],))
    return torch.gather(u_rows, -2, idx)

  @staticmethod
  def backward(ctx, d_rows):
    inv, in_order = ctx.saved_tensors
    lead = tuple(inv.shape[:-1])
    nblk = math.prod(lead)
    m, w, k = inv.shape[-1], d_rows.shape[-1], ctx.k
    dest = (torch.arange(nblk, device=inv.device)[:, None] * k
            + inv.reshape(nblk, m).long()).reshape(-1)
    d_u = add_rows_in_order(nblk * k, dest, d_rows.reshape(nblk * m, w),
                            in_order.reshape(-1))
    return d_u.reshape(lead + (k, w)), None, None


def expand_unique_rows(u_rows: torch.Tensor, inv: torch.Tensor,
                       in_order: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
  """Per-unique rows ``[..., K, w]`` -> per-occurrence rows ``[..., m,
  w]`` (leading dimensions are independent blocks, as in
  :func:`unique_ids_map`).

  The dp-side re-expansion of a deduplicated exchange. Differentiable:
  its backward adds the per-occurrence cotangents into ``[..., K, w]``,
  so duplicate ids' cotangents are summed before the reverse exchange,
  which ships one row per unique id: in f32 for f32 rows, add by add in
  bf16 for bf16 rows (narrow storage), as the JAX package's scatter-add
  transpose sums them. ``in_order`` (``[..., K]`` bool, default all)
  marks the slots whose sums are read: a sentinel slot, which every
  padded occurrence hits and whose update the apply drops, sums at
  once."""
  if in_order is None:
    in_order = torch.ones(tuple(u_rows.shape[:-1]), dtype=torch.bool,
                          device=u_rows.device)
  return _ExpandRows.apply(u_rows, inv, in_order)


# ---------------------------------------------------------------------------
# Table-level sparse optimizers
# ---------------------------------------------------------------------------


class SparseOptimizer(NamedTuple):
  """Sparse counterpart of ``optax.GradientTransformation``:
  ``init(table)`` builds the table's state; ``apply(table, state, grad)``
  applies a :class:`SparseRows` gradient to the ``grad.ids`` rows (in
  place) and returns ``(table, new_state)``. ``grad`` must be deduplicated
  (:func:`dedup_rows`): duplicate live ids would apply twice."""

  init: Callable[[torch.Tensor], Any]
  apply: Callable[[torch.Tensor, Any, SparseRows], tuple]


ScalarOrSchedule = Union[float, Callable[[int], Any]]


def _lr_at(learning_rate: ScalarOrSchedule, count: int, like: torch.Tensor
           ) -> torch.Tensor:
  """The learning rate at ``count`` (the sparse rules' ``_lr_at``) in
  ``like``'s dtype, on its device."""
  return _on(_rule_lr_at(learning_rate, count), like.device).to(like.dtype)


def _live(table: torch.Tensor, grad: SparseRows):
  """The live ``(ids, rows)`` of ``grad`` (padding dropped, as the JAX
  scatters' ``mode='drop'``)."""
  ids = grad.ids.reshape(-1).long()
  live = (ids >= 0) & (ids < table.shape[0])
  return ids[live], grad.rows.reshape(ids.shape[0], -1)[live]


def _count(state) -> int:
  return int(state.count)


class SparseSgdState(NamedTuple):
  count: int


def sparse_sgd(learning_rate: ScalarOrSchedule) -> SparseOptimizer:
  """Row-sparse SGD: ``table[ids] -= lr * rows`` (``optax.sgd``)."""

  def init(table):
    del table
    return SparseSgdState(count=0)

  def apply(table, state, grad: SparseRows):
    ids, rows = _live(table, grad)
    lr = _lr_at(learning_rate, _count(state), table)
    table.index_add_(0, ids, -lr * rows.to(table.dtype))
    return table, SparseSgdState(count=_count(state) + 1)

  return SparseOptimizer(init, apply)


class SparseAdagradState(NamedTuple):
  sum_of_squares: torch.Tensor  # the table's shape
  count: int


def sparse_adagrad(learning_rate: ScalarOrSchedule,
                   initial_accumulator_value: float = 0.1,
                   eps: float = 1e-7) -> SparseOptimizer:
  """Row-sparse Adagrad (``optax.adagrad``): per live row ``acc[id] +=
  row²; table[id] -= lr * row * rsqrt(acc[id] + eps)`` (with optax's ``acc
  > 0`` guard), reading the updated accumulator."""

  def init(table):
    return SparseAdagradState(
        sum_of_squares=torch.full_like(table, initial_accumulator_value),
        count=0)

  def apply(table, state, grad: SparseRows):
    acc = state.sum_of_squares
    ids, rows = _live(table, grad)
    g = rows.to(acc.dtype)
    acc.index_add_(0, ids, g * g)
    acc_rows = acc.index_select(0, ids)
    scaled = torch.where(acc_rows > 0, g * torch.rsqrt(acc_rows + eps),
                         torch.zeros_like(g))
    lr = _lr_at(learning_rate, _count(state), table)
    table.index_add_(0, ids, -lr * scaled.to(table.dtype))
    return table, SparseAdagradState(sum_of_squares=acc,
                                     count=_count(state) + 1)

  return SparseOptimizer(init, apply)


class SparseMomentumState(NamedTuple):
  trace: torch.Tensor  # the table's shape
  count: int


def sparse_momentum(learning_rate: ScalarOrSchedule, momentum: float = 0.9,
                    nesterov: bool = False) -> SparseOptimizer:
  """Row-sparse SGD with momentum (``optax.sgd(lr, momentum)``): per live
  row ``m[id] = momentum * m[id] + row; table[id] -= lr * m[id]``
  (nesterov: ``lr * (row + momentum * m[id])``)."""

  def init(table):
    return SparseMomentumState(trace=torch.zeros_like(table), count=0)

  def apply(table, state, grad: SparseRows):
    tr = state.trace
    ids, rows = _live(table, grad)
    g = rows.to(tr.dtype)
    m_old = tr.index_select(0, ids)
    m_new = momentum * m_old + g
    tr.index_add_(0, ids, m_new - m_old)
    upd = (g + momentum * m_new) if nesterov else m_new
    lr = _lr_at(learning_rate, _count(state), table)
    table.index_add_(0, ids, -lr * upd.to(table.dtype))
    return table, SparseMomentumState(trace=tr, count=_count(state) + 1)

  return SparseOptimizer(init, apply)


class SparseAdamState(NamedTuple):
  mu: torch.Tensor  # the table's shape
  nu: torch.Tensor
  count: int


def sparse_adam(learning_rate: ScalarOrSchedule, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> SparseOptimizer:
  """Row-sparse Adam (``optax.adam`` on the touched rows): per live row the
  moments decay toward the gradient and the update is bias-corrected by
  the global count (``1 - b^(count + 1)``, an f32 power); untouched rows
  keep their moments."""

  def init(table):
    return SparseAdamState(mu=torch.zeros_like(table),
                           nu=torch.zeros_like(table), count=0)

  def apply(table, state, grad: SparseRows):
    ids, rows = _live(table, grad)
    g = rows.to(state.mu.dtype)
    m_old = state.mu.index_select(0, ids)
    v_old = state.nu.index_select(0, ids)
    m_new = b1 * m_old + (1.0 - b1) * g
    v_new = b2 * v_old + (1.0 - b2) * g * g
    state.mu.index_add_(0, ids, m_new - m_old)
    state.nu.index_add_(0, ids, v_new - v_old)
    t = torch.tensor(float(_count(state) + 1))  # the corrections on the host
    m_hat = m_new / _on(1.0 - torch.pow(torch.tensor(b1), t), g.device)
    v_hat = v_new / _on(1.0 - torch.pow(torch.tensor(b2), t), g.device)
    lr = _lr_at(learning_rate, _count(state), table)
    upd = m_hat / (torch.sqrt(v_hat) + eps)
    table.index_add_(0, ids, -lr * upd.to(table.dtype))
    return table, SparseAdamState(mu=state.mu, nu=state.nu,
                                  count=_count(state) + 1)

  return SparseOptimizer(init, apply)


_SPARSE_FACTORIES = {
    "sgd": sparse_sgd,
    "adagrad": sparse_adagrad,
    "momentum": sparse_momentum,
    "adam": sparse_adam,
}


def sparse_optimizer(name: str, learning_rate: ScalarOrSchedule,
                     **kwargs) -> SparseOptimizer:
  """Factory: 'sgd' | 'adagrad' | 'momentum' | 'adam' by name."""
  if name not in _SPARSE_FACTORIES:
    raise ValueError(
        f"Unknown sparse optimizer {name!r}; have {sorted(_SPARSE_FACTORIES)}")
  return _SPARSE_FACTORIES[name](learning_rate, **kwargs)
