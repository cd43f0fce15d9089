"""Distributed lookup engine (PyTorch port of ``parallel/lookup_engine.py``).

Route the ids into per-bucket routing tensors (sentinel-padded) and, at
world > 1, exchange them to the ranks that own the tables (dp -> mp);
look up the small-vocab dense classes; return the activations to the
ranks that own the samples (mp -> dp, ``parallel/wire.py``) and
reassemble one activation per input, summing row-slice partials. For
training: the fused sparse lookup (activations and the optimizer-state
rows in one gather per class) and the sparse apply (one fused
scatter-add per class, kernel K1 on the card). Under ``overlap='fused'``
each (round, chunk) send block of a sparse class is gathered just before
its send (:class:`FusedChunks`), by kernel K4 on the card for plain-row
f32 layouts. Names, bucket keys and tensor shapes follow the JAX engine
so the two can be compared piece by piece.

At world > 1 the engine runs in every rank's process with that rank's
:class:`~.mesh.Mesh`; class params are the rank's local blocks.

Narrow multi-hot classes with optimizer state keep their gather at
physical width: window-masked physical rows, summed per bag, the ``rpp``
windows folded once per bag (the JAX engine's masked physical-row path).
Where a class's rule has a lane form (Adagrad, momentum, Adam on 128-lane
physical rows), its update rows are built by kernel K6
(``ops/cuda_delta.py``) and go straight to K1; ``DE_TORCH_COTANGENT_PIN=1``
copies each sparse bucket's cotangent to a contiguous tensor with kernel
K7 first (``ops/cuda_layout.py``, the JAX ``DE_TPU_COTANGENT_PIN``).

The simple layout's differentiable lookup (:meth:`DistributedLookup.
forward`, the path of ``layers/dist_model_parallel.py:
DistributedEmbedding`` and ``training.make_train_step``) runs at any
world: the id exchange, padded ids gathered from each sparse class's
local ``[rows, width]`` block with the sentinel reading zeros
(:class:`_FillRows`), the dense classes' window lookups, the activation
exchange through the wire's autograd Functions, assembly; autograd gives
each rank's blocks their dense gradients. Under ``overlap='fused'`` its
exchanges are the pipelined rounds of plain activations, as in the JAX
engine (no per-round gather, so no K4).

Under ``dedup_exchange=True`` (world > 1) every sparse bucket routes as a
:class:`DedupRouted`: each destination block of ids is sorted and
uniqued on its source rank (``ops/sparse_grad.py: unique_ids_map``,
static capacity), only the unique blocks cross the wire, the owner
gathers one row per unique id (K4 per round chunk under ``'fused'``),
and the source rank re-expands the returned rows through its inverse
map and runs the combiner (:meth:`DistributedLookup._exchange_dedup`).
The expansion's backward sums duplicate ids' cotangents before the
reverse exchange, so the cotangent wire shrinks alike and the sparse
apply sees one row per unique id and source block.

A :class:`~..ops.ragged.RaggedIds` input (variable hotness, the
reference's uneven-split exchange) routes as its value stream: per
bucket ``(vals [world, n_b, V], lens [world, n_b, B])``, ``V`` the
input's capacity (``values.shape[0]``, part of the bucket key, so every
rank passes the same). The owner gathers the stream's rows and sums each
sample's segment with ``torch.segment_reduce`` (no atomics: one thread
per output lane adds the segment in stream order, as XLA's CPU
``segment_sum`` does); under ``'fused'`` each round gathers its
destination's stream (K4) and chunks the combined rows. The backward
expands each sample's cotangent to its occurrences: parts with ``h=0``,
as K6 and K1 already take deduplicated parts. Ragged buckets stay raw
under ``dedup_exchange``.

Model-parallel input mode (:meth:`DistributedLookup.forward_mp` over
:func:`pack_mp_inputs`) skips the id exchange: every rank gets its
tables' ids for the global batch, pre-offset.

Tiered storage (``tiering/``): a host-tier class keeps only a hot cache
plus a staging region on the device. The routed ids stay in the logical
vocabulary; :meth:`DistributedLookup.translate_tiered_ids` maps them to
compact cache or staging slots after routing (the padded, deduplicated
and ragged forms alike), :meth:`~DistributedLookup.install_staging`
writes the step's staged cold rows into the staging region,
:meth:`~DistributedLookup.staged_regions` copies them back out after the
apply, and :meth:`~DistributedLookup.trim_spill` returns a spill step's
cache region to the persistent buffer. The fused gather and the one
scatter-add per class then serve both tiers unchanged: an id in neither
tier becomes the logical sentinel, which lies at or past the compact
buffer's rows, so K4 reads zeros for it and K1 drops it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cuda_delta import build_delta_rows, build_delta_rows_plain
from ..ops.cuda_exchange import gather_rows
from ..ops.cuda_layout import row_major
from ..ops.packed_table import (
    PackedLayout,
    SparseRule,
    _grp_sub,
    gather_fused,
    gather_fused_chunked,
    mxu_operand_dtype,
    residual_lanes,
    scatter_add_fused,
)
from ..ops.ragged import RaggedIds
from ..ops.sparse_grad import (
    add_rows_in_order,
    dedup_rows,
    expand_unique_rows,
    unique_ids_map,
)
from . import wire

if TYPE_CHECKING:
  from ..layers.planner import DistEmbeddingStrategy

PAD_ID = -1  # marks hotness padding in dense-padded inputs


def _cotangent_pin() -> bool:
  """``DE_TORCH_COTANGENT_PIN=1``: copy each sparse bucket's cotangent to
  a contiguous tensor with kernel K7 before the apply (the JAX engine's
  default-off ``DE_TPU_COTANGENT_PIN`` layout pin). Off by default."""
  return os.environ.get("DE_TORCH_COTANGENT_PIN", "0") == "1"


def _masked_multi_hot(layout: PackedLayout, ids) -> bool:
  """A multi-hot bucket of a narrow class with optimizer state: gathered
  as window-masked physical rows, folded per bag (the JAX engine's
  condition)."""
  return (layout.rows_per_phys > 1 and bool(layout.n_aux)
          and ids.dim() == 3 and ids.shape[-1] > 1)


def class_param_name(width: int, combiner: Optional[str],
                     kind: str = "sparse", gen: int = 0) -> str:
  base = f"mp_table_w{width}_{combiner if combiner else 'cat'}"
  if kind != "sparse":
    base += "_dense"
  return base if gen == 0 else f"{base}_g{gen}"


def vocab_cap(n: int) -> int:
  """Static one-hot window size for a dense-class slot: pow2, >= 8."""
  cap = 8
  while cap < n:
    cap *= 2
  return cap


class Bucket(NamedTuple):
  """Slots of one class sharing (hotness, one-hot window size, row-sliced)."""

  h: int
  vcap: int  # 0 for sparse classes
  slot_idx_per_rank: tuple  # per rank, indices into slots_per_rank[rank]
  n_b: int  # padded slot count (max over ranks)
  rs: bool = False  # slots of row-sliced shards (partial-sum semantics)


class BucketKey(NamedTuple):
  """Sortable dict key for one (class, hotness, vocab-window) bucket;
  ``combiner=None`` is encoded as ``""``."""

  width: int
  combiner: str
  kind: str
  gen: int
  h: int
  vcap: int
  rs: bool = False

  @property
  def class_key(self):
    return (self.width, self.combiner or None, self.kind, self.gen)


def bucket_key(class_key, h: int, vcap: int, rs: bool = False) -> BucketKey:
  w, c, kind, gen = class_key
  return BucketKey(w, c or "", kind, gen, h, vcap, rs)


def class_buckets(plan: "DistEmbeddingStrategy", key,
                  hotness_of) -> List[Bucket]:
  """Split a class's slots into static (hotness, vocab-window) buckets."""
  cp = plan.classes[key]
  dense = cp.kind == "dense"

  def bkey(slot):
    h = hotness_of(slot.input_id)
    if h < 0:  # ragged value stream
      if dense:
        # the planner keeps a table sparse when its input is declared
        # ragged (negative input_hotness); raggedness that appears only at
        # call time lands here
        raise NotImplementedError(
            "ragged inputs into a dense-class (MXU one-hot) table: declare "
            "the input ragged up front (negative input_hotness entry) so "
            "the planner keeps its table on the sparse path, or pre-pad "
            "the input (ragged_to_padded)")
      if cp.combiner is None:
        raise ValueError("ragged distributed inputs require a combiner "
                         "('sum' or 'mean')")
    return (h, vocab_cap(slot.shard.input_dim) if dense else 0,
            slot.shard.row_sliced)

  keys = sorted({bkey(s) for slots in cp.slots_per_rank for s in slots})
  buckets = []
  for h, vcap_, rs in keys:
    per_rank = tuple(
        tuple(i for i, s in enumerate(slots) if bkey(s) == (h, vcap_, rs))
        for slots in cp.slots_per_rank)
    buckets.append(Bucket(h, vcap_, per_rank,
                          max(len(i) for i in per_rank), rs))
  return buckets


def padded_rows(plan: "DistEmbeddingStrategy", key) -> int:
  """Buffer rows for a class: max fused rows, plus for dense classes enough
  tail padding that every slot's one-hot window fits inside the buffer."""
  cp = plan.classes[key]
  rows = cp.max_rows
  if cp.kind == "dense":
    for slots in cp.slots_per_rank:
      for s in slots:
        rows = max(rows, s.row_offset + vocab_cap(s.shard.input_dim))
  return rows


def ragged_to_padded(ids: RaggedIds, max_hot: int) -> torch.Tensor:
  """RaggedIds -> dense ``[B, max_hot]`` with PAD_ID padding (each sample's
  first ``max_hot`` ids; the JAX package's function)."""
  ids = _as_ragged(ids)
  b = ids.nrows
  splits = ids.row_splits.long()
  pos = torch.arange(max_hot, device=splits.device)[None, :]
  valid = pos < (splits[1:] - splits[:-1])[:, None]
  if not ids.values.shape[0]:
    return torch.full((b, max_hot), PAD_ID, dtype=torch.int32,
                      device=splits.device)
  flat = (splits[:-1, None] + pos).clamp(0, ids.values.shape[0] - 1)
  gathered = ids.values[flat].to(torch.int32)
  return torch.where(valid, gathered, torch.full_like(gathered, PAD_ID))


def _as_ragged(x: RaggedIds) -> RaggedIds:
  """A RaggedIds whose fields are integer tensors on one device."""
  values = torch.as_tensor(x.values)
  splits = torch.as_tensor(x.row_splits, device=values.device)
  for name, t in (("values", values), ("row_splits", splits)):
    if t.dtype.is_floating_point or t.dtype == torch.bool:
      raise TypeError(f"RaggedIds {name} must be integers, got {t.dtype}")
  if values.dim() != 1 or splits.dim() != 1 or splits.shape[0] < 1:
    raise ValueError(
        f"RaggedIds needs 1-D values and non-empty 1-D row_splits, got "
        f"{tuple(values.shape)} and {tuple(splits.shape)}")
  return RaggedIds(values, splits)


def ragged_hotness(x) -> int:
  """Engine-internal hotness code of one input: ``>= 1`` is a static
  hotness (1 for ``[B]``, ``H`` for ``[B, H]``); ``-(V + 1)`` is a ragged
  value stream of capacity ``V = values.shape[0]`` (the +1 keeps a
  capacity-0 stream apart from the static codes)."""
  if isinstance(x, RaggedIds):
    return -(int(x.values.shape[0]) + 1)
  if not hasattr(x, "ndim"):
    x = torch.as_tensor(x)
  return 1 if x.ndim == 1 else int(x.shape[1])


def _normalize_input(x):
  """-> ``[B, H]`` int64 tensor, PAD_ID marking invalid entries, or a
  :class:`RaggedIds` (passed through as its value stream and splits)."""
  if isinstance(x, RaggedIds):
    return _as_ragged(x)
  x = torch.as_tensor(x)
  if x.dim() == 1:
    x = x[:, None]
  if x.dim() != 2:
    raise ValueError(f"Distributed inputs must be 1-D or 2-D, got {x.dim()}-D")
  if x.dtype.is_floating_point or x.dtype == torch.bool:
    raise TypeError(f"ids must be integers, got {x.dtype}")
  return x.long()


def _batch_of(inputs) -> int:
  x = inputs[0]
  return x.nrows if isinstance(x, RaggedIds) else x.shape[0]


def _device_of(x) -> torch.device:
  return x.values.device if isinstance(x, RaggedIds) else x.device


def _require_wide_ids(plan: "DistEmbeddingStrategy", shard, ids) -> None:
  """Refuse int32 ids addressing a table with more than 2^31 - 1 rows: the
  rows past int32 cannot be named by them (the JAX package's guard)."""
  vocab = plan.global_configs[shard.table_id].input_dim
  if vocab > 2 ** 31 - 1 and ids.dtype != torch.int64:
    raise ValueError(
        f"table {shard.table_id} has input_dim={vocab:,} > int32 max but "
        f"its ids arrived as {ids.dtype}: ids above 2^31 cannot be "
        "expressed. Pass int64 ids for this table.")


def _seg_ids(lengths: torch.Tensor, capacity: int) -> torch.Tensor:
  """Per value-stream position, its sample index (clamped to ``B - 1`` for
  the sentinel-padded tail): ``lengths [..., B]`` -> ``[..., capacity]``
  int64 (the JAX ``_seg_ids``, batched over leading axes)."""
  lengths = lengths.long()
  b = lengths.shape[-1]
  splits = _splits_of(lengths)
  pos = torch.arange(capacity, device=lengths.device).expand(
      tuple(lengths.shape[:-1]) + (capacity,)).contiguous()
  seg = torch.searchsorted(splits.contiguous(), pos, right=True) - 1
  return seg.clamp(0, max(b - 1, 0))


def _seg_offsets(lengths: torch.Tensor, capacity: int) -> torch.Tensor:
  """Segment offsets ``[..., B + 1]`` of a value stream from its sample
  lengths ``[..., B]``: ``[0, cumsum(lengths)]`` clamped into ``[0,
  capacity]`` and kept non-decreasing, so no segment reads past the stream
  (for valid lengths, the positions :func:`_seg_ids` assigns)."""
  offs = _splits_of(lengths.long())
  return torch.cummax(offs.clamp(0, capacity), dim=-1).values


def _splits_of(lengths: torch.Tensor) -> torch.Tensor:
  """``[..., B]`` lengths -> ``[..., B + 1]`` splits ``[0, cumsum]``."""
  zero = lengths.new_zeros(tuple(lengths.shape[:-1]) + (1,))
  return torch.cat([zero, torch.cumsum(lengths, dim=-1)], dim=-1)


def _segment_counts(flags: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
  """Per segment, the count of set ``flags [..., V]`` inside its window of
  ``offs [..., B + 1]``: ``[..., B]`` int64 (exact; no atomics)."""
  at = _splits_of(flags.long()).gather(-1, offs)
  return at[..., 1:] - at[..., :-1]


# Staged-id padding of the tiering searchsorted: larger than any physical
# row id, so padded staging slots sort after every real id and match none.
TIER_PAD_GRP = np.int32(2 ** 31 - 1)


@dataclasses.dataclass(frozen=True)
class TierSpec:
  """Device-side geometry of one host-tiered class (per rank).

  The compact device buffer is ``[cache_grps + staging_grps, phys_width]``:
  physical rows ``[0, cache_grps)`` hold the frequency-ranked resident hot
  set, rows ``[cache_grps, cache_grps + staging_grps)`` are the per-step
  staging region for the batch's cold rows. ``rows``/``rpp`` describe the
  LOGICAL vocabulary the routing tensors address."""

  name: str
  rows: int          # logical rows (sentinel base; = padded_rows(plan, key))
  rpp: int           # logical rows per physical row (layout.rows_per_phys)
  cache_grps: int    # resident physical rows per rank
  staging_grps: int  # persistent staging physical rows per rank

  @property
  def compact_rows(self) -> int:
    """Logical row capacity of the persistent compact buffer."""
    return (self.cache_grps + self.staging_grps) * self.rpp


def _translate_tier(ids: torch.Tensor, spec: TierSpec, sentinel: int,
                    resident_local: torch.Tensor,
                    staged_local: torch.Tensor):
  """One routing tensor's logical ids -> ``(compact ids, [hot, staged,
  missed, total])``.

  ``resident_local``: ``[phys_rows]`` int32, the cache physical row or -1;
  ``staged_local``: ``[S]`` sorted staged physical-row ids
  (``TIER_PAD_GRP`` padding). A valid id resolves hot -> cache slot,
  cold-staged -> staging slot; anything else (the routing sentinel too)
  maps to ``sentinel``, an id the gather zero-fills and the scatter
  drops. The ids keep their dtype; the counters are int32 occurrence
  counts."""
  valid = (ids >= 0) & (ids < spec.rows)
  safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
  grp = safe // spec.rpp
  sub = safe % spec.rpp
  cache_slot = resident_local[grp.clamp(0, resident_local.shape[0] - 1)]
  s = staged_local.shape[0]
  if s:
    pos = torch.searchsorted(staged_local,
                             grp.to(staged_local.dtype)).clamp(0, s - 1)
    staged_hit = staged_local[pos] == grp
  else:
    pos = torch.zeros_like(grp)
    staged_hit = torch.zeros_like(valid)
  slot = torch.where(cache_slot >= 0, cache_slot.long(),
                     torch.where(staged_hit, spec.cache_grps + pos,
                                 torch.full_like(pos, -1)))
  translated = torch.where(valid & (slot >= 0), slot * spec.rpp + sub,
                           torch.full_like(slot, sentinel)).to(ids.dtype)
  hot = (valid & (cache_slot >= 0)).sum()
  staged = (valid & (cache_slot < 0) & staged_hit).sum()
  missed = (valid & (slot < 0)).sum()
  total = valid.sum()
  return translated, torch.stack([hot, staged, missed, total]).to(torch.int32)


@dataclasses.dataclass
class DedupRouted:
  """The deduplicated routing of one padded sparse bucket
  (``dedup_exchange=True``, world > 1).

  Per destination rank the routing block's ids are sorted and uniqued on
  the source rank to the static capacity ``K = min(block occurrences,
  sentinel + 1)`` (the values lie in ``[0, sentinel]``, so it never
  overflows) and only the unique blocks cross the wire. The owner
  gathers one row per unique id and returns ``[K, w]`` rows; the source
  rank re-expands them through its own inverse map and runs the combiner
  there.

  ``overflow`` is set only when the plan caps ``K`` below that bound
  (``dedup_capacity``): this rank's count of distinct ids that got no
  slot of their own, summed over the bucket's destination blocks (each
  aliased onto the cap's last slot and read the wrong row). The guarded
  step and the eval step with metrics sum it over the ranks into
  ``dedup_overflow``."""

  uniq: torch.Tensor        # [world_src, K] the owner's unique ids
  inv: torch.Tensor         # [world_dst, n_b, B(, h)] this rank's inverse map
  uniq_local: torch.Tensor  # [world_dst, K] this rank's unique blocks
  overflow: Optional[torch.Tensor] = None  # int32 scalar iff capped


@dataclasses.dataclass
class SparseResiduals:
  """Forward-saved state for the fused sparse backward: the routed ids and
  the rows that rode along in the forward gather.

  ``aux_rows[bk]`` holds the bucket's gathered fused rows ``[..., stride]``
  when the rule reads them (optimizer state, or the forward-time table row
  for ``weight_decay``), else None. The gather's advanced indexing copies
  the rows, so the residuals never alias the buffer that the apply then
  updates in place."""

  ids_all: Dict[BucketKey, torch.Tensor]
  aux_rows: Dict[BucketKey, Optional[torch.Tensor]]


@dataclasses.dataclass
class FusedChunks:
  """Round-major fused-exchange payload of one sparse bucket
  (``overlap='fused'``).

  ``blocks[k][c]`` is chunk ``c`` of what this rank gathered for round
  ``k``'s destination, rank ``(i + k) % world``: ``[n_b, rows_c, w]``
  combined activations of a raw bucket (``kind == "raw"``), ``[rows_c,
  w]`` unique rows of a deduplicated one (``kind == "dedup"``). Each
  chunk feeds exactly one :func:`wire.fused_block_send`, and its
  cotangent comes back in the same per-round form;
  :meth:`DistributedLookup._sparse_parts_by_class` reassembles it to the
  dest-major layout (pure data movement, so f32 stays bit-exact against
  the monolithic and pipelined schedules)."""

  blocks: tuple  # blocks[k][c]: round k's c-th row chunk
  kind: str = "raw"  # "raw" | "dedup"

  def map(self, fn) -> "FusedChunks":
    """The same structure with ``fn`` applied to every chunk."""
    return FusedChunks(tuple(tuple(fn(c) for c in blk)
                             for blk in self.blocks), self.kind)

  def rounds(self) -> list:
    """Each round's chunks concatenated: ``[n_b, rows, w]`` (raw) or
    ``[K, w]`` (dedup) per round."""
    axis = 0 if self.kind == "dedup" else 1
    return [blk[0] if len(blk) == 1 else torch.cat(blk, dim=axis)
            for blk in self.blocks]


class _DenseWindowRows(torch.autograd.Function):
  """Dense-class lookup with the JAX engine's backward precision.

  Forward: the table rows at ``idx`` (zero where ``valid`` is false),
  summed in f32 over the hotness axis for multi-hot buckets, in
  ``out_dtype`` (the JAX one-hot contraction at HIGHEST precision returns
  the rows exactly in f32, cast to the table's storage type). Backward:
  ``d_z`` rounded to ``mxu_operand_dtype(f32, device)`` (bf16 on the
  card, as on the TPU; f32 on the CPU) and accumulated in f32 into the
  table rows with ``index_add_`` — the JAX ``_onehot_window_matmul_bwd``
  in row form. The table gradient is f32, as the JAX one's: the sparse
  step reads an f32 work copy of a bf16 table (``training.trained_tables``),
  so nothing rounds it. A bf16 leaf (the dense-autodiff layer's bf16 class
  buffer) has its ``.grad`` rounded to bf16 by autograd; where an
  optimizer that follows the JAX step's dtypes asked for it
  (``training.Adam``), the leaf also gets the f32 gradient as its
  ``wide_grad`` (:func:`add_wide_grad`)."""

  @staticmethod
  def forward(ctx, table, idx, valid, two_d, out_dtype):
    rows = table[idx].to(torch.float32)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    ctx.save_for_backward(idx, valid)
    ctx.two_d = two_d
    ctx.table_shape = table.shape
    ctx.wide_leaf = (table if hasattr(table, "wide_grad") and table.is_leaf
                     and table.requires_grad else None)
    return (rows if two_d else _sum_axis2(rows)).to(out_dtype)

  @staticmethod
  def backward(ctx, d_z):
    idx, valid = ctx.saved_tensors
    cd = mxu_operand_dtype(torch.float32, d_z.device)
    g = d_z.to(cd).to(torch.float32)
    if not ctx.two_d:
      g = g[:, :, None, :].expand(idx.shape + (g.shape[-1],))
    g = torch.where(valid[..., None], g, torch.zeros_like(g))
    d_table = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=d_z.device)
    d_table.index_add_(0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
    if ctx.wide_leaf is not None:
      add_wide_grad(ctx.wide_leaf, d_table)
    return d_table, None, None, None, None


def add_wide_grad(leaf: torch.Tensor, grad: torch.Tensor) -> None:
  """Accumulate the f32 ``grad`` of a narrow (bf16) leaf into its
  ``wide_grad`` attribute: the gradient the JAX step hands its optimizer
  unrounded, where autograd's ``.grad`` holds it rounded to the leaf's
  dtype. Only ``training.Adam`` creates the attribute (on the narrow
  parameters it steps), reads it and clears it, at its step and with
  ``.grad`` at its ``zero_grad``."""
  wide = getattr(leaf, "wide_grad", None)
  leaf.wide_grad = grad if wide is None else wide + grad


class _FillRows(torch.autograd.Function):
  """Sparse-class rows of the simple layout: ``table[ids]``, all-zero rows
  for ids outside ``[0, rows)`` (the JAX engine's ``jnp.take(...,
  mode="fill", fill_value=0)``: the sentinel and padding read nothing).
  Backward: the f32 cotangent rows of the in-range ids accumulated into a
  dense ``[rows, width]`` table gradient with ``index_add_``; the
  sentinel's and the padding's land nowhere. The gradient is a fresh
  tensor, so autograd makes it the leaf's ``.grad`` without a copy."""

  @staticmethod
  def forward(ctx, table, ids):
    rows = table.shape[0]
    valid = (ids >= 0) & (ids < rows)
    idx = torch.where(valid, ids, torch.zeros_like(ids))
    out = table[idx]
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    ctx.save_for_backward(idx, valid)
    ctx.table_shape = table.shape
    return out

  @staticmethod
  def backward(ctx, d_rows):
    idx, valid = ctx.saved_tensors
    g = torch.where(valid[..., None], d_rows, torch.zeros_like(d_rows))
    d_table = torch.zeros(ctx.table_shape, dtype=d_rows.dtype,
                          device=d_rows.device)
    d_table.index_add_(0, idx.reshape(-1), g.reshape(-1, g.shape[-1]))
    return d_table, None


class DistributedLookup:
  """Lookup engine bound to one plan and, at world > 1, to this rank's
  :class:`~.mesh.Mesh` (see module docstring).

  Class params are the rank's local 2-D blocks: ``[rows, width]`` of the
  JAX package's ``[world * rows, width]`` arrays (at world 1 the whole
  buffer)."""

  def __init__(self, plan: "DistEmbeddingStrategy",
               apply_chunk: int = 1 << 22, mesh=None):
    self.plan = plan
    if mesh is not None and mesh.world != plan.world_size:
      raise ValueError(f"the mesh has {mesh.world} ranks, the plan "
                       f"{plan.world_size}")
    self.mesh = mesh if plan.world_size > 1 else None
    # occurrences per scatter chunk in apply_sparse (bounds the backward's
    # per-occurrence temporaries; small values exercise the multi-chunk
    # path in tests)
    self.apply_chunk = apply_chunk
    self._bucket_cache: Dict[tuple, List[Bucket]] = {}
    self._slot_map_cache: Dict[tuple, Dict[tuple, tuple]] = {}

  # ---- shapes ------------------------------------------------------------
  def param_shapes(self) -> Dict[str, tuple]:
    """Simple-layout class param shapes ``[world * padded_rows, width]``:
    rank r's block is rows ``[r * padded_rows, (r + 1) * padded_rows)``."""
    shapes = {}
    for key in self.plan.class_keys:
      cp = self.plan.classes[key]
      shapes[class_param_name(*key)] = (
          self.plan.world_size * padded_rows(self.plan, key), cp.width)
    return shapes

  def _my_rank(self) -> int:
    if self.plan.world_size == 1:
      return 0
    if self.mesh is None:
      raise ValueError(
          f"a world-{self.plan.world_size} plan's lookups need this rank's "
          "mesh: DistributedLookup(plan, mesh=parallel.mesh.create_mesh())")
    return self.mesh.rank

  # ---- the plan's wire, in one place -------------------------------------
  def _pipelined_wire(self) -> bool:
    """Rotation rounds for every exchange (``overlap='pipelined'``, and
    the exchanges with no per-round gather under ``'fused'``)."""
    return (wire.plan_overlap(self.plan) in ("pipelined", "fused")
            and self.plan.world_size > 1)

  def _fused_wire(self) -> bool:
    """Sparse-class blocks gathered per round just before their sends."""
    return (wire.plan_overlap(self.plan) == "fused"
            and self.plan.world_size > 1)

  def _wire_exchange_ids(self, x: torch.Tensor) -> torch.Tensor:
    if self._pipelined_wire():
      return wire.pipelined_exchange_ids(
          x, self.mesh, wire.plan_exchange_chunks(self.plan))
    return wire.exchange_ids(x, self.mesh)

  def _wire_exchange_float(self, x: torch.Tensor) -> torch.Tensor:
    wd = wire.plan_wire_dtype(self.plan)
    if self._pipelined_wire():
      return wire.pipelined_float_exchange(
          x, self.mesh, wd, wire.plan_exchange_chunks(self.plan))
    return wire.float_all_to_all(x, self.mesh, wd)

  # ---- dp-side routing ---------------------------------------------------
  def _build_routing(self, key, bucket: Bucket,
                     inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[world, n_b, B(, h)]`` routing tensor for one bucket (hotness-1
    buckets drop the h axis). Sentinel (= buffer rows) marks padded slots
    and PAD_ID entries; out-of-vocabulary ids clamp to the table's last
    row (the plan's 'clip' policy)."""
    if bucket.h < 0:
      return self._build_ragged_routing(key, bucket, inputs)
    cp = self.plan.classes[key]
    world = self.plan.world_size
    sentinel = padded_rows(self.plan, key)
    b = _batch_of(inputs)
    dev = _device_of(inputs[0])
    pad_shape = (b,) if bucket.h == 1 else (b, bucket.h)
    pad_block = torch.full(pad_shape, sentinel, dtype=torch.long, device=dev)
    per_dest = []
    for rank in range(world):
      idxs = bucket.slot_idx_per_rank[rank]
      per_slot = []
      for k in range(bucket.n_b):
        if k >= len(idxs):
          per_slot.append(pad_block)
          continue
        slot = cp.slots_per_rank[rank][idxs[k]]
        ids = inputs[slot.input_id]
        if bucket.h == 1:
          ids = ids[:, 0]
        sh = slot.shard
        if sh.row_sliced:
          vocab = self.plan.global_configs[sh.table_id].input_dim
          clamped = ids.clamp(0, vocab - 1)
          in_win = (ids >= 0) & (clamped >= sh.row_start) & (
              clamped < sh.row_start + sh.input_dim)
          routed = torch.where(in_win,
                               clamped - sh.row_start + slot.row_offset,
                               sentinel)
        else:
          routed = torch.where(ids < 0, sentinel,
                               ids.clamp(0, sh.input_dim - 1)
                               + slot.row_offset)
        per_slot.append(routed)
      per_dest.append(torch.stack(per_slot))
    return torch.stack(per_dest)

  def _build_ragged_routing(self, key, bucket: Bucket, inputs):
    """Value-stream routing of a ragged bucket: ``(vals [world, n_b, V],
    lens [world, n_b, B])``, per destination rank and slot the routed
    value stream and the samples' positional lengths (``row_lengths``:
    they segment the stream; the mean divisor is the VALID-id count,
    recomputed on the owner from the sentinel pattern). The sentinel
    (= buffer rows) marks the tail past ``row_splits[-1]``, negative ids,
    padded slots and, for row slices, the ids outside the slice's window
    (clamped into the vocabulary first, as the padded routing does). ``V``
    is the bucket's capacity: the bucket key carries it, so all its inputs
    share it."""
    cp = self.plan.classes[key]
    world = self.plan.world_size
    sentinel = padded_rows(self.plan, key)
    cap = -bucket.h - 1
    b = _batch_of(inputs)
    dev = _device_of(inputs[0])
    pad_vals = torch.full((cap,), sentinel, dtype=torch.long, device=dev)
    pad_lens = torch.zeros((b,), dtype=torch.long, device=dev)
    all_vals, all_lens = [], []
    for rank in range(world):
      idxs = bucket.slot_idx_per_rank[rank]
      vals_r, lens_r = [], []
      for k in range(bucket.n_b):
        if k >= len(idxs):
          vals_r.append(pad_vals)
          lens_r.append(pad_lens)
          continue
        slot = cp.slots_per_rank[rank][idxs[k]]
        rg: RaggedIds = inputs[slot.input_id]
        sh = slot.shard
        _require_wide_ids(self.plan, sh, rg.values)
        v = rg.values.long()
        live = (torch.arange(cap, device=v.device)
                < rg.row_splits[-1].to(v.device))
        if sh.row_sliced:
          vocab = self.plan.global_configs[sh.table_id].input_dim
          clamped = v.clamp(0, vocab - 1)
          in_win = live & (v >= 0) & (clamped >= sh.row_start) & (
              clamped < sh.row_start + sh.input_dim)
          routed = torch.where(in_win,
                               clamped - sh.row_start + slot.row_offset,
                               sentinel)
        else:
          routed = torch.where(live & (v >= 0),
                               v.clamp(0, sh.input_dim - 1) + slot.row_offset,
                               sentinel)
        vals_r.append(routed)
        lens_r.append(rg.row_lengths().long())
      all_vals.append(torch.stack(vals_r))
      all_lens.append(torch.stack(lens_r))
    return torch.stack(all_vals), torch.stack(all_lens)

  def _check_hotness_agreement(self, codes: List[int]) -> None:
    """World > 1: refuse inputs whose hotness code differs between ranks
    (a ragged capacity ``values.shape[0]`` or a padded width): the bucket
    shapes, and so every exchange's size, follow from the codes, and
    unequal sizes would hang the exchange. One ``all_reduce`` of the
    codes and one host read; runs when an input is ragged or the plan
    declares one ragged (negative ``input_hotness``)."""
    n = len(codes)
    t = torch.tensor(list(codes) + [-c for c in codes], dtype=torch.int64,
                     device=self.mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = t[:n].tolist(), [-c for c in t[n:].tolist()]
    bad = [i for i in range(n) if hi[i] != lo[i]]
    if bad:
      i = bad[0]
      raise ValueError(
          f"input {i} arrives with different shapes on the ranks (hotness "
          f"codes {lo[i]} to {hi[i]}; a ragged input's code is -(capacity "
          "+ 1)): every rank must pass the same RaggedIds capacity "
          "(values.shape[0]) and the same padded hotness for an input, "
          "because the bucket shapes set the size of every exchange")

  def route_ids(self, inputs: Sequence, hotness_of=None,
                eager_oov: bool = True) -> Dict[BucketKey, torch.Tensor]:
    """dp->mp id exchange: per bucket, the global batch's ids that this
    rank's tables serve, ``bk -> [n_b, G]`` (hotness 1) or ``[n_b, G,
    h]`` with ``G = world * B`` source-rank-major. At world > 1 the ids
    travel the wire as int32, as in the JAX package, and stay int32.

    Under ``oov='error'`` an out-of-vocabulary id raises here, unless
    ``eager_oov=False``: the guarded train step and the eval step with
    metrics enforce the policy through their OOV counters instead (the
    JAX engine skips this check for traced inputs).

    A ragged bucket routes as ``(vals [n_b, world, V], lens [n_b, world,
    B])`` (the source-rank axis stays explicit: each source block has its
    own segmentation); the two travel the wire separately, and ragged
    buckets stay raw under ``dedup_exchange`` (the stream already scales
    with the true id count)."""
    plan = self.plan
    world = plan.world_size
    self._my_rank()  # a world > 1 plan needs the mesh
    inputs = [_normalize_input(x) for x in inputs]
    if len(inputs) != plan.num_inputs:
      raise ValueError(f"Expected {plan.num_inputs} inputs, got {len(inputs)}")
    b = _batch_of(inputs)
    for x in inputs:
      nrows = x.nrows if isinstance(x, RaggedIds) else x.shape[0]
      if nrows != b:
        raise ValueError("All inputs need the same batch size "
                         f"(got {nrows} vs {b}).")
    if plan.oov == "error" and eager_oov:
      self._oov_error_eager(inputs)
    if hotness_of is None:
      hotness_of = lambda i: ragged_hotness(inputs[i])  # noqa: E731
    if world > 1 and (any(isinstance(x, RaggedIds) for x in inputs) or any(
        h < 0 for h in (getattr(plan, "input_hotness", None) or ()))):
      self._check_hotness_agreement([hotness_of(i)
                                     for i in range(len(inputs))])
    ids_all = {}
    for key in plan.class_keys:
      for bucket in self._buckets(key, hotness_of):
        x = self._build_routing(key, bucket, inputs)  # [world, n_b, B(, h)]
        if bucket.h < 0:  # ragged: (vals [world, n_b, V], lens [world, n_b, B])
          vals, lens = x
          if world > 1:
            vals, lens = vals.to(torch.int32), lens.to(torch.int32)
            if vals.numel():
              vals = self._wire_exchange_ids(vals)
            if lens.numel():
              lens = self._wire_exchange_ids(lens)
          routed = (vals.transpose(0, 1), lens.transpose(0, 1))
        elif world > 1 and self._dedup_class(key):
          routed = self._dedup_route(key, x.to(torch.int32))
        elif world > 1:
          routed = self._reshape_routed(
              self._wire_exchange_ids(x.to(torch.int32)), bucket, world, b)
        else:
          routed = self._reshape_routed(x, bucket, world, b)
        ids_all[bucket_key(key, bucket.h, bucket.vcap, bucket.rs)] = routed
    return ids_all

  def _dedup_class(self, key) -> bool:
    """The deduplicated exchange applies to sparse-kind buckets only (the
    dense classes' window lookups gather no rows to dedup)."""
    return (wire.plan_dedup_exchange(self.plan)
            and self.plan.classes[key].kind == "sparse")

  def _dedup_route(self, key, x: torch.Tensor) -> DedupRouted:
    """Unique-then-exchange routing of one padded bucket: ``x [world,
    n_b, B(, h)]`` is the dest-major int32 routing tensor. Each
    destination block is sorted and uniqued here to ``K = min(m, sentinel
    + 1)`` slots (or the plan's ``dedup_capacity``, below that bound,
    with the overflow counted) and only the unique blocks cross the
    wire; the inverse maps stay here for the return expansion."""
    world = self.plan.world_size
    sentinel = padded_rows(self.plan, key)
    m = int(np.prod(x.shape[1:]))
    cap = min(m, sentinel + 1)
    cap_knob = getattr(self.plan, "dedup_capacity", None)
    overflow = None
    if cap_knob is not None and cap_knob < cap:
      cap = cap_knob
      uniq_local, inv, n_distinct = unique_ids_map(
          x.reshape(world, m), sentinel, cap, with_count=True)
      overflow = (n_distinct - cap).clamp(min=0).sum().to(torch.int32)
    else:
      uniq_local, inv = unique_ids_map(x.reshape(world, m), sentinel, cap)
    uniq = self._wire_exchange_ids(uniq_local)  # [world_src, K]
    return DedupRouted(uniq=uniq, inv=inv.reshape(x.shape),
                       uniq_local=uniq_local, overflow=overflow)

  @staticmethod
  def _reshape_routed(y, bucket, world, b):
    if bucket.h == 1:  # [world, n_b, B] -> [n_b, G]
      return y.transpose(0, 1).reshape(bucket.n_b, world * b)
    return y.transpose(0, 1).reshape(bucket.n_b, world * b, bucket.h)

  def _oov_error_eager(self, inputs: Sequence) -> None:
    """``oov='error'``: raise naming the input, the table, the first
    out-of-vocabulary id and the vocabulary (the JAX message); a value
    stream is read up to ``row_splits[-1]``."""
    for input_id, x in enumerate(inputs):
      vocab = self.plan.global_configs[
          self.plan.input_table_map[input_id]].input_dim
      if isinstance(x, RaggedIds):
        x = x.values.reshape(-1)[:int(x.row_splits[-1])]
      bad = x[x >= vocab]
      if bad.numel():
        table = self.plan.input_table_map[input_id]
        raise ValueError(
            f"OOV policy 'error': input {input_id} carries {bad.numel()} "
            f"id(s) outside table {table}'s vocabulary [0, {vocab}) — first "
            f"offender {int(bad[0])}. The 'clip' policy would have "
            "silently mapped these to the last row; fix the id pipeline "
            "or construct the plan with oov='clip'.")

  # ---- mp-side local lookups ---------------------------------------------
  def _combine(self, rows: torch.Tensor, ids_all: torch.Tensor, key,
               rs: bool = False) -> torch.Tensor:
    """Gathered rows -> ``[n_b, G, w]`` via the class combiner. The h-axis
    sum adds the hotness slots in order, one add per slot."""
    cp = self.plan.classes[key]
    sentinel = padded_rows(self.plan, key)
    if ids_all.dim() == 2 or ids_all.shape[-1] == 1:
      return rows if ids_all.dim() == 2 else rows[:, :, 0, :]
    if cp.combiner is None:
      raise ValueError("combiner=None requires hotness-1 inputs in the "
                       "distributed path (2-D model-parallel outputs)")
    summed = _sum_axis2(rows)
    if cp.combiner == "mean" and not rs:
      counts = (ids_all < sentinel).sum(dim=2).to(summed.dtype)
      summed = summed / counts.clamp(min=1)[..., None]
    return summed

  def _z_sparse_simple(self, key, table_local: torch.Tensor,
                       ids_all, rs: bool = False) -> torch.Tensor:
    """Differentiable gather on the simple ``[rows, w]`` table, then the
    class combiner (padded ids). A :class:`DedupRouted` bucket gathers one
    row per unique id, ``[world_src, K, w]``: its combiner runs on the
    source rank after the return exchange re-expands the rows."""
    if isinstance(ids_all, DedupRouted):
      return _FillRows.apply(table_local, ids_all.uniq)
    if isinstance(ids_all, tuple):  # ragged value stream
      vals, lens = ids_all
      return self._combine_ragged(_FillRows.apply(table_local, vals), vals,
                                  lens, key, rs)
    return self._combine(_FillRows.apply(table_local, ids_all), ids_all,
                         key, rs)

  def _ragged_valid_counts(self, vals: torch.Tensor, lens: torch.Tensor,
                           key) -> torch.Tensor:
    """Per-sample VALID-id counts ``[..., B]`` of value streams ``vals
    [..., V]`` segmented by ``lens [..., B]``: the entries a sample's
    length window covers minus those routed to the sentinel (invalid,
    negative or another row slice's ids): the divisor the padded path's
    ``sum(ids < sentinel)`` computes."""
    sentinel = padded_rows(self.plan, key)
    return _segment_counts(vals < sentinel,
                           _seg_offsets(lens, vals.shape[-1]))

  def _combine_ragged(self, rows: torch.Tensor, vals: torch.Tensor,
                      lens: torch.Tensor, key, rs: bool = False
                      ) -> torch.Tensor:
    """Per-occurrence rows ``[n_b, world, V, w]`` and ``lens [n_b, world,
    B]`` -> ``[n_b, world * B, w]``: each source block's samples summed
    over their segments of the stream by ``torch.segment_reduce`` (each
    segment's rows added in stream order from +0.0, one thread per output
    lane on the card: no atomics, so the answer repeats bit for bit;
    differentiable). The tail past the live stream belongs to no segment
    (its sentinel rows are zeros, which the JAX engine adds to the last
    sample: the same sums). bf16 rows (narrow storage) add one after
    another with every add rounded (:func:`_segment_sum_in_order`).
    ``mean`` divides by the valid-id counts;
    row-sliced buckets (``rs``) leave the division to :meth:`assemble`,
    as the padded path does."""
    cp = self.plan.classes[key]
    n_b, world, cap, w = rows.shape
    b = lens.shape[2]
    if rows.dtype == torch.float32:
      summed = torch.segment_reduce(
          rows, "sum", offsets=_seg_offsets(lens, cap), axis=2, unsafe=True)
    else:
      summed = _segment_sum_in_order(rows, lens)
    summed = summed.reshape(n_b, world * b, w)
    if cp.combiner == "mean" and not rs:
      counts = self._ragged_valid_counts(vals, lens, key).reshape(
          n_b, world * b).to(summed.dtype)
      summed = summed / counts.clamp(min=1)[..., None]
    return summed

  def _dense_offsets(self, key, bucket: Bucket) -> np.ndarray:
    cp = self.plan.classes[key]
    offs = np.zeros((self.plan.world_size, bucket.n_b), np.int64)
    for rank in range(self.plan.world_size):
      for k, idx in enumerate(bucket.slot_idx_per_rank[rank]):
        offs[rank, k] = cp.slots_per_rank[rank][idx].row_offset
    return offs

  def _z_dense(self, key, bucket: Bucket, table_local: torch.Tensor,
               ids_all: torch.Tensor) -> torch.Tensor:
    """Small-vocab lookup of the dense classes.

    The JAX engine contracts a one-hot of each slot's window-local ids
    with the slot's ``[vcap, w]`` window at HIGHEST precision, which
    returns the window's rows exactly; this indexes the same rows
    (:class:`_DenseWindowRows`, which also gives the JAX backward's
    precision). Ids outside the window (the sentinel) read zeros. The rows
    come out in the table's storage type: a bf16 table's, or the
    ``storage_dtype`` its f32 work copy carries
    (``training.trained_tables``)."""
    two_d = ids_all.dim() == 2
    h = 1 if two_d else ids_all.shape[2]
    cp = self.plan.classes[key]
    if cp.combiner is None and h != 1:
      raise ValueError("combiner=None requires hotness-1 inputs in the "
                       "distributed path (2-D model-parallel outputs)")
    offs = torch.as_tensor(self._dense_offsets(key, bucket)[self._my_rank()],
                           device=ids_all.device)
    off_b = offs[:, None] if two_d else offs[:, None, None]
    ids_local = ids_all - off_b
    valid = (ids_local >= 0) & (ids_local < bucket.vcap)
    idx = torch.where(valid, ids_all, off_b.expand_as(ids_all))
    out_dtype = getattr(table_local, "storage_dtype", table_local.dtype)
    z = _DenseWindowRows.apply(table_local, idx, valid, two_d, out_dtype)
    if two_d:
      return z
    if cp.combiner == "mean" and h > 1:
      sentinel = padded_rows(self.plan, key)
      counts = (ids_all < sentinel).sum(dim=2).to(z.dtype)
      z = z / counts.clamp(min=1)[..., None]
    return z

  def exchange(self, z: Dict[BucketKey, torch.Tensor], batch_local: int,
               ids_all=None) -> Dict[BucketKey, torch.Tensor]:
    """mp->dp activation exchange: ``z`` maps ``bk -> [n_b, G, w]`` (or a
    :class:`FusedChunks`); returns ``bk -> [world_owner, n_b, B, w]``.
    Differentiable: the wire's backward runs the reverse exchange, which
    brings each rank the cotangents of the rows it owns.

    ``ids_all`` (the :meth:`route_ids` dict) is needed when the plan
    dedups the exchange: a bucket routed as :class:`DedupRouted` carries
    ``z[bk] = [world_src, K, w]`` unique rows and returns through
    :meth:`_exchange_dedup`."""
    world = self.plan.world_size
    self._my_rank()  # a world > 1 plan needs the mesh
    received = {}
    for bk, zb in z.items():
      dr = ids_all.get(bk) if ids_all is not None else None
      if isinstance(zb, FusedChunks):
        received[bk] = self._exchange_fused(bk, zb, dr)
        continue
      if isinstance(dr, DedupRouted):
        received[bk] = self._exchange_dedup(bk, zb, dr)
        continue
      zb = zb.reshape(zb.shape[0], world, batch_local, -1).transpose(0, 1)
      if world > 1:
        zb = self._wire_exchange_float(zb)
      received[bk] = zb
    return received

  # ---- just-in-time fused schedule (overlap='fused') ---------------------
  def _fused_chunk_slices(self, rows: int):
    """Static ``(start, size)`` row chunks of one round block: at most
    ``exchange_chunks`` chunks, never an empty one, the tail the
    smallest; the same on every rank."""
    chunks = max(1, min(wire.plan_exchange_chunks(self.plan), rows))
    per = -(-rows // chunks)
    return [(s, min(per, rows - s)) for s in range(0, rows, per)]

  def _fused_gather(self, layout: PackedLayout, buf_local: torch.Tensor,
                    ids: torch.Tensor, masked_phys: bool = False
                    ) -> torch.Tensor:
    """One round block's gather: kernel K4 (``ops/cuda_exchange.py``) for
    plain-row f32 or bf16 layouts (one fused row per physical row, at any
    stride; bf16 takes K4's bf16 form), ``gather_fused_chunked`` (the
    monolithic schedule's gather) for every other layout and for
    window-masked physical rows. On the CPU K4's wrapper runs its plain
    version."""
    if (not masked_phys and layout.rows_per_phys == 1
        and buf_local.dtype in (torch.float32, torch.bfloat16)):
      return gather_rows(layout, buf_local, ids.to(torch.int32))
    return gather_fused_chunked(layout, buf_local, ids,
                                masked_phys=masked_phys)

  def _fused_reassemble(self, per_round, kind: str = "raw") -> torch.Tensor:
    """Round-major blocks -> the dest-major layout: ``per_round[k]`` is
    the payload for rank ``(i + k) % world``, ``[n_b, rows, ...]`` ->
    ``[n_b, world * rows, ...]`` (raw), ``[K, ...]`` -> ``[world, K,
    ...]`` (dedup). Pure data movement."""
    world, i = self.plan.world_size, self._my_rank()
    by_dest = [per_round[(d - i) % world] for d in range(world)]
    if kind == "dedup":
      return torch.stack(by_dest)
    out = torch.stack(by_dest, dim=1)  # [n_b, world, rows, ...]
    return out.reshape((out.shape[0], world * out.shape[2])
                       + tuple(out.shape[3:]))

  def _z_sparse_fused_jit(self, key, layout: PackedLayout,
                          buf_local: torch.Tensor, ids_all: torch.Tensor,
                          rs: bool = False, keep_rows: bool = False):
    """Just-in-time counterpart of :meth:`_z_sparse_fused`: ``(FusedChunks,
    aux)``. Round ``k`` gathers and combines only the ids of destination
    ``(i + k) % world``, chunk by chunk; gather and combine act per
    (slot, sample), so slicing the ids first equals slicing the
    monolithic result after (bit-exact). The aux residuals are
    reassembled to their dest-major layouts here.

    A :class:`DedupRouted` bucket's round ``k`` gathers only rank ``(i +
    k) % world``'s unique block, chunk by chunk (K4 on the card; the
    sentinel-padded slots gather zero rows); the source rank expands and
    combines after the return (:meth:`_exchange_fused`)."""
    world, i = self.plan.world_size, self._my_rank()
    if isinstance(ids_all, DedupRouted):
      w = layout.width
      keep = bool(layout.n_aux or keep_rows)
      blocks, aux_rounds = [], []
      for k in range(world):
        uniq_d = ids_all.uniq[(i + k) % world]  # [K]
        zc, ac = [], []
        for s0, sz in self._fused_chunk_slices(uniq_d.shape[0]):
          fused = self._fused_gather(layout, buf_local, uniq_d[s0:s0 + sz])
          zc.append(fused[..., :w])
          ac.append(fused)
        blocks.append(tuple(zc))
        if keep:
          aux_rounds.append(ac[0] if len(ac) == 1 else torch.cat(ac))
      aux = self._fused_reassemble(aux_rounds, "dedup") if keep else None
      return FusedChunks(tuple(blocks), "dedup"), aux
    if isinstance(ids_all, tuple):  # ragged value stream
      # each round gathers its destination's whole stream (K4 on the card)
      # and combines it; the combined rows are chunked, since a segment
      # sum cannot split a sample
      vals, lens = ids_all  # [n_b, world, V], [n_b, world, B]
      w = layout.width
      keep = bool(layout.n_aux or keep_rows)
      blocks, aux_rounds = [], []
      for k in range(world):
        d = (i + k) % world
        vals_d, lens_d = vals[:, d:d + 1], lens[:, d:d + 1]
        fused = self._fused_gather(layout, buf_local, vals_d)
        zblk = self._combine_ragged(fused[..., :w], vals_d, lens_d, key, rs)
        blocks.append(tuple(zblk[:, s0:s0 + sz] for s0, sz in
                            self._fused_chunk_slices(lens.shape[2])))
        aux_rounds.append(fused if keep else None)
      aux = self._fused_reassemble(aux_rounds) if keep else None
      return FusedChunks(tuple(blocks)), aux
    bsz = ids_all.shape[1] // world
    masked = _masked_multi_hot(layout, ids_all)
    blocks, aux_rounds = [], []
    for k in range(world):
      d = (i + k) % world
      ids_d = ids_all[:, d * bsz:(d + 1) * bsz]
      zc, ac = [], []
      for s0, sz in self._fused_chunk_slices(bsz):
        ids_c = ids_d[:, s0:s0 + sz]
        z, a = self._combine_fused(
            key, layout, self._fused_gather(layout, buf_local, ids_c, masked),
            ids_c, rs, keep_rows)
        zc.append(z)
        ac.append(a)
      blocks.append(tuple(zc))
      aux_rounds.append(None if ac[0] is None else
                        ac[0] if len(ac) == 1 else torch.cat(ac, dim=1))
    aux = (None if aux_rounds[0] is None
           else self._fused_reassemble(aux_rounds))
    return FusedChunks(tuple(blocks)), aux

  def _exchange_fused(self, bk, fz: FusedChunks,
                      dr: Optional[DedupRouted]) -> torch.Tensor:
    """mp->dp return of a :class:`FusedChunks` payload, one send per
    just-gathered chunk; received round ``k`` came from rank ``(i - k) %
    world``, so the rounds are placed source-major:
    ``[world, n_b, B, w]``.

    A deduplicated bucket expands and combines per round, through that
    round's own inverse-map slice (round ``k``'s rows answer the unique
    block this rank sent to ``(i - k) % world``); multi-hot buckets
    rebuild the original ids ``uniq_local[inv]`` so that the combiner sees
    the raw path's sentinel pattern. The combiner never mixes source
    blocks, so running it per round is the same arithmetic on the same
    values (bit-exact)."""
    world, i = self.plan.world_size, self._my_rank()
    wd = wire.plan_wire_dtype(self.plan)
    rounds = []
    for k, blk in enumerate(fz.blocks):
      got = [wire.fused_block_send(c, self.mesh, k, wd) for c in blk]
      axis = 0 if fz.kind == "dedup" else 1
      ret = got[0] if len(got) == 1 else torch.cat(got, dim=axis)
      if fz.kind == "dedup":
        j = (i - k) % world
        sentinel = padded_rows(self.plan, bk.class_key)
        ret = self._dedup_combine(
            bk, expand_unique_rows(ret, dr.inv[j].reshape(-1),
                                   dr.uniq_local[j] != sentinel),
            dr.inv[j], dr.uniq_local[j])
      rounds.append(ret)
    return torch.stack([rounds[(i - j) % world] for j in range(world)])

  def _exchange_dedup(self, bk, z_u: torch.Tensor,
                      dr: DedupRouted) -> torch.Tensor:
    """Deduplicated mp->dp return: ``z_u [world_src, K, w]`` unique rows
    -> ``[world_owner, n_b, B, w]`` combined activations. The exchange
    ships one row per unique id (narrowed to the wire dtype in flight);
    this rank re-expands them through its inverse maps and runs the
    combiner here, differentiably, so the backward sums the occurrences'
    cotangents per unique id (f32) before the reverse exchange. The
    sentinel-padded unique slots gathered zero rows, so the expansion
    reproduces the raw path's rows bit for bit, and the combiner sums the
    same values in the same order."""
    world = self.plan.world_size
    ret = self._wire_exchange_float(z_u)
    inv_flat = dr.inv.reshape(world, -1)
    sentinel = padded_rows(self.plan, bk.class_key)
    expanded = expand_unique_rows(ret, inv_flat, dr.uniq_local != sentinel)
    # [world, m, w]
    return torch.stack([
        self._dedup_combine(bk, expanded[j], dr.inv[j], dr.uniq_local[j])
        for j in range(world)])

  def _dedup_combine(self, bk, rows: torch.Tensor, inv: torch.Tensor,
                     uniq_local: torch.Tensor) -> torch.Tensor:
    """One destination block's expanded rows ``[m, w]`` -> ``[n_b, B,
    w]`` through the shared combiner (:meth:`_combine`). Hotness-1
    buckets pass 2-D ids (only their rank matters there); multi-hot ones
    rebuild the original ids ``uniq_local[inv]``, whose sentinels give the
    mean divisor the raw path's."""
    shape = tuple(inv.shape)  # [n_b, B(, h)]
    rows = rows.reshape(shape + (rows.shape[-1],))
    ids = inv if len(shape) == 2 else uniq_local[inv.long()]
    return self._combine(rows, ids, bk.class_key, bk.rs)

  # ---- reassembly --------------------------------------------------------
  def _hot_sig(self, key, hotness_of) -> tuple:
    cp = self.plan.classes[key]
    return tuple(hotness_of(s.input_id)
                 for slots in cp.slots_per_rank for s in slots)

  def _buckets(self, key, hotness_of) -> List[Bucket]:
    """Cached :func:`class_buckets`."""
    ck = (key, self._hot_sig(key, hotness_of))
    got = self._bucket_cache.get(ck)
    if got is None:
      got = class_buckets(self.plan, key, hotness_of)
      self._bucket_cache[ck] = got
    return got

  def _slot_bucket_map(self, hotness_of) -> Dict[tuple, tuple]:
    """(class_key, rank, slot_idx) -> (bucket key, index within bucket)."""
    ck = tuple((key, self._hot_sig(key, hotness_of))
               for key in self.plan.class_keys)
    got = self._slot_map_cache.get(ck)
    if got is not None:
      return got
    out = {}
    for key in self.plan.class_keys:
      for bucket in self._buckets(key, hotness_of):
        bk = bucket_key(key, bucket.h, bucket.vcap, bucket.rs)
        for rank, idxs in enumerate(bucket.slot_idx_per_rank):
          for pos, slot_idx in enumerate(idxs):
            out[(key, rank, slot_idx)] = (bk, pos)
    self._slot_map_cache[ck] = out
    return out

  def assemble(self, received: Dict[BucketKey, torch.Tensor], hotness_of,
               mean_counts: Optional[Dict[int, torch.Tensor]] = None
               ) -> List[torch.Tensor]:
    """Per-input output reassembly: column-slice concat, row-slice sum
    (with the deferred mean division from ``mean_counts``)."""
    plan = self.plan
    slot_map = self._slot_bucket_map(hotness_of)
    results = []
    for input_id, pieces in enumerate(plan.output_pieces):
      parts = []
      for p in pieces:
        bk, idx = slot_map[(p.class_key, p.rank, p.slot)]
        parts.append(received[bk][p.rank, idx])
      if pieces and pieces[0].row_sliced:
        out = parts[0] if len(parts) == 1 else sum(parts[1:], parts[0])
        combiner = plan.global_configs[
            plan.input_table_map[input_id]].combiner
        h_code = hotness_of(input_id)
        # h_code < 0: a ragged value stream; hotness-1 inputs skip the
        # division (the mean of one element)
        if combiner == "mean" and (h_code > 1 or h_code < 0):
          if mean_counts is None or input_id not in mean_counts:
            raise ValueError(
                "mean combiner on a row-sliced table needs mean_counts "
                "(pass the forward inputs through DistributedLookup."
                "mean_counts)")
          counts = mean_counts[input_id].to(out.dtype)
          out = out / counts.clamp(min=1)[:, None]
        results.append(out)
      else:
        results.append(parts[0] if len(parts) == 1 else
                       torch.cat(parts, dim=-1))
    return results

  def mean_counts(self, inputs: Sequence) -> Dict[int, torch.Tensor]:
    """Per-sample valid-id counts for mean x row-sliced inputs
    (``input_id -> [B]``; empty when no such input exists)."""
    plan = self.plan
    out = {}
    for input_id, pieces in enumerate(plan.output_pieces):
      if not (pieces and pieces[0].row_sliced):
        continue
      if plan.global_configs[plan.input_table_map[input_id]].combiner \
          != "mean":
        continue
      x = _normalize_input(inputs[input_id])
      if isinstance(x, RaggedIds):
        # valid ids of each sample's window of the live stream (the
        # padded path's sum(x >= 0))
        cap = x.values.shape[0]
        live = torch.arange(cap, device=x.values.device) < x.row_splits[-1]
        out[input_id] = _segment_counts(
            live & (x.values >= 0),
            _seg_offsets(x.row_lengths().to(x.values.device), cap))
      else:
        out[input_id] = (x >= 0).sum(dim=1)
    return out

  # ---- OOV observability -------------------------------------------------
  def oov_counts(self, inputs: Sequence) -> Dict[str, torch.Tensor]:
    """Per-class out-of-vocabulary occurrence counts of one batch: ids
    ``>= input_dim`` of the table the input feeds (negative ids are
    padding, not OOV), counted once per class an input's pieces live in;
    a value stream counts its live entries (before ``row_splits[-1]``).
    Class name -> int32 scalar (this rank's batch)."""
    plan = self.plan
    dev = None
    out = {}
    for input_id, pieces in enumerate(plan.output_pieces):
      x = _normalize_input(inputs[input_id])
      vocab = plan.global_configs[plan.input_table_map[input_id]].input_dim
      if isinstance(x, RaggedIds):
        dev = x.values.device
        live = (torch.arange(x.values.shape[0], device=dev)
                < x.row_splits[-1])
        n = (live & (x.values >= vocab)).sum().to(torch.int32)
      else:
        dev = x.device
        n = (x >= vocab).sum().to(torch.int32)
      for ck in sorted({p.class_key for p in pieces}):
        name = class_param_name(*ck)
        out[name] = out[name] + n if name in out else n
    return {class_param_name(*k): out.get(class_param_name(*k),
                                          torch.zeros((), dtype=torch.int32,
                                                      device=dev))
            for k in plan.class_keys}

  def dedup_overflow_counts(self, ids_all) -> Dict[str, torch.Tensor]:
    """Per-class dedup-capacity overflow counts of one routed batch: the
    :class:`DedupRouted` buckets' ``overflow`` (set only under a capped
    ``dedup_capacity``) summed per class, 0 for a class with none. Class
    name -> int32 scalar (this rank's count). A nonzero count means those
    ids gathered, and in training updated, the wrong rows."""
    first = next(iter(ids_all.values()), None)
    if isinstance(first, DedupRouted):
      first = first.inv
    elif isinstance(first, tuple):  # ragged (vals, lens)
      first = first[0]
    dev = first.device if first is not None else None
    out = {class_param_name(*k): torch.zeros((), dtype=torch.int32,
                                             device=dev)
           for k in self.plan.class_keys}
    for bk, ids in ids_all.items():
      if isinstance(ids, DedupRouted) and ids.overflow is not None:
        name = class_param_name(*bk.class_key)
        out[name] = out[name] + ids.overflow
    return out

  # ---- composed forward --------------------------------------------------
  def forward(self, class_params: Dict[str, torch.Tensor],
              inputs: Sequence) -> List[torch.Tensor]:
    """Differentiable lookup on simple-layout params.

    Args:
      class_params: class name -> this rank's ``[rows, width]`` block (at
        world 1 the whole table).
      inputs: per global input, this rank's ``[B]`` or ``[B, H]`` int ids
        (PAD_ID entries ignored) or its :class:`RaggedIds` (the same
        capacity on every rank).

    Returns:
      Per global input its ``[B, table_width]`` activations. Autograd
      carries the loss to every class block as a dense gradient; at
      world > 1 the wire's backward (the reverse exchange) brings each
      rank the cotangents of its own rows, every rank issuing the same
      collectives in the same order."""
    inputs = [_normalize_input(x) for x in inputs]
    hotness_of = lambda i: ragged_hotness(inputs[i])  # noqa: E731
    b = _batch_of(inputs)
    counts = self.mean_counts(inputs)
    ids_all = self.route_ids(inputs, hotness_of)
    z_sparse = {
        bk: self._z_sparse_simple(
            bk.class_key, self._squeeze_local(
                class_params[class_param_name(*bk.class_key)]), ids, bk.rs)
        for bk, ids in ids_all.items()
        if self.plan.classes[bk.class_key].kind == "sparse"}
    return self.finish_forward(z_sparse, class_params, ids_all, b,
                               hotness_of, counts)

  def _find_bucket(self, key, h, vcap, hotness_of) -> Bucket:
    for bucket in self._buckets(key, hotness_of):
      if bucket.h == h and bucket.vcap == vcap:
        return bucket
    raise KeyError((key, h, vcap))

  @staticmethod
  def _squeeze_local(p: torch.Tensor) -> torch.Tensor:
    """Validate a local class-param block (2-D ``[rows, width]``)."""
    if p.dim() != 2:
      raise ValueError(
          f"class param must be 2-D [rows, width] (the local block of a "
          f"[world * rows, width] array), got {tuple(p.shape)}")
    return p

  def finish_forward(self, z_sparse: Dict[BucketKey, torch.Tensor],
                     dense_params: Dict[str, torch.Tensor],
                     ids_all: Dict[BucketKey, torch.Tensor],
                     batch_local: int, hotness_of,
                     mean_counts: Optional[Dict[int, torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """Dense-class lookups + exchange + assembly."""
    z = dict(z_sparse)
    for bk, ids in ids_all.items():
      key = bk.class_key
      if self.plan.classes[key].kind != "dense":
        continue
      table_local = self._squeeze_local(dense_params[class_param_name(*key)])
      bucket = self._find_bucket(key, bk.h, bk.vcap, hotness_of)
      z[bk] = self._z_dense(key, bucket, table_local, ids)
    received = self.exchange(z, batch_local, ids_all)
    return self.assemble(received, hotness_of, mean_counts)


  # ---- fused training path -----------------------------------------------
  def fused_layouts(self, rule: SparseRule,
                    rows_overrides: Optional[Dict[str, int]] = None
                    ) -> Dict[str, PackedLayout]:
    """Per sparse class, its :class:`PackedLayout` under ``rule`` (``n_aux``
    interleaved state slots). ``rows_overrides`` (class name -> logical
    rows) substitutes a tiered class's compact device buffer
    (``tiering.TieringPlan.rows_overrides``). The JAX engine's 2^31-element
    bound is XLA's indexing limit; the port indexes in 64 bits and has
    none."""
    rows_overrides = rows_overrides or {}
    layouts = {}
    for key in self.plan.class_keys:
      cp = self.plan.classes[key]
      if cp.kind != "sparse":
        continue
      name = class_param_name(*key)
      layouts[name] = PackedLayout(
          rows=rows_overrides.get(name, padded_rows(self.plan, key)),
          width=cp.width, n_aux=rule.n_aux)
    return layouts

  # ---- tiered storage: hot/cold routing + staging buffers ----------------
  def translate_tiered_ids(self, ids_all: Dict[BucketKey, torch.Tensor],
                           tier_specs: Dict[str, TierSpec],
                           resident: Dict[str, torch.Tensor],
                           staged_grps: Dict[str, torch.Tensor]):
    """Rewrite routed LOGICAL ids of host-tiered classes to compact
    device-buffer ids (hot-cache slot or staging slot).

    The routing tensors stay in the logical vocabulary, so routing,
    bucketing, sentinel and mean-count semantics are untouched; this pass
    runs after :meth:`route_ids`, before the fused gather. Each valid id's
    physical row goes through this rank's resident map (cold rows: a
    searchsorted over this step's sorted staged row ids) and the id is
    rebuilt at the compact slot with its sub-row index. A deduplicated
    bucket translates its unique blocks only (the inverse maps and local
    unique blocks stay logical, so the mean combiner's sentinel count is
    unchanged), and its counters then count UNIQUE ids per block; a
    ragged bucket translates its value stream.

    Args:
      tier_specs: class name -> :class:`TierSpec`.
      resident: class name -> ``[phys_rows]`` int32, this rank's map
        (cache slot or -1).
      staged_grps: class name -> ``[S]`` int32, this rank's SORTED staged
        physical-row ids padded with ``TIER_PAD_GRP``.

    Returns:
      ``(ids_out, metrics)``: the translated routing dict and, per class
      name, an int32 ``[4]`` tensor ``[hot_hits, staged_hits, missed,
      valid_total]`` of this rank's counts."""
    out: Dict[BucketKey, torch.Tensor] = {}
    metrics: Dict[str, torch.Tensor] = {}
    for bk, ids in ids_all.items():
      name = class_param_name(*bk.class_key)
      spec = tier_specs.get(name)
      if spec is None:
        out[bk] = ids
        continue
      sentinel = padded_rows(self.plan, bk.class_key)
      if isinstance(ids, DedupRouted):
        tv, m = _translate_tier(ids.uniq, spec, sentinel, resident[name],
                                staged_grps[name])
        out[bk] = dataclasses.replace(ids, uniq=tv)
      elif isinstance(ids, tuple):  # ragged value stream (vals, lens)
        vals, lens = ids
        tv, m = _translate_tier(vals, spec, sentinel, resident[name],
                                staged_grps[name])
        out[bk] = (tv, lens)
      else:
        out[bk], m = _translate_tier(ids, spec, sentinel, resident[name],
                                     staged_grps[name])
      metrics[name] = metrics[name] + m if name in metrics else m
    return out, metrics

  def install_staging(self, fused_params: Dict[str, torch.Tensor],
                      tier_specs: Dict[str, TierSpec],
                      staged_rows: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Write this step's staged cold rows into each tiered buffer's
    staging region (physical rows ``[cache_grps, cache_grps + S)``).

    ``S == staging_grps`` (every step but a spill): the rows are copied
    into the persistent buffer in place and the returned dict holds that
    same tensor. A spill step (``S`` larger) applies on an EXTENDED copy
    (``[cache_grps + S, phys_width]``: the cache region copied, then the
    staged rows), which the returned dict holds instead; the persistent
    buffer is left as it was until :meth:`trim_spill` copies the cache
    region back. The effective :class:`PackedLayout` of the step must be
    built from the same ``S``."""
    out = dict(fused_params)
    for name, spec in tier_specs.items():
      rows = staged_rows[name]
      buf = self._squeeze_local(fused_params[name])
      keep = spec.cache_grps + spec.staging_grps
      if buf.shape[0] != keep:
        raise ValueError(
            f"class {name}: the persistent buffer has {buf.shape[0]} "
            f"physical rows, its tier geometry {keep}")
      need = spec.cache_grps + rows.shape[0]
      if need > keep:
        ext = torch.empty((need, buf.shape[1]), dtype=buf.dtype,
                          device=buf.device)
        ext[:spec.cache_grps].copy_(buf[:spec.cache_grps])
        buf = ext
      buf[spec.cache_grps:need].copy_(rows)
      out[name] = buf
    return out

  def staged_regions(self, fused_in: Dict[str, torch.Tensor],
                     tier_specs: Dict[str, TierSpec],
                     staged_grps: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The (post-scatter) staging regions of :meth:`install_staging`'s
    buffers, sized to this step's staged row count: the rows the host
    writes back to the cold store. Copies, so the next step's staging
    never overwrites them."""
    out = {}
    for name, spec in tier_specs.items():
      s = staged_grps[name].shape[0]
      buf = self._squeeze_local(fused_in[name])
      out[name] = buf[spec.cache_grps:spec.cache_grps + s].clone()
    return out

  def trim_spill(self, fused_params: Dict[str, torch.Tensor],
                 fused_in: Dict[str, torch.Tensor],
                 tier_specs: Dict[str, TierSpec]
                 ) -> Dict[str, torch.Tensor]:
    """After a spill step: copy each extended buffer's (updated) cache
    region back into the persistent compact buffer of ``fused_params``,
    which keeps its tensor and its shape; a no-op for a buffer the step
    updated in place. Returns ``fused_params``."""
    for name, spec in tier_specs.items():
      buf = fused_in[name]
      if buf is not fused_params[name]:
        fused_params[name][:spec.cache_grps].copy_(buf[:spec.cache_grps])
    return fused_params

  def lookup_sparse_fused(self, fused_params: Dict[str, torch.Tensor],
                          layouts: Dict[str, PackedLayout],
                          ids_all: Dict[BucketKey, torch.Tensor],
                          keep_rows: bool = False, keep_aux: bool = True):
    """Fused lookup of every sparse class, outside autograd: returns
    ``(z_sparse, residuals)``. The caller makes ``z_sparse`` leaves of the
    differentiable tail (:meth:`finish_forward`) and feeds their
    cotangents to :meth:`apply_sparse`. ``keep_rows`` saves the
    forward-time rows even for aux-free rules (``rule.weight_decay``
    needs them); ``keep_aux=False`` saves nothing (the eval step).

    Under ``overlap='fused'`` (world > 1) each bucket's ``z`` is a
    :class:`FusedChunks` of per-round gathers (:meth:`_z_sparse_fused_jit`);
    the residuals keep their dest-major layouts either way."""
    gather = (self._z_sparse_fused_jit if self._fused_wire()
              else self._z_sparse_fused)
    z: Dict[BucketKey, torch.Tensor] = {}
    aux: Dict[BucketKey, Optional[torch.Tensor]] = {}
    for bk, ids in ids_all.items():
      key = bk.class_key
      if self.plan.classes[key].kind != "sparse":
        continue
      name = class_param_name(*key)
      buf_local = self._squeeze_local(fused_params[name])
      z[bk], auxb = gather(key, layouts[name], buf_local, ids, bk.rs,
                           keep_rows=keep_rows)
      aux[bk] = auxb if keep_aux else None
    return z, SparseResiduals(ids_all=dict(ids_all), aux_rows=aux)

  def _z_sparse_fused(self, key, layout: PackedLayout,
                      buf_local: torch.Tensor, ids_all: torch.Tensor,
                      rs: bool = False, keep_rows: bool = False):
    """Fused gather: ``(z, fused_rows)``, the optimizer state riding along.

    The combine sums the full fused stride (table + aux lanes) and slices
    the table lanes at bag granularity, as the JAX engine does; the
    residual is the gathered fused rows (None when nothing reads them).
    Multi-hot buckets of narrow classes with optimizer state gather
    window-masked physical rows instead (:meth:`_combine_fused`).

    A :class:`DedupRouted` bucket gathers each unique id's fused row once,
    ``[world_src, K, stride]``, and combines nothing here: the source rank
    expands and combines (:meth:`_exchange_dedup`), so the cotangent of
    the backward arrives per unique id."""
    if isinstance(ids_all, DedupRouted):
      fused = gather_fused_chunked(layout, buf_local, ids_all.uniq)
      return (fused[..., :layout.width],
              fused if (layout.n_aux or keep_rows) else None)
    if isinstance(ids_all, tuple):  # ragged value stream
      vals, lens = ids_all
      fused = gather_fused_chunked(layout, buf_local, vals)
      return (self._combine_ragged(fused[..., :layout.width], vals, lens,
                                   key, rs),
              fused if (layout.n_aux or keep_rows) else None)
    return self._combine_fused(
        key, layout,
        gather_fused_chunked(layout, buf_local, ids_all,
                             masked_phys=_masked_multi_hot(layout, ids_all)),
        ids_all, rs, keep_rows)

  def _combine_fused(self, key, layout: PackedLayout, fused: torch.Tensor,
                     ids: torch.Tensor, rs: bool, keep_rows: bool):
    """Gathered fused rows -> ``(z, residual rows or None)``.

    For window-masked physical rows (:func:`_masked_multi_hot`) the bag
    sums at physical width and the ``rpp`` windows' table lanes fold once
    per bag, in window order (the JAX engine's order of additions); the
    residual is the masked rows, whose state lanes the apply folds per
    occurrence (``residual_lanes``)."""
    w = layout.width
    if _masked_multi_hot(layout, ids):
      cp = self.plan.classes[key]
      if cp.combiner is None:
        raise ValueError("combiner=None requires hotness-1 inputs in the "
                         "distributed path (2-D model-parallel outputs)")
      bag = _sum_axis2(fused)  # [n_b, G, rpp * stride]
      z = residual_lanes(layout, bag, 0, w).reshape(bag.shape[:-1] + (w,))
      if cp.combiner == "mean" and not rs:
        sentinel = padded_rows(self.plan, key)
        counts = (ids < sentinel).sum(dim=2).to(z.dtype)
        z = z / counts.clamp(min=1)[..., None]
      return z, fused
    if layout.n_aux == 0:
      return (self._combine(fused, ids, key, rs),
              fused if keep_rows else None)
    if ids.dim() == 2 or ids.shape[-1] == 1:
      return self._combine(fused[..., :w], ids, key, rs), fused
    return self._combine(fused, ids, key, rs)[..., :w], fused

  @staticmethod
  def _aux_occ(aux, layout: PackedLayout, rule: SparseRule):
    """Residual rows (stride-wide or window-masked physical rows) ->
    per-occurrence aux rows ``[-1, n_aux, w]``."""
    if aux is None or not rule.n_aux:
      return None
    w = layout.width
    return residual_lanes(layout, aux, w, layout.stride).reshape(
        -1, rule.n_aux, w)

  @staticmethod
  def _decayed(g, res, layout: PackedLayout, rule: SparseRule):
    """Touched-rows l2: add ``2λ * row`` (the forward-time row from the
    residuals, in either layout) to the occurrence cotangent."""
    if not rule.weight_decay or res is None:
      return g
    row = residual_lanes(layout, res, 0, layout.width)
    return g + (2.0 * rule.weight_decay) * row.reshape(g.shape)

  def _sparse_parts_by_class(self, d_z, residuals: SparseResiduals,
                             rule: SparseRule) -> Dict[str, list]:
    """Group per-bucket cotangents into per-class ``(ids, dz, aux, h)``
    parts; mean combiners divide by the forward's valid counts. A
    :class:`FusedChunks` cotangent (the fused schedule's per-round form)
    is reassembled to the dest-major layout first. A
    :class:`DedupRouted` bucket's cotangent arrives per unique id (the
    expansion's backward summed its occurrences, and the mean division
    ran on the source rank), so its part is ``(uniq, dz, aux, 0)``: one
    row per unique id and source block, no hotness broadcast, no
    divisor (the ``exact=True`` semantics within one exchange block). Under
    ``DE_TORCH_COTANGENT_PIN=1`` each sparse bucket's cotangent is copied
    to a fresh contiguous tensor by kernel K7 (the values are unchanged)."""
    plan = self.plan
    by_class: Dict[str, list] = {}
    pin = _cotangent_pin()
    for bk, dzb in d_z.items():
      key, h = bk.class_key, bk.h
      if plan.classes[key].kind != "sparse":
        continue
      if isinstance(dzb, FusedChunks):
        dzb = self._fused_reassemble(dzb.rounds(), dzb.kind)
      if pin:
        dzb = row_major(dzb)
      cp = plan.classes[key]
      ids = residuals.ids_all[bk]
      aux = (residuals.aux_rows[bk]
             if (rule.n_aux or rule.weight_decay) else None)
      if isinstance(ids, DedupRouted):
        by_class.setdefault(class_param_name(*key), []).append(
            (ids.uniq.reshape(-1), dzb.reshape(-1, cp.width), aux, 0))
        continue
      if isinstance(ids, tuple):
        # ragged: each sample's cotangent expanded to its occurrences
        # (the tail takes the last sample's, as in the JAX engine; its
        # sentinel ids apply nothing), pre-expanded parts marked h=0
        vals, lens = ids
        n_b, world, cap = vals.shape
        b, w = lens.shape[2], cp.width
        seg = _seg_ids(lens.reshape(n_b * world, b), cap)
        dz_blocks = dzb.reshape(n_b * world, b, w)
        g_occ = dz_blocks[torch.arange(n_b * world, device=seg.device)[:, None],
                          seg]  # [n_b * world, V, w]
        if cp.combiner == "mean" and not bk.rs:
          # the forward's valid-count divisor (row-sliced buckets divide
          # in the differentiable assemble, so d_z arrives pre-divided)
          counts = self._ragged_valid_counts(
              vals.reshape(n_b * world, cap), lens.reshape(n_b * world, b),
              key)
          cnt = counts.gather(1, seg).to(g_occ.dtype)
          g_occ = g_occ / cnt.clamp(min=1)[..., None]
        by_class.setdefault(class_param_name(*key), []).append(
            (vals.reshape(-1), g_occ.reshape(-1, w), aux, 0))
        continue
      if cp.combiner == "mean" and h > 1 and not bk.rs:
        # row-sliced buckets skip this: their mean division lives in the
        # differentiable assemble, so d_z arrives pre-divided
        sentinel = padded_rows(plan, key)
        counts = (ids < sentinel).sum(dim=2).to(dzb.dtype)
        dzb = dzb / counts.clamp(min=1)[..., None]
      by_class.setdefault(class_param_name(*key), []).append(
          (ids, dzb, aux, h))
    return by_class

  @staticmethod
  def _delta_rows_serve(layout: PackedLayout, part, rule: SparseRule) -> bool:
    """Whether kernel K6 (``ops/cuda_delta.py``) builds this part's update
    rows: the rule has a lane form, the class has 128-lane physical rows,
    the cotangent and state are f32 and the residual rows are stride-wide
    or window-masked physical rows. Decided from the plan, the rule and
    the tensors' layouts alone. (The TPU kernel's VMEM blocking limits are
    not conditions here.)"""
    _, dzb, aux, _ = part
    if rule.delta_lanes is None or rule.lane_scalars is None:
      return False
    if layout.phys_width != 128 or dzb.dtype != torch.float32:
      return False
    if rule.n_aux:
      if aux is None or aux.dtype != torch.float32:
        return False
      if aux.shape[-1] not in (layout.stride, layout.phys_width):
        return False
    return True

  @staticmethod
  def _delta_rows(layout: PackedLayout, part, rule: SparseRule, step,
                  kernel: bool) -> torch.Tensor:
    """One part's ``[n, phys_width]`` physical-row updates: from kernel K6
    when ``kernel`` (its plain version for CPU tensors), else from the
    same chain in PyTorch ops (``build_delta_rows_plain``)."""
    ids, dzb, aux, h = part
    hh = max(1, h)
    n = ids.numel()
    _, sub, _ = _grp_sub(layout, ids.reshape(-1))
    aux_flat = aux.reshape(n, aux.shape[-1]) if rule.n_aux else None
    build = build_delta_rows if kernel else build_delta_rows_plain
    return build(layout, rule, dzb.reshape(n // hh, layout.width), sub,
                 aux_flat, hh, step)

  def _stream_of_parts(self, layout: PackedLayout, parts, rule: SparseRule,
                       step):
    """A class's parts -> one occurrence stream ``(ids [n], rows [n, k])``:
    the physical-row updates of :meth:`_delta_rows`, from kernel K6 where
    it serves every part of the class (all or nothing, as the JAX engine
    decides it), except for scale-only rules, whose raw cotangent rows the
    apply scales, and rules with a decay, whose cotangent takes the decay
    term before ``rule.delta``."""
    w = layout.width
    all_ids = [ids.reshape(-1) for ids, _, _, _ in parts]
    if rule.linear_scale is None and not rule.weight_decay:
      kernel = all(self._delta_rows_serve(layout, p, rule) for p in parts)
      all_rows = [self._delta_rows(layout, p, rule, step, kernel)
                  for p in parts]
    else:
      all_rows = []
      for ids, dzb, aux, h in parts:
        n = ids.numel()
        g = dzb.reshape(-1, w)
        if h > 1:
          g = g[:, None, :].expand(n // h, h, w).reshape(n, w)
        g = self._decayed(g, aux, layout, rule)
        all_rows.append(g if rule.linear_scale is not None else
                        rule.delta(g, self._aux_occ(aux, layout, rule), step))
    if len(all_ids) == 1:
      return all_ids[0], all_rows[0]
    return torch.cat(all_ids), torch.cat(all_rows)

  def sparse_delta_streams(self, layouts: Dict[str, PackedLayout], d_z,
                           residuals: SparseResiduals, rule: SparseRule,
                           step):
    """Per-class update streams ``name -> (ids, rows)``."""
    by_class = self._sparse_parts_by_class(d_z, residuals, rule)
    return {name: self._stream_of_parts(layouts[name], parts, rule, step)
            for name, parts in by_class.items()}

  def apply_sparse_streams(self, fused_params: Dict[str, torch.Tensor],
                           layouts: Dict[str, PackedLayout], streams,
                           rule: SparseRule, step) -> Dict[str, torch.Tensor]:
    """One fused scatter-add per class over prebuilt streams, in place
    (K1 on the card); returns ``fused_params``."""
    scale_only = rule.linear_scale is not None
    for name, (ids_cat, rows_cat) in streams.items():
      buf = self._squeeze_local(fused_params[name])
      scatter_add_fused(
          layouts[name], buf, ids_cat, rows_cat,
          delta_scale=rule.linear_scale(step) if scale_only else None)
    return fused_params

  def apply_sparse(self, fused_params: Dict[str, torch.Tensor],
                   layouts: Dict[str, PackedLayout], d_z,
                   residuals: SparseResiduals, rule: SparseRule, step,
                   exact: bool = False) -> Dict[str, torch.Tensor]:
    """Apply the sparse update in place: one fused scatter-add per sparse
    class (kernel K1 on the card); returns ``fused_params``.

    Per-occurrence cotangent rows are combined with the forward-saved
    optimizer-state rows by ``rule.delta`` and scatter-added (table delta
    | state delta) into the packed buffer. ``exact=True`` deduplicates
    first (sort + segment-sum, :func:`~..ops.sparse_grad.dedup_rows`) and
    re-gathers the unique rows' state, the reference's deduplicated
    semantics. Streams longer than ``apply_chunk`` occurrences apply
    chunk by chunk, never holding the whole per-occurrence delta."""
    by_class = self._sparse_parts_by_class(d_z, residuals, rule)
    for name, parts in by_class.items():
      layout = layouts[name]
      w = layout.width
      buf = self._squeeze_local(fused_params[name])
      if exact:
        # class-level dedup: cross-bucket duplicates of one table merge
        ids = torch.cat([p[0].reshape(-1) for p in parts])
        g = torch.cat([
            dzb[:, :, None, :].expand(idb.shape + (w,)).reshape(-1, w)
            if idb.dim() == 3 else dzb.reshape(-1, w)
            for idb, dzb, _, _ in parts])
        ids, g = dedup_rows(ids, g, layout.rows)
        fused_rows = gather_fused(layout, buf, ids)
        aux = (fused_rows[..., w:].reshape(ids.shape + (rule.n_aux, w))
               if rule.n_aux else None)
        if rule.weight_decay:
          # once per unique touched row
          g = g + (2.0 * rule.weight_decay) * fused_rows[..., :w]
        scatter_add_fused(layout, buf, ids, rule.delta(g, aux, step))
        continue
      n_total = sum(ids.numel() for ids, _, _, _ in parts)
      if n_total <= self.apply_chunk:
        self.apply_sparse_streams(
            {name: buf}, layouts,
            {name: self._stream_of_parts(layout, parts, rule, step)}, rule,
            step)
        continue
      # memory escape hatch for very long streams: delta and apply per
      # chunk of occurrences (the deltas read forward-time state, so the
      # chunks' order does not matter)
      for ids, dzb, aux, h in parts:
        n = ids.numel()
        hh = max(1, h)
        ids_f = ids.reshape(-1)
        dz_f = dzb.reshape(-1, w)
        aux_f = None if aux is None else aux.reshape(n, aux.shape[-1])
        chunk = max(hh, (self.apply_chunk // hh) * hh)
        for c0 in range(0, n, chunk):
          cn = min(chunk, n - c0)
          part = (ids_f[c0:c0 + cn], dz_f[c0 // hh:(c0 + cn) // hh],
                  None if aux_f is None else aux_f[c0:c0 + cn], h)
          self.apply_sparse_streams(
              {name: buf}, layouts,
              {name: self._stream_of_parts(layout, [part], rule, step)},
              rule, step)
    return fused_params

  # ---- model-parallel input mode -----------------------------------------
  def forward_mp(self, class_params: Dict[str, torch.Tensor],
                 packed_inputs: Dict[str, torch.Tensor],
                 hotness: Optional[Sequence[int]] = None
                 ) -> List[torch.Tensor]:
    """Differentiable lookup of model-parallel inputs (``dp_input=False``).

    ``packed_inputs`` is this rank's block of :func:`pack_mp_inputs`' dict:
    per bucket ``[1, n_b, G, h]`` pre-offset ids of this rank's tables
    over the GLOBAL batch (``{k: v[rank:rank + 1]}``, or
    ``training.shard_batch(packed, mesh)``). The id exchange is skipped;
    the activation exchange still runs (the reference's semantics), so
    each rank gets its ``G / world`` samples' activations."""
    plan = self.plan
    world = plan.world_size
    if any(sh.row_sliced for shards in plan.rank_shards for sh in shards):
      raise NotImplementedError(
          "row-sliced tables are not supported with model-parallel inputs "
          "(dp_input=False): every rank holding a row slice needs the full "
          "id stream, which contradicts the mp-input contract")
    if hotness is not None and any(h < 0 for h in hotness):
      raise ValueError(
          "negative hotness entries (the planner's ragged-input hint) are "
          "not valid in model-parallel input mode: ragged value streams "
          "only exist for the dp-input exchange. Convert the input with "
          "ragged_to_padded and pass its static max hotness instead.")
    self._my_rank()  # a world > 1 plan needs the mesh
    hotness_of = (lambda i: 1) if hotness is None else \
        (lambda i: hotness[i])  # noqa: E731
    z = {}
    g = None
    for key in plan.class_keys:
      table_local = self._squeeze_local(class_params[class_param_name(*key)])
      for bucket in self._buckets(key, hotness_of):
        name = _packed_input_name(key, bucket)
        if name not in packed_inputs:
          raise ValueError(
              f"packed input {name!r} missing; pass the same `hotness` to "
              "pack_mp_inputs and forward_mp")
        ids_all = torch.as_tensor(packed_inputs[name])
        if (ids_all.dim() != 4 or ids_all.shape[0] != 1
            or ids_all.shape[1] != bucket.n_b
            or ids_all.shape[3] != bucket.h):
          raise ValueError(
              f"packed input {name!r} has shape {tuple(ids_all.shape)}, "
              f"expected [1, {bucket.n_b}, G, {bucket.h}] — was it packed "
              "with a different plan or hotness?")
        ids_all = ids_all[0]
        g = ids_all.shape[1]
        if g % world:
          raise ValueError(f"Global batch {g} not divisible by world {world}")
        bk = bucket_key(key, bucket.h, bucket.vcap, bucket.rs)
        if plan.classes[key].kind == "dense":
          z[bk] = self._z_dense(key, bucket, table_local, ids_all)
        else:
          z[bk] = self._z_sparse_simple(key, table_local, ids_all)
    received = self.exchange(z, g // world)
    return self.assemble(received, hotness_of)


def _packed_input_name(key, bucket: Bucket) -> str:
  name = f"{class_param_name(*key)}_h{bucket.h}"
  if bucket.vcap:
    name += f"_v{bucket.vcap}"
  return name


def pack_mp_inputs(plan: "DistEmbeddingStrategy",
                   per_rank_inputs: Sequence[Sequence],
                   hotness: Optional[Sequence[int]] = None
                   ) -> Dict[str, torch.Tensor]:
  """Global packed arrays for model-parallel input mode
  (``dp_input=False``).

  Args:
    plan: the strategy.
    per_rank_inputs: ``per_rank_inputs[r]`` lists rank r's inputs in
      ``plan.input_ids_list[r]`` order, each ``[G]`` or ``[G, H]`` over the
      GLOBAL batch (the reference's mp-input contract).
    hotness: per global input id, its static hotness; pass the same to
      :meth:`DistributedLookup.forward_mp`. Default all-1.

  Returns:
    packed-input name -> ``[world, n_b, G, h]`` int32 tensors; rank r
    passes its block ``[r:r + 1]`` to ``forward_mp``."""
  world = plan.world_size
  if any(sh.row_sliced for shards in plan.rank_shards for sh in shards):
    raise NotImplementedError(
        "row-sliced tables are not supported with model-parallel inputs: "
        "per-rank id streams cannot cover a table split across ranks")
  if hotness is not None and any(h < 0 for h in hotness):
    raise ValueError(
        "negative hotness entries (the planner's ragged-input hint) are "
        "not valid for pack_mp_inputs: ragged value streams only exist "
        "for the dp-input exchange. Convert the input with "
        "ragged_to_padded and pass its static max hotness instead.")
  hotness_of = (lambda i: 1) if hotness is None else \
      (lambda i: hotness[i])  # noqa: E731
  # resolve each (rank, class, slot) to its normalized input once
  slot_inputs = {}  # (key, rank, slot_idx) -> [G, H]
  for rank in range(world):
    for pos, input_id in enumerate(plan.input_ids_list[rank]):
      piece = next(p for p in plan.output_pieces[input_id] if p.rank == rank)
      x = _normalize_input(per_rank_inputs[rank][pos])
      if isinstance(x, RaggedIds):
        raise TypeError(
            "model-parallel inputs (dp_input=False) do not support "
            "RaggedIds; convert with ragged_to_padded(ids, max_hot) — "
            "value-stream routing only exists for the dp-input exchange")
      if x.shape[1] != hotness_of(input_id):
        raise ValueError(
            f"input {input_id} has hotness {x.shape[1]}, `hotness` says "
            f"{hotness_of(input_id)}")
      slot_inputs[(piece.class_key, rank, piece.slot)] = x

  dev = next((x.device for x in slot_inputs.values()), None)
  g = next((x.shape[0] for x in slot_inputs.values()), 0)
  packed = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    sentinel = padded_rows(plan, key)
    for bucket in class_buckets(plan, key, hotness_of):
      per_rank = []
      for rank in range(world):
        idxs = bucket.slot_idx_per_rank[rank]
        entries = []
        for k in range(bucket.n_b):
          if k < len(idxs):
            slot = cp.slots_per_rank[rank][idxs[k]]
            x = slot_inputs[(key, rank, idxs[k])]
            rows = slot.shard.input_dim
            routed = torch.where(x < 0, sentinel,
                                 x.clamp(0, rows - 1) + slot.row_offset)
            entries.append(routed.to(torch.int32))
          else:
            entries.append(torch.full((g, bucket.h), sentinel,
                                      dtype=torch.int32, device=dev))
        per_rank.append(torch.stack(entries))
      packed[_packed_input_name(key, bucket)] = torch.stack(per_rank)
  return packed


def _segment_sum_in_order(rows: torch.Tensor, lens: torch.Tensor
                          ) -> torch.Tensor:
  """Per-occurrence rows ``[..., V, w]`` summed over the segments of
  ``lens [..., B]`` into ``[..., B, w]`` as XLA's scatter sums a bf16
  ``segment_sum``: each segment's rows added in stream order from +0.0,
  every add rounded to the rows' dtype (``torch.segment_reduce`` sums a
  bf16 segment in f32 on the card and rounds once;
  ``sparse_grad.add_rows_in_order``). The tail past the live stream adds
  nothing (its rows are zeros). Differentiable."""
  lead, (cap, w) = tuple(rows.shape[:-2]), tuple(rows.shape[-2:])
  b = lens.shape[-1]
  nblk = int(np.prod(lead)) if lead else 1
  dev = rows.device
  lens = lens.reshape(nblk, b)
  offs = _seg_offsets(lens, cap)
  at = torch.arange(cap, device=dev).expand(nblk, cap)
  live = at < offs[:, -1:]
  dest = (torch.arange(nblk, device=dev)[:, None] * b
          + _seg_ids(lens, cap))[live]
  src = rows.reshape(nblk, cap, w)[live]
  return add_rows_in_order(nblk * b, dest, src).reshape(lead + (b, w))


def _sum_axis2(rows: torch.Tensor) -> torch.Tensor:
  """``rows.sum(dim=2)`` as a left-to-right chain of f32 adds, so the
  order of the additions is fixed on every device. bf16 rows (narrow
  storage) are summed in f32 and rounded once, as XLA reduces bf16."""
  out = rows[:, :, 0].to(torch.float32)
  for j in range(1, rows.shape[2]):
    out = out + rows[:, :, j]
  return out.to(rows.dtype)
