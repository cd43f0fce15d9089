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

Not ported yet: deduplicated routing (``dedup_exchange``), ragged value
streams and tiering.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

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
from ..ops.sparse_grad import dedup_rows
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


def ragged_hotness(x) -> int:
  """Hotness code of one input: 1 for ``[B]``, ``H`` for ``[B, H]``.
  (Ragged value streams, whose codes are negative in the JAX engine,
  are not ported yet.)"""
  if not hasattr(x, "ndim"):
    raise NotImplementedError(
        f"input of type {type(x).__name__}: ragged value streams are not "
        "ported yet; pass dense [B] or [B, H] ids (PAD_ID padding)")
  return 1 if x.ndim == 1 else int(x.shape[1])


def _normalize_input(x) -> torch.Tensor:
  """-> ``[B, H]`` int64 tensor, PAD_ID marking invalid entries."""
  ragged_hotness(x)
  x = torch.as_tensor(x)
  if x.dim() == 1:
    x = x[:, None]
  if x.dim() != 2:
    raise ValueError(f"Distributed inputs must be 1-D or 2-D, got {x.dim()}-D")
  if x.dtype.is_floating_point or x.dtype == torch.bool:
    raise TypeError(f"ids must be integers, got {x.dtype}")
  return x.long()


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

  ``blocks[k][c]`` is chunk ``c`` of the combined activations this rank
  gathered for round ``k``'s destination, rank ``(i + k) % world``:
  ``[n_b, rows_c, w]``. Each chunk feeds exactly one
  :func:`wire.fused_block_send`, and its cotangent comes back in the same
  per-round form; :meth:`DistributedLookup._sparse_parts_by_class`
  reassembles it to the dest-major layout (pure data movement, so f32
  stays bit-exact against the monolithic and pipelined schedules)."""

  blocks: tuple  # blocks[k][c]: round k's c-th row chunk

  def map(self, fn) -> "FusedChunks":
    """The same structure with ``fn`` applied to every chunk."""
    return FusedChunks(tuple(tuple(fn(c) for c in blk)
                             for blk in self.blocks))


class _DenseWindowRows(torch.autograd.Function):
  """Dense-class lookup with the JAX engine's backward precision.

  Forward: the table rows at ``idx`` (zero where ``valid`` is false),
  summed over the hotness axis for multi-hot buckets (the JAX one-hot
  contraction at HIGHEST precision returns the rows exactly). Backward:
  ``d_z`` rounded to ``mxu_operand_dtype(f32, device)`` (bf16 on the
  card, as on the TPU; f32 on the CPU) and accumulated in f32 into the
  table rows with ``index_add_`` — the JAX ``_onehot_window_matmul_bwd``
  in row form."""

  @staticmethod
  def forward(ctx, table, idx, valid, two_d):
    rows = table[idx]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    ctx.save_for_backward(idx, valid)
    ctx.two_d = two_d
    ctx.table_shape = table.shape
    return rows if two_d else _sum_axis2(rows)

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
    return d_table, None, None, None


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
    cp = self.plan.classes[key]
    world = self.plan.world_size
    sentinel = padded_rows(self.plan, key)
    b = inputs[0].shape[0]
    dev = inputs[0].device
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

  def route_ids(self, inputs: Sequence, hotness_of=None
                ) -> Dict[BucketKey, torch.Tensor]:
    """dp->mp id exchange: per bucket, the global batch's ids that this
    rank's tables serve, ``bk -> [n_b, G]`` (hotness 1) or ``[n_b, G,
    h]`` with ``G = world * B`` source-rank-major. At world > 1 the ids
    travel the wire as int32, as in the JAX package, and stay int32."""
    plan = self.plan
    world = plan.world_size
    self._my_rank()  # a world > 1 plan needs the mesh
    if world > 1 and getattr(plan, "dedup_exchange", False):
      raise NotImplementedError(
          "dedup_exchange=True: the deduplicated exchange (DedupRouted) "
          "is not ported yet")
    inputs = [_normalize_input(x) for x in inputs]
    if len(inputs) != plan.num_inputs:
      raise ValueError(f"Expected {plan.num_inputs} inputs, got {len(inputs)}")
    b = inputs[0].shape[0]
    for x in inputs:
      if x.shape[0] != b:
        raise ValueError("All inputs need the same batch size "
                         f"(got {x.shape[0]} vs {b}).")
    if plan.oov == "error":
      self._oov_error_eager(inputs)
    if hotness_of is None:
      hotness_of = lambda i: ragged_hotness(inputs[i])  # noqa: E731
    ids_all = {}
    for key in plan.class_keys:
      for bucket in self._buckets(key, hotness_of):
        x = self._build_routing(key, bucket, inputs)  # [world, n_b, B(, h)]
        if world > 1:
          x = self._wire_exchange_ids(x.to(torch.int32))
        ids_all[bucket_key(key, bucket.h, bucket.vcap, bucket.rs)] = \
            self._reshape_routed(x, bucket, world, b)
    return ids_all

  @staticmethod
  def _reshape_routed(y, bucket, world, b):
    if bucket.h == 1:  # [world, n_b, B] -> [n_b, G]
      return y.transpose(0, 1).reshape(bucket.n_b, world * b)
    return y.transpose(0, 1).reshape(bucket.n_b, world * b, bucket.h)

  def _oov_error_eager(self, inputs: Sequence[torch.Tensor]) -> None:
    """``oov='error'``: raise naming the first out-of-vocabulary id."""
    for input_id, x in enumerate(inputs):
      vocab = self.plan.global_configs[
          self.plan.input_table_map[input_id]].input_dim
      bad = x[x >= vocab]
      if bad.numel():
        raise ValueError(
            f"OOV policy 'error': input {input_id} carries {bad.numel()} "
            f"id(s) outside table {self.plan.input_table_map[input_id]}'s "
            f"vocabulary [0, {vocab}) — first offender {int(bad[0])}.")

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
    precision). Ids outside the window (the sentinel) read zeros."""
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
    z = _DenseWindowRows.apply(table_local, idx, valid, two_d)
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
    brings each rank the cotangents of the rows it owns."""
    del ids_all
    world = self.plan.world_size
    self._my_rank()  # a world > 1 plan needs the mesh
    received = {}
    for bk, zb in z.items():
      if isinstance(zb, FusedChunks):
        received[bk] = self._exchange_fused(zb)
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
    plain-row f32 layouts (one fused row per physical row, at any stride),
    ``gather_fused_chunked`` (the monolithic schedule's gather) for every
    other layout and for window-masked physical rows. On the CPU K4's
    wrapper runs its plain version."""
    if (not masked_phys and layout.rows_per_phys == 1
        and buf_local.dtype == torch.float32):
      return gather_rows(layout, buf_local, ids.to(torch.int32))
    return gather_fused_chunked(layout, buf_local, ids,
                                masked_phys=masked_phys)

  def _fused_reassemble(self, per_round) -> torch.Tensor:
    """Round-major blocks -> the dest-major layout: ``per_round[k]``
    (``[n_b, rows, ...]``, the payload for rank ``(i + k) % world``) ->
    ``[n_b, world * rows, ...]``. Pure data movement."""
    world, i = self.plan.world_size, self._my_rank()
    out = torch.stack([per_round[(d - i) % world] for d in range(world)],
                      dim=1)  # [n_b, world, rows, ...]
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
    reassembled to their dest-major layouts here."""
    self._check_routed(ids_all)
    world, i = self.plan.world_size, self._my_rank()
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

  def _exchange_fused(self, fz: FusedChunks) -> torch.Tensor:
    """mp->dp return of a :class:`FusedChunks` payload, one send per
    just-gathered chunk; received round ``k`` came from rank ``(i - k) %
    world``, so the rounds are placed source-major:
    ``[world, n_b, B, w]``."""
    world, i = self.plan.world_size, self._my_rank()
    wd = wire.plan_wire_dtype(self.plan)
    rounds = []
    for k, blk in enumerate(fz.blocks):
      got = [wire.fused_block_send(c, self.mesh, k, wd) for c in blk]
      rounds.append(got[0] if len(got) == 1 else torch.cat(got, dim=1))
    return torch.stack([rounds[(i - j) % world] for j in range(world)])

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
        if combiner == "mean" and hotness_of(input_id) > 1:
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
      out[input_id] = (x >= 0).sum(dim=1)
    return out

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
  def fused_layouts(self, rule: SparseRule) -> Dict[str, PackedLayout]:
    """Per sparse class, its :class:`PackedLayout` under ``rule`` (``n_aux``
    interleaved state slots). The JAX engine's 2^31-element bound is
    XLA's indexing limit; the port indexes in 64 bits and has none."""
    layouts = {}
    for key in self.plan.class_keys:
      cp = self.plan.classes[key]
      if cp.kind != "sparse":
        continue
      layouts[class_param_name(*key)] = PackedLayout(
          rows=padded_rows(self.plan, key), width=cp.width, n_aux=rule.n_aux)
    return layouts

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
    window-masked physical rows instead (:meth:`_combine_fused`)."""
    self._check_routed(ids_all)
    return self._combine_fused(
        key, layout,
        gather_fused_chunked(layout, buf_local, ids_all,
                             masked_phys=_masked_multi_hot(layout, ids_all)),
        ids_all, rs, keep_rows)

  @staticmethod
  def _check_routed(ids_all) -> None:
    """Refuse the routings the fused gather does not serve yet."""
    if not isinstance(ids_all, torch.Tensor):
      raise NotImplementedError(
          f"routed ids of type {type(ids_all).__name__}: deduplicated and "
          "ragged routing are not ported yet (ROADMAP.md open items, "
          "queue B, item 7)")

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
    is reassembled to the dest-major layout first. Under
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
        dzb = self._fused_reassemble(
            [blk[0] if len(blk) == 1 else torch.cat(blk, dim=1)
             for blk in dzb.blocks])
      if pin:
        dzb = row_major(dzb)
      cp = plan.classes[key]
      ids = residuals.ids_all[bk]
      aux = (residuals.aux_rows[bk]
             if (rule.n_aux or rule.weight_decay) else None)
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


def _sum_axis2(rows: torch.Tensor) -> torch.Tensor:
  """``rows.sum(dim=2)`` as a left-to-right chain of adds, so the order of
  the f32 additions is fixed on every device."""
  out = rows[:, :, 0]
  for j in range(1, rows.shape[2]):
    out = out + rows[:, :, j]
  return out
