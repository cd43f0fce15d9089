"""Distributed lookup engine, world-1 subset (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/parallel/lookup_engine.py``
for the serving path at world 1: route the request's ids into per-bucket
routing tensors (sentinel-padded), look up the small-vocab dense classes,
run the (trivial, world-1) mp->dp exchange and reassemble one activation
per input. The sparse-class gathers run in ``serving/engine.py`` over the
frozen images. Names, bucket keys and tensor shapes follow the JAX engine
so the two can be compared piece by piece.

Not ported yet: world > 1 (the wire exchanges), deduplicated routing,
ragged value streams, tiering and the sparse apply.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
  from ..layers.planner import DistEmbeddingStrategy

PAD_ID = -1  # marks hotness padding in dense-padded inputs


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


class DistributedLookup:
  """Lookup engine bound to one plan (world 1; see module docstring).

  Class params are 2-D ``[world * rows, width]`` buffers; at world 1 the
  whole buffer is rank 0's block."""

  def __init__(self, plan: "DistEmbeddingStrategy"):
    self.plan = plan
    self._bucket_cache: Dict[tuple, List[Bucket]] = {}
    self._slot_map_cache: Dict[tuple, Dict[tuple, tuple]] = {}

  def _require_world_1(self, what: str) -> None:
    if self.plan.world_size != 1:
      raise NotImplementedError(
          f"{what} at world {self.plan.world_size}: the port runs world 1 "
          "only so far (the wire exchanges are a later slice)")

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
    """Per bucket, the ids this (only) rank's tables serve:
    ``bk -> [n_b, B]`` (hotness 1) or ``[n_b, B, h]``."""
    self._require_world_1("route_ids")
    plan = self.plan
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
        x = self._build_routing(key, bucket, inputs)
        ids_all[bucket_key(key, bucket.h, bucket.vcap, bucket.rs)] = \
            self._reshape_routed(x, bucket, 1, b)
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
    returns the window's rows exactly; this indexes the same rows. Ids
    outside the window (the sentinel) read zeros."""
    two_d = ids_all.dim() == 2
    h = 1 if two_d else ids_all.shape[2]
    cp = self.plan.classes[key]
    if cp.combiner is None and h != 1:
      raise ValueError("combiner=None requires hotness-1 inputs in the "
                       "distributed path (2-D model-parallel outputs)")
    offs = torch.as_tensor(self._dense_offsets(key, bucket)[0],
                           device=ids_all.device)
    off_b = offs[:, None] if two_d else offs[:, None, None]
    ids_local = ids_all - off_b
    valid = (ids_local >= 0) & (ids_local < bucket.vcap)
    rows = table_local[torch.where(valid, ids_all, off_b)]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    if two_d:
      return rows
    z = _sum_axis2(rows)
    if cp.combiner == "mean" and h > 1:
      sentinel = padded_rows(self.plan, key)
      counts = (ids_all < sentinel).sum(dim=2).to(z.dtype)
      z = z / counts.clamp(min=1)[..., None]
    return z

  def exchange(self, z: Dict[BucketKey, torch.Tensor], batch_local: int,
               ids_all=None) -> Dict[BucketKey, torch.Tensor]:
    """mp->dp activation exchange: ``bk -> [world_owner, n_b, B, w]``. At
    world 1 it is the reshape the JAX engine does before its wire."""
    del ids_all
    self._require_world_1("exchange")
    return {bk: zb.reshape(zb.shape[0], 1, batch_local, -1).transpose(0, 1)
            for bk, zb in z.items()}

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


def _sum_axis2(rows: torch.Tensor) -> torch.Tensor:
  """``rows.sum(dim=2)`` as a left-to-right chain of adds, so the order of
  the f32 additions is fixed on every device."""
  out = rows[:, :, 0]
  for j in range(1, rows.shape[2]):
    out = out + rows[:, :, j]
  return out
