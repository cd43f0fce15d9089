"""Sharding planner for distributed embedding tables (PyTorch port).

A copy of ``distributed_embeddings_tpu/layers/planner.py``: the plan is
pure Python, so the logic is carried over unchanged and the two packages
compute field-for-field identical plans (``tests/test_torch_planner.py``).
The only change is the table description it consumes: the port's
:class:`~.embedding.TableConfig` (a plain dataclass) or a config dict,
since the port has no flax ``Embedding`` module.

Semantics of the reference ``DistEmbeddingStrategy``:

- auto column-slice threshold when there are fewer tables than workers
  (repeatedly halve the largest table until there are enough slices);
- column slicing into the smallest power-of-two number of slices that brings
  each slice under the threshold, capped by ``min(N, world, output_dim)``,
  remainder columns spread over the first slices;
- three placement strategies: ``basic`` (round-robin), ``memory_balanced``
  (size-sorted boustrophedon, two per pass), ``memory_optimized`` (greedy
  bin-pack onto the least-loaded worker);
- re-merge of slices of the same table that land on the same worker;
- per-rank fusion of same-(width, combiner) tables into one concatenated
  table with row offsets;
- a width-class layout: for every distinct (width, combiner, kind, gen)
  class, each rank's fused table becomes one row-padded block of a
  row-stacked 2-D buffer ``[world * max_rows, width]``.

The buffer-size bounds (2^31 elements per buffer, ``max_class_bytes``)
are kept as they are so that both packages lay out the same classes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .embedding import TableConfig

# (width, combiner, kind, gen) — kind is 'sparse' (row-gather path) or
# 'dense' (small-vocab MXU one-hot path; see
# DistEmbeddingStrategy.dense_row_threshold). gen splits one width class
# into multiple fused buffers, bounded hard by XLA's 2^31-element buffer
# indexing and soft by ``max_class_bytes``. (Round-3 measurement retired
# the earlier >=4 GiB copy-on-use fear: a donated 6.0 GB buffer
# scatter-adds at 20.6 ns/row, identical to small buffers.) Every input's
# ids statically target exactly one generation, so the split adds no
# per-index work; generation COMPOSITION is chosen to keep each backward
# scatter in XLA's fast regime — see _assign_generations.
ClassKey = Tuple[int, Optional[str], str, int]


@dataclasses.dataclass
class Shard:
  """A (possibly merged) column or row shard of one table on one rank.

  ``input_dim`` is the number of vocabulary rows this shard holds. For a
  row shard (``row_sliced``), those are global rows ``[row_start,
  row_start + input_dim)`` of the table; ids outside the window are served
  by other ranks' shards (routing sends them to the sentinel here).
  """

  table_id: int
  col_start: int
  col_end: int  # exclusive
  input_dim: int
  combiner: Optional[str]
  initializer: object
  gen: int = 0  # width-class generation (assigned by the planner)
  row_start: int = 0
  row_sliced: bool = False

  @property
  def width(self) -> int:
    return self.col_end - self.col_start

  def size(self) -> int:
    return self.input_dim * self.width


@dataclasses.dataclass
class ClassSlot:
  """One lookup slot of a width class on a rank: which global input feeds it
  and where its shard's rows start inside the rank's fused buffer."""

  input_id: int
  row_offset: int
  shard: Shard


@dataclasses.dataclass
class WidthClassPlan:
  """Uniform stacked layout for one (width, combiner) class.

  ``shards_per_rank[r]`` lists rank r's shards fused (row-concatenated) into
  this class's buffer; ``rows_per_rank[r]`` is the unpadded row count. The
  physical array is ``[world * max_rows, width]`` sharded over the mesh axis
  (rank r's block at rows ``[r * max_rows, (r + 1) * max_rows)``).
  ``slots_per_rank[r]`` lists the lookups rank r performs for this class;
  ``num_slots`` is the padded (max) slot count used by the SPMD program.
  """

  width: int
  combiner: Optional[str]
  kind: str  # 'sparse' | 'dense'
  shards_per_rank: List[List[Shard]]
  row_offsets_per_rank: List[List[int]]
  rows_per_rank: List[int]
  slots_per_rank: List[List[ClassSlot]]

  @property
  def max_rows(self) -> int:
    return max(self.rows_per_rank)

  @property
  def num_slots(self) -> int:
    return max(len(s) for s in self.slots_per_rank)


@dataclasses.dataclass
class OutputPiece:
  """Where one slice of one input's output comes from.

  Column slices (``row_sliced=False``) concatenate along the width axis;
  row slices (``row_sliced=True``) are full-width partial results that SUM
  (each holds the rows its vocab window served; the rest gathered the
  sentinel and contributed zeros)."""

  class_key: ClassKey
  rank: int
  slot: int
  width: int
  col_start: int
  row_sliced: bool = False


def _normalize_configs(embeddings) -> List[TableConfig]:
  configs = []
  for e in embeddings:
    if isinstance(e, TableConfig):
      configs.append(dataclasses.replace(e))
    elif isinstance(e, dict):
      # accept stock-Keras Embedding configs like the reference
      # (`embedding.py:145-152` drops mask_zero/input_length): map the
      # Keras initializer key and ignore Keras-only fields
      d = dict(e)
      if "embeddings_initializer" in d:
        d.setdefault("initializer", d.pop("embeddings_initializer"))
      if "embeddings_regularizer" in d:
        d.setdefault("regularizer", d.pop("embeddings_regularizer"))
      if "embeddings_constraint" in d:
        d.setdefault("constraint", d.pop("embeddings_constraint"))
      # a non-None activity regularizer cannot be honored by the
      # distributed path (outputs are assembled from shards) — error
      # instead of the silent drop the reference-config acceptance used
      # to do (reference accepts it, `embedding.py:64-70`)
      if d.pop("activity_regularizer", None) is not None:
        raise ValueError(
            "activity_regularizer is not supported in the distributed "
            "path: apply it to the model outputs in the loss instead")
      for k in ("mask_zero", "input_length", "dtype",
                "batch_input_shape", "trainable"):
        d.pop(k, None)
      configs.append(TableConfig(**d))
    else:
      raise TypeError(f"Cannot build TableConfig from {type(e)}")
  return configs


def _pow2_ranges(total_units: int, size: float, threshold: Optional[float],
                 world_size: int) -> List[Tuple[int, int]]:
  """Split ``total_units`` into the smallest power-of-two number of
  contiguous ranges with ``size / N <= threshold``, capped at
  ``min(N, world, total_units)``; the remainder spreads over the first
  ranges. The split rule of the reference ``maybe_slice_table_column``
  (`dist_model_parallel.py:157-188`), shared by column and row slicing."""
  if threshold is None:
    return [(0, total_units)]
  if threshold <= 0:
    raise ValueError(f"slice threshold must be positive, got {threshold}")
  num_slices = 1
  while size > threshold:
    num_slices *= 2
    size /= 2
  num_slices = min(num_slices, world_size, total_units)
  if num_slices <= 1:
    return [(0, total_units)]
  base = total_units // num_slices
  rem = total_units % num_slices
  ranges, start = [], 0
  for i in range(num_slices):
    n = base + (1 if i < rem else 0)
    ranges.append((start, start + n))
    start += n
  return ranges


def slice_columns(config: TableConfig, threshold: Optional[float],
                  world_size: int) -> List[Tuple[int, int]]:
  """Column ranges for one table under a slice threshold (semantics of the
  reference ``maybe_slice_table_column``, `dist_model_parallel.py:157-188`)."""
  return _pow2_ranges(config.output_dim, float(config.size()), threshold,
                      world_size)


def slice_rows(config: TableConfig, threshold: Optional[float],
               world_size: int) -> List[Tuple[int, int]]:
  """Row (vocabulary) ranges for one table under a row-slice threshold.

  Same split rule as :func:`slice_columns` applied to the vocab dim. The
  reference only stubs row slicing (`dist_model_parallel.py:343,364-365`
  raises NotImplementedError); this build implements it — the natural
  split for tables whose single-column footprint still exceeds one device
  (e.g. multi-hundred-GiB vocabularies).
  """
  return _pow2_ranges(config.input_dim, float(config.size()), threshold,
                      world_size)


def auto_column_slice_threshold(sizes: Sequence[int],
                                world_size: int) -> Optional[float]:
  """Pick a threshold so every worker gets at least one slice.

  Reference `dist_model_parallel.py:205-211`: while there are fewer tables
  than workers, halve the largest table; the threshold ends just below the
  largest table seen at the final halving step.
  """
  if len(sizes) >= world_size:
    return None
  sizes = sorted(sizes)
  threshold = None
  while world_size > len(sizes):
    threshold = sizes[-1] - 1
    largest = sizes.pop()
    sizes += [largest // 2, largest // 2]
    sizes.sort()
  return threshold


def apply_placement(mode: str, world_size: int,
                    slice_sizes: List[int], slice_table_ids: List[int]
                    ) -> List[List[int]]:
  """Distribute slice ids (positions into the flat slice list) to workers.

  Reference ``apply_stragety`` (`dist_model_parallel.py:227-263`), returning
  per-rank lists of *flat slice indices* (the reference returns table ids; we
  keep slice identity and map back to tables later, which avoids its
  input-id/table-id conflation in slice-range bookkeeping).
  """
  n = len(slice_sizes)
  flat = list(range(n))
  if mode == "basic":
    return [flat[i::world_size] for i in range(world_size)]
  if mode == "memory_balanced":
    order = [i for _, _, i in
             sorted(((slice_sizes[i], slice_table_ids[i], i) for i in flat),
                    reverse=True)]
    return [
        order[i::2 * world_size] + order[(2 * world_size - 1 - i)::2 * world_size]
        for i in range(world_size)
    ]
  if mode == "memory_optimized":
    # Greedy: biggest slice first onto the least-loaded worker.
    order = sorted(flat, key=lambda i: (slice_sizes[i], slice_table_ids[i]),
                   reverse=True)
    loads = [(0, r) for r in range(world_size)]
    assignment: List[List[int]] = [[] for _ in range(world_size)]
    import heapq
    heapq.heapify(loads)
    for i in order:
      load, r = heapq.heappop(loads)
      assignment[r].append(i)
      heapq.heappush(loads, (load + slice_sizes[i], r))
    return assignment
  raise ValueError(f"Unsupported strategy {mode}")



def _rows_hard_noaux(width: int) -> int:
  """Max shard rows that fit one 2^31-element TPU buffer with NO packed
  aux state (the plan-time hard bound; the exact per-rule check lives in
  DistributedLookup.fused_layouts)."""
  stride = width
  rpp = max(1, 128 // stride)
  pw = max(128, -(-stride // 128) * 128)
  return max(1, int((2 ** 31) // (pw / rpp)))


def _raise_shard_too_big(table_id: int, rows: int, width: int) -> None:
  raise ValueError(
      f"table {table_id}'s shard of {rows:,} rows x width {width} "
      f"exceeds one TPU buffer (2^31 elements ~= "
      f"{_rows_hard_noaux(width):,} rows at this width) and a generation "
      "cannot split a single shard. Shard it finer: more workers, a "
      "smaller row_slice threshold (slices are capped at "
      "min(2^k, world)), or column slicing (column_slice_threshold).")


class DistEmbeddingStrategy:
  """Global-view embedding placement plan (deterministic, collective-free).

  Args:
    embeddings: global list of ``TableConfig``s / config dicts.
    world_size: number of model-parallel workers.
    strategy: 'basic' | 'memory_balanced' | 'memory_optimized'.
    input_table_map: input i feeds table ``input_table_map[i]`` (shared
      tables); None means the identity map.
    column_slice_threshold: max elements per slice, or None for auto.
  """

  def __init__(self,
               embeddings,
               world_size: int,
               strategy: str = "basic",
               input_table_map: Optional[Sequence[int]] = None,
               column_slice_threshold: Optional[int] = None,
               dense_row_threshold: int = 0,
               max_class_bytes: int = 3 * 1024 ** 3,
               row_slice_threshold: Optional[int] = None,
               input_hotness: Optional[Sequence[int]] = None,
               batch_hint: Optional[int] = None,
               gen_assignment: str = "auto",
               host_row_threshold: Optional[int] = None,
               hbm_budget_bytes: Optional[int] = None,
               oov: str = "clip",
               vocab_capacity: Optional[int] = None,
               admit_threshold: int = 1,
               evict_ttl: Optional[int] = None,
               wire_dtype: str = "f32",
               dedup_exchange: bool = False,
               overlap: str = "none",
               exchange_chunks: int = 1,
               dedup_capacity: Optional[int] = None):
    if strategy not in ("basic", "memory_balanced", "memory_optimized"):
      raise ValueError(f"Unsupported shard strategy {strategy}")
    # ---- wire format of the dp<->mp exchanges ---------------------------
    # Plan-level because the wire is a contract between routing, combine,
    # backward and audit — one lookup call flipping it per-site would
    # desynchronize the reverse (autodiff-inserted) exchange from the
    # forward one. "wire_dtype": float payloads (activations + reverse
    # cotangents) travel 'f32' (identity, the pre-knob program), 'bf16'
    # (half the float wire bytes), or 'fp8' (quarter: float8_e4m3 payload
    # with one f32 amax scale shipped per destination block/chunk —
    # tables, combiners and the one-scatter-add backward stay f32 master
    # precision in every mode; the narrowing exists only in flight).
    # "dedup_exchange": per (source, dest, bucket) block, ship the
    # sorted-unique id set and one activation/cotangent row per unique
    # id instead of one per occurrence/sample (lookup_engine.DedupRouted;
    # sparse-kind padded buckets only — dense MXU classes and ragged
    # value streams keep the raw exchange). "overlap='pipelined'":
    # rewrite each monolithic all_to_all as (world - 1) ppermute rounds
    # per chunk, the payload split into "exchange_chunks" chunks, so the
    # receiving side's gather/combine of chunk k overlaps chunk k+1's
    # flight (wire.pipelined_float_exchange / pipelined_exchange_ids;
    # f32 pipelined is bit-exact vs monolithic — pure data movement).
    # "overlap='fused'": the just-in-time form of the pipelined schedule
    # — sparse-class activation/cotangent rows are gathered (and, under
    # dedup_exchange, expanded/segment-summed) per ROUND immediately
    # before each wire.fused_block_send instead of in one monolithic
    # pre-gather, so round k's collective can overlap round k+1's gather
    # (and on a real TPU the ops/pallas_exchange.py remote-DMA kernel
    # takes over). Id exchanges and dense-class floats still ride the
    # pipelined schedule; f32 fused is bit-exact vs both other modes.
    # None of these knobs changes any buffer layout, so checkpoints
    # restore across knob changes; training step builders reject
    # exact=True with a narrowed (bf16/fp8) wire (the exact path's
    # bit-for-bit claim cannot survive a narrowed cotangent exchange).
    if wire_dtype not in ("f32", "bf16", "fp8"):
      raise ValueError(
          f"wire_dtype must be 'f32', 'bf16' or 'fp8', got {wire_dtype!r}")
    self.wire_dtype = wire_dtype
    self.dedup_exchange = bool(dedup_exchange)
    if overlap not in ("none", "pipelined", "fused"):
      raise ValueError(
          f"overlap must be 'none', 'pipelined' or 'fused', got {overlap!r}")
    if not isinstance(exchange_chunks, int) or exchange_chunks < 1:
      raise ValueError(
          f"exchange_chunks must be a positive int, got {exchange_chunks!r}")
    if exchange_chunks > 1 and overlap == "none":
      raise ValueError(
          f"exchange_chunks={exchange_chunks} without overlap='pipelined' "
          "or 'fused' would be silently ignored: the monolithic all_to_all "
          "has no chunk axis. Set overlap='pipelined'/'fused' (or "
          "exchange_chunks=1).")
    self.overlap = overlap
    self.exchange_chunks = exchange_chunks
    # "dedup_capacity": override the dedup'd exchange's per-block unique
    # capacity K (default min(block occurrences, sentinel + 1) — the
    # value-range bound, which can never overflow). A SMALLER cap shrinks
    # the unique wire further but creates an overflow path: distinct ids
    # beyond the cap alias onto the last slot and gather the wrong row.
    # The knob is therefore only legal alongside the counter that makes
    # that observable — guarded train steps and with_metrics eval surface
    # a psum'd per-class 'dedup_overflow' count, and the unguarded step
    # builders REFUSE a capped plan at build time.
    if dedup_capacity is not None:
      if not dedup_exchange:
        raise ValueError(
            "dedup_capacity requires dedup_exchange=True: the capacity "
            "caps the dedup'd exchange's unique blocks, which a raw "
            "exchange does not have.")
      if not isinstance(dedup_capacity, int) or dedup_capacity < 1:
        raise ValueError(
            f"dedup_capacity must be a positive int, got {dedup_capacity!r}")
    self.dedup_capacity = dedup_capacity
    # Out-of-vocabulary id POLICY (plan-level — one id pipeline feeds all
    # tables, so the policy is a property of the plan, not a lookup-call
    # flag). "clip": ids >= input_dim clamp to the last row (reference
    # numeric semantics, unchanged) but are COUNTED — guarded train steps
    # surface a per-class OOV counter in their metrics so clipping is
    # observable instead of silent. "error": a nonzero counter raises —
    # eagerly at routing time for concrete (non-traced) inputs, host-side
    # from step metrics under jit (resilience.guards.check_oov) — for
    # debugging id pipelines where a clip would bury the bug. Not part of
    # the plan fingerprint: the policy changes no layout and no numerics.
    # "allocate" (dynamic vocabulary, dynvocab/ subsystem): raw 64-bit ids
    # are TRANSLATED host-side — between steps, like the tiered
    # prefetcher's classify — to physical rows a host-side
    # open-addressing table allocates on first admission
    # (count-min-sketch frequency admission, TTL eviction recycling rows
    # in place). The traced step only ever sees translated in-range ids,
    # so the jaxpr is byte-identical to an oov='clip' plan's; a nonzero
    # in-trace OOV counter under this policy means raw ids leaked past
    # the translator, which guards.check_oov escalates like 'error'.
    if oov not in ("clip", "error", "allocate"):
      raise ValueError(
          f"oov policy must be 'clip', 'error' or 'allocate', got {oov!r}")
    self.oov = oov
    # ---- dynamic-vocabulary knobs (oov='allocate' only) -----------------
    # vocab_capacity: allocatable rows per table (None = the table's full
    # input_dim — every physical row is allocatable). admit_threshold: an
    # id must be OBSERVED this many times (count-min-sketch estimate)
    # before it earns a row; 1 admits everything on first sight.
    # evict_ttl: steps of non-observation after which a row is reclaimed
    # to the freelist (its table AND interleaved optimizer lanes re-zero
    # before reuse); None never evicts. None of these knobs changes any
    # buffer layout or the traced step, so they are NOT part of the plan
    # fingerprint — the checkpoint manifest's 'vocab' section pins the
    # translator state they govern instead.
    if oov != "allocate":
      if vocab_capacity is not None or admit_threshold != 1 \
          or evict_ttl is not None:
        raise ValueError(
            "vocab_capacity/admit_threshold/evict_ttl only apply to the "
            "dynamic-vocabulary policy: build the plan with "
            "oov='allocate' (got oov=" + repr(oov) + ").")
      for t, c in enumerate(_normalize_configs(embeddings)):
        if getattr(c, "vocab_capacity", None) is not None:
          raise ValueError(
              f"table {t} carries a per-table vocab_capacity "
              f"({c.vocab_capacity}) on a static-vocab plan "
              f"(oov={oov!r}): the cap only governs dynamic allocation "
              "— build the plan with oov='allocate' or drop the field.")
    else:
      if vocab_capacity is not None and (
          not isinstance(vocab_capacity, int) or vocab_capacity < 1):
        raise ValueError(
            f"vocab_capacity must be a positive int, got "
            f"{vocab_capacity!r}")
      for t, c in enumerate(_normalize_configs(embeddings)):
        per = getattr(c, "vocab_capacity", None)
        if per is not None and (not isinstance(per, int) or per < 1):
          raise ValueError(
              f"table {t}'s vocab_capacity must be a positive int, got "
              f"{per!r}")
        for cap, what in ((vocab_capacity, "vocab_capacity"),
                          (per, f"table {t}'s vocab_capacity")):
          if cap is not None and cap > c.input_dim:
            raise ValueError(
                f"{what}={cap:,} exceeds table {t}'s "
                f"input_dim={c.input_dim:,}: allocated rows must fit the "
                "physical table. Lower the capacity or grow the table.")
      if not isinstance(admit_threshold, int) or admit_threshold < 1:
        raise ValueError(
            f"admit_threshold must be an int >= 1, got {admit_threshold!r}")
      if evict_ttl is not None and (not isinstance(evict_ttl, int)
                                    or evict_ttl < 1):
        raise ValueError(
            f"evict_ttl must be None or an int >= 1, got {evict_ttl!r}")
    self.vocab_capacity = vocab_capacity
    self.admit_threshold = admit_threshold
    self.evict_ttl = evict_ttl
    self.strategy = "basic" if world_size == 1 else strategy
    self.world_size = world_size
    # ---- third placement tier: host-offloaded cold storage --------------
    # Tables with input_dim > host_row_threshold are HOST-tier: their rows
    # live in host RAM (the cold store) and only a frequency-ranked hot
    # subset is resident on device, plus a per-step staging buffer for the
    # batch's cold rows (see distributed_embeddings_tpu/tiering/). The
    # placement/fusion/routing math is unchanged — tiering is a physical
    # storage attribute of a class, resolved per class after generation
    # assignment (host-tier tables get their own generations so small
    # tables fused in the same width class are not dragged to host).
    # ``hbm_budget_bytes`` (per device) is the accounting input the
    # tiering planner sizes hot caches against; recorded here for
    # tier_capacity_report. It is deliberately NOT in the plan
    # fingerprint — checkpoints pin the RESULTING per-class cache/staging
    # geometry (manifest tiering section), so a different budget that
    # yields the same geometry restores fine.
    if host_row_threshold is not None:
      if host_row_threshold <= 0:
        raise ValueError(
            f"host_row_threshold must be positive, got {host_row_threshold}")
      if host_row_threshold <= dense_row_threshold:
        raise ValueError(
            f"host_row_threshold ({host_row_threshold}) must exceed "
            f"dense_row_threshold ({dense_row_threshold}): a table cannot "
            "be both MXU-dense and host-offloaded")
    self.host_row_threshold = host_row_threshold
    self.hbm_budget_bytes = hbm_budget_bytes
    # Tables with input_dim <= dense_row_threshold are served by the MXU
    # one-hot-matmul path (zero indexed row ops, dense autodiff grads)
    # instead of HBM row gathers; 0 disables. On v5e every gathered/scattered
    # row costs ~8-23ns regardless of width, so small tables are strictly
    # cheaper as matmuls (the TPU answer to the reference's
    # ConcatOneHotEmbedding, `embedding.py:155-180`).
    self.dense_row_threshold = dense_row_threshold
    self.global_configs = _normalize_configs(embeddings)
    for t, c in enumerate(self.global_configs):
      # Routing tensors carry LOCALIZED ids as int32 on the wire; GLOBAL
      # ids for a >int32 table arrive as int64 (the engine keeps int64
      # inputs wide, `lookup_engine._normalize_input`; the reference
      # registers the same two widths, `embedding_lookup_ops.cc:24-88`)
      # and the row-slice window subtraction narrows them. That only
      # works when every SHARD's window fits int32 — i.e. the table is
      # row-sliced — so an unsliceable >int32 table still fails at plan
      # time rather than folding ids at the engine's cast. (The per-rank
      # 2^31 buffer-element bound in fused_layouts/_buffer_limit already
      # forces such tables into row slices far below int32 rows.)
      if c.input_dim > 2 ** 31 - 1 and not row_slice_threshold:
        raise ValueError(
            f"table {t} has input_dim={c.input_dim:,} > int32 max "
            f"({2 ** 31 - 1:,}): global ids need the int64 routing path, "
            "which localizes them through row-slice windows. Enable row "
            "slicing (row_slice_threshold), split the id space across "
            "several tables (an input_table_map entry per split, with a "
            "host-side id fold), or reduce the vocabulary.")
    num_tables = len(self.global_configs)
    if input_table_map is None:
      input_table_map = list(range(num_tables))
    self.input_table_map = list(input_table_map)
    self.num_inputs = len(self.input_table_map)
    if input_hotness is not None and len(input_hotness) != self.num_inputs:
      raise ValueError(
          f"input_hotness has {len(input_hotness)} entries for "
          f"{self.num_inputs} inputs")
    self.input_hotness = None if input_hotness is None else list(input_hotness)
    # A NEGATIVE input_hotness entry declares "input i may be ragged":
    # its table is kept on the sparse (gather) path regardless of
    # dense_row_threshold, because the MXU one-hot path has no
    # value-stream form. |entry| still serves as the occurrence weight
    # for generation balancing (use -avg_hotness when known, else -1).
    self._ragged_tables = set()
    if self.input_hotness is not None:
      for i, h in enumerate(self.input_hotness):
        if h < 0:
          self._ragged_tables.add(self.input_table_map[i])
    # expected per-step GLOBAL batch (optional): lets the generation
    # assignment evaluate the scatter-regime cost model on absolute id
    # counts instead of only balancing ratios — see _assign_generations
    self.batch_hint = batch_hint

    # ---- column slicing --------------------------------------------------
    self.column_slice_threshold = column_slice_threshold
    threshold = column_slice_threshold
    if threshold is None and row_slice_threshold is None:
      # the auto threshold exists to give every worker a shard when there
      # are fewer tables than workers; an explicit row_slice request can
      # provide that coverage itself, so auto column slicing must not
      # preempt it (it would cap at output_dim and crash for one huge
      # narrow table across many workers)
      threshold = auto_column_slice_threshold(
          [c.size() for c in self.global_configs], world_size)
    self.table_col_ranges: List[List[Tuple[int, int]]] = [
        slice_columns(c, threshold, world_size) for c in self.global_configs
    ]
    for t, c in enumerate(self.global_configs):
      if c.constraint is not None and len(self.table_col_ranges[t]) > 1:
        raise ValueError(
            f"table {t} has an embeddings_constraint but would be column-"
            "sliced: a row projection (e.g. max_norm) needs the full row "
            "on one shard. Raise column_slice_threshold for this table or "
            "drop the constraint.")

    # API-parity view: [input_id, input_id + num_slices] per sliced input.
    self.sliced_out_ranges = [
        [i, i + len(self.table_col_ranges[t])]
        for i, t in enumerate(self.input_table_map)
        if len(self.table_col_ranges[t]) > 1
    ]

    # ---- row slicing (vocab dim; this build's extension — the reference
    # stubs it, `dist_model_parallel.py:364-365`). A table is sliced along
    # ONE dim: column slicing wins when both thresholds would trigger.
    self.row_slice_threshold = row_slice_threshold
    self.table_row_ranges: List[List[Tuple[int, int]]] = [
        slice_rows(c, row_slice_threshold, world_size)
        if len(self.table_col_ranges[t]) == 1 else [(0, c.input_dim)]
        for t, c in enumerate(self.global_configs)
    ]
    # int64 routing backstop (completes the __init__ guard, which only
    # proves row slicing was REQUESTED): every >int32 table must have
    # actually sliced into int32-sized windows — column slicing or a
    # too-coarse row threshold can leave a single full-vocab range, and
    # the engine's post-localization int32 narrowing would then wrap.
    for t, c in enumerate(self.global_configs):
      if c.input_dim <= 2 ** 31 - 1:
        continue
      windows = self.table_row_ranges[t]
      worst = max(r1 - r0 for (r0, r1) in windows)
      if worst > 2 ** 31 - 1:
        raise ValueError(
            f"table {t} (input_dim={c.input_dim:,}) did not row-slice "
            f"into int32-sized windows (largest window {worst:,} rows): "
            "the int64 routing path localizes ids through row-slice "
            "windows. Lower row_slice_threshold (and note column "
            "slicing disables row slicing for a table).")

    # ---- placement -------------------------------------------------------
    # one placement unit per (table, column range or row range)
    slice_sizes, slice_table_ids = [], []
    for t, config in enumerate(self.global_configs):
      for (s, e) in self.table_col_ranges[t]:
        if len(self.table_row_ranges[t]) > 1 and (s, e) == (
            0, config.output_dim):
          continue  # row-sliced table: units come from row ranges below
        slice_sizes.append(config.input_dim * (e - s))
        slice_table_ids.append(t)
      if len(self.table_row_ranges[t]) > 1:
        for (r0, r1) in self.table_row_ranges[t]:
          slice_sizes.append((r1 - r0) * config.output_dim)
          slice_table_ids.append(t)
    placement = apply_placement(self.strategy, world_size, slice_sizes,
                                slice_table_ids)

    # ---- per-rank shards: hand out column/row ranges in rank order,
    # merging same-table slices that land together (always contiguous in
    # the sliced dim: slices are handed out in rank order).
    next_slice: List[int] = [0] * num_tables
    self.rank_shards: List[List[Shard]] = []
    for rank in range(world_size):
      shards: List[Shard] = []
      by_table: Dict[int, Shard] = {}
      for flat_idx in placement[rank]:
        t = slice_table_ids[flat_idx]
        config = self.global_configs[t]
        row_sliced = len(self.table_row_ranges[t]) > 1
        if row_sliced:
          r0, r1 = self.table_row_ranges[t][next_slice[t]]
          next_slice[t] += 1
          if t in by_table:  # merge row-contiguous slices on this rank
            by_table[t].input_dim += r1 - r0
          else:
            shard = Shard(table_id=t, col_start=0,
                          col_end=config.output_dim, input_dim=r1 - r0,
                          combiner=config.combiner,
                          initializer=config.initializer,
                          row_start=r0, row_sliced=True)
            by_table[t] = shard
            shards.append(shard)
        else:
          s, e = self.table_col_ranges[t][next_slice[t]]
          next_slice[t] += 1
          if t in by_table:  # merge with earlier shard on this rank
            by_table[t].col_end = e
          else:
            shard = Shard(table_id=t, col_start=s, col_end=e,
                          input_dim=config.input_dim,
                          combiner=config.combiner,
                          initializer=config.initializer)
            by_table[t] = shard
            shards.append(shard)
      self.rank_shards.append(shards)
    if world_size > 1 and not all(self.rank_shards):
      raise ValueError(
          "Not enough tables after slicing to run on all workers. "
          "Try decreasing column_slice_threshold or the worker count")

    # reference-compatible per-rank table id lists (for get/set weights order)
    self.table_ids = [[sh.table_id for sh in shards]
                      for shards in self.rank_shards]

    # ---- per-rank inputs + width-class fusion ----------------------------
    # Generation assignment. A width class bigger than one TPU buffer can
    # hold (2^31 elements — XLA's 32-bit buffer indexing) splits into
    # generations, each a separate buffer with its own gather and backward
    # scatter. Two measured facts drive the assignment
    # (tools/profile_scatter_regimes.py, docs/BENCHMARKS.md):
    #
    # 1. XLA's scatter-add has two regimes: a fast path at ~16-25 ns/row
    #    it only picks when the id stream is a large enough fraction of
    #    the buffer's rows (>= ~0.15 ids/row empirically — raw buffer
    #    bytes do NOT matter), and a ~75 ns/row serial path otherwise.
    #    First-fit in table order packed the Tiny model's nine 1-hot
    #    1M-row tables into a generation of their own: a 590k-id stream
    #    over 8.25M physical rows (ratio 0.07) ran at 74.7 ns — 44
    #    ms/step, traced — while a mixed assignment keeps every
    #    generation's scatter in the fast regime.
    # 2. Gather cost is flat in buffer size, so fewer+bigger generations
    #    are otherwise free.
    #
    # The assignment therefore MAXIMIZES THE MINIMUM ids/rows ratio over
    # generations: try every feasible generation count from the capped
    # minimum up, balance each by expected id traffic (input_hotness when
    # known, else inputs-per-table), and keep the best. Generations never
    # exceed max_class_bytes (min'd with the element limit) unless a
    # single shard alone does.
    self.max_class_bytes = max_class_bytes
    if gen_assignment not in ("auto", "first_fit"):
      raise ValueError(
          f"gen_assignment must be 'auto' or 'first_fit', got "
          f"{gen_assignment!r}")
    self.gen_assignment = gen_assignment
    occ_of = [0.0] * num_tables
    for i, t in enumerate(self.input_table_map):
      # negative entries are ragged markers; |h| is the occurrence weight
      occ_of[t] += (abs(self.input_hotness[i])
                    if self.input_hotness is not None else 1)
    if gen_assignment == "first_fit":
      # Legacy (round-2) layout: first-fit in shard order against the byte
      # cap. Exists so checkpoints written under the old assignment stay
      # restorable (pass gen_assignment='first_fit' plus the saving run's
      # max_class_bytes — the checkpoint manifest's layout diff names the
      # mismatch otherwise). Performance-wise the occurrence-balanced
      # default dominates it (docs/BENCHMARKS.md, scatter-regime matrix).
      for shards in self.rank_shards:
        gen_rows: Dict[tuple, List[int]] = {}
        for sh in shards:
          base = (sh.width, sh.combiner, self._kind_of(sh),
                  self.table_tier(sh.table_id))
          # same plan-time hard error as the auto mode (a generation
          # cannot split a shard, and one shard past the 2^31-element
          # buffer limit is untrainable regardless of assignment) —
          # except host-tier shards, whose device footprint is the
          # compact cache+staging buffer (TieringPlan enforces ITS 2^31
          # bound), not the full vocabulary
          if (base[3] != "host"
              and sh.input_dim > _rows_hard_noaux(sh.width)):
            _raise_shard_too_big(sh.table_id, sh.input_dim, sh.width)
          rows_list = gen_rows.setdefault(base, [0])
          cap_rows = max(1, max_class_bytes // (sh.width * 4))
          for g, r in enumerate(rows_list):
            if r == 0 or r + sh.input_dim <= cap_rows:
              sh.gen = g
              rows_list[g] += sh.input_dim
              break
          else:
            sh.gen = len(rows_list)
            rows_list.append(sh.input_dim)
    else:
      for shards in self.rank_shards:
        by_base: Dict[tuple, List] = {}
        for sh in shards:
          # tier joins the grouping key so host-tier tables never share a
          # generation with device-tier ones — a class (one physical
          # buffer) must be uniformly device-resident or host-offloaded
          by_base.setdefault(
              (sh.width, sh.combiner, self._kind_of(sh),
               self.table_tier(sh.table_id)), []).append(sh)
        for base, group in by_base.items():
          self._assign_generations(base[0], group, occ_of)

    if host_row_threshold is not None:
      # Host-tier generations are renumbered after a GLOBAL offset (max
      # device-tier gen over every rank, per (width, combiner, kind)):
      # gens are assigned per rank, and a rank-local offset could give the
      # same generation number a device shard on one rank and a host
      # shard on another — one class, two tiers, which the storage split
      # cannot represent.
      max_dev_gen: Dict[tuple, int] = {}
      for shards in self.rank_shards:
        for sh in shards:
          if self.table_tier(sh.table_id) == "device":
            k = (sh.width, sh.combiner, self._kind_of(sh))
            max_dev_gen[k] = max(max_dev_gen.get(k, -1), sh.gen)
      for shards in self.rank_shards:
        for sh in shards:
          if self.table_tier(sh.table_id) == "host":
            k = (sh.width, sh.combiner, self._kind_of(sh))
            sh.gen += max_dev_gen.get(k, -1) + 1

    class_keys: List[ClassKey] = []
    for shards in self.rank_shards:
      for sh in shards:
        key = self.class_key_of(sh)
        if key not in class_keys:
          class_keys.append(key)
    class_keys.sort(key=lambda k: (k[0], str(k[1]), k[2], k[3]))
    self.class_keys = class_keys

    # Per-class storage tier, derived from member tables (uniform by
    # construction: host-tier tables have disjoint generations). "device"
    # = the class buffer is fully HBM-resident (the only tier before this
    # existed); "host" = rows live in the host cold store with a device
    # hot cache + staging buffer (tiering/ subsystem).
    self.class_tiers: Dict[ClassKey, str] = {}
    for shards in self.rank_shards:
      for sh in shards:
        key = self.class_key_of(sh)
        tier = self.table_tier(sh.table_id)
        prev = self.class_tiers.setdefault(key, tier)
        if prev != tier:
          raise AssertionError(
              f"class {key} mixes storage tiers ({prev} vs {tier}) — "
              "generation separation failed; this is a planner bug")

    self.classes: Dict[ClassKey, WidthClassPlan] = {
        key: WidthClassPlan(width=key[0], combiner=key[1], kind=key[2],
                            shards_per_rank=[[] for _ in range(world_size)],
                            row_offsets_per_rank=[[] for _ in range(world_size)],
                            rows_per_rank=[0] * world_size,
                            slots_per_rank=[[] for _ in range(world_size)])
        for key in class_keys
    }

    # worker-order input ids (an input appears once per slice of its table)
    self.input_ids_list: List[List[int]] = []
    # output routing: input_id -> pieces in column order
    self.output_pieces: List[List[OutputPiece]] = [
        [] for _ in range(self.num_inputs)
    ]

    for rank, shards in enumerate(self.rank_shards):
      # fuse: row-concat shards of equal (width, combiner, kind) in local order
      for sh in shards:
        plan = self.classes[self.class_key_of(sh)]
        plan.shards_per_rank[rank].append(sh)
        plan.row_offsets_per_rank[rank].append(plan.rows_per_rank[rank])
        plan.rows_per_rank[rank] += sh.input_dim

      rank_input_ids: List[int] = []
      for sh in shards:
        key = self.class_key_of(sh)
        plan = self.classes[key]
        idx_in_rank = plan.shards_per_rank[rank].index(sh)
        row_offset = plan.row_offsets_per_rank[rank][idx_in_rank]
        for input_id, mapped_table in enumerate(self.input_table_map):
          if mapped_table == sh.table_id:
            rank_input_ids.append(input_id)
            slot = ClassSlot(input_id=input_id, row_offset=row_offset, shard=sh)
            plan.slots_per_rank[rank].append(slot)
            self.output_pieces[input_id].append(
                OutputPiece(class_key=key, rank=rank,
                            slot=len(plan.slots_per_rank[rank]) - 1,
                            width=sh.width, col_start=sh.col_start,
                            row_sliced=sh.row_sliced))
      self.input_ids_list.append(rank_input_ids)

    # column slices of one input must concat in column order
    for pieces in self.output_pieces:
      pieces.sort(key=lambda p: p.col_start)

    # ---- reference-compatible per-rank fused views -----------------------
    self.local_configs: List[List[dict]] = []
    self.local_group_list: List[List[List[int]]] = []
    self.local_weight_offsets: List[List[List[int]]] = []
    self.local_maps: List[List[int]] = []
    self.local_input_offsets: List[List[int]] = []
    self.widths_list_flat: List[int] = []
    for rank in range(world_size):
      configs, groups, weight_offsets = [], [], []
      # fused groups in class order, skipping classes absent on this rank
      rank_class_keys = [k for k in class_keys
                         if self.classes[k].shards_per_rank[rank]]
      shards_flat = self.rank_shards[rank]
      for key in rank_class_keys:
        plan = self.classes[key]
        members = plan.shards_per_rank[rank]
        configs.append({
            "input_dim": plan.rows_per_rank[rank],
            "output_dim": key[0],
            "combiner": key[1],
        })
        groups.append([shards_flat.index(sh) for sh in members])
        offs = [0]
        for sh in members:
          offs.append(offs[-1] + sh.input_dim)
        weight_offsets.append(offs)
      self.local_configs.append(configs)
      self.local_group_list.append(groups)
      self.local_weight_offsets.append(weight_offsets)

      input_map, input_offsets = [], []
      for input_id in self.input_ids_list[rank]:
        piece = next(p for p in self.output_pieces[input_id] if p.rank == rank)
        # recover class + slot for this (input, rank)
        key = piece.class_key
        gid = rank_class_keys.index(key)
        input_map.append(gid)
        slot = self.classes[key].slots_per_rank[rank][piece.slot]
        input_offsets.append(slot.row_offset)
        # flat output widths in worker order (reference widths_list_flat)
        self.widths_list_flat.append(piece.width)
      self.local_maps.append(input_map)
      self.local_input_offsets.append(input_offsets)

    worker_order = [i for rank_ids in self.input_ids_list for i in rank_ids]
    self.rev_global_input_ids = [
        idx for _, idx in sorted(zip(worker_order, range(len(worker_order))))
    ]

  # ---- convenience -------------------------------------------------------
  def _assign_generations(self, width: int, group: List,
                          occ_of: Sequence[float]) -> None:
    """Set ``sh.gen`` for one (width, combiner, kind) shard group.

    Tries every feasible generation count from the capped minimum
    (``max_class_bytes``, min'd with the 2^31-element buffer limit under a
    one-aux packed layout) upward; within a count, shards are handed out
    in descending occurrence-weight order to the generation with the
    least weight so far (ties: fewest rows). Keeps the assignment
    maximizing the minimum occurrence-weight / physical-rows ratio — the
    quantity that decides the backward scatter's regime. See __init__ for
    the measured rationale."""
    # per-logical-row element count under a 1-aux packed layout (the common
    # training case; n_aux is unknown at plan time — assuming 1 is
    # conservative for SGD and exact for Adagrad)
    stride = width * 2
    rpp = max(1, 128 // stride)
    phys_width = max(128, -(-stride // 128) * 128)
    elems_per_row = phys_width / rpp
    rows_hard = max(1, int((2 ** 31) // elems_per_row))
    cap_rows = min(rows_hard,
                   max(1, self.max_class_bytes // (width * 4)))
    total = sum(sh.input_dim for sh in group)
    largest = max(sh.input_dim for sh in group)
    # The plan doesn't know the optimizer yet, so the hard error uses the
    # aux-free bound (illegal for ANY rule); the 1-aux estimate only warns.
    # The exact check (actual n_aux) lives in DistributedLookup.fused_layouts.
    # Host-tier groups are exempt from both: their full image lives in host
    # RAM and only the compact cache+staging buffer (bounded by
    # TieringPlan's own 2^31 check) ever occupies a device — training
    # vocabularies past the device buffer limit is the tier's purpose.
    host_tier = self.table_tier(group[0].table_id) == "host"
    if largest > _rows_hard_noaux(width) and not host_tier:
      big = max(group, key=lambda sh: sh.input_dim)
      _raise_shard_too_big(big.table_id, big.input_dim, width)
    if largest > rows_hard and not host_tier:
      import warnings
      big = max(group, key=lambda sh: sh.input_dim)
      warnings.warn(
          f"table {big.table_id}'s shard of {big.input_dim:,} rows x "
          f"width {width} fits one TPU buffer only WITHOUT packed "
          f"optimizer state (> {rows_hard:,} rows at one aux slot); "
          "training with Adagrad-style rules will fail the exact check "
          "in DistributedLookup.fused_layouts — shard finer for training.")
    n_min = max(1, -(-total // cap_rows))
    order = sorted(group, key=lambda sh: (-occ_of[sh.table_id],
                                          -sh.input_dim, sh.table_id))

    def attempt(n_bins):
      # row target balances bins; a shard over the cap only lands in an
      # empty bin (its generation may then exceed the cap — unavoidable
      # without row-slicing the table)
      rows_cap = min(cap_rows, max(-(-total // n_bins) * 21 // 20, largest))
      bins = [[0, 0.0] for _ in range(n_bins)]  # [rows, occ]
      assign = {}
      for sh in order:
        cands = [g for g in range(n_bins)
                 if bins[g][0] + sh.input_dim <= rows_cap or bins[g][0] == 0]
        if not cands:
          return None, -1.0
        best = min(cands, key=lambda g: (bins[g][1], bins[g][0]))
        assign[id(sh)] = best
        bins[best][0] += sh.input_dim
        bins[best][1] += occ_of[sh.table_id]
      score = min((o / max(1.0, r / rpp) if r else float("inf"))
                  for r, o in bins)
      return assign, score

    candidates = []  # (assign dict, bins [rows, occ] list)
    for n_bins in range(n_min, n_min + 7):
      assign, score = attempt(n_bins)
      if assign is not None:
        candidates.append((assign, score, n_bins))

    if self.batch_hint is None:
      # no absolute id counts: keep the best-balanced candidate
      # (strict > : equal-regime ties keep FEWER generations — fewer
      # gather/scatter launches and routing tensors)
      best_assign, best_score = None, -1.0
      for assign, score, _ in candidates:
        if score > best_score:
          best_assign, best_score = assign, score
    else:
      # absolute id counts known: score every candidate with the measured
      # cost model (fast sorted-scatter path at >= ~0.15 ids/physical-row,
      # else the ~75 ns serial path) and also try a CONCENTRATION layout —
      # when traffic is scarce (small batch, huge vocabularies) no
      # balanced split reaches the fast regime, but packing the heavy
      # multi-hot streams together can carry most ids at fast-path cost
      # while quarantining low-traffic giants into few slow generations.
      T, NS_FAST, NS_SLOW = 0.15, 20.0, 75.0
      b = float(self.batch_hint)

      def cost_of(assign):
        bins: Dict[int, List[float]] = {}
        for sh in group:
          g = assign[id(sh)]
          bins.setdefault(g, [0.0, 0.0])
          bins[g][0] += sh.input_dim
          bins[g][1] += occ_of[sh.table_id]
        total_ns = 0.0
        for r, o in bins.values():
          ids = o * b
          ratio = ids / max(1.0, r / rpp)
          # ~0.2 ms fixed cost per generation (its own gather + scatter
          # launch and routing tensors) breaks regime-cost ties toward
          # fewer, larger generations
          total_ns += ids * (NS_FAST if ratio >= T else NS_SLOW) + 200_000.0
        return total_ns

      conc = self._concentrate(group, occ_of, b, rpp, cap_rows, T)
      if conc is not None:
        candidates.append((conc, 0.0, -1))
      best_assign, best_cost = None, float("inf")
      for assign, _, _ in candidates:
        c = cost_of(assign)
        if c < best_cost:
          best_assign, best_cost = assign, c

    if best_assign is None:  # pathological: give every shard its own gen
      for g, sh in enumerate(order):
        sh.gen = g
      return
    # renumber generations densely in first-appearance order (stable names)
    remap: Dict[int, int] = {}
    for sh in group:
      bnum = best_assign[id(sh)]
      sh.gen = remap.setdefault(bnum, len(remap))

  @staticmethod
  def _concentrate(group, occ_of, batch, rpp, cap_rows, threshold):
    """Concentration generation layout: greedy fast-generation packing in
    traffic-density order, then first-fit-decreasing for the slow pool."""
    dens = lambda sh: (occ_of[sh.table_id] * batch  # noqa: E731
                       / max(1.0, sh.input_dim / rpp))
    order = sorted(group, key=lambda sh: (-dens(sh), sh.table_id))
    assign = {}
    bins: List[List[float]] = []  # [rows, ids]
    cur = None
    slow = []
    for sh in order:
      ids = occ_of[sh.table_id] * batch
      if cur is not None:
        r, i = bins[cur]
        if (r + sh.input_dim <= cap_rows
            and (i + ids) / ((r + sh.input_dim) / rpp) >= threshold):
          assign[id(sh)] = cur
          bins[cur][0] += sh.input_dim
          bins[cur][1] += ids
          continue
      if (sh.input_dim <= cap_rows
          and ids / max(1.0, sh.input_dim / rpp) >= threshold):
        cur = len(bins)
        bins.append([sh.input_dim, ids])
        assign[id(sh)] = cur
      else:
        slow.append(sh)
    # slow pool: plain FFD by rows (composition cannot change its regime)
    for sh in sorted(slow, key=lambda s: (-s.input_dim, s.table_id)):
      placed = False
      for g in range(len(bins)):
        if bins[g][1] == -1 and bins[g][0] + sh.input_dim <= cap_rows:
          assign[id(sh)] = g
          bins[g][0] += sh.input_dim
          placed = True
          break
      if not placed:
        assign[id(sh)] = len(bins)
        bins.append([sh.input_dim, -1])
    return assign if assign else None

  def table_vocab_capacity(self, table_id: int) -> int:
    """Allocatable rows of one table under ``oov='allocate'``: the
    table's own ``TableConfig.vocab_capacity`` when set, else the
    plan-level ``vocab_capacity``, else the full ``input_dim``."""
    cfg = self.global_configs[table_id]
    cap = cfg.input_dim
    if getattr(self, "vocab_capacity", None) is not None:
      cap = min(cap, self.vocab_capacity)
    if getattr(cfg, "vocab_capacity", None) is not None:
      cap = min(cap, cfg.vocab_capacity)
    return cap

  def table_tier(self, table_id: int) -> str:
    """Storage tier of one table: 'host' (cold store + hot cache) or
    'device' (fully HBM-resident)."""
    if self.host_row_threshold is None:
      return "device"
    return ("host"
            if self.global_configs[table_id].input_dim
            > self.host_row_threshold else "device")

  def host_tier_class_keys(self) -> List[ClassKey]:
    """Class keys whose buffers are host-offloaded (in class_keys order)."""
    return [k for k in self.class_keys if self.class_tiers[k] == "host"]

  def tier_capacity_report(self, n_aux: int = 1) -> Dict[str, object]:
    """Per-rank storage accounting by tier.

    Sizes each class's packed buffer under ``n_aux`` interleaved
    optimizer-state slots (1 = Adagrad-style, the conservative default
    the generation assignment also uses; dense classes have no aux
    lanes). Dense-class buffers are estimated at ``max_rows`` — the
    one-hot window tail padding (``lookup_engine.padded_rows``) adds a
    little on top for small-vocab classes. Host-tier entries report the
    COLD STORE footprint; the device side of a host-tier class (hot
    cache + staging + resident map) is chosen by the tiering planner
    against ``hbm_budget_bytes`` (`tiering/plan.py`)."""
    from ..ops.packed_table import PackedLayout

    device = host = 0
    classes = {}
    for key in self.class_keys:
      cp = self.classes[key]
      if cp.kind == "dense":
        nbytes = cp.max_rows * cp.width * 4
      else:
        lay = PackedLayout(rows=cp.max_rows, width=cp.width, n_aux=n_aux)
        nbytes = lay.phys_rows * lay.phys_width * 4
      tier = self.class_tiers[key]
      classes[key] = {"tier": tier, "bytes_per_rank": nbytes}
      if tier == "host":
        host += nbytes
      else:
        device += nbytes
    return {
        "device_bytes_per_rank": device,
        "host_bytes_per_rank": host,
        "hbm_budget_bytes": self.hbm_budget_bytes,
        "classes": classes,
    }

  def exchange_report(self) -> Dict[str, object]:
    """Wire-format summary of the dp<->mp exchange path.

    Per class: its kind and whether the deduplicated exchange applies to
    its padded buckets (sparse-kind classes only — dense MXU classes have
    no row gather to dedup, and ragged value streams already scale with
    the true id count, so both keep the raw exchange; a class serving a
    call-time-ragged input routes that bucket raw even when ``dedup``
    reports True here). ``float_wire_bytes_per_value`` is the in-flight
    element size of activation/cotangent payloads under ``wire_dtype``.
    ``rounds_per_exchange`` is the pipelined schedule's collective count
    per exchange: ``(world - 1) * exchange_chunks`` ppermute rounds
    under ``overlap='pipelined'`` or ``'fused'`` (the jaxpr audit pins
    exactly this per artifact; fused sparse-class exchanges may carry
    fewer when a block has fewer rows than chunks — the per-bucket chunk
    count caps at the row count), 1 monolithic all_to_all otherwise.
    ``jit_gather`` reports whether the fused just-in-time per-round
    gather schedule is active.
    """
    from ..parallel.lookup_engine import class_param_name
    classes = {}
    for key in self.class_keys:
      cp = self.classes[key]
      classes[class_param_name(*key)] = {
          "kind": cp.kind,
          "width": cp.width,
          "dedup": bool(self.dedup_exchange and cp.kind == "sparse"
                        and self.world_size > 1),
      }
    pipelined = (self.overlap in ("pipelined", "fused")
                 and self.world_size > 1)
    return {
        "wire_dtype": self.wire_dtype,
        "dedup_exchange": self.dedup_exchange,
        "dedup_capacity": self.dedup_capacity,
        "float_wire_bytes_per_value": {"f32": 4, "bf16": 2,
                                       "fp8": 1}[self.wire_dtype],
        "overlap": self.overlap,
        "exchange_chunks": self.exchange_chunks,
        "rounds_per_exchange": ((self.world_size - 1) * self.exchange_chunks
                                if pipelined else
                                (1 if self.world_size > 1 else 0)),
        "jit_gather": self.overlap == "fused" and self.world_size > 1,
        "world_size": self.world_size,
        "classes": classes,
    }

  def _kind_of(self, shard: Shard) -> str:
    # row shards always take the gather path: the one-hot window trick
    # assumes slot-local ids cover the full table from offset 0
    if shard.row_sliced:
      return "sparse"
    # tables declared ragged-fed (negative input_hotness hint) stay on the
    # sparse path: the MXU one-hot lookup has no value-stream form, and
    # demoting at plan time is what lets ragged inputs reach ANY
    # non-row-sliced table (reference parity: embedding_lookup_ops.py
    # accepts ragged into any single-process layer)
    if shard.table_id in self._ragged_tables:
      return "sparse"
    return ("dense" if shard.input_dim <= self.dense_row_threshold
            else "sparse")

  def class_key_of(self, shard: Shard) -> ClassKey:
    return (shard.width, shard.combiner, self._kind_of(shard), shard.gen)

  def table_shard_map(self, table_id: int) -> List[Tuple[int, Shard]]:
    """All (rank, shard) holding part of ``table_id``, in (column, row)
    order — column slices concat along width, row slices along vocab."""
    entries = []
    for rank, shards in enumerate(self.rank_shards):
      for sh in shards:
        if sh.table_id == table_id:
          entries.append((rank, sh))
    entries.sort(key=lambda e: (e[1].col_start, e[1].row_start))
    return entries

  def routing_recipe(self, key) -> List[List[Tuple[int, int, int, int,
                                                   int, bool]]]:
    """Host-side routing slots of one class, per rank: ``(input_id,
    row_offset, row_start, shard_rows, vocab, row_sliced)``.

    The numpy replica of the engine's in-trace id routing
    (``lookup_engine._build_routing``): a raw id of ``input_id`` lands on
    ``rank`` at logical row ``clip(id, 0, shard_rows - 1) + row_offset``
    (row-sliced shards keep only ids in ``[row_start, row_start +
    shard_rows)`` after the vocab clamp). One shared recipe so every
    host-side pass that must agree with the traced step's row targeting
    — the tiered prefetcher's classify, the streaming row-generation
    tracker — derives it from the plan instead of hand-copying the
    slot walk."""
    cp = self.classes[key]
    per_rank = []
    for rank in range(self.world_size):
      slots = []
      for slot in cp.slots_per_rank[rank]:
        sh = slot.shard
        vocab = self.global_configs[sh.table_id].input_dim
        slots.append((slot.input_id, slot.row_offset, sh.row_start,
                      sh.input_dim, vocab, sh.row_sliced))
      per_rank.append(slots)
    return per_rank


def routed_rows(slots, cats, ids_of):
  """Apply one rank's :meth:`DistEmbeddingStrategy.routing_recipe` slots
  to a batch: the LOGICAL rows this rank's block is addressed at, as one
  concatenated int64 array (valid ids only — hotness padding dropped;
  occurrences kept, for callers that count traffic).

  ``ids_of(x)`` flattens one input to a 1-D id array — callers differ
  only in their ragged-input policy (the tiered prefetcher refuses
  RaggedIds, the streaming tracker reads the value stream), so the
  routing arithmetic itself lives HERE, once: clip to the shard (or, row
  -sliced, clamp to the vocab then keep the shard's window) and offset
  into the rank block — exactly what the traced step's routing does."""
  import numpy as np
  routed_all = []
  for (input_id, off, row_start, rows, vocab, rs) in slots:
    ids = ids_of(cats[input_id])
    if rs:
      clamped = np.clip(ids, 0, vocab - 1)
      m = (ids >= 0) & (clamped >= row_start) \
          & (clamped < row_start + rows)
      routed = clamped[m] - row_start + off
    else:
      routed = np.clip(ids[ids >= 0], 0, rows - 1) + off
    routed_all.append(routed.astype(np.int64))
  if not routed_all:
    return np.zeros((0,), np.int64)
  return np.concatenate(routed_all)
