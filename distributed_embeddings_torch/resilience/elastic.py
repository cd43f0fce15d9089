"""Elastic worlds: re-shard a train state onto another world size, across
restarts and in the run, and the pod membership that says when (PyTorch
port of ``resilience/elastic.py``).

Three layers:

- **The regroup engine** (:func:`build_source_index`,
  :func:`read_logical_rows`, :func:`regroup_rank_block`,
  :func:`regroup_dense_flat`, :func:`remap_group_counts`): the
  window-streamed re-slicing of rank blocks at LOGICAL-row granularity,
  numpy over a row reader. ``checkpoint.restore``'s elastic path reads
  memory-mapped rank files through it, :func:`elastic_resize` live
  buffers and host-tier images, so the two paths are one implementation.
  The engine copies rows: a bf16 block moves as its 2-byte bit patterns
  (numpy ``'V2'``, the dtype ``np.load`` gives the JAX package's bf16
  files), so every logical row, table and optimizer lanes, is bit-equal
  across the move in f32 and bf16 alike; padding rows are zero.
- **:func:`elastic_resize`**: the in-run world change. It quiesces (a
  ``torch.cuda.synchronize`` of the state's device, then the old store's
  flush, timed into ``elastic/quiesce_s``), regroups every packed rank
  block, the host-tier images with their observed counts, and the
  dense-class blocks with their optimizer leaves, and counts
  ``elastic/resizes``. Without meshes it re-shards a whole-world state
  held in one process (every rank's blocks: the JAX package's
  single-controller form). Across processes (``old_mesh`` / ``new_mesh``
  / ``pod``) each process of the old world spills its blocks into the pod
  directory as a checkpoint of the old world, the pod meets at a
  file-based barrier (it needs no process group), the default process
  group is torn down and formed again at the new world from a new
  rendezvous, and every rank of the new world window-reads its own
  targets from the spill (``checkpoint.restore``'s elastic path); a
  process outside the new world parks.
- **Pod membership** (:func:`register_member`, :func:`alive_members`,
  :func:`membership_barrier`, :class:`PreemptionSupervisor`): pid-based
  lease files under ``<pod_dir>/members/`` and step-boundary barriers
  under ``<pod_dir>/barriers/``, plain files, so that a pod agrees on a
  world change without a process group.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry as _telemetry
from ..ops.packed_table import PackedLayout
from ..parallel.lookup_engine import class_param_name, padded_rows
from . import faultinject

# fired once per source window a live resize reads: the in-memory
# counterpart of checkpoint.restore's "reshard_gather"
RESIZE_GATHER_SITE = faultinject.register_site("resize_gather")

MEMBER_DIR = "members"
BARRIER_DIR = "barriers"
RENDEZVOUS_DIR = "rendezvous"

# a bf16 block in the engine: its bit patterns, as np.load reads the
# JAX package's '<V2' files
BF16_BITS = np.dtype("V2")


# ---------------------------------------------------------------------------
# tensors <-> host arrays, nested dicts -> path-keyed flat dicts
# ---------------------------------------------------------------------------


def to_host(leaf):
  """A tensor (any device) or array leaf on the host, for the npy and npz
  writers: f32 and integer tensors as numpy arrays, bf16 tensors as host
  tensors (``hostarrays`` writes their bits under the JAX package's
  ``'<V2'`` descr)."""
  if isinstance(leaf, torch.Tensor):
    leaf = leaf.detach().cpu()
    return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
  return np.asarray(leaf)


def flatten_with_paths(tree) -> Dict[str, Any]:
  """Nested dicts of tensors or arrays -> ``{'a/b/c': host leaf}``, the
  JAX package's path spelling for a tree of dicts (keys in sorted order,
  as its pytree flattening visits them)."""
  flat: Dict[str, Any] = {}

  def walk(prefix, node):
    if isinstance(node, dict):
      for k in sorted(node):
        walk(f"{prefix}/{k}" if prefix else str(k), node[k])
    else:
      flat[prefix] = to_host(node)

  walk("", tree)
  return flat


def block_bits(t) -> np.ndarray:
  """One packed block on the host as the engine holds it: an f32 array,
  or a bf16 block's bit patterns (``'V2'``)."""
  if isinstance(t, torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
      return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()
  arr = np.asarray(t)
  if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
    return arr.view(BF16_BITS)
  return arr


def block_tensor(arr: np.ndarray, device) -> torch.Tensor:
  """An engine block (:func:`block_bits`' form) as a tensor on
  ``device``: bf16 from its bits."""
  if arr.dtype == BF16_BITS:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
        torch.bfloat16).to(device, copy=True)
  return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


def _pack(lay: PackedLayout, parts: np.ndarray) -> np.ndarray:
  """``lay.pack`` of ``[1 + n_aux, rows, width]`` parts, numpy in and
  out; bf16 parts move as their bits."""
  bits = parts.dtype == BF16_BITS
  ts = [torch.from_numpy(np.ascontiguousarray(
      p.view(np.int16) if bits else p)) for p in parts]
  out = lay.pack(ts[0], ts[1:]).numpy()
  return out.view(BF16_BITS) if bits else out


# ---------------------------------------------------------------------------
# plan -> source-world description (the checkpoint manifest's layout and
# world sections are exactly these)
# ---------------------------------------------------------------------------


def plan_layout(plan) -> Dict[str, list]:
  """Per class, per rank, the slot windows ``[table_id, row_offset,
  row_start, input_dim, col_start, col_end, row_sliced]``: the checkpoint
  fingerprint's ``layout`` section, and the regroup engine's description
  of where every logical table row lives."""
  layout = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    layout[class_param_name(*key)] = [
        [[int(s.shard.table_id), int(s.row_offset), int(s.shard.row_start),
          int(s.shard.input_dim), int(s.shard.col_start),
          int(s.shard.col_end), int(s.shard.row_sliced)]
         for s in slots]
        for slots in cp.slots_per_rank]
  return layout


def plan_world_classes(plan) -> Dict[str, dict]:
  """Per class name: kind, tier, per-rank logical rows and width (the
  checkpoint manifest's ``world.classes`` section)."""
  classes = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    classes[class_param_name(*key)] = {
        "kind": cp.kind,
        "tier": plan.class_tiers.get(key, "device"),
        "rows": int(padded_rows(plan, key)),
        "width": int(cp.width),
    }
  return classes


def plan_for_world(plan, world: int):
  """The same tables, strategy and knobs re-planned at ``world`` ranks:
  every layout-shaping knob the plan keeps is forwarded, so the two plans
  differ only in placement."""
  from ..layers.planner import DistEmbeddingStrategy
  return DistEmbeddingStrategy(
      list(plan.global_configs), int(world), plan.strategy,
      input_table_map=list(plan.input_table_map),
      column_slice_threshold=plan.column_slice_threshold,
      dense_row_threshold=plan.dense_row_threshold,
      max_class_bytes=plan.max_class_bytes,
      row_slice_threshold=plan.row_slice_threshold,
      input_hotness=plan.input_hotness,
      batch_hint=plan.batch_hint,
      gen_assignment=plan.gen_assignment,
      host_row_threshold=plan.host_row_threshold,
      hbm_budget_bytes=plan.hbm_budget_bytes,
      oov=plan.oov,
      vocab_capacity=plan.vocab_capacity,
      admit_threshold=plan.admit_threshold,
      evict_ttl=plan.evict_ttl,
      wire_dtype=plan.wire_dtype,
      dedup_exchange=plan.dedup_exchange,
      overlap=plan.overlap,
      exchange_chunks=plan.exchange_chunks,
      dedup_capacity=plan.dedup_capacity,
      buffer_elements=plan.buffer_elements)


def resize_reason(old_plan, new_plan) -> Optional[str]:
  """None when the old world's state can re-shard onto ``new_plan``, else
  the reason it cannot (the JAX package's messages). Bridgeable: anything
  that only moves logical rows between rank blocks. Not bridgeable:
  different tables, a different input->table map, a table changing tier
  or sparse/dense kind."""

  def tables(p):
    return [[c.input_dim, c.output_dim, c.combiner] for c in p.global_configs]

  def kinds(p):
    out: Dict[int, str] = {}
    for key in p.class_keys:
      cp = p.classes[key]
      for slots in cp.slots_per_rank:
        for s in slots:
          out[s.shard.table_id] = cp.kind
    return out

  if tables(old_plan) != tables(new_plan):
    return "the logical tables differ (vocab/width/combiner)"
  if list(old_plan.input_table_map) != list(new_plan.input_table_map):
    return "the input->table map differs"
  ko, kn = kinds(old_plan), kinds(new_plan)
  for t in sorted(ko):
    if old_plan.table_tier(t) != new_plan.table_tier(t):
      return (f"table {t} sits on the {old_plan.table_tier(t)!r} tier in "
              f"the old world but {new_plan.table_tier(t)!r} in the new — "
              "cross-tier moves need a format conversion, not an elastic "
              "re-shard (keep host_row_threshold across the resize)")
    if ko[t] != kn.get(t):
      return (f"table {t} is {ko[t]!r}-kind in the old world but "
              f"{kn.get(t)!r}-kind in the new — the sparse<->dense "
              "storage formats differ (packed aux lanes vs optax state); "
              "keep dense_row_threshold across the resize")
  return None


# ---------------------------------------------------------------------------
# the regroup engine
# ---------------------------------------------------------------------------


def build_source_index(src_classes: Dict[str, dict],
                       src_layout: Dict[str, list],
                       n_src: int, n_aux: int) -> Dict[int, set]:
  """Where each sparse table's rows and columns live in the SOURCE world:
  ``table_id -> {((class, rank), layout, row_offset, row_start, rows, c0,
  c1)}`` (a set: shared tables list one shard once per feeding slot). The
  ``(class, rank)`` tag keys the caller's row reader."""
  out: Dict[int, set] = {}
  for cname in sorted(src_classes):
    meta = src_classes[cname]
    if meta["kind"] != "sparse":
      continue
    lay = PackedLayout(rows=int(meta["rows"]), width=int(meta["width"]),
                       n_aux=n_aux)
    for rank in range(n_src):
      for slot in src_layout[cname][rank]:
        t, off, rs0, nrows, c0, c1, _rs = (int(v) for v in slot)
        out.setdefault(t, set()).add(
            ((cname, rank), lay, off, rs0, nrows, c0, c1))
  return out


def read_logical_rows(lay: PackedLayout, phys_reader: Callable,
                      lo: int, hi: int, n_aux: int) -> np.ndarray:
  """Logical rows ``[lo, hi)`` of one packed rank block as ``[1 + n_aux,
  hi - lo, width]``. ``phys_reader(p0, p1)`` returns the covering PHYSICAL
  rows ``[p0, p1)`` (:func:`block_bits`' form); only those are ever
  materialized."""
  rpp = lay.rows_per_phys
  p0, p1 = lo // rpp, -(-hi // rpp)
  sub = block_bits(phys_reader(p0, p1))
  sublay = PackedLayout(rows=(p1 - p0) * rpp, width=lay.width, n_aux=n_aux)
  tbl, aux = sublay.unpack(sub)
  skip = lo - p0 * rpp
  return np.stack([tbl] + list(aux))[:, skip:skip + (hi - lo)]


def regroup_rank_block(plan, key, lay_log: PackedLayout, rank: int,
                       src_slots: Dict[int, set], read_rows: Callable,
                       n_aux: int, dtype=np.float32) -> np.ndarray:
  """One TARGET rank's packed block of a sparse class, window-streamed.

  ``read_rows(tag, lay, lo, hi)`` returns logical rows ``[lo, hi)`` of the
  source block named by ``tag`` as ``[1 + n_aux, hi - lo, width]``. The
  saved slots of each table partition its rows x cols, so the 2-D overlaps
  below cover the target window exactly, whatever the two worlds'
  slicings. Pack and unpack are exact inverses, so every logical row
  (table and optimizer lanes) is bit-equal across the move; padding rows
  are zero. ``dtype`` is the blocks' (f32, or :data:`BF16_BITS`)."""
  cp = plan.classes[key]
  parts = np.zeros((1 + n_aux, lay_log.rows, cp.width), dtype)
  for s in cp.slots_per_rank[rank]:
    sh = s.shard
    for (tag, lay, off_s, rs0_s, n_s, c0_s, c1_s) \
        in sorted(src_slots[sh.table_id], key=lambda v: (v[0], v[2:])):
      r0 = max(sh.row_start, rs0_s)
      r1 = min(sh.row_start + sh.input_dim, rs0_s + n_s)
      ca = max(sh.col_start, c0_s)
      cb = min(sh.col_end, c1_s)
      if r0 >= r1 or ca >= cb:
        continue
      win = read_rows(tag, lay, off_s + (r0 - rs0_s), off_s + (r1 - rs0_s))
      if win.dtype != parts.dtype:
        raise ValueError(
            f"source block {tag} holds {win.dtype} rows, the target "
            f"{parts.dtype}: a re-shard moves rows, it converts no type")
      parts[:, s.row_offset + (r0 - sh.row_start):
            s.row_offset + (r1 - sh.row_start),
            ca - sh.col_start:cb - sh.col_start] = \
          win[:, :, ca - c0_s:cb - c0_s]
  return _pack(lay_log, parts)


def regroup_dense_flat(flat_src: Dict[str, Any],
                       src_classes: Dict[str, dict],
                       src_layout: Dict[str, list],
                       n_src: int, plan) -> Dict[str, Any]:
  """Re-shard the class-block-shaped leaves of a flat (path-keyed) dict
  onto the new plan's dense-kind classes; other leaves (optax counts)
  pass through. Covers the dense-class tables and every class-shaped
  optimizer leaf by the same table windows. Leaves are numpy arrays
  (bf16 ones as ``'V2'`` bits)."""
  src_dense = {n: m for n, m in src_classes.items() if m["kind"] == "dense"}
  cfgs = plan.global_configs
  per_prefix: Dict[str, Dict[int, np.ndarray]] = {}
  out: Dict[str, Any] = {}
  for key_str, arr in flat_src.items():
    head, _, last = key_str.rpartition("/")
    meta = src_dense.get(last)
    if meta is None or getattr(arr, "ndim", 0) != 2 \
        or arr.shape[0] != n_src * int(meta["rows"]):
      out[key_str] = arr
      continue
    arr = block_bits(arr)
    rows_src = int(meta["rows"])
    per_t = per_prefix.setdefault(head, {})
    for rank in range(n_src):
      for slot in src_layout[last][rank]:
        t, off, rs0, nrows, c0, c1, _rs = (int(v) for v in slot)
        dstt = per_t.get(t)
        if dstt is None:
          dstt = per_t[t] = np.zeros(
              (cfgs[t].input_dim, cfgs[t].output_dim), arr.dtype)
        base = rank * rows_src + off
        dstt[rs0:rs0 + nrows, c0:c1] = arr[base:base + nrows]
  for head, per_t in per_prefix.items():
    for key in plan.class_keys:
      cp = plan.classes[key]
      if cp.kind == "sparse":
        continue
      name = class_param_name(*key)
      rows_dst = padded_rows(plan, key)
      dtype = next(iter(per_t.values())).dtype
      block = np.zeros((plan.world_size * rows_dst, cp.width), dtype)
      for rank in range(plan.world_size):
        for s in cp.slots_per_rank[rank]:
          sh = s.shard
          base = rank * rows_dst + s.row_offset
          block[base:base + sh.input_dim] = \
              per_t[sh.table_id][sh.row_start:sh.row_start + sh.input_dim,
                                 sh.col_start:sh.col_end]
      out[(head + "/" + name) if head else name] = block
  return out


def remap_group_counts(src_classes: Dict[str, dict],
                       src_layout: Dict[str, list],
                       n_src: int, n_aux: int,
                       counts_of: Callable,
                       plan, store) -> Optional[Dict[str, list]]:
  """Window-wise re-map of host-tier observed counts across a re-shard.

  ``counts_of(cname, rank)`` returns one source rank's per-physical-row
  counts, or None. Each covered LOGICAL table row inherits its group's
  count (overlapping sources merge by max: column slices of one table see
  one stream), then each target rank's groups max-pool their logical rows
  (an N -> N round trip is exact). Writes ``store.counts`` in place and
  returns the count-descending ``warm_start`` ranking (ties row-id
  ascending, the re-rank's tie policy), or None without source counts."""
  cfgs = plan.global_configs
  table_counts: Dict[int, np.ndarray] = {}
  found = False
  for cname in sorted(src_classes):
    meta = src_classes[cname]
    if meta["tier"] != "host":
      continue
    lay = PackedLayout(rows=int(meta["rows"]), width=int(meta["width"]),
                       n_aux=n_aux)
    rpp = lay.rows_per_phys
    for rank in range(n_src):
      cnt = counts_of(cname, rank)
      if cnt is None:
        continue
      found = True
      cnt = np.asarray(cnt, np.int64)
      for slot in src_layout[cname][rank]:
        t, off, rs0, nrows, _c0, _c1, _rs = (int(v) for v in slot)
        tc = table_counts.get(t)
        if tc is None:
          tc = table_counts[t] = np.zeros((cfgs[t].input_dim,), np.int64)
        vals = cnt[(off + np.arange(nrows)) // rpp]
        np.maximum(tc[rs0:rs0 + nrows], vals, out=tc[rs0:rs0 + nrows])
  if not found:
    return None
  ranking: Dict[str, list] = {}
  for key in plan.host_tier_class_keys():
    cp = plan.classes[key]
    name = class_param_name(*key)
    lay = store.tplan.by_name(name).layout_logical
    rpp = lay.rows_per_phys
    per_rank = []
    for rank in range(plan.world_size):
      arr = np.zeros((lay.phys_rows,), np.int64)
      for sh, off in zip(cp.shards_per_rank[rank],
                         cp.row_offsets_per_rank[rank]):
        tc = table_counts.get(sh.table_id)
        if tc is None:
          continue
        grp = (off + np.arange(sh.input_dim)) // rpp
        np.maximum.at(arr, grp,
                      tc[sh.row_start:sh.row_start + sh.input_dim])
      dst = store.counts[name][rank]
      if dst is not None:
        dst[:] = arr
      # count-desc, row-id-asc ties (stable argsort over ascending ids)
      per_rank.append(np.argsort(-arr, kind="stable").astype(np.int32))
    ranking[name] = per_rank
  return ranking


# ---------------------------------------------------------------------------
# the in-run resize
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodSync:
  """The file-based meeting points of one membership change: ``n``
  participants (the old world's processes and every process joining or
  parking) under ``pod_dir``, this one named ``member_id``, the change
  numbered ``epoch``. Needs no process group."""

  pod_dir: str
  epoch: int
  member_id: str
  n: int
  timeout_s: float = 60.0

  def barrier(self, tag: str) -> None:
    """Every participant reaches ``tag`` of this epoch."""
    _file_barrier(os.path.join(self.pod_dir, BARRIER_DIR,
                               f"{int(self.epoch):06d}_{tag}"),
                  self.member_id, self.n, self.timeout_s,
                  f"resize epoch {self.epoch} {tag}")

  def init_method(self) -> str:
    """A rendezvous no earlier group used: a file under the pod directory
    named by the epoch."""
    d = os.path.join(os.path.abspath(self.pod_dir), RENDEZVOUS_DIR)
    os.makedirs(d, exist_ok=True)
    return f"file://{d}/{int(self.epoch):06d}"


def _file_barrier(d: str, member_id: str, n: int, timeout_s: float,
                  what: str) -> Dict[str, dict]:
  """Post ``member_id``'s record under ``d`` and wait until ``n`` records
  are there; returns them."""
  from ..telemetry import atomic_write_text
  os.makedirs(d, exist_ok=True)
  atomic_write_text(os.path.join(d, f"{member_id}.json"),
                    json.dumps({"id": member_id}))
  deadline = time.monotonic() + timeout_s
  while True:
    recs = _records(d)
    if len(recs) >= int(n):
      return recs
    if time.monotonic() >= deadline:
      raise RuntimeError(
          f"{what}: only {sorted(recs)} of {n} participants arrived "
          f"within {timeout_s:.0f}s")
    time.sleep(0.02)


def _records(d: str) -> Dict[str, dict]:
  recs: Dict[str, dict] = {}
  try:
    names = sorted(os.listdir(d))
  except OSError:
    return recs
  for name in names:
    if not name.endswith(".json"):
      continue
    try:
      with open(os.path.join(d, name)) as f:
        rec = json.load(f)
      recs[str(rec["id"])] = rec
    except (OSError, ValueError, KeyError, TypeError):
      continue  # torn or foreign: the poll sees it next pass
  return recs


def _quiesce(state, old_store, reg) -> None:
  """Nothing in flight while blocks are read: the state's device drained,
  then the resident rows flushed into the old store's images."""
  with _telemetry.timed("elastic/quiesce_s", reg):
    devs = {t.device for part in ("fused", "dense", "emb_dense")
            for t in state[part].values()}
    for dev in devs:
      if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if old_store is not None:
      old_store.flush(state["fused"])


def _check_stores(old_plan, new_plan, old_store, new_store) -> None:
  """The stores a resize needs: the old one where the old plan has
  host-tier classes (``old_plan`` None: this process held no state), the
  new one where the new plan has (``new_plan`` None: this process
  parks)."""
  old_host = {class_param_name(*k) for k in old_plan.host_tier_class_keys()} \
      if old_plan is not None else set()
  if old_host and old_store is None:
    raise ValueError(
        "the old plan has host-tier classes but no HostTierStore was "
        "passed (old_store=...): their authoritative rows live in its "
        "images, and the quiesce must flush the resident device rows "
        "into them first.")
  if new_plan is None:
    return
  new_host = {class_param_name(*k) for k in new_plan.host_tier_class_keys()}
  if new_host and new_store is None:
    raise ValueError(
        "the new plan has host-tier classes but no HostTierStore was "
        "passed (new_store=...): the re-sharded cold images have "
        "nowhere to live otherwise.")
  if new_store is not None \
      and set(new_store.tplan.tier_specs) != new_host:
    raise ValueError(
        f"new_store geometry {sorted(new_store.tplan.tier_specs)} does "
        f"not cover the new plan's host-tier classes {sorted(new_host)}: "
        "build the HostTierStore from a TieringPlan of the NEW plan")


def elastic_resize(state: Optional[Dict[str, Any]], old_plan, new_world,
                   rule, *, new_mesh=None, old_mesh=None, old_store=None,
                   new_store=None, telemetry=None,
                   spill_dir: Optional[str] = None, pod: Optional[PodSync] = None,
                   state_like=None, extra=None, manifest_out=None,
                   device=None) -> Tuple[Any, Optional[Dict[str, Any]]]:
  """Re-shard a train state onto a different world, in the run.

  Every logical row (table and interleaved optimizer lanes) is bit-equal
  across the move, in f32 and bf16; padding rows are zero.

  Args:
    state: the old world's train state (``fused`` / ``dense`` /
      ``dense_opt`` / ``emb_dense`` / ``emb_dense_opt`` / ``step``); None
      in a pod process that held none (it joins or stays parked).
    old_plan: the plan ``state`` was built under.
    new_world: a world size (the new plan from :func:`plan_for_world`) or
      a plan.
    rule: the sparse rule (unchanged across a resize).
    new_mesh / old_mesh: this process's ``Mesh`` in the new and old
      worlds. Both None: ``state`` holds every rank's blocks and so does
      the result (one process; the new state's tensors on ``device``, by
      default the state's). Across processes ``new_mesh`` is None in a
      process that parks.
    old_store / new_store: the two worlds' ``HostTierStore``s of a tiered
      plan (the new one owns the new mesh's rank across processes). The
      quiesce flushes the resident rows into ``old_store``; the
      re-sharded images land in ``new_store``, its resident sets follow
      the re-mapped observed counts.
    telemetry: registry of ``elastic/resizes``, ``elastic/quiesce_s`` and
      (across processes) ``elastic/regroup_s``.
    spill_dir: pod-shared directory of the cross-process spill (a
      checkpoint of the old world under ``resize_<epoch>_w<N>to<M>``,
      removed after the move).
    pod: the membership change's :class:`PodSync`, required across
      processes: the spill barrier, the group's new rendezvous and the
      completion barrier.
    state_like: across processes, a template of the state (the dense
      parameters' names and shapes, the optimizers' kinds); default
      ``state``.
    extra: across processes, the JSON the spill's manifest carries
      (``ResilientTrainer`` passes its stream accounting).
    manifest_out: a dict that receives the spill's manifest.

  Returns ``(new_plan, new_state)``; ``new_state`` is None in a process
  that parks. Unbridgeable plan differences are refused with the reason
  named, as the restore path refuses them.
  """
  reg = telemetry if telemetry is not None else _telemetry.get_registry()
  new_plan = plan_for_world(old_plan, new_world) \
      if isinstance(new_world, int) else new_world
  reason = resize_reason(old_plan, new_plan)
  if reason is not None:
    raise ValueError(
        f"the live state cannot be elastically re-sharded onto the new "
        f"plan ({reason}).")
  # a process that held nothing needs no old store, one that parks no new
  _check_stores(old_plan if state is not None else None,
                new_plan if (new_mesh is not None or pod is None) else None,
                old_store, new_store)
  multi = pod is not None or old_mesh is not None or new_mesh is not None \
      or any(st is not None and not st.owns_all
             for st in (old_store, new_store))
  if multi:
    return _resize_across_processes(
        state, old_plan, new_plan, rule, new_mesh=new_mesh,
        old_mesh=old_mesh, old_store=old_store, new_store=new_store,
        reg=reg, spill_dir=spill_dir, pod=pod,
        state_like=state if state_like is None else state_like,
        extra=extra, manifest_out=manifest_out)
  if state is None:
    raise ValueError("elastic_resize without meshes re-shards a state "
                     "held in this process: pass it")
  return new_plan, _resize_in_process(state, old_plan, new_plan, rule,
                                      old_store, new_store, reg, device)


def _resize_in_process(state, old_plan, new_plan, rule, old_store,
                       new_store, reg, device) -> Dict[str, Any]:
  """The whole-world form: every rank's blocks in this process, read
  straight from the live buffers and images, one source window at a
  time."""
  from ..checkpoint import _assemble_state, _part_flats
  n_aux = rule.n_aux
  old_tiered = frozenset(old_store.tplan.tier_specs) \
      if old_store is not None else frozenset()
  _quiesce(state, old_store, reg)
  src_classes = plan_world_classes(old_plan)
  src_layout = plan_layout(old_plan)
  n_src = old_plan.world_size
  src_slots = build_source_index(src_classes, src_layout, n_src, n_aux)
  dev = device
  if dev is None:
    for part in ("fused", "dense", "emb_dense"):
      for t in state[part].values():
        dev = t.device
        break
      if dev is not None:
        break

  def read_rows(tag, lay, lo, hi):
    cname, rank = tag
    faultinject.fire("resize_gather", clazz=cname, rank=rank, rows=hi - lo)
    if cname in old_tiered:
      img = old_store.images[cname][rank]
      reader = lambda p0, p1, img=img: img[p0:p1]  # noqa: E731
    else:
      arr = state["fused"][cname]
      base = rank * lay.phys_rows
      # one window on the host at a time
      reader = lambda p0, p1, arr=arr, base=base: arr[base + p0:  # noqa: E731
                                                      base + p1]
    return read_logical_rows(lay, reader, lo, hi, n_aux)

  dtype = _fused_dtype(state["fused"])
  new_tiered = frozenset(new_store.tplan.tier_specs) \
      if new_store is not None else frozenset()
  fused: Dict[str, torch.Tensor] = {}
  for key in new_plan.class_keys:
    cp = new_plan.classes[key]
    if cp.kind != "sparse":
      continue
    name = class_param_name(*key)
    lay_log = PackedLayout(rows=padded_rows(new_plan, key), width=cp.width,
                           n_aux=n_aux)
    if name in new_tiered:
      for rank in new_store.owned_ranks:
        new_store.set_image(name, rank, regroup_rank_block(
            new_plan, key, lay_log, rank, src_slots, read_rows, n_aux,
            new_store.dtype))
      continue
    fused[name] = block_tensor(np.concatenate(
        [regroup_rank_block(new_plan, key, lay_log, r, src_slots, read_rows,
                            n_aux, dtype)
         for r in range(new_plan.world_size)]), dev)

  if new_store is not None and new_tiered:
    def counts_of(cname, rank):
      if old_store is None or cname not in old_store.counts:
        return None
      return old_store.counts[cname][rank]

    ranking = remap_group_counts(src_classes, src_layout, n_src, n_aux,
                                 counts_of, new_plan, new_store)
    if ranking is None:
      for name in new_store.counts:
        for cnt in new_store.counts[name]:
          cnt[:] = 0
    new_store.warm_start(ranking)
    fused.update(new_store.build_fused(None, dev))

  flats = _part_flats(state)
  for part in ("emb_dense", "emb_dense_opt"):
    flats[part] = regroup_dense_flat(flats[part], src_classes, src_layout,
                                     n_src, new_plan)
  new_state = _assemble_state(flats, state, new_plan, None, dev,
                              int(state["step"]), strict_tables=False)
  new_state["fused"] = fused
  reg.counter("elastic/resizes").inc()
  return new_state


def _fused_dtype(fused: Dict[str, torch.Tensor]):
  for t in fused.values():
    if t.dtype == torch.bfloat16:
      return BF16_BITS
  return np.float32


def _resize_across_processes(state, old_plan, new_plan, rule, *, new_mesh,
                             old_mesh, old_store, new_store, reg, spill_dir,
                             pod, state_like, extra, manifest_out):
  """The pod form: spill the old world as a checkpoint, meet, re-form the
  default process group at the new world, window-read this rank's
  targets, meet again, remove the spill."""
  from .. import checkpoint
  if pod is None or spill_dir is None:
    raise ValueError(
        "an elastic resize across processes needs spill_dir=... and pod="
        "PodSync(...): each process of the old world spills its blocks "
        "there, the pod meets at file barriers (the process group is "
        "re-formed in between), and every rank of the new world reads "
        "its targets back. Pass a pod-shared directory (e.g. "
        "<pod_dir>/spill).")
  if state is None and state_like is None:
    raise ValueError("a joining process needs state_like (a template of "
                     "the state: dense names and shapes, optimizer kinds)")
  if new_mesh is not None and new_mesh.world != new_plan.world_size:
    raise ValueError(f"new_mesh has {new_mesh.world} ranks, the new plan "
                     f"{new_plan.world_size}")
  spill_sub = os.path.join(
      spill_dir, f"resize_{int(pod.epoch):06d}_w{old_plan.world_size}to"
      f"{new_plan.world_size}")
  if state is not None:
    _quiesce(state, old_store, reg)
    # the old world writes itself as a checkpoint: every rank its blocks,
    # rank 0 the shared parts (a collective of the old group)
    checkpoint.save(spill_sub, old_plan, rule, state, store=old_store,
                    mesh=old_mesh, extra=extra, telemetry=reg)
  pod.barrier("spilled")
  if dist.is_initialized():
    dist.destroy_process_group()
  if new_mesh is not None and new_mesh.world > 1:
    from ..parallel.mesh import join_group
    join_group(new_mesh, pod.init_method())
  new_state = None
  if new_mesh is not None:
    manifest = checkpoint.read_manifest(spill_sub)
    if manifest_out is not None:
      manifest_out.update(manifest)
    with _telemetry.timed("elastic/regroup_s", reg):
      new_state = checkpoint.restore(
          spill_sub, new_plan, rule, state_like,
          mesh=new_mesh if new_mesh.world > 1 else None, store=new_store,
          verify_integrity=False, device=new_mesh.device)
  pod.barrier("regrouped")
  if new_mesh is not None and new_mesh.rank == 0:
    shutil.rmtree(spill_sub, ignore_errors=True)
  if new_mesh is not None:
    reg.counter("elastic/resizes").inc()
  return new_plan, new_state


# ---------------------------------------------------------------------------
# pod membership and preemption supervision
# ---------------------------------------------------------------------------


def member_path(pod_dir: str, member_id: str) -> str:
  return os.path.join(pod_dir, MEMBER_DIR, f"{member_id}.json")


def proc_start_ticks(pid: int) -> Optional[int]:
  """Kernel start time of ``pid`` in clock ticks (``/proc/<pid>/stat``
  field 22), or None when the process is gone or /proc is unavailable.
  Pins a lease to one incarnation of a pid: a recycled pid has another
  start time. Field 2 (comm) may hold spaces and parentheses, so parsing
  starts after the LAST ``)``."""
  try:
    with open(f"/proc/{pid}/stat", "rb") as f:
      data = f.read()
    return int(data[data.rindex(b")") + 1:].split()[19])
  except (OSError, ValueError, IndexError):
    return None


def register_member(pod_dir: str, member_id: str,
                    pid: Optional[int] = None) -> int:
  """Register one worker's liveness lease under ``<pod_dir>/members/``.

  The lease is pid-based: a killed worker writes no goodbye, but its pid
  stops existing once it is reaped, which :func:`alive_members` probes.
  Written atomically, so a scan never reads a torn lease."""
  from ..telemetry import atomic_write_text
  os.makedirs(os.path.join(pod_dir, MEMBER_DIR), exist_ok=True)
  pid = os.getpid() if pid is None else int(pid)
  atomic_write_text(member_path(pod_dir, member_id),
                    json.dumps({"id": member_id, "pid": pid,
                                "start": proc_start_ticks(pid)}))
  return pid


def withdraw_member(pod_dir: str, member_id: str) -> None:
  """Remove a lease: the graceful leave (a killed worker cannot; its dead
  pid drops it from the scan instead)."""
  try:
    os.remove(member_path(pod_dir, member_id))
  except OSError:
    pass


def alive_members(pod_dir: str) -> Dict[str, int]:
  """``id -> pid`` of the members whose lease exists and whose pid is
  alive (and is the lease's incarnation). Unreadable or foreign files
  are skipped; a pid this process may not signal still counts as
  alive."""
  out: Dict[str, int] = {}
  d = os.path.join(pod_dir, MEMBER_DIR)
  try:
    names = os.listdir(d)
  except OSError:
    return out
  for name in sorted(names):
    if not name.endswith(".json"):
      continue
    try:
      with open(os.path.join(d, name)) as f:
        rec = json.load(f)
      pid = int(rec["pid"])
      mid = str(rec["id"])
    except (OSError, ValueError, KeyError, TypeError):
      continue
    try:
      os.kill(pid, 0)  # liveness probe: signal 0 delivers nothing
    except ProcessLookupError:
      continue  # dead (and reaped): the lease is stale
    except PermissionError:
      pass  # exists, owned by another user: alive
    start = rec.get("start")
    if start is not None:
      cur = proc_start_ticks(pid)
      if cur is not None and cur != int(start):
        continue  # pid recycled: the lease's own process is gone
    out[mid] = pid
  return out


def membership_barrier(pod_dir: str, epoch: int, member_id: str,
                       n_participants: int, step: Optional[int], world: int,
                       timeout_s: float = 60.0) -> Tuple[int, int]:
  """All participants of a membership change agree on ONE step boundary.

  Each posts ``{"id", "step", "world"}`` under ``<pod_dir>/barriers/
  <epoch>/`` (atomic rename) and polls until ``n_participants`` records
  exist. Every record must carry the same ``(step, world)``: a member
  that raced one step past the others, or computed another world, fails
  loudly here. A parked process, which holds no state, posts ``step=
  None`` and adopts the others' step. Returns the agreed ``(step,
  world)``; ``epoch`` must be new for each membership change."""
  from ..telemetry import atomic_write_text
  d = os.path.join(pod_dir, BARRIER_DIR, f"{int(epoch):06d}")
  os.makedirs(d, exist_ok=True)
  atomic_write_text(
      os.path.join(d, f"{member_id}.json"),
      json.dumps({"id": member_id,
                  "step": None if step is None else int(step),
                  "world": int(world)}))
  deadline = time.monotonic() + timeout_s
  while True:
    recs: Dict[str, Tuple[Optional[int], int]] = {}
    for mid, rec in _records(d).items():
      try:
        recs[mid] = (None if rec["step"] is None else int(rec["step"]),
                     int(rec["world"]))
      except (KeyError, TypeError, ValueError):
        continue
    if len(recs) >= int(n_participants):
      break
    if time.monotonic() >= deadline:
      raise RuntimeError(
          f"membership barrier epoch {epoch}: only {sorted(recs)} of "
          f"{n_participants} participants arrived within {timeout_s:.0f}s "
          "— a survivor died between the membership change and the "
          "barrier; re-derive the target world and retry at a new epoch")
    time.sleep(0.05)
  steps = sorted({s for s, _ in recs.values() if s is not None})
  if step is None and len(steps) == 1:
    step = steps[0]
  want = (None if step is None else int(step), int(world))
  wrong = {m: sw for m, sw in recs.items()
           if sw[1] != want[1] or (sw[0] is not None and sw[0] != want[0])}
  if wrong or want[0] is None:
    raise RuntimeError(
        f"membership barrier epoch {epoch} DISAGREES: this member is at "
        f"step {step} targeting world {world}, but {wrong} — survivors "
        "must quiesce on a common step boundary before rank blocks "
        "regroup (resize exactly at the barrier's agreed step)")
  return want


def agreed_target_world(supervisor: "PreemptionSupervisor") -> int:
  """The pod's resize target as ONE number every rank agrees on: rank 0's
  observation, broadcast over the current process group (a collective:
  call it at the same point of every rank's loop)."""
  if not dist.is_initialized() or dist.get_world_size() <= 1:
    return supervisor.target_world()
  t = supervisor.target_world() if dist.get_rank() == 0 else 0
  backend = dist.get_backend()
  dev = (torch.device("cuda", torch.cuda.current_device())
         if backend == "nccl" else torch.device("cpu"))
  buf = torch.tensor([t], dtype=torch.int64, device=dev)
  dist.broadcast(buf, src=0)
  return int(buf.item())


def member_rank(members, member_id: str, world: int) -> Optional[int]:
  """This member's rank in a world of ``world`` ranks over ``members``,
  in membership order (sorted ids), or None when it parks."""
  order = sorted(members)
  i = order.index(member_id)
  return i if i < int(world) else None


class PreemptionSupervisor:
  """Maps live pod membership onto the world the run should be.

  Between steps the training loop asks :meth:`target_world`; when the
  answer differs from the current world it resizes
  (``ResilientTrainer.resize``): shrink when a worker was lost, grow when
  one registered again.

  Args:
    pod_dir: the directory whose ``members/`` leases define the pod.
    allowed_worlds: legal world sizes. ``target_world() = max(w in
      allowed_worlds with w <= alive)``, clamped to the smallest allowed
      world (a pod keeps training on its last survivor)."""

  def __init__(self, pod_dir: str, allowed_worlds=(1, 2, 4, 8)):
    worlds = tuple(sorted(set(int(w) for w in allowed_worlds)))
    if not worlds or worlds[0] < 1:
      raise ValueError(
          f"allowed_worlds must name at least one world >= 1, got "
          f"{allowed_worlds!r}")
    self.pod_dir = pod_dir
    self.allowed_worlds = worlds

  def members(self) -> Dict[str, int]:
    return alive_members(self.pod_dir)

  def target_world(self) -> int:
    n = len(self.members())
    fit = [w for w in self.allowed_worlds if w <= n]
    return fit[-1] if fit else self.allowed_worlds[0]


__all__ = [
    "PodSync",
    "PreemptionSupervisor",
    "agreed_target_world",
    "alive_members",
    "block_bits",
    "block_tensor",
    "build_source_index",
    "elastic_resize",
    "flatten_with_paths",
    "member_path",
    "member_rank",
    "membership_barrier",
    "plan_for_world",
    "plan_layout",
    "plan_world_classes",
    "proc_start_ticks",
    "read_logical_rows",
    "regroup_dense_flat",
    "regroup_rank_block",
    "register_member",
    "remap_group_counts",
    "resize_reason",
    "to_host",
    "withdraw_member",
]
