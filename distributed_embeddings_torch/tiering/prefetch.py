"""Prefetch stage of the tiered classes: classify, stage, write back,
re-rank (PyTorch port of ``tiering/prefetch.py``).

Runs on the host, AHEAD of the train step. Per step:

1. **classify**: the planner's routing arithmetic
   (``layers/planner.routed_rows``) in numpy over the GLOBAL batch gives,
   per (host-tier class, rank), the deduplicated requested physical rows,
   split hot/cold against the resident map; it also accumulates the
   per-row observed counts that drive the re-rank. Every process
   classifies every rank, so the padded staging size (a max over the
   ranks) comes out the same on every process with no collective;
2. **stage**: host-gather the cold rows (with their interleaved
   optimizer-state lanes) from the class image and upload them as this
   step's staging input: sorted ids and a row block, padded to the
   staging size. A batch whose cold rows overflow the base region spills
   into the next power-of-two bucket (a larger gather; no update is ever
   dropped);
3. **write_back**: after the step, download the post-scatter staging
   region and overwrite the staged rows in the host image (they are the
   new authoritative values); this download is the step's sync point;
4. **rerank** (periodic): promote the highest-count rows into the cache
   and evict the lowest, value-preserving swaps through the image, then
   refresh the device resident maps. Every rank's bookkeeping moves on
   every process; rows move only for the ranks this process owns.

The uploads and the download are plain synchronous copies from and to
pageable host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ragged import RaggedIds
from ..parallel.lookup_engine import TIER_PAD_GRP
from ..resilience import retry as _retry
from ..telemetry import get_registry as _registry, span as _span
from .plan import TieringPlan
from .store import HostTierStore, _host_rows


@dataclasses.dataclass
class StagedBatch:
  """One step's staging upload and the host-side info to write it back."""

  device: dict                       # step input: {"grps", "rows", "resident"}
  cold: Dict[str, List[np.ndarray]]  # per class, per rank: staged row ids
  s_eff: Dict[str, int]              # per class: padded staging size
  host_gather_bytes: int
  spilled: bool


@dataclasses.dataclass
class ColdBlocks:
  """The host half of one batch's staging: padded id and row blocks, all
  numpy (``gather_cold``), committed by ``upload_staged``."""

  cold: Dict[str, List[np.ndarray]]          # per class, per rank: sorted ids
  s_eff: Dict[str, int]                      # per class: padded staging size
  g_blocks: Dict[str, Dict[int, np.ndarray]]  # per class, per rank: padded ids
  r_blocks: Dict[str, Dict[int, np.ndarray]]  # owned ranks: padded row blocks
  host_gather_bytes: int
  spilled: bool


def _top_mask(counts: np.ndarray, k: int) -> np.ndarray:
  """The ``k`` physical rows of highest count as a boolean mask, ties
  broken by row id ascending: rows above the k-th count outright, rows AT
  it fill the remainder lowest-id first (the JAX re-rank's set, without
  its sort of the top rows: ``np.flatnonzero`` of the mask is that sorted
  list)."""
  cstar = counts[np.argpartition(-counts, k - 1)[:k]].min()
  mask = counts > cstar
  ties = np.flatnonzero(counts == cstar)[:k - int(np.count_nonzero(mask))]
  mask[ties] = True
  return mask


class TieredPrefetcher:
  """Host-side prefetch pipeline bound to one plan and store; its device
  inputs go to the mesh's device, else ``device``."""

  def __init__(self, tplan: TieringPlan, store: HostTierStore,
               mesh=None, device="cuda",
               retry_policy: _retry.RetryPolicy = _retry.DEFAULT_POLICY,
               telemetry=None):
    # the registry the gather/spill counters land in (default: the
    # process-wide one; a wrapping trainer may re-point it)
    self.telemetry = telemetry if telemetry is not None else _registry()
    # host gathers touch storage outside the step's control: a transient
    # OSError retries with backoff; other errors (the store's bounds
    # IndexError) propagate at once
    self.host_gather_retries = 0

    def _count_retry(attempt, exc):
      self.host_gather_retries += 1
      self.telemetry.counter("tiered/host_gather_retries").inc()

    self._count_retry = _count_retry
    self._retry_policy = retry_policy
    self.total_host_gather_bytes = 0
    self.spill_steps = 0
    self.tplan = tplan
    self.store = store
    self.plan = tplan.plan
    self.mesh = mesh
    self.device = mesh.device if mesh is not None else resolve_device(device)
    self.local_ranks = store.local_ranks(mesh)
    self._gather = _retry.retrying(store.gather, policy=retry_policy,
                                   on_retry=self._count_retry)
    self._recipe: Dict[tuple, List[list]] = {
        key: self.plan.routing_recipe(key) for key in tplan.classes}
    self._resident_dev = store.resident_arrays(mesh, self.device)
    self.steps_since_rerank = 0

  def refresh_resident(self) -> None:
    """Re-derive the device resident maps from the store. Call after
    anything rewrites the store's resident state outside the re-rank (a
    checkpoint restore): classifying against stale maps would stage the
    wrong cold rows and trip the ``missed > 0`` contract."""
    self._resident_dev = self.store.resident_arrays(self.mesh, self.device)

  # ---- classification ----------------------------------------------------
  @staticmethod
  def _input_ids_np(x) -> np.ndarray:
    if isinstance(x, RaggedIds):
      raise NotImplementedError(
          "tiered prefetch of RaggedIds inputs: classify over the value "
          "stream is not wired up yet — pad to dense multi-hot "
          "(ragged_to_padded) for host-tiered tables")
    if isinstance(x, torch.Tensor):
      x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)

  def classify(self, cats: Sequence) -> Dict[str, List[np.ndarray]]:
    """Global batch -> per class name, per rank, the deduplicated COLD
    physical rows; updates the observed counts (occurrences, so the
    re-rank weighs by traffic)."""
    with _span("tiered/classify"):
      cold, updates = self.classify_pure(cats)
      self.apply_counts(updates)
      return cold

  def classify_pure(self, cats: Sequence):
    """The classify pass WITHOUT its side effect: ``(cold,
    count_updates)``, the observed-count increments as data (``{name:
    [(req, occ), ...]}`` per rank) for :meth:`apply_counts`."""
    from ..layers.planner import routed_rows
    cold: Dict[str, List[np.ndarray]] = {}
    updates: Dict[str, list] = {}
    for key, c in self.tplan.classes.items():
      rpp = c.spec.rpp
      per_rank = []
      per_rank_updates = []
      for rank in range(self.plan.world_size):
        grps_occ = routed_rows(self._recipe[key][rank], cats,
                               self._input_ids_np) // rpp
        # one sort serves both: dedup for the split, counts for the rerank
        req, occ = np.unique(grps_occ, return_counts=True)
        req = self.store.check_rows(c.name, rank, req.astype(np.int32))
        per_rank_updates.append((req, occ))
        rmap = self.store.resident_map[c.name][rank]
        per_rank.append(req[rmap[req] < 0])
      cold[c.name] = per_rank
      updates[c.name] = per_rank_updates
    return cold, updates

  def apply_counts(self, count_updates: Dict[str, list]) -> None:
    """Commit :meth:`classify_pure`'s observed-count increments."""
    for name, per_rank in count_updates.items():
      for rank, (req, occ) in enumerate(per_rank):
        self.store.counts[name][rank][req] += occ

  # ---- staging -----------------------------------------------------------
  def _bucket(self, c, n: int) -> int:
    """Padded staging size for ``n`` deduplicated cold rows: the base
    region, or on overflow the next power-of-two multiple up to
    ``spill_factor_max``; demand past that pads to exactly ``n``. Clamped
    to the hard cap so compact ids stay under the sentinel."""
    base = c.spec.staging_grps
    fmax = self.tplan.config.spill_factor_max
    if n <= base:
      return base
    factor = 1
    while base * factor < n and factor < fmax:
      factor = min(factor * 2, fmax)
    s = min(max(base * factor, n), c.spill_cap_grps)
    if n > s:
      raise ValueError(
          f"class {c.name}: batch touches {n:,} distinct cold physical "
          f"rows but at most {s:,} can stage (cache {c.spec.cache_grps:,}"
          f" of {c.layout_logical.phys_rows:,} rows). This batch covers "
          "nearly the whole table — tiering cannot serve it; raise "
          "host_row_threshold or enlarge the cache/staging budget.")
    return s

  def stage(self, cold: Dict[str, List[np.ndarray]]) -> StagedBatch:
    """Host-gather the cold rows and upload the staging inputs."""
    with _span("tiered/stage"):
      return self.upload_staged(self.gather_cold(cold))

  def gather_cold(self, cold: Dict[str, List[np.ndarray]]) -> ColdBlocks:
    """The host half of staging: padded id blocks for every rank and
    host-gathered row blocks for the owned ranks, all numpy."""
    g_blocks_all: Dict[str, Dict[int, np.ndarray]] = {}
    r_blocks_all: Dict[str, Dict[int, np.ndarray]] = {}
    s_eff: Dict[str, int] = {}
    nbytes = 0
    spilled = False
    owned = frozenset(self.store.owned_ranks)
    for c in self.tplan.classes.values():
      per_rank_cold = cold[c.name]
      lay = c.layout_logical
      # a GLOBAL max over every rank's cold count: every process derives
      # the same s, so the ranks' staged shapes agree
      s = max(self._bucket(c, len(g)) for g in per_rank_cold)
      spilled |= s > c.spec.staging_grps
      g_blocks: Dict[int, np.ndarray] = {}
      r_blocks: Dict[int, np.ndarray] = {}
      for rank, g in enumerate(per_rank_cold):
        pad = s - g.shape[0]
        g_blocks[rank] = np.concatenate(
            [g, np.full((pad,), TIER_PAD_GRP, np.int32)])
        if rank not in owned:
          continue  # the owner host-gathers its own image
        rows = self._gather(c.name, rank, g)  # bounds-checked, retried
        nbytes += rows.nbytes
        r_blocks[rank] = np.concatenate(
            [rows, np.zeros((pad, lay.phys_width), rows.dtype)])
      g_blocks_all[c.name] = g_blocks
      r_blocks_all[c.name] = r_blocks
      s_eff[c.name] = s
    return ColdBlocks(cold=cold, s_eff=s_eff, g_blocks=g_blocks_all,
                      r_blocks=r_blocks_all, host_gather_bytes=nbytes,
                      spilled=spilled)

  def repair_conflicts(self, blocks: ColdBlocks,
                       prev_cold: Dict[str, List[np.ndarray]]) -> int:
    """Re-gather the rows a concurrent write-back may have raced: after
    the previous step's write-back returned, only rows in
    ``intersect(blocks.cold, prev_cold)`` can hold a stale value, so
    re-reading exactly those makes every row block byte-identical to a
    serial gather-after-write-back (the host-pass overlap's repair; both
    id sets are sorted and unique). Returns the rows re-gathered."""
    owned = frozenset(self.store.owned_ranks)
    repaired = 0
    for c in self.tplan.classes.values():
      for rank in range(self.plan.world_size):
        if rank not in owned:
          continue
        g = blocks.cold[c.name][rank]
        conflict = np.intersect1d(g, prev_cold[c.name][rank],
                                  assume_unique=True)
        if not conflict.size:
          continue
        rows = self._gather(c.name, rank, conflict.astype(np.int32))
        blocks.r_blocks[c.name][rank][np.searchsorted(g, conflict)] = rows
        repaired += int(conflict.size)
    if repaired:
      self.telemetry.counter("tiered/conflict_rows_regathered").inc(repaired)
    return repaired

  def _upload(self, blocks: Dict[int, np.ndarray]) -> torch.Tensor:
    """The local ranks' blocks, concatenated, copied to the device (a
    synchronous copy: the host blocks may be reused at once)."""
    parts = [blocks[r] for r in self.local_ranks]
    host = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return torch.from_numpy(np.ascontiguousarray(host)).to(self.device,
                                                           copy=True)

  def upload_staged(self, blocks: ColdBlocks) -> StagedBatch:
    """The device half of staging: upload the local ranks' padded blocks
    and commit the cumulative gather/spill counters."""
    grps_dev, rows_dev = {}, {}
    for c in self.tplan.classes.values():
      grps_dev[c.name] = self._upload(blocks.g_blocks[c.name])
      rows_dev[c.name] = self._upload(blocks.r_blocks[c.name])
    self.total_host_gather_bytes += blocks.host_gather_bytes
    self.spill_steps += int(blocks.spilled)
    self.telemetry.counter("tiered/host_gather_bytes").inc(
        blocks.host_gather_bytes)
    if blocks.spilled:
      self.telemetry.counter("tiered/spill_steps").inc()
    return StagedBatch(
        device={"grps": grps_dev, "rows": rows_dev,
                "resident": self._resident_dev},
        cold=blocks.cold, s_eff=blocks.s_eff,
        host_gather_bytes=blocks.host_gather_bytes, spilled=blocks.spilled)

  def prepare(self, cats: Sequence) -> StagedBatch:
    """classify + stage in one call (the synchronous path)."""
    return self.stage(self.classify(cats))

  # ---- write-back --------------------------------------------------------
  def write_back(self, staged: StagedBatch,
                 staged_out: Dict[str, torch.Tensor]) -> None:
    """Overwrite the staged rows in the host images with the post-scatter
    device values: each process downloads its local ranks' windows of the
    staged output and scatters them into its own images."""
    with _span("tiered/write_back"):
      for c in self.tplan.classes.values():
        s = staged.s_eff[c.name]
        for i, rank in enumerate(self.local_ranks):
          g = staged.cold[c.name][rank]
          if not g.shape[0]:
            continue
          rows = _host_rows(staged_out[c.name][i * s:i * s + g.shape[0]])
          self.store.scatter(c.name, rank, g, rows)

  # ---- promotion / eviction ----------------------------------------------
  def maybe_rerank(self, fused: Dict[str, torch.Tensor], decay: bool = True
                   ) -> Dict[str, torch.Tensor]:
    """Re-rank the resident set when the configured interval elapsed;
    otherwise a no-op. Returns ``fused`` (updated in place)."""
    interval = self.tplan.config.rerank_interval
    self.steps_since_rerank += 1
    if not interval or self.steps_since_rerank < interval:
      return fused
    self.steps_since_rerank = 0
    return self.rerank(fused, decay=decay)

  def rerank(self, fused: Dict[str, torch.Tensor], decay: bool = True
             ) -> Dict[str, torch.Tensor]:
    """Promote the top-count rows into the cache, evicting the rest.

    Value-preserving: evicted rows' device values go to the image, the
    promoted rows' image values go to the vacated cache slots (in place on
    ``fused``'s buffers), and the resident maps (host and device) are
    refreshed. Every rank's maps move (they are replicated); rows move
    for the local ranks. ``decay`` halves the counts afterwards, so the
    ranking tracks traffic drift."""
    with _span("tiered/rerank"):
      return self._rerank(fused, decay=decay)

  def _rerank(self, fused: Dict[str, torch.Tensor], decay: bool = True
              ) -> Dict[str, torch.Tensor]:
    local = {r: i for i, r in enumerate(self.local_ranks)}
    for c in self.tplan.classes.values():
      spec, lay = c.spec, c.layout_logical
      per = spec.cache_grps + spec.staging_grps
      name = c.name
      all_idx, all_rows = [], []
      for rank in range(self.plan.world_size):
        counts = self.store.counts[name][rank]
        in_top = _top_mask(counts, spec.cache_grps)
        current = self.store.resident_grps[name][rank]
        rmap = self.store.resident_map[name][rank]
        # O(rows) set algebra through the maps: the slots whose row left
        # the top set, and the top rows not resident (ascending)
        slots = np.flatnonzero(~in_top[current]).astype(np.int32)
        entering = np.flatnonzero(in_top & (rmap < 0)).astype(np.int32)
        k = min(slots.shape[0], entering.shape[0])
        if not k:
          continue
        slots, entering = slots[:k], entering[:k]
        if rank in local:
          gidx = torch.as_tensor(local[rank] * per + slots.astype(np.int64),
                                 device=fused[name].device)
          # evict: device values -> image; promote: image -> vacated slots
          self.store.scatter(name, rank, current[slots],
                             _host_rows(fused[name][gidx]))
          all_idx.append(gidx)
          all_rows.append(self._gather(name, rank, entering))
        rmap[current[slots]] = -1
        rmap[entering] = slots
        current[slots] = entering
      if all_idx:
        idx = torch.cat(all_idx)
        rows = torch.from_numpy(np.concatenate(all_rows)).to(
            fused[name].device, copy=True)
        fused[name][idx] = rows.to(fused[name].dtype)
      if decay:
        for rank in range(self.plan.world_size):
          self.store.counts[name][rank] >>= 1
    self.refresh_resident()
    return fused
