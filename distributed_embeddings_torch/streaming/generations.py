"""Per-logical-row generation accounting for incremental publication
(PyTorch port of ``streaming/generations.py``).

The sparse train step's backward is one scatter-add per fused class over
exactly the rows the batch routed: an un-routed row's table and
optimizer lanes are bit-identical before and after the step. Which
logical rows a batch routes is a pure host computation over the raw ids
(the plan's ``routing_recipe``, the same numpy replica of the step's
routing the tiered prefetcher classifies with).
:class:`RowGenerationTracker` uses both facts: it observes each GLOBAL
batch between steps, stamps every routed logical row with a monotone
clock, and the rows whose stamp advanced past a publication watermark are
exactly the rows a delta must ship. Everything else is unchanged since
the last publish, whatever the step's knobs (dedup, wire dtype, overlap,
micro-batching; a guard-skipped step leaves rows unchanged, which makes
the stamp a harmless superset).

The tracker also accumulates per-row observed counts (occurrences, the
serve cache's re-rank signal, as the prefetcher counts) and the wall
times of the oldest and newest unpublished observation, the anchors of
the train-step -> servable freshness measurement.

Dense-kind classes and the model's dense parameters change every step
and are small; the publisher ships them whole with every delta, so the
tracker covers sparse-kind classes only.

Host numpy only, bit-equal to the JAX package's tracker on the same
batches (its clock, stamps and counts). At world N every rank's tracker
observes the same global batches and holds every rank's stamps, as the
JAX single controller does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..layers.planner import routed_rows
from ..ops.ragged import RaggedIds
from ..parallel.lookup_engine import class_param_name, padded_rows


class RowGenerationTracker:
  """Logical-row update stamps + observed counts for one train run.

  Per sparse class ``name`` and rank ``r``:

  - ``gen[name][r]``: int64 ``[rows]``, the clock value at which each
    logical row of that rank block was last routed (0 = never);
  - ``counts[name][r]``: int64 ``[rows]``, cumulative routed occurrences
    (the serve-cache re-rank signal).

  ``clock`` advances once per observed batch. The tracker must see every
  batch the step trains, translated as the step sees it (for
  ``oov='allocate'`` runs: AFTER ``DynVocabTranslator.translate_batch``,
  so the stamps land on the allocated rows). Observation is host-side and
  single-writer: call it from the training loop, between steps."""

  def __init__(self, plan, rule=None):
    del rule  # the geometry is logical-row-shaped; kept for symmetry
    self.plan = plan
    self.clock = 0
    self.gen: Dict[str, List[np.ndarray]] = {}
    self.counts: Dict[str, List[np.ndarray]] = {}
    self._recipe: Dict[str, list] = {}
    self._rows: Dict[str, int] = {}
    for key in plan.class_keys:
      cp = plan.classes[key]
      if cp.kind != "sparse":
        continue
      name = class_param_name(*key)
      rows = padded_rows(plan, key)
      self._rows[name] = rows
      self._recipe[name] = plan.routing_recipe(key)
      self.gen[name] = [np.zeros((rows,), np.int64)
                        for _ in range(plan.world_size)]
      self.counts[name] = [np.zeros((rows,), np.int64)
                           for _ in range(plan.world_size)]
    if not self.gen:
      raise ValueError(
          "plan has no sparse-kind classes: every table rides the "
          "MXU-dense path, which the publisher ships wholesale — there "
          "are no row-granular deltas to track. Lower "
          "dense_row_threshold, or publish full exports.")
    # freshness anchors: wall time of the oldest and newest observation
    # not yet covered by a publish (reset by the publisher)
    self.oldest_unpublished_wall: Optional[float] = None
    self.newest_wall: Optional[float] = None

  @staticmethod
  def _input_ids_np(x) -> np.ndarray:
    if isinstance(x, RaggedIds):
      # the value stream IS the id stream (the splits only group it)
      x = x.values
    if isinstance(x, torch.Tensor):
      x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)

  def observe(self, cats: Sequence) -> int:
    """Stamp one GLOBAL batch's routed rows; returns the new clock."""
    if len(cats) != self.plan.num_inputs:
      raise ValueError(
          f"expected {self.plan.num_inputs} inputs, got {len(cats)}")
    self.clock += 1
    now = time.time()
    if self.oldest_unpublished_wall is None:
      self.oldest_unpublished_wall = now
    self.newest_wall = now
    for name, per_rank in self._recipe.items():
      rows_n = self._rows[name]
      for rank, slots in enumerate(per_rank):
        flat = routed_rows(slots, cats, self._input_ids_np)
        if not flat.size:
          continue
        # one sort serves both: dedup for the stamps, occurrence counts
        # for the re-rank signal
        u, occ = np.unique(flat, return_counts=True)
        if u[0] < 0 or u[-1] >= rows_n:
          bad = int(u[0] if u[0] < 0 else u[-1])
          raise IndexError(
              f"class {name!r} rank {rank}: routed logical row {bad} "
              f"outside [0, {rows_n}) — routing arithmetic diverged "
              "from the plan (corrupt id stream or a recipe bug).")
        self.gen[name][rank][u] = self.clock
        self.counts[name][rank][u] += occ
    return self.clock

  def force_dirty(self, rows: Dict[str, Dict[int, np.ndarray]],
                  floor: Optional[int] = None) -> None:
    """Stamp the given logical rows dirty at a clock strictly above
    ``floor`` (default: the current clock).

    The publisher's :meth:`~.publish.DeltaPublisher.attach` uses this for
    the superset rule: every row an orphaned tail delta shipped is
    re-stamped, so the next publication re-ships it at the resumed
    trainer's values. ``rows`` maps class name -> rank -> sorted
    logical-row indices."""
    if floor is not None:
      self.clock = max(self.clock, int(floor) + 1)
    else:
      # advance the clock so the stamps lie strictly above every earlier
      # stamp, in particular above a watermark equal to the current clock
      # (right after a publication), which would otherwise exclude the
      # forced rows from every future delta
      self.clock += 1
    now = time.time()
    if self.oldest_unpublished_wall is None:
      self.oldest_unpublished_wall = now
    self.newest_wall = now
    for name, per_rank in rows.items():
      if name not in self.gen:
        raise ValueError(
            f"force_dirty names unknown class {name!r}: this tracker "
            f"covers {sorted(self.gen)} — the rows came from a chain "
            "built under a different plan")
      rows_n = self._rows[name]
      for rank, idx in per_rank.items():
        idx = np.asarray(idx, np.int64)
        if not idx.size:
          continue
        if int(idx.min()) < 0 or int(idx.max()) >= rows_n:
          bad = int(idx.min() if idx.min() < 0 else idx.max())
          raise IndexError(
              f"class {name!r} rank {rank}: force-dirty row {bad} "
              f"outside [0, {rows_n}) — the delta rows do not fit this "
              "plan's geometry")
        self.gen[name][int(rank)][idx] = self.clock

  def state_arrays(self) -> Dict[str, np.ndarray]:
    """Flat (npz-keyed) persistence form of the generation state,
    ``<class>/r<rank>/gen|counts``: the checkpoint's ``stream.npz``."""
    flat: Dict[str, np.ndarray] = {}
    for name, per_rank in self.gen.items():
      for rank, g in enumerate(per_rank):
        flat[f"{name}/r{rank}/gen"] = g
        flat[f"{name}/r{rank}/counts"] = self.counts[name][rank]
    return flat

  def load_arrays(self, flat: Dict[str, np.ndarray]) -> None:
    """Inverse of :meth:`state_arrays`; refuses geometry mismatches with
    the field named."""
    for name, per_rank in self.gen.items():
      rows_n = self._rows[name]
      for rank in range(len(per_rank)):
        for part, dst in (("gen", self.gen), ("counts", self.counts)):
          key = f"{name}/r{rank}/{part}"
          arr = flat.get(key)
          if arr is None:
            raise ValueError(
                f"checkpoint stream state is missing {key!r}: it was "
                "written under a different plan or world size — the "
                "generation stamps cannot be adopted")
          arr = np.asarray(arr, np.int64)
          if arr.shape != (rows_n,):
            raise ValueError(
                f"checkpoint stream state {key!r} has shape {arr.shape}, "
                f"this plan implies ({rows_n},) — geometry mismatch")
          dst[name][rank] = arr.copy()

  def changed_rows(self, watermark: int) -> Dict[str, List[np.ndarray]]:
    """Per class, per rank: the SORTED logical rows whose generation
    advanced past ``watermark``, the delta's exact row set."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, per_rank in self.gen.items():
      out[name] = [np.where(g > watermark)[0].astype(np.int64)
                   for g in per_rank]
    return out

  def changed_row_total(self, watermark: int) -> int:
    return sum(int(np.sum(g > watermark))
               for per_rank in self.gen.values() for g in per_rank)

  def mark_published(self) -> None:
    """Reset the freshness anchor (every observation so far is covered
    by a publish)."""
    self.oldest_unpublished_wall = None
