"""Host-side open-addressing id translation table (raw 64-bit id -> row)
(PyTorch port of ``distributed_embeddings_tpu/dynvocab/table.py``: host
numpy, bit-equal mappings).

The dynamic-vocabulary layer's core data structure: one
:class:`IdTranslationTable` per dynamic table maps arbitrary non-negative
raw 64-bit ids onto physical rows ``[0, capacity)`` of the EXISTING
packed class buffers. It is a plain numpy open-addressing hash table
(linear probing, load factor <= 0.5, tombstone deletion with periodic
compaction), because the translation runs on the HOST between steps —
exactly like the tiered prefetcher's classify stage — so the train step
only ever sees already-translated, in-range ids and runs exactly as a
static-vocab plan's.

Determinism contract: ``lookup`` is a pure function of the current
MAPPING; the mapping itself is a deterministic function of the insertion
/ removal sequence (no RNG, no wall clock — the hash is a fixed-constant
splitmix64 finalizer). Serialization (:meth:`items`) captures the
mapping, not the probe history, so a restore rebuilds an equivalent
table regardless of how many tombstones the saving run had accumulated.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# splitmix64 finalizer constants (fixed — the table must hash identically
# across runs and restores)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_EMPTY = np.int64(-1)
_TOMBSTONE = np.int64(-2)


def _mix(ids: np.ndarray) -> np.ndarray:
  """splitmix64 finalizer over uint64 (vectorized, wrap-around exact)."""
  x = ids.astype(np.uint64)
  x ^= x >> np.uint64(30)
  x *= _M1
  x ^= x >> np.uint64(27)
  x *= _M2
  x ^= x >> np.uint64(31)
  return x


class IdTranslationTable:
  """Open-addressing map: raw id (int64 >= 0) -> physical row (int32).

  ``capacity`` bounds the number of live entries (the allocatable row
  count); the backing array is the next power of two >= 2x capacity so
  linear probe chains stay short. Raw ids are non-negative by the engine
  contract (negative ids are hotness padding everywhere else in the
  repo), which frees the sign bit for the EMPTY/TOMBSTONE sentinels.
  """

  def __init__(self, capacity: int):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = int(capacity)
    size = 8
    while size < 2 * self.capacity:
      size *= 2
    self._size = size
    self._mask = np.uint64(size - 1)
    self._keys = np.full((size,), _EMPTY, np.int64)
    self._vals = np.zeros((size,), np.int32)
    self._live = 0
    self._tombstones = 0

  def __len__(self) -> int:
    return self._live

  def _start(self, ids: np.ndarray) -> np.ndarray:
    return (_mix(ids) & self._mask).astype(np.int64)

  # ---- vectorized read path ----------------------------------------------
  def lookup(self, ids: np.ndarray) -> np.ndarray:
    """Rows for ``ids`` (int64 array, any shape); -1 where unmapped.

    Vectorized linear probing: each round resolves every id whose probe
    slot holds its key (hit) or EMPTY (definitive miss); tombstoned
    slots keep probing. Probe counts are bounded by the longest chain
    (load <= 0.5 plus compacted tombstones keeps chains short)."""
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    out = np.full(ids.shape, -1, np.int32)
    if not ids.size:
      return out
    if np.any(ids < 0):
      bad = int(ids[ids < 0][0])
      raise ValueError(
          f"raw id {bad} is negative: negative ids are hotness padding "
          "by the engine contract and must never reach the translation "
          "table — filter with ids >= 0 first.")
    active = np.arange(ids.size)
    pos = self._start(ids)
    for _ in range(self._size + 1):
      if not active.size:
        return out
      k = self._keys[pos[active]]
      hit = k == ids[active]
      out[active[hit]] = self._vals[pos[active[hit]]]
      done = hit | (k == _EMPTY)
      active = active[~done]
      pos[active] = (pos[active] + 1) & np.int64(self._mask)
    raise RuntimeError(
        "translation-table probe chain exceeded the table size — the "
        "open-addressing invariants are broken (this is a bug).")

  def items(self) -> Tuple[np.ndarray, np.ndarray]:
    """The live mapping as ``(ids, rows)``, sorted by row (the
    serialization form: probe-history-free and deterministic)."""
    live = self._keys >= 0
    ids = self._keys[live]
    rows = self._vals[live]
    order = np.argsort(rows, kind="stable")
    return ids[order], rows[order].astype(np.int32)

  # ---- scalar write path (allocation volume per step is small) -----------
  def insert(self, raw_id: int, row: int) -> None:
    """Map ``raw_id`` -> ``row``; the id must not already be mapped."""
    if self._live >= self.capacity:
      raise RuntimeError(
          f"translation table is full ({self.capacity} live entries): "
          "the caller must check occupancy (freelist/fresh rows) before "
          "inserting — denied admissions never reach insert().")
    raw_id = int(raw_id)
    if raw_id < 0:
      raise ValueError(f"raw id must be >= 0, got {raw_id}")
    pos = int(self._start(np.asarray([raw_id], np.int64))[0])
    first_tomb = -1
    for _ in range(self._size):
      k = int(self._keys[pos])
      if k == raw_id:
        raise ValueError(f"raw id {raw_id} is already mapped to row "
                         f"{int(self._vals[pos])}")
      if k == _TOMBSTONE and first_tomb < 0:
        first_tomb = pos
      if k == _EMPTY:
        slot = first_tomb if first_tomb >= 0 else pos
        if slot == first_tomb and first_tomb >= 0:
          self._tombstones -= 1
        self._keys[slot] = raw_id
        self._vals[slot] = np.int32(row)
        self._live += 1
        return
      pos = (pos + 1) & int(self._mask)
    raise RuntimeError("translation-table insert found no slot — the "
                       "open-addressing invariants are broken.")

  def remove(self, raw_id: int) -> int:
    """Unmap ``raw_id``; returns the row it held. Tombstones the slot
    (probe chains through it stay intact) and compacts the table once
    tombstones pile past a quarter of the backing array."""
    raw_id = int(raw_id)
    pos = int(self._start(np.asarray([raw_id], np.int64))[0])
    for _ in range(self._size):
      k = int(self._keys[pos])
      if k == raw_id:
        row = int(self._vals[pos])
        self._keys[pos] = _TOMBSTONE
        self._live -= 1
        self._tombstones += 1
        if self._tombstones > self._size // 4:
          self._rebuild()
        return row
      if k == _EMPTY:
        raise KeyError(f"raw id {raw_id} is not mapped")
      pos = (pos + 1) & int(self._mask)
    raise KeyError(f"raw id {raw_id} is not mapped")

  def _rebuild(self) -> None:
    """Re-insert every live entry into a fresh backing array (drops the
    tombstones so probe chains shrink back)."""
    ids, rows = self.items()
    self._keys.fill(_EMPTY)
    self._vals.fill(0)
    self._live = 0
    self._tombstones = 0
    for i, r in zip(ids.tolist(), rows.tolist()):
      self.insert(i, r)

  # ---- serialization ------------------------------------------------------
  def load_items(self, ids: np.ndarray, rows: np.ndarray) -> None:
    """Replace the mapping with ``(ids, rows)`` (a checkpointed
    :meth:`items` pair)."""
    if ids.shape != rows.shape:
      raise ValueError(f"ids/rows shape mismatch: {ids.shape} vs "
                       f"{rows.shape}")
    if ids.size > self.capacity:
      raise ValueError(
          f"checkpointed mapping holds {ids.size} entries but this "
          f"table's capacity is {self.capacity} — the vocab_capacity "
          "differs from the saving run's.")
    self._keys.fill(_EMPTY)
    self._vals.fill(0)
    self._live = 0
    self._tombstones = 0
    for i, r in zip(ids.tolist(), rows.tolist()):
      self.insert(int(i), int(r))


class ReadonlyIdTranslator:
  """An immutable, serializable snapshot of a dynamic id space — the
  SERVE-SIDE form of ``DynVocabTranslator.translate_readonly``.

  The live translator is trainer state (admission sketch, freelist, TTL
  stamps) that must never leave the training process; what serving needs
  is only the pure raw-id -> row MAPPING at one instant, plus the plan's
  input -> table wiring so request inputs route to the right table. This
  class captures exactly that pair, round-trips through flat npz arrays
  (it rides the serve artifact and every streaming delta — new ids
  admitted by training become servable in the same delta cycle), and
  translates with the identical semantics: unmapped ids emit ``PAD_ID``
  (-1, the engine's hotness-padding sentinel — a row-less id contributes
  a zero embedding), inputs of non-dynamic tables pass through.
  """

  def __init__(self, tables: Dict[int, IdTranslationTable],
               input_table_map: List[int]):
    self.tables = tables
    self.input_table_map = [int(t) for t in input_table_map]

  @classmethod
  def from_translator(cls, translator) -> "ReadonlyIdTranslator":
    """Snapshot a live ``DynVocabTranslator`` (mapping only — the
    sketch / freelist / TTL state stays behind)."""
    tables = {}
    for t in translator.dynamic_tables:
      ids, rows = translator.tables[t].items()
      tab = IdTranslationTable(max(1, translator.tables[t].capacity))
      tab.load_items(ids, rows)
      tables[int(t)] = tab
    return cls(tables, list(translator.plan.input_table_map))

  # ---- the read path ------------------------------------------------------
  def translate(self, inputs) -> list:
    """Raw-id inputs -> translated int32 arrays (pure lookup; the id
    space cannot change under a reader by construction — promotion
    swaps the whole snapshot reference)."""
    out = []
    for i, x in enumerate(inputs):
      t = self.input_table_map[i]
      tab = self.tables.get(t)
      if tab is None:
        out.append(x)
        continue
      arr = np.asarray(x)
      flat = arr.reshape(-1).astype(np.int64)
      valid = flat >= 0
      res = np.full(flat.shape, -1, np.int32)
      res[valid] = tab.lookup(flat[valid])
      out.append(res.reshape(arr.shape))
    return out

  def occupancy(self) -> Dict[int, int]:
    return {t: len(tab) for t, tab in self.tables.items()}

  # ---- serialization (rides serve artifacts and streaming deltas) --------
  def state_arrays(self) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {
        "input_table_map": np.asarray(self.input_table_map, np.int64)}
    for t, tab in sorted(self.tables.items()):
      ids, rows = tab.items()
      flat[f"t{t}/ids"] = ids
      flat[f"t{t}/rows"] = rows
      flat[f"t{t}/capacity"] = np.asarray([tab.capacity], np.int64)
    return flat

  def manifest_section(self) -> Dict[str, Any]:
    """The artifact manifest's ``vocab_snapshot`` section (geometry +
    occupancy — observability and a load-time cross-check)."""
    return {
        "tables": {str(t): {"capacity": tab.capacity,
                            "occupancy": len(tab)}
                   for t, tab in sorted(self.tables.items())},
        "input_table_map": list(self.input_table_map),
    }

  @classmethod
  def from_arrays(cls, flat: Dict[str, np.ndarray]) -> "ReadonlyIdTranslator":
    tables: Dict[int, IdTranslationTable] = {}
    for key in flat:
      if not (key.startswith("t") and key.endswith("/ids")):
        continue
      t = int(key[1:].split("/", 1)[0])
      cap = int(np.asarray(flat[f"t{t}/capacity"]).reshape(-1)[0])
      tab = IdTranslationTable(max(1, cap))
      tab.load_items(np.asarray(flat[f"t{t}/ids"], np.int64),
                     np.asarray(flat[f"t{t}/rows"], np.int32))
      tables[t] = tab
    return cls(tables,
               np.asarray(flat["input_table_map"], np.int64).tolist())
