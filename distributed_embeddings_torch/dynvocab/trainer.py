"""The dynamic-vocabulary translator + host-side training loop (PyTorch
port of ``distributed_embeddings_tpu/dynvocab/trainer.py``).

:class:`DynVocabTranslator` composes the three lifecycle pieces — the
open-addressing id table (:mod:`.table`), count-min-sketch admission
(:mod:`.admission`), and TTL eviction / row recycling (:mod:`.lifecycle`)
— into the per-step host pass that makes ``oov='allocate'`` real:

    evict expired rows (freelist + device re-zero targets)
    -> observe the batch's raw ids (sketch)
    -> translate (admitting ids past ``admit_threshold`` onto recycled
       or fresh rows; un-admitted ids emit PAD_ID and contribute nothing)

It runs BETWEEN steps on the host — the ``TieredPrefetcher`` pattern —
so the sparse train step sees only translated in-range ids and runs
exactly as a static-vocab (``oov='clip'``) plan's kernels: K1 applies the
rows, K2 interacts them, K4 gathers them on the fused wire. With every
id pre-admitted the whole run equals the static run it shadows. The
translator's state (mapping, sketch, freelist, counters) is host numpy,
bit-equal to the JAX package's over the same batches.

Stream-position discipline: the id space consumes EVERY batch (a
guard-skipped poison batch still observed its ids — exactly like the
``consumed`` counter counts skipped batches), while the commit gate
keeps the trained state bit-identical on skips. An unkilled reference
and a kill/resume run therefore agree on both states.

:class:`DynVocabTrainer` drives the protocol around the fused step
(translate -> re-zero evicted rows in the packed buffers -> device step)
and accounts per-class lifecycle counters ``[allocs, evictions,
admit_denied, occupancy]`` next to the guarded step's ``oov`` /
``dedup_overflow`` metrics. At world N every rank translates the GLOBAL
host batch with its own translator (the passes are deterministic, so the
id spaces agree on every rank), zeroes the recycled rows of its own
blocks, and steps on its slice. ``resilience.ResilientTrainer(
dynvocab=...)`` wraps it with durable snapshots (the translator state
rides the checkpoint manifest's ``vocab`` section) and auto-resume.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ..ops.packed_table import SparseRule
from ..ops.ragged import RaggedIds
from ..parallel.lookup_engine import DistributedLookup, class_param_name
from ..telemetry import get_registry as _registry, span as _span
from .admission import CountMinSketch
from .lifecycle import RowRecycler, apply_zero_work, merge_zero_work, \
    zero_targets
from .table import IdTranslationTable


class DynVocabTranslator:
  """Host-side dynamic id space for every sparse-kind table of a plan.

  One translation table / sketch / recycler per DYNAMIC table (sparse
  kind; MXU-dense small-vocab tables keep static ids — their one-hot
  windows have no row scarcity to manage, and the allocation protocol is
  a property of the gather path). State is keyed by TABLE
  id, not rank: raw-id -> row is a logical-vocabulary fact, which is
  what lets the checkpointed id space restore unchanged across an
  elastic world resize.
  """

  def __init__(self, plan, rule: SparseRule,
               sketch_width: int = 1 << 16, sketch_depth: int = 4):
    if getattr(plan, "oov", "clip") != "allocate":
      raise ValueError(
          "DynVocabTranslator needs a plan built with oov='allocate' "
          f"(got oov={getattr(plan, 'oov', 'clip')!r}): the dynamic id "
          "layer replaces the clip/error policies, it does not wrap "
          "them.")
    if plan.host_tier_class_keys():
      raise NotImplementedError(
          "oov='allocate' with host-tier (tiered) classes: the tiered "
          "prefetcher classifies RAW ids, so the two host passes would "
          "have to compose — an open follow-on (ROADMAP). Keep dynamic "
          "tables device-resident (host_row_threshold=None).")
    self.plan = plan
    self.rule = rule
    layouts = DistributedLookup(plan).fused_layouts(rule)
    table_kind: Dict[int, str] = {}
    for shards in plan.rank_shards:
      for sh in shards:
        table_kind[sh.table_id] = plan._kind_of(sh)
    self.dynamic_tables = tuple(sorted(
        t for t, k in table_kind.items() if k == "sparse"))
    if not self.dynamic_tables:
      raise ValueError(
          "plan has no sparse-kind tables: every table rides the MXU "
          "one-hot path, which keeps static ids — there is nothing for "
          "oov='allocate' to allocate. Lower dense_row_threshold.")
    self.tables: Dict[int, IdTranslationTable] = {}
    self.sketches: Dict[int, CountMinSketch] = {}
    self.recyclers: Dict[int, RowRecycler] = {}
    # cumulative [allocs, evictions, admit_denied] per table — lives IN
    # the translator (serialized with it) so restarts never double-count
    self.totals: Dict[int, np.ndarray] = {}
    # per-table zero recipe: every shard window holding the table's rows
    # (column slices replicate rows across ranks; each copy re-zeroes)
    self._recipe: Dict[int, List[tuple]] = {}
    # classes each table touches (counter aggregation granularity — the
    # same convention as oov_counts: shared/sliced tables count once per
    # class)
    self._classes_of: Dict[int, List[str]] = {}
    for t in self.dynamic_tables:
      cap = plan.table_vocab_capacity(t)
      self.tables[t] = IdTranslationTable(cap)
      self.sketches[t] = CountMinSketch(sketch_width, sketch_depth)
      self.recyclers[t] = RowRecycler(cap)
      self.totals[t] = np.zeros((3,), np.int64)
      entries, names = [], []
      for rank, sh in plan.table_shard_map(t):
        key = plan.class_key_of(sh)
        cp = plan.classes[key]
        name = class_param_name(*key)
        lay = layouts[name]
        idx = cp.shards_per_rank[rank].index(sh)
        row_offset = cp.row_offsets_per_rank[rank][idx]
        entries.append((name, rank * lay.phys_rows, sh.row_start,
                        sh.input_dim, row_offset, lay.rows_per_phys))
        if name not in names:
          names.append(name)
      self._recipe[t] = entries
      self._classes_of[t] = names
    self.steps = 0  # the TTL clock: batches CONSUMED by the id space

  # ---- the per-step host pass --------------------------------------------
  def _evict(self, step: int):
    """Reclaim expired rows; returns (per-table eviction counts,
    per-class zero targets)."""
    ttl = getattr(self.plan, "evict_ttl", None)
    evicted = {t: 0 for t in self.dynamic_tables}
    zero: Dict[str, tuple] = {}
    if ttl is None:
      return evicted, zero
    for t in self.dynamic_tables:
      rec, tab = self.recyclers[t], self.tables[t]
      rows = rec.expired(step, ttl)
      if not rows.size:
        continue
      for row in rows.tolist():
        tab.remove(int(rec.row_to_id[row]))
        rec.release(row)
      evicted[t] = int(rows.size)
      self.totals[t][1] += rows.size
      merge_zero_work(zero, zero_targets(self._recipe[t], rows))
    return evicted, zero

  def _translate_one(self, t: int, ids: np.ndarray, step: int,
                     mutate: bool) -> tuple:
    """One input's raw ids -> (translated int32 array, allocs, denied).

    Un-admitted / capacity-denied ids emit PAD_ID (-1): the engine
    treats them as hotness padding, so they gather nothing and train
    nothing — a row-less id contributes a zero embedding, which is
    exactly what "no row yet" means."""
    if isinstance(ids, RaggedIds):
      raise NotImplementedError(
          "dynamic-vocab translation of RaggedIds inputs: translate "
          "over the value stream is not wired up yet — pad to dense "
          "multi-hot (ragged_to_padded) for dynamic tables.")
    arr = np.asarray(ids)
    flat = arr.reshape(-1).astype(np.int64)
    valid = flat >= 0
    vids = flat[valid]
    tab, rec, sk = self.tables[t], self.recyclers[t], self.sketches[t]
    allocs = denied = 0
    if mutate:
      sk.update(vids)
    rows = tab.lookup(vids)
    if mutate:
      missing = np.unique(vids[rows < 0])
      if missing.size:
        est = sk.estimate(missing)
        thr = getattr(self.plan, "admit_threshold", 1)
        for mid, e in zip(missing.tolist(), est.tolist()):
          if e >= thr:
            row = rec.allocate(mid, step)
            if row >= 0:
              tab.insert(mid, row)
              allocs += 1
            else:
              denied += 1
          else:
            denied += 1
        if allocs:
          rows = tab.lookup(vids)
      hit = rows[rows >= 0]
      if hit.size:
        rec.touch(np.unique(hit), step)
      self.totals[t][0] += allocs
      self.totals[t][2] += denied
    out = np.full(flat.shape, -1, np.int32)
    out[valid] = rows
    return out.reshape(arr.shape), allocs, denied

  def translate_batch(self, inputs) -> tuple:
    """The full host pass over one batch of raw-id inputs.

    Returns ``(translated_inputs, metrics, zero_work)``:

    - ``translated_inputs``: per input, the int32 translated array
      (inputs of non-dynamic tables pass through untouched);
    - ``metrics``: class name -> int64 ``[4]`` counter vector
      ``[allocs, evictions, admit_denied, occupancy]`` for THIS step
      (occupancy = live rows after it). The translator sees the GLOBAL
      batch — like the tiered prefetcher's classify — so the counters
      are already global; the trainer surfaces them in the step metrics
      next to the guarded step's rank-summed ``oov``/``dedup_overflow``.
    - ``zero_work``: class name -> (grp, sub) device re-zero targets of
      this step's evicted rows (apply BEFORE dispatching the step —
      ``lifecycle.apply_zero_work`` — so a recycled row re-admits onto
      zeroed lanes).
    """
    if len(inputs) != self.plan.num_inputs:
      raise ValueError(
          f"expected {self.plan.num_inputs} inputs, got {len(inputs)}")
    self.steps += 1
    step = self.steps
    evicted, zero = self._evict(step)
    per_table = {t: np.zeros((2,), np.int64) for t in self.dynamic_tables}
    out_inputs = []
    for i, x in enumerate(inputs):
      t = self.plan.input_table_map[i]
      if t not in self.tables:
        out_inputs.append(x)
        continue
      tx, allocs, denied = self._translate_one(t, x, step, mutate=True)
      per_table[t] += np.asarray([allocs, denied], np.int64)
      out_inputs.append(tx)
    metrics: Dict[str, np.ndarray] = {}
    for t in self.dynamic_tables:
      vec = np.asarray([per_table[t][0], evicted[t], per_table[t][1],
                        self.recyclers[t].occupancy], np.int64)
      for name in self._classes_of[t]:
        metrics[name] = metrics.get(name, np.zeros((4,), np.int64)) + vec
    return out_inputs, metrics, zero

  def translate_readonly(self, inputs) -> list:
    """Pure lookup (no observation, admission, or eviction): the eval /
    serve form — an inference path must never mutate the id space, which
    is also why the eval and serve step BUILDERS refuse ``'allocate'``
    plans outright. Unmapped ids emit PAD_ID."""
    out = []
    for i, x in enumerate(inputs):
      t = self.plan.input_table_map[i]
      if t not in self.tables:
        out.append(x)
        continue
      tx, _, _ = self._translate_one(t, x, self.steps, mutate=False)
      out.append(tx)
    return out

  def occupancy(self) -> Dict[int, int]:
    return {t: self.recyclers[t].occupancy for t in self.dynamic_tables}

  # ---- checkpoint state ---------------------------------------------------
  def state_arrays(self) -> Dict[str, np.ndarray]:
    """Flat npz-ready state: mapping, sketch, recycler, cumulative
    counters per table, plus the TTL clock."""
    flat: Dict[str, np.ndarray] = {
        "steps": np.asarray([self.steps], np.int64)}
    for t in self.dynamic_tables:
      ids, rows = self.tables[t].items()
      flat[f"t{t}/ids"] = ids
      flat[f"t{t}/rows"] = rows
      flat[f"t{t}/sketch"] = self.sketches[t].state()
      flat[f"t{t}/totals"] = self.totals[t]
      for k, v in self.recyclers[t].state().items():
        flat[f"t{t}/{k}"] = v
    return flat

  def manifest_section(self) -> Dict[str, Any]:
    """The checkpoint manifest's ``vocab`` section: the knobs and
    geometry a restore must match (occupancy rides along as
    observability, not identity)."""
    return {
        "admit_threshold": int(getattr(self.plan, "admit_threshold", 1)),
        "evict_ttl": getattr(self.plan, "evict_ttl", None),
        "sketch": {"width": self.sketches[self.dynamic_tables[0]].width,
                   "depth": self.sketches[self.dynamic_tables[0]].depth},
        "tables": {str(t): {"capacity": self.tables[t].capacity,
                            "occupancy": self.recyclers[t].occupancy}
                   for t in self.dynamic_tables},
    }

  def config_mismatch(self, section: Dict[str, Any]) -> Optional[str]:
    """None when a checkpoint's ``vocab`` section is loadable into this
    translator, else the first reason it is not."""
    want = self.manifest_section()
    for k in ("admit_threshold", "evict_ttl"):
      if section.get(k) != want[k]:
        return (f"{k} was {section.get(k)!r} at save time, this plan has "
                f"{want[k]!r}")
    if section.get("sketch") != want["sketch"]:
      return (f"sketch geometry was {section.get('sketch')!r} at save "
              f"time, this translator has {want['sketch']!r}")
    saved_tables = section.get("tables", {})
    if set(saved_tables) != set(want["tables"]):
      return (f"dynamic table set was {sorted(saved_tables)} at save "
              f"time, this plan has {sorted(want['tables'])}")
    for t, meta in sorted(saved_tables.items()):
      if meta["capacity"] != want["tables"][t]["capacity"]:
        return (f"table {t} capacity was {meta['capacity']} at save "
                f"time, this plan allows {want['tables'][t]['capacity']}")
    return None

  def load_state(self, flat: Dict[str, np.ndarray],
                 section: Dict[str, Any]) -> None:
    """Restore the id space from a checkpoint's ``vocab.npz`` + manifest
    section (refuses a knob/geometry mismatch with the reason named)."""
    reason = self.config_mismatch(section)
    if reason is not None:
      raise ValueError(
          f"checkpoint vocab state does not fit this translator: "
          f"{reason} — rebuild the plan/translator with the saving "
          "run's dynamic-vocabulary knobs.")
    self.steps = int(np.asarray(flat["steps"]).reshape(-1)[0])
    for t in self.dynamic_tables:
      self.tables[t].load_items(np.asarray(flat[f"t{t}/ids"], np.int64),
                                np.asarray(flat[f"t{t}/rows"], np.int32))
      self.sketches[t].load_state(np.asarray(flat[f"t{t}/sketch"]))
      self.totals[t] = np.asarray(flat[f"t{t}/totals"], np.int64).copy()
      self.recyclers[t].load_state(
          {k: flat[f"t{t}/{k}"]
           for k in ("row_to_id", "last_seen", "freelist", "next_fresh")})


class DynVocabTrainer:
  """Drives dynamic-vocabulary training: translate, re-zero, device step.

  Owns the train ``state`` (updated in place by the step) and the
  :class:`DynVocabTranslator`; one :meth:`step` call is the synchronous
  protocol (the translate pass is host-side and independent of the
  device step's results, so :meth:`run` with ``overlap_host=True``
  translates the next batch on the pipeline's worker thread while the
  card runs this step, bit-equal to the serial loop).

  Counters (cumulative, aggregated per class like the tier hit
  counters): ``vocab_totals[name] = [allocs, evictions, admit_denied,
  occupancy]`` with occupancy holding the LATEST value; the
  ``vocab/allocs|evictions|admit_denied/<class>`` counters and the
  ``vocab/occupancy/<class>`` gauge emit to ``telemetry``.
  ``guard=True`` builds the hardened step and accounts
  ``bad_steps``/``oov_totals`` exactly like ``TieredTrainer`` — and under
  ``oov='allocate'`` a nonzero in-step OOV counter means raw ids leaked
  past the translator, which ``guards.check_oov`` escalates to a
  host-side error with the state uncommitted.

  ``mesh``: this rank's mesh at world N (every rank builds a trainer and
  feeds it the same GLOBAL host batches); ``device``: where the state
  lives without a mesh (``"cuda"`` unless the caller asks for the CPU).
  """

  def __init__(self, model, plan, translator: DynVocabTranslator,
               loss_fn: Callable, dense_optimizer, rule: SparseRule,
               mesh, state: Dict[str, Any], emb_dense_optimizer=None,
               micro_batches: int = 1, guard: bool = False,
               telemetry=None, overlap_host: bool = False,
               device="cuda"):
    from ..training import _state_device, make_sparse_train_step
    if getattr(plan, "oov", "clip") != "allocate":
      raise ValueError(
          "DynVocabTrainer needs a plan built with oov='allocate' "
          f"(got {getattr(plan, 'oov', 'clip')!r}).")
    if translator.plan is not plan:
      raise ValueError(
          "translator was built for a different plan object: the zero "
          "recipe and class names are plan-derived, so the two must "
          "share one DistEmbeddingStrategy.")
    self.plan = plan
    self.translator = translator
    self.mesh = mesh
    self.device = _state_device(device, mesh)
    # the blocks this process holds: its own at world N, all otherwise
    self.rank = mesh.rank if mesh is not None and plan.world_size > 1 \
        else None
    self.state = state
    self.guard = guard
    self.overlap_host = overlap_host
    # lifecycle counters/gauges emit here (default: process registry)
    self.telemetry = telemetry if telemetry is not None else _registry()
    self.engine = DistributedLookup(plan, mesh=mesh)
    self.layouts = self.engine.fused_layouts(rule)
    self._step_fn = make_sparse_train_step(
        model, plan, loss_fn, dense_optimizer, rule, mesh,
        emb_dense_optimizer=emb_dense_optimizer,
        micro_batches=micro_batches, guard=guard)
    self.vocab_totals: Dict[str, np.ndarray] = {}
    self.rows_zeroed = 0
    self.steps = 0
    self.bad_steps = 0
    self.oov_totals: Dict[str, int] = {}
    self.dedup_overflow_totals: Dict[str, int] = {}

  # ---- metrics -----------------------------------------------------------
  def account_vocab(self, vocab: Dict[str, np.ndarray]) -> None:
    """Accumulate one step's per-class lifecycle counters (allocs /
    evictions / denied sum; occupancy is the latest value)."""
    reg = self.telemetry
    for name, vec in vocab.items():
      tot = self.vocab_totals.setdefault(name, np.zeros((4,), np.int64))
      tot[:3] += vec[:3]
      tot[3] = vec[3]
      reg.counter(f"vocab/allocs/{name}").inc(int(vec[0]))
      reg.counter(f"vocab/evictions/{name}").inc(int(vec[1]))
      reg.counter(f"vocab/admit_denied/{name}").inc(int(vec[2]))
      reg.gauge(f"vocab/occupancy/{name}").set(int(vec[3]))

  def _account(self, metrics) -> None:
    if self.guard:
      self.bad_steps += int(metrics["bad_step"])
      # account FIRST, enforce second: the leak raise leaves the totals
      # covering the rejected batch (which committed nothing)
      counts = {name: int(v) for name, v in metrics["oov"].items()}
      for name, n in counts.items():
        self.oov_totals[name] = self.oov_totals.get(name, 0) + n
      for name, v in metrics.get("dedup_overflow", {}).items():
        n = int(v)
        if n:
          self.dedup_overflow_totals[name] = \
              self.dedup_overflow_totals.get(name, 0) + n
      from ..resilience import guards as _guards
      _guards.check_oov(self.plan, counts, where="dynvocab step")
    self.steps += 1

  def metrics_summary(self) -> Dict[str, Any]:
    out = {
        "steps": self.steps,
        "per_class": {
            name: {"allocs": int(v[0]), "evictions": int(v[1]),
                   "admit_denied": int(v[2]), "occupancy": int(v[3])}
            for name, v in self.vocab_totals.items()},
        "occupancy": self.translator.occupancy(),
        "rows_zeroed": self.rows_zeroed,
    }
    if self.guard:
      out["bad_steps"] = self.bad_steps
      out["oov"] = dict(self.oov_totals)
      if self.dedup_overflow_totals:
        out["dedup_overflow"] = dict(self.dedup_overflow_totals)
    return out

  # ---- stepping ----------------------------------------------------------
  def _apply_zero(self, zero) -> None:
    """Main-thread half of translation: clear recycled rows on the card
    BEFORE the step that may read them (the overlapped loop translates
    on its worker but always applies the zero work here,
    pre-dispatch)."""
    self.state["fused"], zeroed = apply_zero_work(
        self.layouts, self.state["fused"], zero, rank=self.rank)
    self.rows_zeroed += zeroed

  def _translate(self, cats):
    with _span("dynvocab/translate"):
      cats_t, vocab_metrics, zero = self.engine.translate_dynamic_ids(
          cats, self.translator)
      self._apply_zero(zero)
      return cats_t, vocab_metrics

  def _dispatch(self, numerical, cats_t, labels):
    """Dispatch one TRANSLATED global batch; returns ``(loss,
    metrics|None)`` with the device span left open on ``self._dev_span``
    — the caller's first host read ends the window and must finish the
    span."""
    from ..training import shard_batch
    self._dev_span = _span("device/step", track="device").start()
    batch = shard_batch((numerical, list(cats_t), labels), self.mesh,
                        device=self.device)
    if self.guard:
      self.state, loss, metrics = self._step_fn(self.state, *batch)
      return loss, metrics
    self.state, loss = self._step_fn(self.state, *batch)
    return loss, None

  def step(self, numerical, cats, labels) -> float:
    """One train step on a GLOBAL host batch of RAW ids."""
    cats_t, vocab_metrics = self._translate(cats)
    loss, metrics = self._dispatch(numerical, cats_t, labels)
    loss = float(loss)  # the host read ending the window
    self._dev_span.finish()
    if self.guard:
      self._account(metrics)
    else:
      self.steps += 1
    self.account_vocab(vocab_metrics)
    return loss

  def run(self, batches: Iterable) -> list:
    """Train over host batches of ``(numerical, cats, labels)``.

    With ``overlap_host=True`` the translate pass for batch k+1 runs on
    the pipeline worker while step k runs on the card — bit-equal with
    the serial loop (the translator mutates in batch order on the single
    worker; see ``pipeline.run_dynvocab_overlapped``)."""
    if self.overlap_host:
      from ..pipeline import run_dynvocab_overlapped
      return run_dynvocab_overlapped(self, batches)
    return [self.step(*b) for b in batches]
