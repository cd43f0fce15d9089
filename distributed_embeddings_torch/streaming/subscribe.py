"""Serve-side delta adoption: validate, fold, promote, without pausing
(PyTorch port of ``streaming/subscribe.py``).

:class:`DeltaSubscriber` watches a publish directory, validates each
``delta_<seq>/`` against the chain contract (directory integrity against
its own crc32 manifest; ``seq`` exactly next; ``base_fingerprint`` equal
to the fingerprint of the artifact last applied; see :mod:`.publish`)
and folds a valid delta into a RUNNING :class:`~..serving.engine.
ServeEngine` by **copy-on-promote**:

- device-tier classes: each touched serve block is cloned and the rows
  written into the clone OFF the dispatch lock, and the device is
  synchronized before the lock is taken; under ``engine.lock`` only the
  references are swapped, between dispatches (a dispatch in flight keeps
  reading the old block, on the same stream);
- the model's dense parameters: the delta's are placed on the device off
  the lock and copied into the model's parameters under it, together
  with the serve blocks, the dense-class tables, ``engine.step`` and the
  dynvocab snapshot, so every dispatch sees one generation;
- host-tier (tiered serve) classes: the delta scatters into a COPY of
  each touched cold image; under the lock the copies swap in, resident
  cache rows whose image rows changed are re-uploaded, and the
  publisher-shipped observed counts re-rank the cache through the
  prefetcher's own re-rank (``rerank(decay=False)``).

A delta that fails validation is REFUSED: counted, recorded in
``last_refusal`` with the failing field named, and the subscriber keeps
serving the last valid state. When the BASE artifact's fingerprint
changes (a re-rooted chain) the subscriber rebases: it reloads the full
artifact and resumes the new chain. Freshness: each promotion observes
``now - train_wall_oldest`` into ``stream/freshness_s``.

World N (one process per rank, ``ServeEngine(mesh=)``): the subscriber
serves behind ``serving.world_batcher`` (rank 0's ``LeaderBatcher``, the
other ranks' ``follow``). Only rank 0 polls: its poll validates the ready
deltas (every rank's files) and advances :meth:`lockstep_seq`. Each
dispatch's header carries that seq to every rank, and every rank folds
its own rank's rows through it (:meth:`dispatch_at`) before the
dispatch: all ranks swap at the same dispatch boundary, so no prediction
mixes generations across row shards. A rebase at world N is refused (the
poll records it in ``last_error``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import _plan_fingerprint, manifest_fingerprint, \
    read_manifest
from ..checkpoint import verify as verify_dir
from ..ops.packed_table import host_gather_rows
from ..resilience import faultinject, retry
from ..serving.engine import ServeEngine
from ..serving.export import ServeClassMeta, _unflatten_paths, \
    serve_dense_state
from ..serving.export import load as serve_load
from ..telemetry import clear_promote as _clear_promote
from ..telemetry import flight as _flight
from ..telemetry import get_registry as _registry, span as _span
from ..telemetry import record_promote as _record_promote
from ..telemetry import trace as _trace
from .publish import (
    BASE_DIR,
    DELTA_FORMAT_VERSION,
    chain_anchor as _chain_anchor,
    delta_dirname,
    published_delta_seqs,
    scatter_rows,
    write_heartbeat,
)

# Freshness histogram geometry: the lag spans many decades (ms when
# healthy, hours when a publisher is down) and must never grow without
# bound: at rel_err=0.05, 256 buckets span about 11 decades before the
# lowest start collapsing.
FRESHNESS_REL_ERR = 0.05
FRESHNESS_MAX_BUCKETS = 256

# fired per filesystem read attempt on the validate/fold path (inside the
# retry loop, so fail_first simulates transient shared-filesystem errors)
STREAM_READ_SITE = faultinject.register_site("stream_read")
# fired at the start of each delta application (kill-mid-promote hook)
DELTA_PROMOTE_SITE = faultinject.register_site("delta_promote")

Rows = Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]]


def poll_phase(subscriber_id: str, jitter_s: float) -> float:
  """Deterministic per-subscriber poll phase offset in ``[0, jitter_s)``:
  a pure function of the subscriber id (sha256), so a fleet of
  subscribers on one pubdir spreads its polls over the jitter window
  instead of statting the directory in lockstep."""
  if jitter_s <= 0.0:
    return 0.0
  digest = hashlib.sha256(subscriber_id.encode("utf-8")).digest()
  frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
  return frac * float(jitter_s)


def _fp_and_manifest(path: str):
  """Fingerprint AND parsed manifest from ONE read of the manifest bytes
  (both describe the same artifact version even while a compactor swaps
  ``base/`` underneath)."""
  with open(os.path.join(path, "manifest.json"), "rb") as f:
    raw = f.read()
  return hashlib.sha256(raw).hexdigest(), json.loads(raw.decode())


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


class DeltaSubscriber:
  """Fold published deltas into a running serve engine.

  Build via :meth:`from_artifact` (loads the base export, builds the
  engine, and records the factory so a re-rooted chain can rebase), or
  from an existing engine and the base fingerprint it was built from.
  ``poll_once`` is the deterministic test surface; :meth:`start` runs it
  on a daemon thread every ``poll_interval_s``.

  Locking: the one shared-state boundary is the ENGINE's ``lock``.
  ``self.engine`` and ``self.translator`` are written only under it;
  :meth:`dispatch` re-checks ``eng is self.engine`` under ``eng.lock``,
  so a rebase swapping both can never split one dispatch across two
  engines. The chain position (``applied_seq``, ``fingerprint``,
  ``last_refusal``, ...) belongs to the poll thread at world 1 and to the
  dispatching thread at world N."""

  def __init__(self, engine: ServeEngine, path: str, plan,
               base_fingerprint: Optional[str] = None,
               translator=None, poll_interval_s: float = 0.05,
               telemetry=None, subscriber_id: Optional[str] = None,
               heartbeat: bool = True,
               retry_policy: retry.RetryPolicy = retry.DEFAULT_POLICY,
               base_manifest: Optional[Dict[str, Any]] = None,
               poll_jitter_s: float = 0.0):
    self.engine = engine          # guarded-by: engine.lock [writes]
    self.path = path
    self.plan = plan
    self.translator = translator  # guarded-by: engine.lock [writes]
    self.poll_interval_s = float(poll_interval_s)
    self.poll_jitter_s = float(poll_jitter_s)
    self.telemetry = telemetry if telemetry is not None else _registry()
    self.retry_policy = retry_policy
    if subscriber_id is None:
      subscriber_id = f"sub-{os.getpid()}-{_trace.mint_id(4)}"
    self.subscriber_id = subscriber_id
    self.poll_phase_s = poll_phase(subscriber_id, self.poll_jitter_s)
    self.poll_walls: list = []  # the last poll stamps (bounded)
    self.mesh = engine.mesh
    # at world N only rank 0 speaks for the server in the pubdir
    self.heartbeat = heartbeat and (self.mesh is None or self.mesh.rank == 0)
    if base_fingerprint is not None:
      self.base_fingerprint = base_fingerprint
      bman = base_manifest
      if bman is None:
        try:
          bman = self._retried(read_manifest,
                               os.path.join(path, BASE_DIR))
        except (OSError, ValueError):
          bman = {}
    else:
      self.base_fingerprint, bman = self._retried(
          _fp_and_manifest, os.path.join(path, BASE_DIR))
    self.applied_seq, self.fingerprint, self.chain_root = \
        _chain_anchor(bman, self.base_fingerprint)
    # world N: what rank 0's poll validated, ahead of what is applied
    self._ready_seq, self._ready_fp = self.applied_seq, self.fingerprint
    self.last_refusal: Optional[Dict[str, Any]] = None
    self.last_error: Optional[BaseException] = None
    self._comp_cache: Optional[tuple] = None
    self.freshness = self.telemetry.histogram(
        "stream/freshness_s", rel_err=FRESHNESS_REL_ERR,
        max_buckets=FRESHNESS_MAX_BUCKETS)
    self._factory: Optional[Dict[str, Any]] = None
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    # (seconds building off the lock, seconds under it) per promote
    self.promote_s: List[Tuple[float, float]] = []

  # ---- retried filesystem reads -------------------------------------------
  def _retried(self, fn, *args):
    """One filesystem read under the subscriber's retry policy (a
    transient ``OSError`` is retried with backoff, counted
    ``retry/attempts``); each attempt fires ``stream_read``."""
    def attempt():
      faultinject.fire("stream_read", op=getattr(fn, "__name__", "read"))
      return fn(*args)
    return retry.retry_call(attempt, policy=self.retry_policy)

  def _read_npz(self, fpath: str) -> Dict[str, np.ndarray]:
    def _load():
      with np.load(fpath) as z:
        return {k: np.asarray(v) for k, v in z.items()}
    _load.__name__ = "npz:" + os.path.basename(fpath)
    return self._retried(_load)

  @classmethod
  def from_artifact(cls, model, plan, path: str, mesh=None,
                    tier_config=None, with_metrics: bool = False,
                    poll_interval_s: float = 0.05,
                    telemetry=None, subscriber_id: Optional[str] = None,
                    heartbeat: bool = True,
                    retry_policy=retry.DEFAULT_POLICY,
                    poll_jitter_s: float = 0.0,
                    device="cuda") -> "DeltaSubscriber":
    """Load ``<path>/base`` and build the engine + subscriber pair (at
    world N every rank, with its mesh).

    A compacted base anchors the subscriber at its ``through_seq``
    (a cold start loads base + tail). The fingerprint is read before AND
    after the load, so a compactor's base swap mid-load retries."""
    base = os.path.join(path, BASE_DIR)
    for _ in range(5):
      fp, bman = _fp_and_manifest(base)
      art = serve_load(base, plan, mesh=mesh, device=device)
      fp_after, _ = _fp_and_manifest(base)
      if fp_after == fp:
        break
    else:
      raise RuntimeError(
          f"base artifact {base!r} kept changing under the load "
          "(a compactor or re-rooting publisher is racing this cold "
          "start faster than it can read); retry when the pubdir "
          "settles")
    engine = ServeEngine(model, plan, art, device=device, mesh=mesh,
                         tier_config=tier_config,
                         with_metrics=with_metrics, telemetry=telemetry)
    sub = cls(engine, path, plan, base_fingerprint=fp,
              base_manifest=bman,
              translator=art.vocab, poll_interval_s=poll_interval_s,
              telemetry=telemetry, subscriber_id=subscriber_id,
              heartbeat=heartbeat, retry_policy=retry_policy,
              poll_jitter_s=poll_jitter_s)
    sub._factory = dict(model=model, mesh=mesh, tier_config=tier_config,
                        with_metrics=with_metrics, device=device)
    return sub

  # ---- the serve surface --------------------------------------------------
  def dispatch(self, numerical, cats):
    """Translate (dynvocab snapshots) + dispatch, atomic against
    promotion: the engine lock pairs the id space with the row values it
    was trained under. Bind THIS to the micro-batcher (at world N:
    ``serving.world_batcher(subscriber, ...)``, which folds through the
    leader's seq first, :meth:`dispatch_at`)."""
    while True:
      eng = self.engine
      with eng.lock:
        if eng is not self.engine:
          # a rebase swapped engines while this waited on the OLD lock
          continue
        translator = self.translator
        tcats = translator.translate(list(cats)) \
            if translator is not None else cats
        return eng.dispatch(numerical, tcats)

  def predict(self, numerical, cats):
    out = self.dispatch(numerical, cats)
    if isinstance(out, tuple):
      preds, metrics = out
      return preds.cpu().numpy(), {
          "tier": {k: v.cpu().numpy() for k, v in metrics["tier"].items()}}
    return out.cpu().numpy()

  # ---- world N: the lockstep fold -----------------------------------------
  def lockstep_seq(self) -> int:
    """Rank 0: the seq every rank folds through before the next dispatch
    (the newest delta rank 0's poll validated); it rides the leader's
    request header."""
    return self._ready_seq

  def dispatch_at(self, seq: int, numerical, cats):
    """Fold this rank's rows of every delta through ``seq`` (the
    leader's header), then dispatch: every rank swaps at the same
    dispatch boundary."""
    while self.applied_seq < int(seq):
      self._fold_lockstep(self.applied_seq + 1)
    return self.dispatch(numerical, cats)

  def _fold_lockstep(self, seq: int) -> None:
    """Apply delta ``seq`` (validated by rank 0's poll) to this rank."""
    path = os.path.join(self.path, delta_dirname(seq))
    manifest = self._retried(read_manifest, path)
    if manifest.get("base_fingerprint") != self.fingerprint:
      raise RuntimeError(
          f"rank {self.mesh.rank}: delta {seq} chains base_fingerprint "
          f"{str(manifest.get('base_fingerprint'))[:12]}... but this rank "
          f"applied {self.fingerprint[:12]}... — the ranks' chains "
          "diverged; the lockstep fold cannot continue")
    meta, rows = self._load_rows(path, manifest, [self.mesh.rank])
    problem = self._check_rows(meta, rows)
    if problem is not None:
      raise RuntimeError(f"rank {self.mesh.rank}: delta {seq}: "
                         f"{problem[1]}")
    self._apply(path, manifest, meta, rows, seq)

  # ---- polling ------------------------------------------------------------
  def start(self) -> "DeltaSubscriber":
    """Poll on a daemon thread until :meth:`stop` (at world N on rank 0
    only). Errors are recorded (``last_error`` + ``stream/poll_errors``),
    never thread-fatal."""
    if self.mesh is not None and self.mesh.rank != 0:
      return self
    if self._thread is not None and self._thread.is_alive():
      return self
    self._stop.clear()
    self._thread = threading.Thread(target=self._poll_loop,
                                    name="stream-delta-subscriber",
                                    daemon=True)
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=10.0)
    # leave the /healthz quorum: a decommissioned subscriber's promote
    # gauges must not read as a stalled sibling forever
    _clear_promote(self.telemetry, self.subscriber_id)

  def _poll_loop(self) -> None:
    if self.poll_phase_s:
      self._stop.wait(self.poll_phase_s)
    while not self._stop.is_set():
      self.poll_walls.append(time.monotonic())
      del self.poll_walls[:-64]
      try:
        self.poll_once()
      except Exception as e:  # noqa: BLE001 — recorded, the loop survives
        self.last_error = e
        self.telemetry.counter("stream/poll_errors").inc()
      self._stop.wait(self.poll_interval_s)

  def _base_compaction(self, base: str, fp: str):
    """The base's compacted section if it belongs to OUR chain (else
    None), cached by fingerprint (the fingerprint IS the manifest's
    sha256, so the answer for one is immutable)."""
    cached = self._comp_cache
    if cached is not None and cached[0] == fp:
      comp = cached[1]
    else:
      try:
        bman = self._retried(read_manifest, base)
      except (OSError, ValueError):
        return None  # transient: not cached, re-read next poll
      comp = (bman.get("stream") or {}).get("compacted")
      self._comp_cache = (fp, comp)
    if comp and comp.get("chain_root") == self.chain_root:
      return comp
    return None

  def poll_once(self) -> int:
    """Scan + apply every ready delta in seq order; returns how many
    were applied (a rebase counts as one). Stops at the first refusal,
    and publishes this subscriber's heartbeat either way. At world N
    (rank 0) it validates instead of applying: the count is of deltas
    newly made ready for the next dispatch."""
    if self.mesh is not None and self.mesh.rank != 0:
      raise RuntimeError("at world N only rank 0 polls; the other ranks "
                         "fold through the leader's seq (dispatch_at)")
    applied = 0
    current = self.base_fingerprint
    base = os.path.join(self.path, BASE_DIR)
    try:
      if os.path.isfile(os.path.join(base, "manifest.json")):
        current = self._retried(manifest_fingerprint, base)
        if current != self.base_fingerprint:
          comp = self._base_compaction(base, current)
          if comp is not None:
            # our own chain, compacted: behind our position only the
            # base's identity changed; past it, the tail deltas may still
            # exist (retention floor), else the gap branch below rebases
            self.base_fingerprint = current
            self.telemetry.counter("stream/compactions_adopted").inc()
          else:
            self._rebase(base, current)
            applied += 1
      while True:
        seq = self._head_seq() + 1
        path = os.path.join(self.path, delta_dirname(seq))
        if not os.path.isfile(os.path.join(path, "manifest.json")):
          comp = self._base_compaction(base, current)
          if comp is not None \
              and int(comp["through_seq"]) > self._head_seq():
            # the delta we need was folded into the compacted base and
            # GC'd: rebase onto it, then keep folding its tail
            self._rebase(base, current)
            applied += 1
            continue
          later = [s for s in published_delta_seqs(self.path) if s > seq]
          if later:
            self._refuse(seq, "seq",
                         f"delta {min(later)} is published but delta "
                         f"{seq} is missing — out-of-order publication; "
                         "holding at the last valid artifact")
          break
        if not self._validate_and_apply(path, seq):
          break
        applied += 1
    finally:
      if self.heartbeat:
        try:
          write_heartbeat(self.path, self.subscriber_id,
                          self.applied_seq, self.fingerprint)
        except OSError:
          self.telemetry.counter("stream/heartbeat_errors").inc()
    return applied

  def _head_seq(self) -> int:
    """The last seq this poll has taken: applied (world 1) or validated
    for the next dispatch (world N)."""
    return self.applied_seq if self.mesh is None else self._ready_seq

  # ---- validation ---------------------------------------------------------
  def _refuse(self, seq: int, field: str, reason: str) -> bool:
    self.last_refusal = {"seq": seq, "field": field, "reason": reason}
    self.telemetry.counter("stream/deltas_refused").inc()
    # a refusal degrades serving to staleness: capture the moment
    _flight.flight_trip("refusal", seq=seq, field=field,
                        member=self.subscriber_id)
    return False

  def _check_rows(self, meta, rows: Rows) -> Optional[Tuple[str, str]]:
    """``(field, reason)`` of the first row payload that does not fit the
    engine's serve geometry, else None. Explicit bounds on externally
    derived indices: a silent drop of an out-of-range row would break the
    delta == re-export invariant."""
    world = self.plan.world_size
    for name, m in meta.items():
      have = self.engine.meta.get(name)
      if have is None or m.packed != have.packed:
        return ("geometry",
                f"delta class {name!r} geometry {m.to_json()} does not "
                "match the engine's serve geometry — artifact and engine "
                "disagree")
    for name, per_rank in rows.items():
      n_rows = meta[name].rows
      lanes = meta[name].lanes
      for rank, (idx, data) in per_rank.items():
        if rank < 0 or rank >= world:
          return ("rows", f"class {name!r}: delta names rank {rank} "
                  f"outside [0, {world})")
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_rows):
          bad = int(idx.min() if idx.min() < 0 else idx.max())
          return ("rows", f"class {name!r} rank {rank}: delta row index "
                  f"{bad} outside this class's [0, {n_rows}) logical rows")
        if data.shape != (idx.size, lanes):
          return ("rows", f"class {name!r} rank {rank}: row data shape "
                  f"{data.shape} != ({idx.size}, {lanes})")
    return None

  def _validate_and_apply(self, path: str, seq: int) -> bool:
    prev_fp = self.fingerprint if self.mesh is None else self._ready_fp
    with _span("stream/validate", args={"seq": seq}):
      problems = self._retried(verify_dir, path)
      if problems:
        return self._refuse(
            seq, "checksums",
            f"torn or corrupt delta {path!r}: " + "; ".join(problems))
      manifest = self._retried(read_manifest, path)
      if manifest.get("kind") != "serve_delta" \
          or manifest.get("format_version") != DELTA_FORMAT_VERSION:
        return self._refuse(
            seq, "kind",
            f"{path!r} is not a v{DELTA_FORMAT_VERSION} serve_delta "
            f"(kind={manifest.get('kind')!r}, "
            f"format={manifest.get('format_version')!r})")
      if int(manifest["seq"]) != seq:
        return self._refuse(
            seq, "seq",
            f"directory {os.path.basename(path)} carries manifest seq "
            f"{manifest['seq']} — expected {seq}; out-of-order or "
            "renamed delta refused")
      if manifest["base_fingerprint"] != prev_fp:
        return self._refuse(
            seq, "base_fingerprint",
            f"delta {seq} chains base_fingerprint "
            f"{manifest['base_fingerprint'][:12]}... but the last "
            f"applied artifact is {prev_fp[:12]}... — the "
            "publisher re-rooted or forked; refusing to fold a delta "
            "built against different predecessor rows")
      if manifest["plan"] != _plan_fingerprint(self.plan):
        return self._refuse(
            seq, "plan",
            "delta plan fingerprint does not match the serving plan — "
            "serve artifacts do not re-shard; re-export under this plan")
      if manifest["serve"]["quantize"] != self.engine.quantize:
        return self._refuse(
            seq, "quantize",
            f"delta quantize={manifest['serve']['quantize']!r} but the "
            f"engine serves {self.engine.quantize!r}")
      try:
        meta, rows = self._load_rows(path, manifest)
      except (OSError, KeyError, ValueError) as e:
        return self._refuse(seq, "rows",
                            f"unreadable delta row payload: {e!r}")
      problem = self._check_rows(meta, rows)
      if problem is not None:
        return self._refuse(seq, *problem)
    if self.mesh is not None:
      # world N: ready for the next dispatch, where every rank folds it
      self._ready_seq, self._ready_fp = seq, manifest_fingerprint(path)
      return True
    self._apply(path, manifest, meta, rows, seq)
    return True

  # ---- application --------------------------------------------------------
  def _load_rows(self, path: str, manifest: Dict[str, Any], ranks=None):
    """Delta row payloads, host-side: ``{name: {rank: (idx, data)}}``
    (``ranks``: only these ranks' files). Every read goes through the
    retry policy."""
    meta = {n: ServeClassMeta.from_json(n, d)
            for n, d in manifest["serve"]["classes"].items()}
    out: Rows = {}
    for name, per_rank in manifest["stream"]["rows"].items():
      m = meta[name]
      out[name] = {}
      for rank_s in per_rank:
        rank = int(rank_s)
        if ranks is not None and rank not in ranks:
          continue
        z = self._read_npz(os.path.join(path, f"rows_{name}_r{rank}.npz"))
        idx = np.asarray(z["idx"], np.int64)
        data = m.from_disk(np.asarray(z["data"]))
        out[name][rank] = (idx, data)
    return meta, out

  def _local_index(self, rank: int) -> int:
    """Position of ``rank``'s block in this engine's buffers."""
    return rank if self.mesh is None else 0

  def _build_device_updates(self, rows: Rows) -> Dict[str, torch.Tensor]:
    """The cloned serve blocks with the delta's rows written in, for the
    device-tier classes: the expensive half of copy-on-promote, run OFF
    the dispatch lock; the caller synchronizes before the swap."""
    eng = self.engine
    updates: Dict[str, torch.Tensor] = {}
    for name, per_rank in rows.items():
      m = eng.meta[name]
      if m.tier != "device" or not per_rank:
        continue
      lay = m.packed
      new = eng.state["serve"][name].clone()
      for rank, (idx, data) in sorted(per_rank.items()):
        # this rank's logical rows, offset to its block
        scatter_rows(new, lay.rows_per_phys, m.lanes,
                     self._local_index(rank) * lay.phys_rows
                     * lay.rows_per_phys + idx, data)
      updates[name] = new
    return updates

  def _fold_tiered(self, rows: Rows,
                   new_images: Dict[str, Dict[int, np.ndarray]],
                   counts: Dict[str, Dict[int, np.ndarray]]) -> None:
    """Under the engine lock: swap the image copies in, refresh the
    resident cache rows whose image rows changed, adopt the shipped
    counts, re-rank. Value-preserving throughout: the serve output for
    any id is a pure function of the promoted images."""
    eng = self.engine
    store = eng.store
    serve = eng.state["serve"]
    for name, per_rank in new_images.items():
      c = eng.tplan.by_name(name)
      lay, spec = c.layout_logical, c.spec
      per = spec.cache_grps + spec.staging_grps
      for rank, img in sorted(per_rank.items()):
        store.images[name][rank] = img
        idx, _ = rows[name][rank]
        changed_pg = np.unique(idx // lay.rows_per_phys)
        slots = store.resident_map[name][rank][changed_pg]
        hot = slots >= 0
        if np.any(hot):
          buf = serve[name]
          gidx = torch.from_numpy(self._local_index(rank) * per
                                  + slots[hot].astype(np.int64))
          vals = host_gather_rows(lay, img, changed_pg[hot].astype(np.int64))
          buf[gidx.to(buf.device)] = torch.from_numpy(vals).to(buf.device)
    for name, per_rank in counts.items():
      for rank, cnt in sorted(per_rank.items()):
        store.counts[name][rank][:] = cnt
    if counts:
      # the shipped counts ARE the ranked signal: re-rank without a
      # second decay, so repeated deltas with stable counts are stable
      eng.prefetcher.rerank(serve, decay=False)

  def _apply(self, path: str, manifest: Dict[str, Any], meta, rows: Rows,
             seq: int) -> None:
    eng = self.engine
    faultinject.fire("delta_promote", seq=seq)
    with _trace.use_context(_trace.mint_context()), \
        _span("stream/promote", args={"seq": seq}):
      # --- build everything off the dispatch lock ---
      t0 = time.perf_counter()
      updates = self._build_device_updates(rows)
      new_images: Dict[str, Dict[int, np.ndarray]] = {}
      for name, per_rank in rows.items():
        m = eng.meta[name]
        if m.tier != "host":
          continue
        new_images[name] = {}
        for rank, (idx, data) in sorted(per_rank.items()):
          img = eng.store.images[name][rank].copy()
          scatter_rows(img, m.packed.rows_per_phys, m.lanes, idx, data)
          new_images[name][rank] = img
      counts: Dict[str, Dict[int, np.ndarray]] = {}
      for name in manifest["stream"].get("counts_classes", []):
        if eng.meta[name].tier != "host":
          continue
        z = self._read_npz(os.path.join(path, f"counts_{name}.npz"))
        counts[name] = {int(k[1:]): np.asarray(v, np.int64)
                        for k, v in z.items()}
      trees = {part: _unflatten_paths(self._read_npz(
          os.path.join(path, f"{part}.npz")))
          for part in ("dense", "emb_dense")}
      parts = serve_dense_state(
          trees, self.plan, None if self.mesh is None else self.mesh.rank,
          eng.device)
      translator = self.translator
      if manifest.get("vocab_snapshot") is not None:
        from ..dynvocab import ReadonlyIdTranslator
        translator = ReadonlyIdTranslator.from_arrays(
            self._read_npz(os.path.join(path, "vocab_snapshot.npz")))
      # the new blocks are complete before the lock is taken
      _sync(eng.device)
      t1 = time.perf_counter()

      # --- the swap: reference promotion between dispatches ---
      with eng.lock:
        eng.state["serve"] = dict(eng.state["serve"], **updates)
        if new_images or counts:
          self._fold_tiered(rows, new_images, counts)
        if parts["dense"]:
          eng.model.load_state_dict(parts["dense"])
        eng.state["dense"] = parts["dense"]
        eng.state["emb_dense"] = parts["emb_dense"]
        eng.step = int(manifest["step"])  # the served watermark
        self.translator = translator
        t2 = time.perf_counter()
      self.promote_s.append((t1 - t0, t2 - t1))
      del self.promote_s[:-1024]

    self.applied_seq = seq
    self.fingerprint = manifest_fingerprint(path)
    self.last_refusal = None
    if self.heartbeat:
      # heartbeat per applied delta, not just per poll: one poll can
      # drain a long backlog
      try:
        write_heartbeat(self.path, self.subscriber_id, seq,
                        self.fingerprint)
      except OSError:
        self.telemetry.counter("stream/heartbeat_errors").inc()
    reg = self.telemetry
    reg.counter("stream/deltas_applied").inc()
    reg.counter("stream/rows_applied").inc(
        sum(idx.size for per in rows.values() for idx, _ in per.values()))
    reg.gauge("stream/applied_seq").set(seq)
    _record_promote(reg, int(manifest["step"]), self.subscriber_id)
    oldest = manifest["stream"].get("train_wall_oldest")
    if oldest is not None:
      self.freshness.observe(max(0.0, time.time() - float(oldest)))

  # ---- rebase (the publisher re-rooted the chain) -------------------------
  def _rebase(self, base: str, fingerprint: str) -> None:
    if self._factory is None:
      raise RuntimeError(
          "the publish directory's base artifact changed (fingerprint "
          f"{fingerprint[:12]}... != {self.base_fingerprint[:12]}...) "
          "but this subscriber was constructed without a factory — "
          "build it with DeltaSubscriber.from_artifact to enable "
          "automatic rebase, or rebuild the engine by hand.")
    if self.mesh is not None:
      raise NotImplementedError(
          "a rebase at world N: the base artifact was re-rooted "
          f"({fingerprint[:12]}...), and reloading it must happen on "
          "every rank at one dispatch boundary, which the lockstep "
          "header does not carry; restart the world-N server on the new "
          "base")
    with _span("stream/rebase"):
      f = self._factory
      # fingerprint + anchoring manifest from ONE read, re-checked after
      # the load: the engine's rows and the anchor describe one version
      for _ in range(5):
        fp, bman = self._retried(_fp_and_manifest, base)
        art = serve_load(base, self.plan, device=f["device"])
        fp_after, _ = self._retried(_fp_and_manifest, base)
        if fp_after == fp:
          break
      else:
        raise RuntimeError(
            f"base artifact {base!r} kept changing under the rebase; "
            "retrying next poll")
      # a model of its own: the old engine may still be dispatching
      # with the current one's parameters
      engine = ServeEngine(copy.deepcopy(f["model"]), self.plan, art,
                           device=f["device"],
                           tier_config=f["tier_config"],
                           with_metrics=f["with_metrics"],
                           telemetry=self.telemetry)
      anchor_seq, anchor_fp, root = _chain_anchor(bman, fp)
      old = self.engine
      with old.lock:
        self.engine = engine
        self.translator = art.vocab
        self.base_fingerprint = fp
        self.fingerprint = anchor_fp
        self.chain_root = root
        self.applied_seq = anchor_seq
        self._ready_seq, self._ready_fp = anchor_seq, anchor_fp
      self.telemetry.counter("stream/rebases").inc()
