"""Incremental (delta) publication of a live train state to serving
(PyTorch port of ``streaming/publish.py``).

The full serve export (:mod:`..serving.export`) re-publishes every row;
a continuously retraining recommender changes a small, traffic-shaped
share of its rows between publishes, and its train -> serve freshness lag
is a product metric. Given the run's
:class:`~.generations.RowGenerationTracker`, :meth:`DeltaPublisher.
publish_delta` extracts only the logical rows whose generation advanced
past the last publication watermark, quantizes them with the serve row
codecs (f32 / int8 / fp8) and seals them as ``delta_<seq>/`` through the
checkpoint layer's crc32-manifest-last protocol.

Extraction of a device-tier class gathers each rank block's changed
PHYSICAL rows in one pass on the buffer's device (K4, ``ops/
cuda_exchange.gather_rows``, on a CUDA buffer; its plain version on a
CPU one), selects the changed rows' table lanes there, quantizes them
there, and copies the result to the host once: no per-window read and no
per-window sync. The bytes equal the JAX package's window-wise reads
(:func:`extract_changed_rows`, kept for the tiered classes, whose rows
live in host images read through the store's flush-free overlay). The
``delta_extract`` fault site still fires once per merged window, with the
JAX package's ``rows=``.

Chain rule (torn, out-of-order or forked deltas are refused by
construction on the serve side): every published artifact is identified
by ``checkpoint.manifest_fingerprint`` (sha256 of its manifest, which
carries every data file's crc32 and size), and delta ``seq`` records the
fingerprint of its predecessor (``base_fingerprint``: delta 1 links the
base export, delta k links delta k-1).

Delta contents, per ``delta_<seq>/`` (the JAX package's files, name for
name)::

    manifest.json                  seq, chained base_fingerprint, plan
                                   fingerprint, serve geometry, stream
                                   section (row counts per class/rank),
                                   freshness wall anchors, checksums
    rows_<class>_r<rank>.npz       {'idx': int64 changed logical rows,
                                    'data': [n, lanes] serve-layout rows}
    counts_<class>.npz             per-rank per-serve-physical-row
                                   observed counts (host-tier classes)
    dense.npz / emb_dense.npz      model params (the flax tree) and the
                                   dense-class tables, shipped whole
    vocab_snapshot.npz             the read-only dynvocab mapping
                                   (``oov='allocate'`` runs)

The JAX publisher is single-controller. The port runs one process per
rank, as its ``serving.export(mesh=)`` does: at world N every rank
builds a publisher with its ``mesh`` and calls each method, every rank's
tracker observes the same global batches, each rank extracts and seals
its own block's ``rows_<class>_r<rank>.npz`` into the shared
``delta_<seq>.tmp``, and rank 0 writes the shared files, gathers the
checksum tables and publishes the manifest last. Rank 0 takes the
back-pressure decision and broadcasts it. Without a mesh one process
holds every rank's blocks and writes every file, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import hostarrays
from ..checkpoint import (
    _crc32_file,
    _flatten_with_paths,
    _fsync_path,
    _host,
    _plan_fingerprint,
    _state_rank,
    blocks_on_root,
    manifest_fingerprint,
    publish_manifest_last,
    read_manifest,
)
from ..checkpoint import verify as verify_dir
from ..ops.cuda_exchange import gather_rows
from ..ops.packed_table import PackedLayout, SparseRule
from ..parallel.lookup_engine import DistributedLookup
from ..resilience import faultinject
from ..serving.export import (
    QUANTIZE_MODES,
    quantize_rows,
    serve_class_meta,
    vocab_snapshot,
)
from ..serving.export import export as full_export
from ..telemetry import get_registry as _registry, span as _span
from .generations import RowGenerationTracker

DELTA_FORMAT_VERSION = 1
BASE_DIR = "base"
HEARTBEAT_DIR = "heartbeats"
_DELTA_RE = re.compile(r"^delta_(\d{6})$")

# fired once per contiguous physical-row window an extract covers
DELTA_EXTRACT_SITE = faultinject.register_site("delta_extract")
# fired per data file sealed into a delta's .tmp directory (a kill here
# leaves a torn delta_<seq>.tmp without disturbing the ckpt_write counts
# of the trainer's own snapshots)
DELTA_SEAL_SITE = faultinject.register_site("delta_seal")
# fired once per tail delta a publisher's attach validates
STREAM_ATTACH_SITE = faultinject.register_site("stream_attach")

# runs of changed physical rows closer than this merge into one window
MERGE_GAP = 8


class ChainDivergedError(RuntimeError):
  """A publisher's attach found the pubdir chain incompatible with its
  restored state: re-joining would fork the chain or serve rows built
  against another predecessor state. ``field`` names the failing
  manifest field. The remedy is explicit: re-root with ``publish_base``
  (every subscriber rebases), never silent."""

  def __init__(self, field: str, msg: str):
    super().__init__(msg)
    self.field = field


def delta_dirname(seq: int) -> str:
  return f"delta_{seq:06d}"


def validate_chain_link(path: str, seq: int, prev_fp: str,
                        plan_fp=None, quantize: Optional[str] = None,
                        where: str = "chain"
                        ) -> Tuple[Dict[str, Any], str]:
  """One delta's chain-continuity validation, the refusal protocol the
  publisher's attach walk and the compactor's fold walk share: directory
  integrity against its own crc32 manifest, ``base_fingerprint``
  continuity from ``prev_fp``, and (when given) plan-fingerprint and
  quantize equality; a break raises :class:`ChainDivergedError` naming
  the field. Returns ``(manifest, fingerprint)`` for the next link."""
  problems = verify_dir(path)
  if problems:
    raise ChainDivergedError(
        "checksums",
        f"{where}: delta {seq} fails integrity verification: "
        + "; ".join(problems))
  man = read_manifest(path)
  if man.get("base_fingerprint") != prev_fp:
    raise ChainDivergedError(
        "base_fingerprint",
        f"{where}: delta {seq} chains base_fingerprint "
        f"{str(man.get('base_fingerprint'))[:12]}... but the validated "
        f"predecessor is {prev_fp[:12]}... — the chain is forked; "
        "refusing to adopt it")
  if plan_fp is not None and man.get("plan") != plan_fp:
    raise ChainDivergedError(
        "plan",
        f"{where}: delta {seq} was published under a different plan "
        "fingerprint — this chain cannot be continued under the "
        "current plan")
  if quantize is not None and man["serve"]["quantize"] != quantize:
    raise ChainDivergedError(
        "quantize",
        f"{where}: delta {seq} quantizes "
        f"{man['serve']['quantize']!r}, expected {quantize!r} — a "
        "chain never changes row codec mid-stream")
  return man, manifest_fingerprint(path)


def chain_anchor(base_manifest: Dict[str, Any], fp_base: str
                 ) -> Tuple[int, str, str]:
  """Where a (possibly compacted) base artifact anchors the chain:
  ``(applied_seq, fingerprint, chain_root)``. A plain base anchors at
  seq 0 with its own fingerprint as link and root; a compacted base
  (its ``stream.compacted`` section, :mod:`.compact`) at its
  ``through_seq`` with ``through_fingerprint`` as the link, carrying the
  original chain root forward."""
  comp = (base_manifest.get("stream") or {}).get("compacted")
  if comp:
    return (int(comp["through_seq"]), comp["through_fingerprint"],
            comp.get("chain_root", fp_base))
  return 0, fp_base, fp_base


def published_delta_seqs(path: str) -> List[int]:
  """Seq numbers of the PUBLISHED deltas under ``path``. A torn
  ``delta_<seq>.tmp``, ``.old`` rotations, a manifest-less delta
  directory, a stray file named like a delta, foreign directories and
  entries that vanish mid-scan are all ignored."""
  out = []
  try:
    names = os.listdir(path)
  except OSError:
    return out
  for name in names:
    m = _DELTA_RE.match(name)
    if not m:
      continue
    try:
      entry = os.path.join(path, name)
      if os.path.isdir(entry) \
          and os.path.isfile(os.path.join(entry, "manifest.json")):
        out.append(int(m.group(1)))
    except OSError:
      continue  # vanished mid-scan (a concurrent GC) or unreadable
  return sorted(out)


# ---------------------------------------------------------------------------
# subscriber heartbeats (the back-pressure / retention signal)
# ---------------------------------------------------------------------------


def heartbeat_path(path: str, subscriber_id: str) -> str:
  return os.path.join(path, HEARTBEAT_DIR, subscriber_id + ".json")


def write_heartbeat(path: str, subscriber_id: str, applied_seq: int,
                    fingerprint: Optional[str] = None) -> None:
  """Atomically publish one subscriber's liveness and applied position
  into the pubdir (fsync, atomic replace, directory fsync: a crash never
  leaves a torn heartbeat)."""
  from ..telemetry import atomic_write_text
  os.makedirs(os.path.join(path, HEARTBEAT_DIR), exist_ok=True)
  atomic_write_text(
      heartbeat_path(path, subscriber_id),
      json.dumps({"id": subscriber_id, "applied_seq": int(applied_seq),
                  "fingerprint": fingerprint, "wall": time.time()}))


def read_heartbeats(path: str, ttl_s: float
                    ) -> Tuple[Dict[str, Dict[str, Any]],
                               Dict[str, Dict[str, Any]]]:
  """``(live, expired)`` heartbeat records keyed by subscriber id.

  A record older than ``ttl_s`` is EXPIRED: dropped from the
  back-pressure quorum and the GC retention floor. Foreign or malformed
  files are ignored. Transient ``OSError`` reads are retried (counted
  ``retry/attempts``); a file still unreadable after the retries is
  returned as EXPIRED with ``unreadable: True``."""
  from ..resilience import retry

  live: Dict[str, Dict[str, Any]] = {}
  expired: Dict[str, Dict[str, Any]] = {}
  hb_dir = os.path.join(path, HEARTBEAT_DIR)
  try:
    names = retry.retry_call(os.listdir, hb_dir)
  except FileNotFoundError:
    return live, expired  # no heartbeat directory yet: no subscribers
  except OSError:
    return live, expired  # unreadable even after the retries
  now = time.time()
  for name in names:
    if not name.endswith(".json"):
      continue
    fp = os.path.join(hb_dir, name)

    def read_one(fp=fp):
      with open(fp) as f:
        return json.load(f)

    try:
      rec = retry.retry_call(read_one)
      sid = str(rec["id"])
      rec["applied_seq"] = int(rec["applied_seq"])
      rec["wall"] = float(rec["wall"])
    except FileNotFoundError:
      continue  # withdrawn between the listing and the read
    except OSError:
      # retries exhausted: the member is expired, not a crash
      sid = name[:-len(".json")]
      expired[sid] = {"id": sid, "applied_seq": -1, "wall": 0.0,
                      "unreadable": True}
      continue
    except (ValueError, KeyError, TypeError):
      continue
    (expired if now - rec["wall"] > ttl_s else live)[sid] = rec
  return live, expired


def artifact_bytes(path: str) -> int:
  """Total payload bytes of one published artifact (from its manifest's
  checksum table)."""
  return sum(int(v["size"])
             for v in read_manifest(path).get("checksums", {}).values())


def scatter_rows(image, rpp: int, lanes: int, idx: np.ndarray,
                 data: np.ndarray) -> None:
  """Write the serve-layout lanes ``data`` of the logical rows ``idx``
  (unique) into a serve image in place, numpy or torch: logical row ``i``
  is window ``i % rpp`` of physical row ``i // rpp``. Indexes a
  ``[phys_rows, rpp, lanes]`` view of the image's windows, so the index
  arrays are a row's, not a lane's."""
  if isinstance(image, torch.Tensor):
    win = image.as_strided((image.shape[0], rpp, lanes),
                           (image.stride(0), lanes, 1))
    dev = image.device
    win[torch.from_numpy(idx // rpp).to(dev),
        torch.from_numpy(idx % rpp).to(dev)] = torch.from_numpy(
            np.ascontiguousarray(data)).to(dev)
    return
  win = np.lib.stride_tricks.as_strided(
      image, (image.shape[0], rpp, lanes),
      (image.strides[0], lanes * image.itemsize, image.itemsize))
  win[idx // rpp, idx % rpp] = data


def _windows(pg: np.ndarray, merge_gap: int = MERGE_GAP
             ) -> Tuple[np.ndarray, np.ndarray]:
  """The sorted changed physical rows ``pg`` of one rank block as the
  windows an extract reads: ``(first, last)`` physical rows of each run
  (runs closer than ``merge_gap`` physical rows merge)."""
  cut = np.flatnonzero(np.diff(pg) > merge_gap)
  return (pg[np.concatenate([[0], cut + 1])],
          pg[np.concatenate([cut, [pg.size - 1]])])


def extract_changed_rows(lay: PackedLayout, reader, changed: np.ndarray,
                         merge_gap: int = MERGE_GAP) -> np.ndarray:
  """Changed LOGICAL rows of one packed rank block, window-wise (the
  JAX package's form; the tiered classes' host images are read so).

  ``reader(p0, p1)`` returns physical rows ``[p0, p1)`` of the block;
  ``changed`` is the sorted logical-row set. Each merged run of physical
  rows is read as one window, unpacked (a reshape) and the changed rows'
  table lanes selected, so peak memory is one window. Returns ``[len(
  changed), width]`` f32."""
  if not changed.size:
    return np.zeros((0, lay.width), np.float32)
  rpp = lay.rows_per_phys
  out = np.empty((changed.size, lay.width), np.float32)
  done = 0
  for first, last in zip(*_windows(np.unique(changed // rpp), merge_gap)):
    p0, p1 = int(first), int(last) + 1
    faultinject.fire("delta_extract", rows=(p1 - p0) * rpp)
    sub = reader(p0, p1)
    if isinstance(sub, torch.Tensor):
      sub = sub.detach().cpu().to(torch.float32).numpy()
    sub = np.asarray(sub)
    sublay = PackedLayout(rows=(p1 - p0) * rpp, width=lay.width,
                          n_aux=lay.n_aux)
    tbl, _aux = sublay.unpack(sub)
    sel = changed[(changed >= p0 * rpp) & (changed < p1 * rpp)]
    out[done:done + sel.size] = np.asarray(tbl, np.float32)[sel - p0 * rpp]
    done += sel.size
  assert done == changed.size
  return out


def gather_changed_rows(lay: PackedLayout, block: torch.Tensor,
                        changed: np.ndarray,
                        merge_gap: int = MERGE_GAP) -> torch.Tensor:
  """Changed LOGICAL rows of one packed rank block, in one pass on the
  block's device: the changed physical rows gathered at once (K4 on a
  CUDA block, its plain version on a CPU one), then the changed rows'
  table lanes selected. Returns ``[len(changed), width]`` in the block's
  dtype, on its device: the bytes of :func:`extract_changed_rows` (a pure
  data movement). ``delta_extract`` fires once per window
  :func:`extract_changed_rows` would read, with its ``rows=``; the
  windows are computed only while a fault injector is installed."""
  if tuple(block.shape) != tuple(lay.shape):
    raise ValueError(f"block {tuple(block.shape)} is not the layout's "
                     f"{tuple(lay.shape)}")
  if not changed.size:
    return torch.zeros((0, lay.width), dtype=block.dtype,
                       device=block.device)
  rpp = lay.rows_per_phys
  pg = np.unique(changed // rpp)
  if faultinject.active() is not None:
    # the window-wise reads' events (a no-op without an injector, so the
    # per-window loop runs only under one)
    first, last = _windows(pg, merge_gap)
    for rows in ((last + 1 - first) * rpp).tolist():
      faultinject.fire("delta_extract", rows=rows)
  # the block as plain physical rows: one "row" a physical row, so the
  # row gather serves every packing
  phys = PackedLayout(rows=lay.phys_rows, width=lay.phys_width, n_aux=0)
  got = gather_rows(phys, block, torch.from_numpy(pg.astype(np.int32)).to(
      block.device))
  pos = torch.from_numpy(np.searchsorted(pg, changed // rpp)).to(
      block.device)
  sub = torch.from_numpy(changed % rpp).to(block.device)
  windows = got[:, :rpp * lay.stride].reshape(pg.size, rpp, lay.stride)
  return windows[pos, sub, :lay.width]


class DeltaPublisher:
  """Trainer-side half of the streaming pipeline.

  Owns the publish directory's chain state (seq, predecessor
  fingerprint, generation watermark). Protocol::

      tracker = RowGenerationTracker(plan)
      pub = DeltaPublisher(pubdir, plan, rule, tracker,
                           quantize="int8", store=store, vocab=translator)
      pub.observe_batch(cats)      # every batch, as the step sees it,
      state = step(state, *batch)  # between steps, host-side
      pub.publish_base(state)      # once: the full export the chain roots at
      pub.publish_delta(state)     # any time later: only advanced rows

  A failed publish leaves a manifest-less ``.tmp`` the subscriber never
  reads; the chain state advances only on success, so the retry
  re-publishes the SAME seq. A restarted publisher re-joins the chain
  with :meth:`attach` (its chain state restored from a checkpoint's
  ``stream`` section) or re-roots it with :meth:`publish_base`.

  Back-pressure: with ``max_subscriber_lag`` set, ``publish_delta``
  reads the subscriber heartbeats and DEFERS publication while a live
  subscriber lags that many deltas; the watermark holds, so the deferred
  intervals coalesce into one superset delta (``publishes_throttled``
  and ``deltas_coalesced`` count the two halves). A heartbeat older than
  ``heartbeat_ttl_s`` drops out of the quorum
  (``stream/subscribers_expired``, counted once).

  ``mesh``: at world N, this rank's mesh (``state`` then holds its own
  blocks, and every rank calls each method; see the module docstring).
  """

  def __init__(self, path: str, plan, rule: SparseRule,
               tracker: RowGenerationTracker, quantize: str = "f32",
               store=None, vocab=None, telemetry=None,
               max_subscriber_lag: Optional[int] = None,
               heartbeat_ttl_s: float = 30.0, mesh=None):
    if quantize not in QUANTIZE_MODES:
      raise ValueError(f"unknown quantize mode {quantize!r}; "
                       f"have {list(QUANTIZE_MODES)}")
    self.path = path
    self.rule = rule
    self.quantize = quantize
    self.vocab = vocab
    self.telemetry = telemetry if telemetry is not None else _registry()
    self._bind_plan(plan, tracker, store, mesh)
    if self._lead:
      os.makedirs(path, exist_ok=True)

    if max_subscriber_lag is not None and max_subscriber_lag < 1:
      raise ValueError(
          f"max_subscriber_lag must be >= 1 (got {max_subscriber_lag}): "
          "lag 0 would defer every publication forever")
    self.max_subscriber_lag = max_subscriber_lag
    self.heartbeat_ttl_s = float(heartbeat_ttl_s)

    # chain state (advances only on successful publication)
    self.seq = 0
    self.fingerprint: Optional[str] = None  # predecessor of the NEXT delta
    self.base_fingerprint: Optional[str] = None
    self.chain_root: Optional[str] = None  # the ORIGINAL base's identity
    self.watermark = 0  # tracker clock covered by the last publication
    self.last_publish_bytes = 0
    # this rank's extract (gather + quantize + host copy) and seal (write,
    # fsync, crc) seconds of the last delta
    self.last_publish_s: Dict[str, float] = {}
    # RESTORED chain state must be re-joined (attach) before publishing;
    # a fresh publisher owns its own new chain
    self.attached = True
    self._expired_ids: set = set()
    self._throttled_pending = False

  def _bind_plan(self, plan, tracker: RowGenerationTracker, store,
                 mesh) -> None:
    """Validate and adopt one (plan, tracker, store, mesh) binding: the
    constructor's and :meth:`re_root`'s, so both derive the same
    extraction geometry."""
    if tracker.plan is not plan:
      raise ValueError(
          "tracker was built for a different plan object: the routing "
          "recipe and class geometry must be THIS plan's.")
    if store is None and plan.host_tier_class_keys():
      raise ValueError(
          "plan has host-tier classes but no HostTierStore was passed: "
          "the cold images hold the authoritative rows the delta must "
          "read. Pass the run's store.")
    rank = _state_rank(plan, mesh)
    if store is not None and rank is None and not store.owns_all:
      raise ValueError(
          "a rank-owner store (owned_ranks=) without a mesh: each rank "
          "publishes its own rows with its mesh")
    self.plan = plan
    self.tracker = tracker
    self.store = store
    self.mesh = mesh if rank is not None else None
    self._rank = rank
    self._lead = rank in (None, 0)
    engine = DistributedLookup(plan)
    self._layouts = engine.fused_layouts(
        self.rule,
        rows_overrides=store.tplan.rows_overrides if store else None)
    self._tiered_names = frozenset(store.tplan.tier_specs) \
        if store is not None else frozenset()
    # the SAME geometry derivation as freeze(): a delta row and a full
    # re-export of the same logical row are byte-identical by
    # construction
    self.meta, self._full_lay = serve_class_meta(
        plan, self.rule, self.quantize, self._tiered_names)

  # ---- world-N coordination ------------------------------------------------
  def _barrier(self) -> None:
    if self.mesh is not None:
      dist.barrier()

  def _from_lead(self, value):
    """Rank 0's ``value`` on every rank (itself without a mesh)."""
    if self.mesh is None:
      return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]

  def _local_ranks(self) -> List[int]:
    return (list(range(self.plan.world_size)) if self._rank is None
            else [self._rank])

  # ---- observation (delegates to the tracker) -----------------------------
  def observe_batch(self, cats) -> int:
    """Stamp one GLOBAL batch (the ids the STEP consumes: after
    translation under ``oov='allocate'``; at world N every rank passes
    the same global batch)."""
    return self.tracker.observe(cats)

  # ---- base ---------------------------------------------------------------
  def publish_base(self, state: Dict[str, Any],
                   re_root_note: Optional[Dict[str, Any]] = None) -> str:
    """Full serve export rooting (or re-rooting) the chain.

    ``re_root_note`` (set by :meth:`re_root`): recorded under the base
    manifest's ``extra.stream.re_rooted``, so a chain fork is auditable
    from the artifact alone."""
    base = os.path.join(self.path, BASE_DIR)
    clock = self.tracker.clock
    stream_extra: Dict[str, Any] = {"clock": clock,
                                    "published_wall": time.time()}
    if re_root_note is not None:
      stream_extra["re_rooted"] = re_root_note
    full_export(base, self.plan, self.rule, state, quantize=self.quantize,
                store=self.store, vocab=self.vocab,
                extra={"stream": stream_extra}, mesh=self.mesh)
    self.seq = 0
    self.fingerprint = self.base_fingerprint = manifest_fingerprint(base)
    self.chain_root = self.base_fingerprint
    self.watermark = clock
    self.last_publish_bytes = artifact_bytes(base)
    self.attached = True  # a re-root IS the explicit recovery choice
    self.tracker.mark_published()
    self.telemetry.counter("stream/base_published").inc()
    self.telemetry.counter("stream/bytes_published").inc(
        self.last_publish_bytes)
    return base

  def re_root(self, state: Dict[str, Any], reason: str, plan=None,
              tracker: Optional[RowGenerationTracker] = None,
              store=None, mesh=None) -> str:
    """Explicit, counted, fingerprint-logged chain re-root.

    The one sanctioned way to start a new chain in a pubdir that holds
    one; its canonical caller is an elastic resize
    (``ResilientTrainer.resize``), whose new world no published delta
    fits. Requires a non-empty ``reason``; optionally RE-BINDS the
    publisher to a new world (``plan`` with a fresh ``tracker`` built
    for it, ``store`` when the plan has host-tier classes, and at world
    N the new world's ``mesh``); publishes a full base whose manifest
    records ``re_rooted = {reason, prev_chain_root, prev_seq,
    prev_fingerprint}``; counts ``stream/re_roots``. Subscribers rebase
    onto the new base. Returns the base path."""
    if not reason or not str(reason).strip():
      raise ValueError(
          "re_root requires a reason: it forces every subscriber "
          "through a full-artifact rebase, and the new base's manifest "
          "records why the old chain was abandoned.")
    if (plan is None) != (tracker is None):
      raise ValueError(
          "pass plan and tracker together: the tracker's row geometry "
          "is the plan's, and re-binding one without the other would "
          "stamp rows of a world that no longer exists")
    if plan is None and (store is not None or mesh is not None):
      raise ValueError(
          "store was passed without plan/tracker: re-binding the cold "
          "store alone would extract rows laid out for a plan the "
          "publisher is not bound to — pass all three (or none, to "
          "re-root on the current binding).")
    note = {
        "reason": str(reason),
        "prev_chain_root": self.chain_root,
        "prev_seq": self.seq,
        "prev_fingerprint": self.fingerprint,
    }
    if plan is not None:
      self._bind_plan(plan, tracker, store, mesh)
    base = self.publish_base(state, re_root_note=note)
    self.telemetry.counter("stream/re_roots").inc()
    return base

  # ---- chain-state persistence (the checkpoint `stream` section) ----------
  def state_arrays(self) -> Dict[str, np.ndarray]:
    """The tracker's generation stamps and observed counts, flat-keyed:
    ``stream.npz`` of a checkpoint (``checkpoint.save(stream=self)``)."""
    return self.tracker.state_arrays()

  def manifest_section(self) -> Dict[str, Any]:
    """The checkpoint manifest's ``stream`` section: everything
    :meth:`attach` needs to re-join the chain after a kill."""
    return {
        "seq": self.seq,
        "fingerprint": self.fingerprint,
        "base_fingerprint": self.base_fingerprint,
        "chain_root": self.chain_root,
        "watermark": self.watermark,
        "clock": self.tracker.clock,
        "quantize": self.quantize,
    }

  def load_state(self, flat: Dict[str, np.ndarray],
                 section: Dict[str, Any]) -> None:
    """Adopt a checkpoint's persisted chain state. Refuses a quantize
    mismatch naming the field (geometry mismatches refuse inside the
    tracker) and leaves a restored chain link un-attached: :meth:`attach`
    must validate the pubdir tail before the next publication."""
    if section.get("quantize") != self.quantize:
      raise ValueError(
          f"checkpoint stream section was written with quantize="
          f"{section.get('quantize')!r} but this publisher quantizes "
          f"{self.quantize!r} — a delta chain never changes row codec "
          "mid-stream; rebuild the publisher with the saving run's mode")
    self.tracker.load_arrays(flat)
    self.seq = int(section["seq"])
    self.fingerprint = section["fingerprint"]
    self.base_fingerprint = section["base_fingerprint"]
    self.chain_root = section.get("chain_root",
                                  section["base_fingerprint"])
    self.watermark = int(section["watermark"])
    self.tracker.clock = int(section["clock"])
    # a snapshot taken BEFORE the chain was rooted restores a fresh
    # publisher (fingerprint None): nothing to re-join, publish_base
    # roots one
    self.attached = self.fingerprint is None

  # ---- attach: re-join the chain after a kill/restore ---------------------
  def attach(self) -> int:
    """Re-join the existing pubdir chain from restored chain state.

    Every delta published after the restored ``seq`` (between the
    snapshot and the kill: "orphaned") is validated (``base_fingerprint``
    continuity, crc32 integrity, plan and quantize) and its row set
    force-re-stamped above the restored watermark, so the next
    ``publish_delta`` ships a superset of the orphaned tail at the
    resumed trainer's values. Any incompatibility raises
    :class:`ChainDivergedError` naming the field, and nothing is adopted.
    Returns the number of tail deltas adopted."""
    if self.fingerprint is None:
      raise RuntimeError(
          "attach() without restored chain state: nothing links this "
          "publisher to an existing chain — the checkpoint had no "
          "'stream' section (or load_state was never called). Root a "
          "new chain with publish_base instead.")
    base = os.path.join(self.path, BASE_DIR)
    if not os.path.isfile(os.path.join(base, "manifest.json")):
      raise ChainDivergedError(
          "base",
          f"attach: pubdir {self.path!r} has no published base artifact "
          "— the chain this state was saved against is gone; re-root "
          "with publish_base")
    fp_base = manifest_fingerprint(base)
    base_fp = self.base_fingerprint
    if fp_base != base_fp:
      comp = (read_manifest(base).get("stream") or {}).get("compacted")
      if comp and comp.get("chain_root") == self.chain_root \
          and int(comp["through_seq"]) <= self.seq:
        # the same chain, compacted behind the restored position: adopt
        # the new base identity; the delta links are untouched
        base_fp = fp_base
      else:
        raise ChainDivergedError(
            "base_fingerprint",
            f"attach: base artifact fingerprint {fp_base[:12]}... does "
            f"not match the restored chain's {self.base_fingerprint[:12]}"
            "... — the chain was re-rooted (or compacted past the "
            "restored seq) by another publisher; refusing to fork it. "
            "Re-root explicitly with publish_base if this publisher "
            "should own the directory.")
    seqs = published_delta_seqs(self.path)
    if self.seq > 0 and self.seq in seqs:
      got = manifest_fingerprint(
          os.path.join(self.path, delta_dirname(self.seq)))
      if got != self.fingerprint:
        raise ChainDivergedError(
            "fingerprint",
            f"attach: delta {self.seq} on disk has fingerprint "
            f"{got[:12]}... but the restored state published "
            f"{self.fingerprint[:12]}... — a different publisher "
            "overwrote the chain; refusing to fork it")
    tail = [s for s in seqs if s > self.seq]
    prev = self.fingerprint
    dirty: Dict[str, Dict[int, list]] = {}
    for want in range(self.seq + 1, (max(tail) + 1) if tail else
                      self.seq + 1):
      dpath = os.path.join(self.path, delta_dirname(want))
      faultinject.fire("stream_attach", seq=want)
      if want not in seqs:
        raise ChainDivergedError(
            "seq",
            f"attach: delta {want} is missing but delta {max(tail)} is "
            "published — a gap in the tail (partial GC or out-of-order "
            "publication); the chain cannot be validated past it")
      man, next_fp = validate_chain_link(
          dpath, want, prev, plan_fp=_plan_fingerprint(self.plan),
          quantize=self.quantize, where="attach")
      for name, per_rank in man["stream"]["rows"].items():
        # bounds-checked here, while nothing is mutated: attach adopts
        # the whole tail or refuses it naming the field
        if name not in self.tracker.gen:
          raise ChainDivergedError(
              "rows",
              f"attach: delta {want} ships rows for class {name!r}, "
              f"unknown to this plan's tracker ({sorted(self.tracker.gen)})")
        rows_n = self.tracker.gen[name][0].shape[0]
        world = len(self.tracker.gen[name])
        for rank_s in per_rank:
          rank = int(rank_s)
          if rank < 0 or rank >= world:
            raise ChainDivergedError(
                "rows",
                f"attach: delta {want} class {name!r} names rank {rank} "
                f"outside [0, {world})")
          with np.load(os.path.join(
              dpath, f"rows_{name}_r{rank}.npz")) as z:
            idx = np.asarray(z["idx"], np.int64)
          if idx.size and (int(idx.min()) < 0
                           or int(idx.max()) >= rows_n):
            bad = int(idx.min() if idx.min() < 0 else idx.max())
            raise ChainDivergedError(
                "rows",
                f"attach: delta {want} class {name!r} rank {rank} row "
                f"{bad} outside this class's [0, {rows_n}) logical rows")
          dirty.setdefault(name, {}).setdefault(rank, []).append(idx)
      prev = next_fp
    adopted = len(tail)
    self.base_fingerprint = base_fp
    self.seq += adopted
    self.fingerprint = prev
    if dirty:
      # the superset rule: every row an orphaned tail delta shipped is
      # re-stamped above the restored watermark
      merged = {
          name: {rank: np.unique(np.concatenate(parts))
                 for rank, parts in per_rank.items()}
          for name, per_rank in dirty.items()}
      self.tracker.force_dirty(merged, floor=self.watermark)
    self.attached = True
    self.telemetry.counter("stream/attaches").inc()
    if adopted:
      self.telemetry.counter("stream/attach_deltas_adopted").inc(adopted)
    return adopted

  # ---- back-pressure ------------------------------------------------------
  def subscriber_lag(self) -> Optional[int]:
    """How far the slowest LIVE subscriber trails the published head
    (None when no live subscriber is registered). Newly expired
    heartbeats are counted once through ``stream/subscribers_expired``
    and dropped from the quorum; a revived subscriber re-enters it."""
    live, expired = read_heartbeats(self.path, self.heartbeat_ttl_s)
    fresh_expired = set(expired) - set(live) - self._expired_ids
    if fresh_expired:
      self.telemetry.counter("stream/subscribers_expired").inc(
          len(fresh_expired))
      self._expired_ids |= fresh_expired
    self._expired_ids -= set(live)  # revived: back in the quorum
    if not live:
      return None
    lag = self.seq - min(hb["applied_seq"] for hb in live.values())
    self.telemetry.gauge("stream/subscriber_lag").set(lag)
    return lag

  # ---- delta --------------------------------------------------------------
  def _extract(self, name: str, state: Dict[str, Any], rank: int,
               idx: np.ndarray) -> torch.Tensor:
    """One rank block's changed rows of one class, quantized, on the
    block's device (device-tier) or the host (host-tier)."""
    if name in self._tiered_names:
      # flush-free: the resident rows overlay the host image per window,
      # the live image is never mutated
      tbl = torch.from_numpy(extract_changed_rows(
          self._full_lay[name],
          self.store.overlay_reader(name, rank, state["fused"]), idx))
    else:
      lay = self._layouts[name]
      buf = state["fused"][name]
      i = 0 if self._rank is not None else rank
      tbl = gather_changed_rows(
          lay, buf[i * lay.phys_rows:(i + 1) * lay.phys_rows], idx)
    return quantize_rows(tbl, self.quantize)

  def _serve_phys_counts(self, name: str, rank: int) -> np.ndarray:
    """Tracker logical-row counts re-binned to SERVE physical rows (the
    granularity the serve cache ranks at)."""
    m = self.meta[name]
    sl = m.packed
    c = self.tracker.counts[name][rank]
    pad = sl.phys_rows * sl.rows_per_phys - m.rows
    if pad:
      c = np.concatenate([c, np.zeros((pad,), np.int64)])
    return c.reshape(sl.phys_rows, sl.rows_per_phys).sum(axis=1)

  def _deferred(self, force: bool) -> bool:
    """Whether back-pressure defers this publication (rank 0's heartbeat
    read decides for every rank)."""
    if self.max_subscriber_lag is None or force:
      return False
    lag = self.subscriber_lag() if self._lead else None
    return bool(self._from_lead(
        lag is not None and lag >= self.max_subscriber_lag))

  def publish_delta(self, state: Dict[str, Any],
                    force: bool = False) -> Optional[str]:
    """Extract and seal one delta; returns its path, or None when nothing
    was observed since the last publication OR back-pressure deferred it
    (``force=True`` bypasses the lag check: an operator override)."""
    if self.fingerprint is None:
      raise RuntimeError(
          "publish_delta before publish_base: the chain needs a root "
          "artifact for the first base_fingerprint to link.")
    if not self.attached:
      raise RuntimeError(
          "publish_delta on restored-but-unattached chain state: call "
          "attach() first (validates the pubdir tail and re-joins the "
          "chain), or re-root explicitly with publish_base.")
    clock = self.tracker.clock
    if clock == self.watermark:
      return None
    if self._deferred(force):
      # the watermark holds, so this interval's rows coalesce into the
      # next successful publication
      self._throttled_pending = True
      self.telemetry.counter("stream/publishes_throttled").inc()
      return None
    seq = self.seq + 1
    path = os.path.join(self.path, delta_dirname(seq))
    tmp = path + ".tmp"
    changed = self.tracker.changed_rows(self.watermark)
    n_rows = sum(int(idx.size) for per in changed.values() for idx in per)
    checksums: Dict[str, Dict[str, int]] = {}

    def _seal(fpath: str) -> None:
      _fsync_path(fpath)
      faultinject.fire("ckpt_write", path=fpath)
      faultinject.fire("delta_seal", path=fpath, seq=seq)
      checksums[os.path.basename(fpath)] = _crc32_file(fpath)

    err: Optional[BaseException] = None
    if self._lead:
      try:
        if os.path.exists(tmp):
          shutil.rmtree(tmp)
        os.makedirs(tmp)
      except BaseException as e:  # reach the barrier even on failure
        err = e
    self._barrier()
    # the dense-class tables whole: rank blocks gathered to rank 0 (a
    # collective, so every rank takes part before anything can fail)
    tables = {k: blocks_on_root(v, self.mesh)
              for k, v in sorted(state.get("emb_dense", {}).items())}
    snap = vocab_snapshot(self.vocab) if self._lead else None
    try:
      if err is not None:
        raise err
      t0 = time.perf_counter()
      with _span("stream/extract", args={"seq": seq}):
        payload: Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        for name, per_rank in changed.items():
          payload[name] = {}
          for rank in self._local_ranks():
            idx = per_rank[rank]
            if idx.size:
              data = _host(self._extract(name, state, rank, idx))
              payload[name][rank] = (idx, data)
      t1 = time.perf_counter()
      with _span("stream/seal", args={"seq": seq}):
        for name, blocks in sorted(payload.items()):
          for rank, (idx, data) in sorted(blocks.items()):
            fpath = os.path.join(tmp, f"rows_{name}_r{rank}.npz")
            np.savez(fpath, idx=idx.astype(np.int64),
                     data=self.meta[name].to_disk(np.ascontiguousarray(
                         data)))
            _seal(fpath)
        if self._lead:
          from ..convert import dense_state_dict_to_flax
          for name in sorted(self._tiered_names):
            fpath = os.path.join(tmp, f"counts_{name}.npz")
            np.savez(fpath, **{f"r{r}": self._serve_phys_counts(name, r)
                               for r in range(self.plan.world_size)})
            _seal(fpath)
          parts = (("dense", dense_state_dict_to_flax(state["dense"])),
                   ("emb_dense", tables))
          for part, tree in parts:
            fpath = os.path.join(tmp, f"{part}.npz")
            hostarrays.savez(fpath, _flatten_with_paths(tree))
            _seal(fpath)
          if snap is not None:
            fpath = os.path.join(tmp, "vocab_snapshot.npz")
            np.savez(fpath, **snap.state_arrays())
            _seal(fpath)
      # this rank's seconds (the manifest's publication follows)
      self.last_publish_s = {"extract": t1 - t0,
                             "seal": time.perf_counter() - t1}
    except BaseException as e:
      err = e
    if self.mesh is not None:
      # every rank's checksum table (or its failure) reaches every rank
      tables_all: List[Any] = [None] * self.mesh.world
      dist.all_gather_object(
          tables_all, {"error": repr(err)} if err is not None else checksums)
      failed = [r for r, t in enumerate(tables_all) if "error" in t]
      if failed and err is None:
        err = RuntimeError(
            f"delta {seq}: ranks {failed} failed to seal their rows "
            f"({tables_all[failed[0]]['error']}); nothing was published")
      if err is None:
        for t in tables_all:
          checksums.update(t)
    if err is not None:
      raise err

    if self._lead:
      try:
        stream_rows: Dict[str, Dict[str, int]] = {}
        for name, per_rank in sorted(changed.items()):
          counts = {str(r): int(idx.size) for r, idx in enumerate(per_rank)
                    if idx.size}
          if counts:
            stream_rows[name] = counts
        manifest: Dict[str, Any] = {
            "format_version": DELTA_FORMAT_VERSION,
            "kind": "serve_delta",
            "seq": seq,
            "step": int(state["step"]),
            "base_fingerprint": self.fingerprint,
            "plan": _plan_fingerprint(self.plan),
            "rule": {"name": self.rule.name, "n_aux": int(self.rule.n_aux)},
            "serve": {
                "quantize": self.quantize,
                "classes": {n: m.to_json()
                            for n, m in sorted(self.meta.items())},
            },
            "stream": {
                "rows": stream_rows,
                "counts_classes": sorted(self._tiered_names),
                "watermark": {"from_clock": self.watermark,
                              "to_clock": clock},
                "train_wall_oldest": self.tracker.oldest_unpublished_wall,
                "train_wall_newest": self.tracker.newest_wall,
                "published_wall": time.time(),
            },
            "checksums": dict(sorted(checksums.items())),
        }
        if snap is not None:
          manifest["vocab_snapshot"] = snap.manifest_section()
        publish_manifest_last(tmp, path, manifest)
      except BaseException as e:
        err = e
    if self.mesh is not None:
      failed = self._from_lead(repr(err) if err is not None else None)
      if failed is not None and err is None:
        err = RuntimeError(f"delta {seq}: rank 0 failed to publish the "
                           f"manifest ({failed})")
    if err is not None:
      raise err

    self.seq = seq
    self.fingerprint = manifest_fingerprint(path)
    self.watermark = clock
    self.last_publish_bytes = artifact_bytes(path)
    self.tracker.mark_published()
    reg = self.telemetry
    reg.counter("stream/deltas_published").inc()
    reg.counter("stream/rows_published").inc(n_rows)
    reg.counter("stream/bytes_published").inc(self.last_publish_bytes)
    reg.gauge("stream/publish_seq").set(seq)
    if self._throttled_pending:
      # this publication folded at least one deferred interval's rows
      self._throttled_pending = False
      reg.counter("stream/deltas_coalesced").inc()
    return path
