"""Delta compaction: fold ``delta_1..k`` into a new sealed base
(PyTorch port of ``streaming/compact.py``).

A long-lived chain grows without bound: a cold-starting subscriber would
replay every delta since the base export, and the pubdir retains them
all. :class:`DeltaCompactor` folds a validated prefix of the chain into
a NEW base artifact, a plain ``serving.export``-format directory whose
rows equal base-plus-deltas (the subscriber's scatter, run on the disk
images), sealed through the same crc32-manifest-last protocol (the
``compact_fold`` fault site per class), then garbage-collects the folded
deltas under a retention floor that never deletes a delta a live
subscriber still needs.

Chain continuity across a compaction: the compacted base's manifest
carries a ``stream.compacted`` section ``{through_seq,
through_fingerprint, chain_root}``; ``through_fingerprint`` is the
manifest fingerprint of the last delta folded, so delta ``through_seq +
1`` validates against the compacted base unchanged, and ``chain_root``
(the original base's fingerprint) tells "my chain, compacted" from "a
re-rooted directory". A cold-starting subscriber anchors at
``through_seq`` and folds only the tail; a live subscriber past it only
adopts the new base fingerprint; a subscriber stranded behind it rebases.

Crash safety: the fold writes into ``base.compact.tmp`` and publishes by
the atomic manifest-last rename, so a compactor killed mid-fold leaves
the old base untouched; GC runs only after publication.

Host numpy over the artifacts alone (no plan, no device): the files it
writes are the JAX package's compactor's.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from ..checkpoint import (
    _crc32_file,
    _fsync_path,
    manifest_fingerprint,
    publish_manifest_last,
    read_manifest,
)
from ..resilience import faultinject
from ..serving.export import SERVE_FORMAT_VERSION, ServeClassMeta
from ..telemetry import get_registry as _registry, span as _span
from .publish import (
    BASE_DIR,
    ChainDivergedError,
    chain_anchor,
    delta_dirname,
    published_delta_seqs,
    read_heartbeats,
    scatter_rows,
    validate_chain_link,
)

# fired once per sparse class folded into the new base (the
# kill-the-compactor-mid-fold hook)
COMPACT_FOLD_SITE = faultinject.register_site("compact_fold")

COMPACT_TMP = BASE_DIR + ".compact.tmp"


class DeltaCompactor:
  """Background fold of the delta chain into a fresh base artifact.

  Purely manifest-driven — no plan object, no device: everything the fold
  needs (class geometry, row codecs' disk form, world size) is pinned
  in the artifacts themselves, so a compactor can run as a separate
  ops process against the pubdir alone.

  Args:
    path: the publish directory (``base/`` + ``delta_<seq>/`` chain).
    heartbeat_ttl_s: heartbeats older than this drop out of the GC
      retention floor (the publisher's quorum rule — a dead subscriber
      must not pin deltas forever).
  """

  def __init__(self, path: str, heartbeat_ttl_s: float = 30.0,
               telemetry=None):
    self.path = path
    self.heartbeat_ttl_s = float(heartbeat_ttl_s)
    self.telemetry = telemetry if telemetry is not None else _registry()

  # ---- the fold -----------------------------------------------------------
  def _validate_chain(self, bman: Dict[str, Any], anchor_seq: int,
                      anchor_fp: str, k: int) -> List[Dict[str, Any]]:
    """Verify deltas ``anchor_seq+1 .. k`` link contiguously from the
    base anchor (the shared :func:`~.publish.validate_chain_link`
    refusal protocol, plus full serve-section equality — the fold
    scatters into the base's geometry byte-for-byte); returns their
    manifests. Any break refuses with the field named — a compactor
    must never publish a frankenbase."""
    manifests = []
    prev = anchor_fp
    for seq in range(anchor_seq + 1, k + 1):
      dpath = os.path.join(self.path, delta_dirname(seq))
      man, prev = validate_chain_link(
          dpath, seq, prev, plan_fp=bman.get("plan"), where="compact")
      if man["serve"] != bman["serve"]:
        raise ChainDivergedError(
            "serve",
            f"compact: delta {seq} serve geometry/quantize differs from "
            "the base's — refusing to fold")
      man["_fingerprint"] = prev
      manifests.append(man)
    return manifests

  def compact_once(self, through_seq: Optional[int] = None,
                   gc: bool = True,
                   class_priority: Optional[Dict[str, float]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Fold the contiguous chain prefix (through ``through_seq``, or
    the whole published tail) into a new base; returns a summary dict,
    or None when there is nothing to fold.

    ``class_priority`` orders the per-class fold schedule: higher
    priority folds FIRST (hot classes reach the new base earliest — a
    compactor killed mid-fold leaves its freshest work on the classes
    that matter). Ties and unlisted classes fold in
    name order — the schedule is deterministic either way, and the
    published result is identical regardless of order (the fold is a
    per-class scatter; ordering only changes crash-interruption
    exposure)."""
    base = os.path.join(self.path, BASE_DIR)
    if not os.path.isfile(os.path.join(base, "manifest.json")):
      raise ChainDivergedError(
          "base", f"compact: {self.path!r} has no published base "
          "artifact — nothing to fold onto")
    bman = read_manifest(base)
    if bman.get("kind") != "serve":
      raise ChainDivergedError(
          "kind", f"compact: base manifest kind {bman.get('kind')!r} is "
          "not a serve artifact")
    fp_base = manifest_fingerprint(base)
    anchor_seq, anchor_fp, root = chain_anchor(bman, fp_base)
    seqs = published_delta_seqs(self.path)
    run_end = anchor_seq
    while run_end + 1 in seqs:
      run_end += 1
    k = run_end if through_seq is None else int(through_seq)
    if k > run_end:
      raise ValueError(
          f"compact: through_seq={k} but the contiguous published chain "
          f"ends at delta {run_end}")
    if k <= anchor_seq:
      return None

    with _span("stream/compact", args={"through_seq": k}):
      manifests = self._validate_chain(bman, anchor_seq, anchor_fp, k)
      metas = {n: ServeClassMeta.from_json(n, d)
               for n, d in bman["serve"]["classes"].items()}
      world = int(bman["plan"]["world_size"])

      tmp = os.path.join(self.path, COMPACT_TMP)
      if os.path.exists(tmp):
        shutil.rmtree(tmp)
      os.makedirs(tmp)
      checksums: Dict[str, Dict[str, int]] = {}

      def _seal(fpath: str) -> None:
        _fsync_path(fpath)
        faultinject.fire("ckpt_write", path=fpath)
        checksums[os.path.basename(fpath)] = _crc32_file(fpath)

      # --- fold the row images, one class at a time ---
      prio = class_priority or {}
      fold_order = sorted(metas,
                          key=lambda n: (-float(prio.get(n, 0.0)), n))
      for name in fold_order:
        m = metas[name]
        faultinject.fire("compact_fold", clazz=name)
        lay = m.packed
        rpp, lanes = lay.rows_per_phys, m.lanes
        prefix = "serve_cold" if m.tier == "host" else "serve"
        for rank in range(world):
          fname = f"{prefix}_{name}_r{rank}.npy"
          img = np.array(np.load(os.path.join(base, fname)))
          for man in manifests:
            per_rank = man["stream"]["rows"].get(name, {})
            if str(rank) not in per_rank:
              continue
            dpath = os.path.join(self.path,
                                 delta_dirname(int(man["seq"])))
            with np.load(os.path.join(
                dpath, f"rows_{name}_r{rank}.npz")) as z:
              idx = np.asarray(z["idx"], np.int64)
              data = np.asarray(z["data"])  # disk form, like the image
            if idx.size and (int(idx.min()) < 0
                             or int(idx.max()) >= m.rows):
              raise ChainDivergedError(
                  "rows",
                  f"compact: delta {man['seq']} class {name!r} rank "
                  f"{rank} names a row outside [0, {m.rows})")
            scatter_rows(img, rpp, lanes, idx, data)
          fpath = os.path.join(tmp, fname)
          np.save(fpath, img)
          _seal(fpath)

      # --- serve-cache ranking from the freshest shipped counts ---
      host_names = sorted(n for n, m in metas.items() if m.tier == "host")
      if host_names:
        ranking: Dict[str, np.ndarray] = {}
        for name in host_names:
          latest = None
          for man in reversed(manifests):
            if name in man.get("stream", {}).get("counts_classes", []):
              latest = os.path.join(self.path,
                                    delta_dirname(int(man["seq"])),
                                    f"counts_{name}.npz")
              break
          if latest is not None:
            with np.load(latest) as z:
              for key, cnt in z.items():
                ranking[f"{name}/{key}"] = np.argsort(
                    -np.asarray(cnt, np.int64),
                    kind="stable").astype(np.int32)
          else:  # no delta shipped counts: carry the base ranking over
            with np.load(os.path.join(base, "serve_ranking.npz")) as z:
              for key, order in z.items():
                if key.startswith(name + "/"):
                  ranking[key] = np.asarray(order)
        fpath = os.path.join(tmp, "serve_ranking.npz")
        np.savez(fpath, **ranking)
        _seal(fpath)

      # --- whole-shipped parts: the freshest copy wins ---
      last_dir = os.path.join(self.path, delta_dirname(k))
      for part in ("dense.npz", "emb_dense.npz"):
        fpath = os.path.join(tmp, part)
        shutil.copyfile(os.path.join(last_dir, part), fpath)
        _seal(fpath)
      vocab_section = None
      last_man = manifests[-1]
      if last_man.get("vocab_snapshot") is not None:
        vocab_section = last_man["vocab_snapshot"]
        src = os.path.join(last_dir, "vocab_snapshot.npz")
      elif bman.get("vocab_snapshot") is not None:
        vocab_section = bman["vocab_snapshot"]
        src = os.path.join(base, "vocab_snapshot.npz")
      if vocab_section is not None:
        fpath = os.path.join(tmp, "vocab_snapshot.npz")
        shutil.copyfile(src, fpath)
        _seal(fpath)

      manifest: Dict[str, Any] = {
          "format_version": SERVE_FORMAT_VERSION,
          "kind": "serve",
          "step": int(last_man["step"]),
          "rule": bman["rule"],
          "plan": bman["plan"],
          "serve": bman["serve"],
          "stream": {
              "compacted": {
                  "through_seq": k,
                  "through_fingerprint": last_man["_fingerprint"],
                  "chain_root": root,
                  "from_fingerprint": fp_base,
                  "deltas_folded": k - anchor_seq,
              },
          },
          "checksums": checksums,
      }
      if vocab_section is not None:
        manifest["vocab_snapshot"] = vocab_section
      publish_manifest_last(tmp, base, manifest)

    reg = self.telemetry
    reg.counter("stream/compactions").inc()
    reg.counter("stream/deltas_compacted").inc(k - anchor_seq)
    removed = self.gc_deltas(k) if gc else []
    return {"through_seq": k, "deltas_folded": k - anchor_seq,
            "chain_root": root, "gc_removed": removed,
            "fold_order": fold_order}

  # ---- garbage collection -------------------------------------------------
  def gc_deltas(self, through_seq: int) -> List[int]:
    """Delete folded deltas under the retention floor.

    The rule: a delta is removable only when it is (a) folded into the
    compacted base (``seq <= through_seq``) AND (b) not needed by any
    registered LIVE subscriber — a subscriber whose heartbeat says
    ``applied_seq = a`` still needs every delta ``> a``, so the floor is
    ``min(live applied_seq)``. Expired heartbeats don't hold the floor
    (their owner rebases onto the compacted base if it revives)."""
    live, _expired = read_heartbeats(self.path, self.heartbeat_ttl_s)
    floor = through_seq
    if live:
      floor = min(floor,
                  min(hb["applied_seq"] for hb in live.values()))
    removed = []
    for seq in published_delta_seqs(self.path):
      if seq <= floor:
        shutil.rmtree(os.path.join(self.path, delta_dirname(seq)),
                      ignore_errors=True)
        removed.append(seq)
    if removed:
      self.telemetry.counter("stream/deltas_gced").inc(len(removed))
    return removed


def compact_chain(path: str, through_seq: Optional[int] = None,
                  gc: bool = True, heartbeat_ttl_s: float = 30.0,
                  telemetry=None) -> Optional[Dict[str, Any]]:
  """One-shot convenience wrapper around :class:`DeltaCompactor`."""
  return DeltaCompactor(path, heartbeat_ttl_s=heartbeat_ttl_s,
                        telemetry=telemetry).compact_once(
                            through_seq=through_seq, gc=gc)
