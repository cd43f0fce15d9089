"""Full train-state checkpoint and resume (PyTorch port of
``checkpoint.py``).

The JAX package's on-disk format and durable protocol, so that either
package restores the other's checkpoint:

- every data file is fsynced and sealed into a per-file crc32 + size
  table (:func:`_crc32_file`);
- the manifest carrying that table is written LAST, fsynced, and the
  ``.tmp`` directory is renamed into place atomically
  (:func:`publish_manifest_last`); a crash at any point leaves either a
  manifest-less ``.tmp`` or a complete directory, and a previous
  checkpoint rotates to ``.old``;
- :func:`verify` checks a published directory's files against the table
  and names each bad file (a manifest without the table, from before the
  durable format, gets the JAX package's existence checks);
- :func:`_plan_fingerprint` pins the plan a directory was written under,
  as JSON equal to the JAX package's for the same plan (plain ``int``\\ s
  and lists only, so a manifest written by one package compares equal
  in the other); the ``world`` section (:func:`_world_section`) says how
  many rank files there are and what each class's rows are.

:func:`save` writes a fused train state (``training.make_sparse_train_step``'s):

    manifest.json
    fused_<class>_r<rank>.npy      packed [phys_rows, phys_width] f32 blocks
    dense.npz                      the model's params as the flax tree
    dense_opt.npz                  their optax state (convert.optax_state_of)
    emb_dense.npz                  the dense-class tables, global
    emb_dense_opt.npz              their optax state, global

At world N every rank calls it with its mesh: each rank writes and seals
its own blocks and its ``DONE_p<rank>`` marker (its crc table), rank 0
writes the npz files (the dense-class tables and their per-row optimizer
state gathered to its host one block at a time), merges the markers and
publishes; barriers over the process group order the steps, and every
exception still reaches them. :func:`restore` reads it back (rank 0
verifies, every rank reads only its own blocks).

Tiered plans (``tiering/``) pass their ``HostTierStore`` as ``store=``:
the cold images are written per owned rank as ``cold_<class>_r<rank>.npy``
with the resident sets and counts in ``tiering.npz`` (``tiering_p<rank>.npz``
per rank at world N) and the manifest's ``tiering`` section, as the JAX
package writes them, and :func:`restore` loads them into the store.

A checkpoint whose plan differs from the restoring one only in
placement (another world size, strategy or slicing) is re-sharded on the
way in (:func:`_restore_elastic`, the regroup engine of
``resilience/elastic``): every logical row of the rank files, cold images
included, lands in the new plan's blocks bit for bit, and the tiered
observed counts are re-mapped with them.

Not ported (refused by name): the dynamic vocabulary and the stream
section (``vocab=``, ``stream=``, ROADMAP.md §1 item 12), and the
per-process clock records of a world-N save (``pod_clock.json``,
:func:`read_pod_clock`, item 11c). The ``telemetry`` section (a metrics
registry's state) is written and read as the JAX package does.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import hostarrays
from .device import resolve_device
from .ops.packed_table import PackedLayout
from .parallel.lookup_engine import (
    DistributedLookup,
    class_param_name,
    padded_rows,
)
from .resilience import elastic as _elastic
from .resilience import faultinject

FORMAT_VERSION = 1

_PARTS = ("dense", "dense_opt", "emb_dense", "emb_dense_opt")


def _crc32_file(path: str, chunk: int = 1 << 22) -> Dict[str, int]:
  """Streaming crc32 + size of one file (never holds the file in RAM)."""
  crc = 0
  size = 0
  with open(path, "rb") as f:
    while True:
      block = f.read(chunk)
      if not block:
        break
      crc = zlib.crc32(block, crc)
      size += len(block)
  return {"crc32": crc & 0xFFFFFFFF, "size": size}


def _fsync_path(path: str) -> None:
  fd = os.open(path, os.O_RDONLY)
  try:
    os.fsync(fd)
  finally:
    os.close(fd)


def _fsync_dir(path: str) -> None:
  # directory fsync publishes the rename/creat entries themselves; not
  # every filesystem supports it (EINVAL on some), and the data-file
  # fsyncs are the load-bearing ones
  try:
    _fsync_path(path)
  except OSError:
    pass


def verify(path: str, only=None) -> List[str]:
  """Validate a published directory; returns a list of problems (empty
  == valid): the manifest exists and parses, and each file of its
  ``checksums`` table exists with the recorded size and crc32. A
  manifest without the table (a checkpoint from before the durable
  format) gets the JAX package's existence checks of the file set the
  manifest implies, in its order and with its messages.

  ``only``: an optional collection of basenames — verify just those
  entries (each must be in the table). A rank of a world-N serve load
  reads its own blocks and the shared files only."""
  mpath = os.path.join(path, "manifest.json")
  if not os.path.isfile(mpath):
    return [f"missing manifest: {mpath}"]
  try:
    with open(mpath) as f:
      manifest = json.load(f)
  except (json.JSONDecodeError, OSError) as e:
    return [f"unreadable manifest {mpath}: {e}"]
  checksums = manifest.get("checksums")
  if checksums is None:
    return _legacy_problems(path, manifest)
  if only is not None:
    missing = sorted(set(only) - set(checksums))
    if missing:
      return [f"file(s) {missing} not in the manifest checksum table"]
    checksums = {f: checksums[f] for f in only}
  problems = []
  for fname, want in sorted(checksums.items()):
    fpath = os.path.join(path, fname)
    if not os.path.isfile(fpath):
      problems.append(f"missing file: {fpath}")
      continue
    size = os.path.getsize(fpath)
    if size != want["size"]:
      problems.append(
          f"truncated file: {fpath} is {size} bytes, manifest says "
          f"{want['size']}")
      continue
    got = _crc32_file(fpath)["crc32"]
    if got != want["crc32"]:
      problems.append(
          f"corrupted file: {fpath} crc32 {got:#010x} != manifest "
          f"{want['crc32']:#010x} (bit flip or torn write)")
  return problems


def _legacy_problems(path: str, manifest: Dict[str, Any]) -> List[str]:
  """Existence checks of a checksum-less manifest's file set: the rank
  files of every fused class, the four npz parts, the host-tier cold
  images (the JAX package's ``verify`` fallback)."""
  problems = []
  world = manifest.get("plan", {}).get("world_size", 1)
  for name in manifest.get("fused", {}):
    for r in range(world):
      fpath = os.path.join(path, f"fused_{name}_r{r}.npy")
      if not os.path.isfile(fpath):
        problems.append(f"missing file: {fpath}")
  for part in _PARTS:
    fpath = os.path.join(path, f"{part}.npz")
    if not os.path.isfile(fpath):
      problems.append(f"missing file: {fpath}")
  for name in manifest.get("tiering", {}).get("classes", {}):
    for r in range(world):
      fpath = os.path.join(path, f"cold_{name}_r{r}.npy")
      if not os.path.isfile(fpath):
        problems.append(f"missing file: {fpath}")
  return problems


_host = _elastic.to_host
_flatten_with_paths = _elastic.flatten_with_paths


def _world_section(plan) -> Dict[str, Any]:
  """The manifest's ``world`` section (the JAX package's
  ``_world_section``): the rank count and, per class, its kind, tier,
  per-rank logical rows and width (``resilience/elastic.
  plan_world_classes``). With the fingerprint's ``layout`` it says where
  every logical row lives in the rank files."""
  return {"ranks": int(plan.world_size),
          "classes": _elastic.plan_world_classes(plan)}


def _elastic_reason(manifest: Dict[str, Any], want: Dict[str, Any],
                    plan) -> Optional[str]:
  """None when a plan-fingerprint mismatch is only a placement
  difference (world size, strategy, slicing, generations) that the JAX
  package re-shards elastically, else the reason it cannot (the JAX
  package's ``_elastic_reason``, its messages)."""
  saved = manifest["plan"]
  if "layout" not in saved or "world" not in manifest:
    return ("the checkpoint predates the elastic manifest format "
            "(no plan.layout / world section), so its rank blocks "
            "cannot be re-sliced")
  if saved.get("tables") != want.get("tables"):
    return "the logical tables differ (vocab/width/combiner)"
  if saved.get("input_table_map") != want.get("input_table_map"):
    return "the input->table map differs"
  src_tier: Dict[int, str] = {}
  src_kind: Dict[int, str] = {}
  for cname, meta in manifest["world"]["classes"].items():
    for rank_slots in saved["layout"].get(cname, []):
      for slot in rank_slots:
        src_tier[int(slot[0])] = meta["tier"]
        src_kind[int(slot[0])] = meta["kind"]
  new_kind: Dict[int, str] = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    for slots in cp.slots_per_rank:
      for s in slots:
        new_kind[s.shard.table_id] = cp.kind
  for t, tier in sorted(src_tier.items()):
    if plan.table_tier(t) != tier:
      return (f"table {t} was saved on the {tier!r} tier but the current "
              f"plan places it on {plan.table_tier(t)!r} — cross-tier "
              "moves need a format conversion, not an elastic re-shard "
              "(adjust host_row_threshold to match the saving run)")
    if new_kind.get(t) != src_kind[t]:
      return (f"table {t} was saved as a {src_kind[t]!r}-kind class but "
              f"the current plan serves it {new_kind.get(t)!r}-kind — "
              "the sparse<->dense storage formats differ (packed aux "
              "lanes vs optax state); match the saving run's "
              "dense_row_threshold")
  return None


def _abbrev(v, limit: int = 200) -> str:
  s = repr(v)
  return s if len(s) <= limit else s[:limit] + f"... (+{len(s) - limit} chars)"


plan_layout = _elastic.plan_layout


def _plan_fingerprint(plan) -> Dict[str, Any]:
  """The plan a directory was written under, as the JAX package's
  manifest spells it: world, strategy, tables, input map, class names,
  the per-rank slot ``layout``, and the class tiers when tiering is in
  effect. A plan with the same fingerprint places every logical row in
  the same rank file at the same row."""
  fp = {
      "world_size": int(plan.world_size),
      "strategy": plan.strategy,
      "tables": [[int(c.input_dim), int(c.output_dim), c.combiner]
                 for c in plan.global_configs],
      "input_table_map": [int(t) for t in plan.input_table_map],
      "class_names": [class_param_name(*k) for k in plan.class_keys],
      "layout": plan_layout(plan),
  }
  if getattr(plan, "host_row_threshold", None) is not None \
      and plan.host_tier_class_keys():
    fp["class_tiers"] = {class_param_name(*k): plan.class_tiers[k]
                         for k in plan.class_keys}
  return fp


def read_manifest(path: str) -> Dict[str, Any]:
  """Load a published directory's manifest (e.g. its ``extra``)."""
  with open(os.path.join(path, "manifest.json")) as f:
    return json.load(f)


def publish_manifest_last(tmp: str, path: str,
                          manifest: Dict[str, Any]) -> None:
  """Durable publication tail: write ``manifest.json`` LAST (after every
  data file in ``tmp`` exists and is fsynced), fsync it, and atomically
  rename ``tmp`` into place (a previous ``path`` rotates to ``.old``).
  The manifest must carry the per-file ``checksums`` table so
  :func:`verify` can validate the published directory."""
  mpath = os.path.join(tmp, "manifest.json")
  with open(mpath, "w") as f:
    json.dump(manifest, f, indent=1)
    f.flush()
    os.fsync(f.fileno())
  _fsync_dir(tmp)
  faultinject.fire("ckpt_rename", path=path)
  if os.path.exists(path):
    backup = path + ".old"
    if os.path.exists(backup):
      shutil.rmtree(backup)
    os.rename(path, backup)
  os.rename(tmp, path)
  _fsync_dir(os.path.dirname(os.path.abspath(path)))


# ---------------------------------------------------------------------------
# full train-state save / restore
# ---------------------------------------------------------------------------


def refuse_unported(vocab, stream) -> None:
  """The arguments of the subsystems not ported yet, each refused naming
  its ROADMAP item (``resilience.durable`` refuses them alike)."""
  if vocab is not None:
    raise NotImplementedError(
        "vocab= (a dynamic-vocabulary translator): its id space is not "
        "ported yet (ROADMAP.md §1 item 12, dynvocab)")
  if stream is not None:
    raise NotImplementedError(
        "stream= (the delta publisher's chain state): not ported yet "
        "(ROADMAP.md §1 item 12, streaming)")


def _state_rank(plan, mesh) -> Optional[int]:
  """This process's rank when it holds one rank's blocks (a world-N plan
  with a mesh), else None (it holds every rank's)."""
  if mesh is None or plan.world_size == 1:
    return None
  if mesh.world != plan.world_size:
    raise ValueError(f"the mesh has {mesh.world} ranks, the plan "
                     f"{plan.world_size}")
  return mesh.rank


def _barrier(rank: Optional[int]) -> None:
  if rank is not None:
    dist.barrier()


def blocks_on_root(block: torch.Tensor, mesh) -> Optional[np.ndarray]:
  """Every rank's ``block`` stacked by rank in rank 0's host memory
  (numpy), None on the other ranks; each block crosses the wire alone, so
  no card ever holds more than its own block and one more. Without a mesh
  (or at world 1) the block itself, on the host."""
  if mesh is None or mesh.world == 1:
    return _host(block)
  # gloo sends and receives host tensors only, NCCL the rank's card's
  block = block.detach()
  block = (block.cpu() if mesh.backend == "gloo"
           else block.to(mesh.device).contiguous())
  if mesh.rank != 0:
    dist.send(block, dst=0)
    return None
  parts = [_host(block)]
  buf = torch.empty_like(block)
  for src in range(1, mesh.world):
    dist.recv(buf, src=src)
    got = _host(buf)  # buf is received into again: copy
    parts.append(got.clone() if isinstance(got, torch.Tensor) else got.copy())
  if isinstance(parts[0], torch.Tensor):
    return torch.cat(parts)
  return np.concatenate(parts)


def _device_layouts(plan, rule, store):
  """``(layouts, tiered class names)``: the packed layouts of the classes
  whose device buffers a checkpoint holds (every sparse class but the
  ``store``'s host-tier ones, which it holds as cold images)."""
  tiered = (frozenset(store.tplan.tier_specs) if store is not None
            else frozenset())
  return ({name: lay for name, lay in
           DistributedLookup(plan).fused_layouts(rule).items()
           if name not in tiered}, tiered)


def _write_tier_blocks(tmp: str, store, seal, rank: Optional[int]) -> None:
  """Write this process's share of a tiered checkpoint into ``tmp`` (the
  JAX package's ``_write_tier_blocks``): per owned rank of each host-tier
  class the cold image as ``cold_<class>_r<rank>.npy``, and one tier-state
  npz of the owned ranks' resident sets and observed counts,
  ``tiering.npz`` from a store that owns every rank, ``tiering_p<rank>.npz``
  from a world-N process's store (restore merges them). Every file goes
  through ``seal``."""
  flat = {}
  for name in sorted(store.tplan.tier_specs):
    for r in store.owned_ranks:
      fpath = os.path.join(tmp, f"cold_{name}_r{r}.npy")
      hostarrays.save_npy(fpath, store.images[name][r])
      seal(fpath)
      flat[f"{name}/r{r}/resident_grps"] = store.resident_grps[name][r]
      flat[f"{name}/r{r}/counts"] = store.counts[name][r]
  fpath = os.path.join(tmp, "tiering.npz" if store.owns_all
                       else f"tiering_p{0 if rank is None else rank}.npz")
  hostarrays.savez(fpath, flat)
  seal(fpath)


def _load_tier_state_flat(path: str) -> Dict[str, np.ndarray]:
  """Merge every ``tiering*.npz`` under ``path`` (one file from a
  fully-owned save, per-owner files from a sharded one)."""
  flat: Dict[str, np.ndarray] = {}
  for fn in sorted(os.listdir(path)):
    if fn == "tiering.npz" or (fn.startswith("tiering_p")
                               and fn.endswith(".npz")):
      with np.load(os.path.join(path, fn)) as z:
        flat.update({k: np.asarray(v) for k, v in z.items()})
  return flat


def _restore_tier_state(path: str, store, tiered_names) -> None:
  """Load a tiered checkpoint into ``store``: the owned ranks' cold
  images, and EVERY rank's resident sets and counts (the bookkeeping is
  replicated, merged from the per-owner npz files)."""
  flat = _load_tier_state_flat(path)
  owned = frozenset(store.owned_ranks)
  for name in sorted(tiered_names):
    for rank in range(store.plan.world_size):
      if rank in owned:
        store.set_image(name, rank, np.load(
            os.path.join(path, f"cold_{name}_r{rank}.npy")))
      key = f"{name}/r{rank}/resident_grps"
      if key not in flat:
        raise ValueError(
            f"checkpoint {path!r} carries no tier state for class {name!r} "
            f"rank {rank} (its tiering*.npz files are incomplete)")
      grps = np.asarray(flat[key], np.int32)
      rmap = store.resident_map[name][rank]
      rmap[:] = -1
      rmap[grps] = np.arange(grps.shape[0], dtype=np.int32)
      store.resident_grps[name][rank] = grps
      store.counts[name][rank] = np.asarray(
          flat[f"{name}/r{rank}/counts"], np.int64)


def _npz_parts(state: Dict[str, Any], mesh, rank: Optional[int]
               ) -> Dict[str, Dict[str, np.ndarray]]:
  """The four npz parts of a checkpoint, flattened in the JAX package's
  spelling, on rank 0 (``{}`` on the others): the model's params as the
  flax tree, the dense-class tables whole, and each part's optax state.
  At world N the dense-class tables and their per-row optimizer leaves
  are rank blocks, gathered to rank 0 one block at a time (a collective:
  every rank calls this)."""
  # convert imports the serving and training modules; import at call time
  from .convert import (
      _row_leaf,
      dense_state_dict_to_flax,
      optax_state_of,
  )
  from .training import trained_tables
  # the optimizers' states are keyed by the tensors they update
  dense = state["dense"]
  emb_dense = state["emb_dense"]
  emb_opt = optax_state_of(state.get("emb_dense_opt"), trained_tables(state))
  if not emb_dense:
    # no dense-class tables: the JAX state keeps the optax state of an
    # empty tree (Adam's and a schedule's counts, which never advance
    # there)
    emb_opt = {k: v for k, v in optax_state_of(
        state.get("dense_opt"), dense).items()
               if k in ("0/count", "1/count")}
    emb_opt = {k: np.zeros_like(v) for k, v in emb_opt.items()}
  if rank is not None:
    names = set(emb_dense)
    tables = {k: blocks_on_root(v, mesh) for k, v in sorted(emb_dense.items())}
    emb_opt = {k: (blocks_on_root(v if isinstance(v, torch.Tensor)
                                  else torch.from_numpy(v), mesh)
                   if _row_leaf(k, names) else v)
               for k, v in sorted(emb_opt.items())}
  else:
    tables = {k: _host(v) for k, v in emb_dense.items()}
  if rank not in (None, 0):
    return {}
  return {
      "dense": _flatten_with_paths(dense_state_dict_to_flax(dense)),
      "dense_opt": optax_state_of(state.get("dense_opt"), dense),
      "emb_dense": tables,
      "emb_dense_opt": emb_opt,
  }


def save(path: str, plan, rule, state: Dict[str, Any], store=None,
         extra: Optional[Dict[str, Any]] = None, vocab=None,
         telemetry=None, stream=None, mesh=None) -> None:
  """Write the full fused train state under directory ``path``, in the
  JAX package's format (its ``checkpoint.restore`` reads it back).

  ``state`` is a port train state: ``fused`` (every rank's blocks, or
  with a world-N ``mesh`` this rank's), ``emb_dense``, ``dense``, the
  bound optimizers ``dense_opt`` / ``emb_dense_opt`` (their states go
  out in optax's spelling, ``convert.optax_state_of``) and ``step``.

  Atomicity: everything is written into ``path + '.tmp'`` and renamed at
  the end, so a crash mid-save never corrupts the previous checkpoint
  (which rotates to ``path + '.old'``). With a world-N ``mesh`` every
  rank calls :func:`save`: each writes and seals only its own blocks and
  its ``DONE_p<rank>`` marker, rank 0 writes the npz parts, merges the
  markers' checksum tables and publishes the manifest, and every rank
  returns once the checkpoint is published (or raises, on every rank,
  when any rank failed). ``extra`` (JSON) rides the manifest, and so does
  ``telemetry`` (a ``telemetry.MetricsRegistry``, or its captured
  ``state_dict()``), as the manifest's ``telemetry`` section in the JAX
  package's spelling (rank 0's registry at world N).

  A tiered plan (``tiering/``) passes the run's ``HostTierStore`` (or a
  ``TierStoreSnapshot``) as ``store``: the resident rows are flushed from
  the device caches into the host images first, then every owned rank's
  cold image is written as ``cold_<class>_r<rank>.npy`` with the resident
  sets and observed counts in ``tiering.npz`` (``tiering_p<rank>.npz`` from
  each rank at world N), and the manifest's ``tiering`` section records the
  tier geometry; the compact device buffers are not saved."""
  refuse_unported(vocab, stream)
  if getattr(plan, "oov", "clip") == "allocate":
    raise NotImplementedError(
        "plan.oov='allocate': the dynamic id space is not ported yet "
        "(ROADMAP.md §1 item 12, dynvocab)")
  if store is None and plan.host_tier_class_keys():
    raise ValueError(
        "plan has host-tier classes but no HostTierStore was passed: "
        "saving only the compact device buffers would drop the cold rows "
        "(the authoritative majority of the weights). Pass the run's "
        "store via save(..., store=store).")
  rank = _state_rank(plan, mesh)
  p0 = rank in (None, 0)
  layouts, tiered_names = _device_layouts(plan, rule, store)
  if store is not None:
    store.flush(state["fused"])
  parts = _npz_parts(state, mesh, rank)  # collective at world N
  # a registry is captured here (a consistent point-in-time state); an
  # already-captured dict (async snapshots) passes through
  telemetry_meta = None
  if telemetry is not None:
    telemetry_meta = (telemetry.state_dict()
                      if hasattr(telemetry, "state_dict") else dict(telemetry))
  tmp = path + ".tmp"
  err: Optional[BaseException] = None
  if p0:
    try:
      if os.path.exists(tmp):
        # a stale .tmp from a crashed save would otherwise merge its files
        # into this checkpoint
        shutil.rmtree(tmp)
      os.makedirs(tmp)
    except BaseException as e:  # reach the barrier even on failure
      err = e
  _barrier(rank)

  local_crcs: Dict[str, Dict[str, int]] = {}

  def _seal(fpath: str) -> None:
    _fsync_path(fpath)
    faultinject.fire("ckpt_write", path=fpath)
    local_crcs[os.path.basename(fpath)] = _crc32_file(fpath)

  me = 0 if rank is None else rank
  n_proc = 1 if rank is None else plan.world_size
  fused_meta = {}
  try:
    if err is not None:
      raise err  # rank 0's mkdir failure, re-raised after the barrier
    if not os.path.isdir(tmp):
      raise RuntimeError(
          f"checkpoint tmp dir {tmp!r} missing after barrier — rank 0 "
          "failed to create it (its exception has the root cause), or the "
          "ranks do not share a filesystem")
    for name, layout in layouts.items():
      buf = state["fused"][name]
      ranks = range(plan.world_size) if rank is None else [rank]
      for i, r in enumerate(ranks):
        block = buf[i * layout.phys_rows:(i + 1) * layout.phys_rows]
        if tuple(block.shape) != (layout.phys_rows, layout.phys_width):
          raise ValueError(
              f"class {name!r}: rank {r}'s block has shape "
              f"{tuple(block.shape)}, the layout "
              f"{(layout.phys_rows, layout.phys_width)}")
        fpath = os.path.join(tmp, f"fused_{name}_r{r}.npy")
        # one rank block on the host at a time
        hostarrays.save_npy(fpath, _host(block))
        _seal(fpath)
      fused_meta[name] = {"phys_rows": int(layout.phys_rows),
                          "phys_width": int(layout.phys_width),
                          # the JAX package's numpy dtype name
                          "dtype": str(buf.dtype).replace("torch.", "")}
    for part, flat in parts.items():
      fpath = os.path.join(tmp, f"{part}.npz")
      hostarrays.savez(fpath, flat)
      _seal(fpath)
    if store is not None:
      _write_tier_blocks(tmp, store, _seal, rank)
    with open(os.path.join(tmp, f"DONE_p{me}"), "w") as f:
      json.dump(local_crcs, f)  # the marker carries this writer's crcs
  except BaseException as e:
    err = e
  _barrier(rank)
  if err is not None:
    raise err
  # every rank checks the marker set, polling briefly for a shared
  # filesystem's attribute-cache lag (a deadline, not a timing)
  deadline = time.monotonic() + 30.0
  while True:
    done = [p for p in range(n_proc)
            if os.path.exists(os.path.join(tmp, f"DONE_p{p}"))]
    if len(done) == n_proc or time.monotonic() >= deadline:
      break
    time.sleep(0.2)
  if len(done) != n_proc:
    raise RuntimeError(
        f"checkpoint save incomplete: only ranks {done} of {n_proc} "
        "finished writing (see the failing rank's exception); the partial "
        "tmp dir was left for inspection")
  # every rank saw the full marker set before rank 0 removes the markers
  _barrier(rank)

  def _publish() -> None:
    checksums: Dict[str, Dict[str, int]] = {}
    for p in range(n_proc):
      mk = os.path.join(tmp, f"DONE_p{p}")
      with open(mk) as f:
        checksums.update(json.load(f))
      os.remove(mk)
    for fname in sorted(os.listdir(tmp)):
      if fname not in checksums:  # defensive: a file no writer claimed
        checksums[fname] = _crc32_file(os.path.join(tmp, fname))
    manifest = {
        "format_version": FORMAT_VERSION,
        "step": int(state["step"]),
        "rule": {"name": rule.name, "n_aux": int(rule.n_aux)},
        "plan": _plan_fingerprint(plan),
        "world": _world_section(plan),
        "fused": fused_meta,
        "checksums": checksums,
    }
    if extra is not None:
      manifest["extra"] = extra
    if store is not None:
      manifest["tiering"] = {"classes": store.tplan.geometry()}
    if telemetry_meta is not None:
      manifest["telemetry"] = telemetry_meta
    publish_manifest_last(tmp, path, manifest)

  err = None
  if p0:
    try:
      _publish()
    except BaseException as e:
      err = e
  _barrier(rank)
  if err is not None:
    raise err
  if not p0:
    # the rename is publication; tmp vanishing is the only success signal
    # the other ranks can observe (rank 0's exception is not visible here)
    deadline = time.monotonic() + 30.0
    while os.path.exists(tmp) and time.monotonic() < deadline:
      time.sleep(0.2)
    if os.path.exists(tmp):
      raise RuntimeError(
          f"checkpoint publication failed: tmp dir {tmp!r} still present "
          "after the rename barrier — rank 0 raised mid-publication (its "
          "exception has the root cause)")


def _verify_on_root(path: str, rank: Optional[int]) -> None:
  """Rank 0 verifies every file; the verdict is broadcast, so every rank
  refuses a checkpoint rank 0 found corrupt."""
  verr: Optional[BaseException] = None
  if rank in (None, 0):
    try:
      problems = verify(path)
      if problems:
        raise ValueError(
            f"checkpoint {path!r} failed integrity verification: "
            + "; ".join(problems)
            + ". Restore the previous valid checkpoint, or pass "
            "verify_integrity=False to load it anyway.")
    except BaseException as e:
      verr = e
  if rank is not None:
    verdict = [verr is None]
    dist.broadcast_object_list(verdict, src=0)
    if verr is None and not verdict[0]:
      raise ValueError(
          f"checkpoint {path!r} failed integrity verification on rank 0 "
          "(its exception names the bad file)")
  if verr is not None:
    raise verr


def _check_manifest(manifest: Dict[str, Any], plan, rule,
                    layouts, store=None) -> bool:
  """Format, rule, plan and physical shapes against the restoring run,
  with the JAX package's messages. Returns True when the plans differ
  only in placement (the restore re-shards elastically; the JAX package
  then checks nothing more), False when they match."""
  if manifest["format_version"] != FORMAT_VERSION:
    raise ValueError(f"checkpoint format {manifest['format_version']} "
                     f"unsupported (expected {FORMAT_VERSION})")
  if manifest["rule"]["name"] != rule.name \
      or manifest["rule"]["n_aux"] != rule.n_aux:
    raise ValueError(
        f"checkpoint was written with rule {manifest['rule']}, restoring "
        f"with {{'name': {rule.name!r}, 'n_aux': {rule.n_aux}}}")
  want = _plan_fingerprint(plan)
  if "layout" not in manifest["plan"]:
    # written before the fingerprint carried the physical layout: the
    # logical comparison (the phys-shape check below guards the rest)
    want = {k: v for k, v in want.items() if k != "layout"}
  if manifest["plan"] != want:
    reason = _elastic_reason(manifest, want, plan)
    if reason is None:
      return True
    diff_keys = sorted(k for k in set(manifest["plan"]) | set(want)
                       if manifest["plan"].get(k) != want.get(k))
    detail = "; ".join(
        f"{k}: saved={_abbrev(manifest['plan'].get(k))} "
        f"have={_abbrev(want.get(k))}" for k in diff_keys)
    raise ValueError(
        "checkpoint plan does not match and cannot be elastically "
        f"re-sharded ({reason}): re-create the DistEmbeddingStrategy "
        f"with the same tables (differs in {detail})")
  saved_tiering = manifest.get("tiering", {}).get("classes", {})
  tiered_names = _device_layouts(plan, rule, store)[1]
  if set(saved_tiering) != set(tiered_names):
    raise ValueError(
        f"checkpoint tiering mismatch: saved host-tier classes "
        f"{sorted(saved_tiering)}, restoring with {sorted(tiered_names)} — "
        "pass the matching HostTierStore (tiered checkpoint) or none "
        "(all-device checkpoint)")
  if store is not None:
    geometry = store.tplan.geometry()
    for name, meta in saved_tiering.items():
      if meta != geometry[name]:
        raise ValueError(
            f"checkpoint class {name!r} tier geometry {meta} does not "
            f"match the current TieringPlan {geometry[name]}: rebuild the "
            "TieringConfig with the saving run's budget/cache/staging "
            "settings")
  if manifest.get("vocab") is not None:
    raise ValueError(
        "checkpoint carries a dynamic-vocabulary ('vocab') section but "
        "no DynVocabTranslator was passed: restoring the buffers without "
        "the id space would train the restored rows with the WRONG ids. "
        "Pass restore(..., vocab=translator) built from an "
        "oov='allocate' plan with the saving run's knobs.")
  for name, layout in layouts.items():
    meta = manifest.get("fused", {}).get(name)
    if meta is not None and (meta["phys_rows"] != layout.phys_rows
                             or meta["phys_width"] != layout.phys_width):
      raise ValueError(
          f"checkpoint class {name!r} was saved with physical shape "
          f"[{meta['phys_rows']}, {meta['phys_width']}] per rank, but the "
          f"current plan/rule implies [{layout.phys_rows}, "
          f"{layout.phys_width}] — the slicing thresholds or optimizer "
          "rule differ from the saving run")
  return False


def _block_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
  """A fused block read from disk as a host tensor (bf16 blocks by their
  bits)."""
  if bf16:
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(arr)


def _read_npz(path: str, part: str) -> Dict[str, np.ndarray]:
  with np.load(os.path.join(path, f"{part}.npz")) as z:
    return {k: np.asarray(v) for k, v in z.items()}


def _check_leaves(flat: Dict[str, np.ndarray],
                  like: Dict[str, torch.Tensor]) -> None:
  """Every dense parameter of ``like`` (state_dict names) is in ``flat``
  (the flax tree's paths) with its shape, as the JAX package's strict
  unflatten checks (kernels transposed)."""
  # convert imports the serving and training modules; import at call time
  from .convert import optax_param_paths
  for name, (key, transpose) in optax_param_paths(like).items():
    if key not in flat:
      raise ValueError(f"checkpoint is missing leaf {key!r}")
    shape = like[name].shape
    want = tuple(shape[::-1]) if transpose else tuple(shape)
    if tuple(flat[key].shape) != want:
      raise ValueError(f"leaf {key!r} has shape {flat[key].shape} in the "
                       f"checkpoint, expected {want}")


def _assemble_state(flats: Dict[str, Dict[str, Any]], state_like,
                    plan, rank: Optional[int], dev, step: int,
                    strict_tables: bool = True) -> Dict[str, Any]:
  """A port train state from a checkpoint's four flat parts (numpy
  leaves in the JAX package's spelling): the dense parameters by
  ``state_like``'s names and shapes, the dense-class tables (global,
  ``[world * rows, width]``; this rank's block at world N) and their
  per-row optimizer leaves cut to ``rank``, the optax states installed
  into optimizers of ``state_like``'s kinds. ``strict_tables=False``
  takes the tables' shapes from ``flats`` (a re-sharded state's template
  may be of another world)."""
  # convert and training import this module's neighbours; import at call
  # time
  from .convert import dense_state_dict_from_flax
  from .serving.export import _unflatten_paths
  from .training import OptaxState, _with_optimizers, rebind_optimizer
  dense_like = state_like["dense"]
  dense_flat = flats["dense"]
  _check_leaves(dense_flat, dense_like)
  dense = {k: v.to(dev) for k, v in dense_state_dict_from_flax(
      _unflatten_paths(dense_flat)).items()}
  if set(dense) != set(dense_like):
    raise ValueError(f"checkpoint dense params {sorted(dense)} do not "
                     f"match the state's {sorted(dense_like)}")

  emb_like = state_like["emb_dense"]
  tables = dict(flats["emb_dense"])
  world_rows = {}
  for name in emb_like:
    if name not in tables:
      raise ValueError(f"checkpoint is missing leaf {name!r}")
    arr = tables[name]
    rows = arr.shape[0] // plan.world_size
    world_rows[name] = rows
    lo = 0 if rank is None else rank * rows
    hi = arr.shape[0] if rank is None else lo + rows
    if strict_tables and (hi - lo != emb_like[name].shape[0] or
                          arr.shape[1:] != tuple(emb_like[name].shape[1:])):
      raise ValueError(
          f"leaf {name!r} has shape {arr.shape} in the checkpoint, "
          f"expected {rows * plan.world_size} rows of "
          f"{tuple(emb_like[name].shape[1:])}")
    tables[name] = arr[lo:hi]
  emb_dense = {k: hostarrays.tensor_of(tables[k]).to(dev)
               for k in emb_like}

  emb_opt_flat = dict(flats["emb_dense_opt"])
  if rank is not None:
    for key, arr in list(emb_opt_flat.items()):
      name = key.split("/")[-1]
      if name in world_rows:
        n = world_rows[name]
        emb_opt_flat[key] = arr[rank * n:(rank + 1) * n]
  opts = {"dense": OptaxState(dict(flats["dense_opt"])),
          "emb_dense": OptaxState(emb_opt_flat)}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": {},
           "dense_opt": opts["dense"], "emb_dense_opt": opts["emb_dense"],
           "step": int(step)}
  bound = {part: state_like.get(f"{part}_opt") for part in opts}
  if any(o is not None and not isinstance(o, OptaxState)
         for o in bound.values()):
    factories = {part: (lambda ps, o=o: rebind_optimizer(o, ps))
                 if o is not None and not isinstance(o, OptaxState) else None
                 for part, o in bound.items()}
    dense_factory = factories["dense"] or factories["emb_dense"]
    _with_optimizers(state, dense_factory, factories["emb_dense"])
  return state


def _part_flats(state: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
  """The four flat parts of a whole-world state held in this process, as
  :func:`_npz_parts` writes them, numpy copies (bf16 leaves as their
  bits): what a checkpoint of it would read back."""
  def host(v):
    return np.array(_elastic.block_bits(v))
  return {part: {k: host(v) for k, v in flat.items()}
          for part, flat in _npz_parts(state, None, None).items()}


def _remap_tier_counts(path: str, manifest: Dict[str, Any], plan, store,
                       n_aux: int) -> Optional[Dict[str, list]]:
  """Window-wise re-map of the saved host-tier observed counts through an
  elastic re-shard (the JAX package's ``_remap_tier_counts``): each
  logical table row carries its old group's count into its new group
  (``elastic.remap_group_counts``, shared with the in-run resize). Writes
  ``store.counts`` and returns the warm-start ranking, or None when the
  checkpoint carries no counts."""
  flat = _load_tier_state_flat(path)
  if not any(k.endswith("/counts") for k in flat):
    return None

  def counts_of(cname, rank):
    return flat.get(f"{cname}/r{rank}/counts")

  return _elastic.remap_group_counts(
      manifest["world"]["classes"], manifest["plan"]["layout"],
      int(manifest["world"]["ranks"]), n_aux, counts_of, plan, store)


def _restore_elastic(path: str, manifest: Dict[str, Any], plan, rule,
                     state_like, rank: Optional[int], mesh, store, dev
                     ) -> Dict[str, Any]:
  """Load a world-N checkpoint onto a world-M plan by re-slicing its rank
  blocks at LOGICAL-row granularity (the JAX package's
  ``_restore_elastic``).

  Per target rank block, each slot's row and column windows are pulled
  from the saved packed blocks (``fused_*`` files and ``cold_*`` images
  alike) through memory-mapped physical-row slices, unpacked and packed
  into the new plan's block: every logical row (table and optimizer
  lanes) is bit-equal across the move, padding rows zero. At world N
  this rank builds only its own blocks (and its store's owned images).
  The dense-class blocks and their per-row optimizer leaves re-shard by
  the same table windows; the host-tier observed counts are re-mapped
  (:func:`_remap_tier_counts`) and the resident sets start from their
  ranking. Peak host memory for the sparse classes is one target block
  and one source window."""
  saved = manifest["plan"]
  world_meta = manifest["world"]
  n_src = int(world_meta["ranks"])
  src_classes = world_meta["classes"]
  src_layout = saved["layout"]
  n_aux = rule.n_aux

  tiered_names = frozenset(store.tplan.tier_specs) if store is not None \
      else frozenset()
  new_host = {class_param_name(*k) for k in plan.host_tier_class_keys()}
  if new_host and store is None:
    raise ValueError(
        "elastic restore onto a plan with host-tier classes requires the "
        "new world's HostTierStore (restore(..., store=store)): the "
        "re-sharded cold images have nowhere to live otherwise.")
  if store is not None and set(tiered_names) != new_host:
    raise ValueError(
        f"store geometry {sorted(tiered_names)} does not cover the plan's "
        f"host-tier classes {sorted(new_host)}: build the HostTierStore "
        "from a TieringPlan of THIS plan")

  src_slots = _elastic.build_source_index(src_classes, src_layout, n_src,
                                          n_aux)

  def read_rows(tag, lay, lo, hi) -> np.ndarray:
    cname, r = tag
    prefix = "cold" if src_classes[cname]["tier"] == "host" else "fused"
    fname = f"{prefix}_{cname}_r{r}.npy"
    faultinject.fire("reshard_gather", file=fname, rows=hi - lo)

    def phys(p0, p1):
      blk = np.load(os.path.join(path, fname), mmap_mode="r")
      if blk.shape != (lay.phys_rows, lay.phys_width):
        raise ValueError(
            f"elastic restore: {fname} has shape {blk.shape}, but the "
            f"manifest's world section implies "
            f"{(lay.phys_rows, lay.phys_width)} — manifest and files "
            "disagree (corrupt or hand-edited checkpoint)")
      return np.asarray(blk[p0:p1])

    return _elastic.read_logical_rows(lay, phys, lo, hi, n_aux)

  bf16 = any(m.get("dtype") == "bfloat16"
             for m in manifest.get("fused", {}).values())
  dtype = _elastic.BF16_BITS if bf16 else np.float32
  ranks = range(plan.world_size) if rank is None else [rank]
  fused: Dict[str, torch.Tensor] = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    if cp.kind != "sparse":
      continue
    name = class_param_name(*key)
    lay_log = PackedLayout(rows=padded_rows(plan, key), width=cp.width,
                           n_aux=n_aux)
    if name in tiered_names:
      for r in store.owned_ranks:
        store.set_image(name, r, _elastic.regroup_rank_block(
            plan, key, lay_log, r, src_slots, read_rows, n_aux,
            store.dtype))
      continue
    fused[name] = _elastic.block_tensor(np.concatenate(
        [_elastic.regroup_rank_block(plan, key, lay_log, r, src_slots,
                                     read_rows, n_aux, dtype)
         for r in ranks]), dev)

  if store is not None and tiered_names:
    ranking = _remap_tier_counts(path, manifest, plan, store, n_aux)
    if ranking is None:
      for name in store.counts:
        for cnt in store.counts[name]:
          cnt[:] = 0
    store.warm_start(ranking)
    fused.update(store.build_fused(mesh, dev))

  flats = {part: _read_npz(path, part) for part in _PARTS}
  for part in ("emb_dense", "emb_dense_opt"):
    flats[part] = _elastic.regroup_dense_flat(flats[part], src_classes,
                                              src_layout, n_src, plan)
  state = _assemble_state(flats, state_like, plan, rank, dev,
                          int(manifest["step"]), strict_tables=False)
  state["fused"] = fused
  return state


def read_pod_clock(path: str):
  """The per-process clock-offset records of a world-N save
  (``pod_clock.json``): not ported yet."""
  raise NotImplementedError(
      "read_pod_clock (the clock records a world-N save piggybacks on its "
      "barriers, pod_clock.json): not ported yet (ROADMAP.md §1 item 11c, "
      "with telemetry.estimate_clock_offset)")


def restore(path: str, plan, rule, state_like: Dict[str, Any],
            mesh=None, store=None, verify_integrity: bool = True,
            vocab=None, telemetry=None, stream=None,
            device="cuda") -> Dict[str, Any]:
  """Load a checkpoint written by :func:`save` (or by the JAX package's
  ``checkpoint.save``) into a new port train state on ``device`` (with a
  world-N ``mesh``: this rank's blocks, on the mesh's device).

  ``state_like`` is a port train state of the same plan (e.g. fresh from
  ``training.init_sparse_state_direct``): it gives the dense parameters'
  names and shapes and the optimizers; the result gets optimizers of the
  same kind and settings, bound to its tensors, with the checkpoint's
  optax states installed (``convert.install_optax_state``), and the
  checkpoint's ``step``. A ``state_like`` whose optimizers are not bound
  yet gives a state that carries the optax states as
  ``training.OptaxState`` (the train step binds and installs them).

  When ``path`` has no manifest but ``path + '.old'`` has one (a crash
  between :func:`save`'s two renames), the backup is restored. Rank 0
  verifies every file first (``verify_integrity``) and the verdict is
  broadcast; then format, rule, plan and physical shapes are checked,
  with the JAX package's messages, and each rank memory-maps only its own
  ``fused_*_r<rank>.npy`` files. With ``telemetry`` (a
  ``telemetry.MetricsRegistry``) the manifest's ``telemetry`` section, if
  any, is loaded into it.

  A checkpoint of another world (a plan that differs only in placement)
  is re-sharded on the way (:func:`_restore_elastic`); each re-sliced
  source window fires the ``reshard_gather`` fault site. The tables, the
  input map, the tiers and the sparse/dense kinds must match (the JAX
  package's refusals otherwise).

  A tiered checkpoint needs ``store`` (a ``HostTierStore`` whose
  ``TieringPlan`` geometry matches the saving run's; the JAX package's
  "tiering mismatch" and "tier geometry" refusals otherwise): the owned
  ranks' cold images and every rank's resident sets and counts are loaded
  into it, and the host-tier classes' compact device buffers are rebuilt
  from the restored resident sets (a ``TieredPrefetcher`` bound to the
  store then needs ``refresh_resident()``)."""
  refuse_unported(vocab, stream)
  rank = _state_rank(plan, mesh)
  dev = mesh.device if mesh is not None else resolve_device(device)
  layouts, tiered_names = _device_layouts(plan, rule, store)
  if not os.path.exists(os.path.join(path, "manifest.json")) \
      and os.path.exists(os.path.join(path + ".old", "manifest.json")):
    # a crash between save()'s two renames leaves only the backup
    path = path + ".old"
  if verify_integrity:
    _verify_on_root(path, rank)
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  elastic = _check_manifest(manifest, plan, rule, layouts, store)
  if telemetry is not None and manifest.get("telemetry") is not None:
    # REPLACES the named metrics' values: a resume continues the run's
    # counts rather than adding to what this process observed so far
    telemetry.load_state_dict(manifest["telemetry"])
  if elastic:
    return _restore_elastic(path, manifest, plan, rule, state_like, rank,
                            mesh, store, dev)

  fused = {}
  ranks = range(plan.world_size) if rank is None else [rank]
  for name in layouts:
    # a bf16 block reads back as 2-byte voids: viewed by the manifest's
    # dtype (the JAX package's own restore cannot read it, ROADMAP.md §3)
    bf16 = manifest["fused"][name].get("dtype") == "bfloat16"
    blocks = [_block_tensor(np.load(
        os.path.join(path, f"fused_{name}_r{r}.npy"), mmap_mode="c"), bf16)
        for r in ranks]
    host = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    fused[name] = host.to(dev, copy=True)
    del blocks, host
  if store is not None:
    _restore_tier_state(path, store, tiered_names)
    fused.update(store.build_fused(mesh, dev))

  state = _assemble_state({part: _read_npz(path, part) for part in _PARTS},
                          state_like, plan, rank, dev, int(manifest["step"]))
  state["fused"] = fused
  return state
