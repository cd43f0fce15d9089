"""Durable publication core of the checkpoint layer (PyTorch port).

The part of ``distributed_embeddings_tpu/checkpoint.py`` that the serve
artifact (``serving/export.py``) writes and reads through, with the same
on-disk contract, so either package verifies and loads the other's
directories:

- every data file is fsynced and sealed into a per-file crc32 + size
  table (:func:`_crc32_file`);
- the manifest carrying that table is written LAST, fsynced, and the
  ``.tmp`` directory is renamed into place atomically
  (:func:`publish_manifest_last`); a crash at any point leaves either a
  manifest-less ``.tmp`` or a complete directory;
- :func:`verify` checks a published directory's files against the table
  and names each bad file;
- :func:`_plan_fingerprint` pins the plan a directory was written under,
  as JSON equal to the JAX package's for the same plan (plain ``int``\\ s
  and lists only, so a manifest written by one package compares equal
  in the other).

Not ported yet: ``save`` and ``restore`` of a full train state.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List

import numpy as np
import torch

from .parallel.lookup_engine import class_param_name
from .resilience import faultinject


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
  ``checksums`` table exists with the recorded size and crc32.

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
    return [f"manifest {mpath} has no checksums table (a checkpoint "
            "written before the durable format; the port reads only "
            "durable directories)"]
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


def _host(leaf) -> np.ndarray:
  """A tensor (on any device) or array leaf as a host numpy array
  (``.cpu()`` first: ``np.asarray`` of a CUDA tensor raises)."""
  if isinstance(leaf, torch.Tensor):
    return leaf.detach().cpu().numpy()
  return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
  """Nested dicts of tensors or arrays -> ``{'a/b/c': numpy}``, the JAX
  package's path spelling for a tree of dicts (keys in sorted order, as
  its pytree flattening visits them)."""
  flat: Dict[str, np.ndarray] = {}

  def walk(prefix, node):
    if isinstance(node, dict):
      for k in sorted(node):
        walk(f"{prefix}/{k}" if prefix else str(k), node[k])
    else:
      flat[prefix] = _host(node)

  walk("", tree)
  return flat


def plan_layout(plan) -> Dict[str, list]:
  """Per class, per rank, the slot windows ``[table_id, row_offset,
  row_start, input_dim, col_start, col_end, row_sliced]`` (the JAX
  package's ``resilience/elastic.plan_layout``): the fingerprint's
  ``layout`` section."""
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
