"""Frozen tables: train state -> inference image (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/serving/export.py`` for the
non-tiered, in-memory path. :func:`freeze` strips the interleaved
optimizer lanes from each packed training buffer into a denser
inference image:

- **f32**: the packed layout with ``n_aux=0`` (same physical-row
  machinery, just denser);
- **int8**: per-row symmetric quantization, ``scale = max|row| / 127``,
  with the row's f32 scale bit-packed into 4 trailing int8 lanes, so the
  serve gather dequantizes with one multiply and no second lookup;
- **fp8**: per-row amax scaling onto the e4m3 grid, ``scale = max|row| /
  448``, the values cast to ``float8_e4m3fn`` and the f32 scale in 4
  trailing byte lanes, as int8. The port holds an fp8 image as its bytes
  (``int8`` storage, the JAX package's on-disk view); only the value
  lanes are ever viewed as ``torch.float8_e4m3fn`` (some scale bytes are
  e4m3 NaN patterns, so the scale lanes are never converted).

The images are byte-identical to the JAX package's for the same train
state, f32 or bf16 (narrow storage: rows widen to f32 exactly)
(``tests/test_torch_serving.py``, ``tests/test_torch_serve_fp8.py``).
The quantization runs in torch, on whatever device the buffers live on
(the card, in production).

:func:`export` writes the artifact to disk and :func:`load` reads it
back, in the JAX package's format (the same directory layout, file
names, manifest and ``SERVE_FORMAT_VERSION``), so either package loads
the other's artifacts (``tests/test_torch_serve_artifact.py``)::

    manifest.json              'serve' section (quantize mode, per-class
                               geometry), plan fingerprint, step,
                               per-file crc32 + size, written LAST
    serve_<class>_r<rank>.npy  one rank's serve-layout block
    dense.npz                  the model's parameters as the flax tree
                               (``bottom_mlp/dense_0/kernel``, kernels
                               ``[in, out]``)
    emb_dense.npz              the dense-class tables by class name, in
                               the train state's storage type (f32, or
                               bf16 under the ``'<V2'`` descr)

The JAX package exports from one controller that holds every rank's
block. The port runs one process per rank, so at world N every rank
calls :func:`export` with its mesh: each writes and seals its own block
files into the shared ``.tmp`` directory, rank 0 gathers the checksum
tables, writes the shared files and publishes the manifest. A rank's
:func:`load` reads and verifies only its own block files and the shared
ones. The directory on disk is the one the JAX package writes.

Not ported yet: host-tier classes (ROADMAP §1 item 8),
dynamic-vocabulary snapshots and owner-sharded loads (item 12).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional

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
    publish_manifest_last,
)
from ..checkpoint import verify as verify_dir
from ..device import resolve_device
from ..ops.packed_table import PackedLayout, SparseRule
from ..parallel import wire
from ..parallel.lookup_engine import class_param_name, padded_rows
from ..resilience import faultinject

SERVE_FORMAT_VERSION = 1

# trailing single-byte lanes per logical row carrying the row's f32 scale
INT8_SCALE_LANES = 4

QUANTIZE_MODES = ("f32", "int8", "fp8")

# largest finite float8_e4m3fn value: an fp8 row's amax lands exactly here
FP8_MAX = 448.0
# the manifest's dtype of an fp8 image (the JAX package's numpy dtype name)
FP8_DTYPE_NAME = "float8_e4m3fn"

# rows quantized per step: bounds the f32 temporaries on large tables
_QUANT_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass(frozen=True)
class ServeClassMeta:
  """Geometry of one sparse class's inference image."""

  name: str
  rows: int           # logical rows (= padded_rows of the class)
  width: int          # table width (f32 output lanes after dequant)
  tier: str           # 'device' (host tiers are not ported yet)
  quantize: str       # 'f32' | 'int8' | 'fp8'
  # the training layout's rows-per-physical-row when the train rule
  # interleaved aux lanes into narrow rows: the f32 serve combine then
  # reproduces the eval step's masked-window summation order
  # (engine._combine_masked_order). 1 = the plain h-axis sum.
  combine_rpp: int = 1

  @property
  def lanes(self) -> int:
    """Byte lanes (int8, fp8) or f32 lanes per stored logical row."""
    return self.width + (INT8_SCALE_LANES
                         if self.quantize in ("int8", "fp8") else 0)

  @property
  def packed(self) -> PackedLayout:
    """Physical layout of the inference image (lane unit = element)."""
    return PackedLayout(rows=self.rows, width=self.lanes, n_aux=0)

  @property
  def np_dtype(self) -> np.dtype:
    return np_dtype_of(self.quantize)

  def to_disk(self, arr: np.ndarray) -> np.ndarray:
    """The on-disk form of a block: its own bytes (an fp8 image is held
    as int8 bytes, the JAX package's on-disk view of it)."""
    return np.ascontiguousarray(arr, self.np_dtype)

  def from_disk(self, arr: np.ndarray) -> np.ndarray:
    """Inverse of :meth:`to_disk`."""
    return np.asarray(arr, self.np_dtype)

  def to_json(self) -> Dict[str, Any]:
    lay = self.packed
    return {"rows": int(self.rows), "width": int(self.width),
            "tier": self.tier, "quantize": self.quantize,
            "combine_rpp": int(self.combine_rpp),
            "phys_rows": int(lay.phys_rows),
            "phys_width": int(lay.phys_width),
            "dtype": (FP8_DTYPE_NAME if self.quantize == "fp8"
                      else str(self.np_dtype))}

  @classmethod
  def from_json(cls, name: str, d: Dict[str, Any]) -> "ServeClassMeta":
    return cls(name=name, rows=int(d["rows"]), width=int(d["width"]),
               tier=d["tier"], quantize=d["quantize"],
               combine_rpp=int(d.get("combine_rpp", 1)))


def np_dtype_of(quantize: str) -> np.dtype:
  """Element dtype of a serve image under one quantize mode, as the port
  stores it (an fp8 image as its int8 bytes: numpy has no e4m3 type
  without ``ml_dtypes``)."""
  return np.dtype(np.int8 if quantize in ("int8", "fp8") else np.float32)


# ---------------------------------------------------------------------------
# int8 row codec
# ---------------------------------------------------------------------------


def quantize_rows_int8(table: torch.Tensor) -> torch.Tensor:
  """``[N, w]`` f32 rows -> ``[N, w + 4]`` int8 rows-with-scale.

  ``scale = max|row| / 127`` (1.0 for all-zero rows), ``q = clip(
  round_half_even(row / scale), -127, 127)``, the f32 scale bitcast into
  the 4 trailing lanes. Runs in row chunks on the table's device."""
  table = torch.as_tensor(table)
  n, w = table.shape
  out = torch.empty((n, w + INT8_SCALE_LANES), dtype=torch.int8,
                    device=table.device)
  for r0 in range(0, n, _QUANT_CHUNK_ROWS):
    t = table[r0:r0 + _QUANT_CHUNK_ROWS].to(torch.float32)
    amax = t.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(t / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    out[r0:r0 + t.shape[0], :w] = q
    out[r0:r0 + t.shape[0], w:] = scale.view(torch.int8).view(-1, 4)
  return out


def dequantize_rows_int8(qrows: torch.Tensor) -> torch.Tensor:
  """Inverse of :func:`quantize_rows_int8` (the serve gather fuses the
  same multiply, ``engine._dequant_rows``)."""
  w = qrows.shape[-1] - INT8_SCALE_LANES
  scale = qrows[..., w:].contiguous().view(torch.float32)
  return qrows[..., :w].to(torch.float32) * scale


def quantize_rows_fp8(table: torch.Tensor) -> torch.Tensor:
  """``[N, w]`` rows -> ``[N, w + 4]`` fp8 rows-with-scale, as int8 bytes.

  ``scale = max|row| / 448`` in f32 (1.0 for all-zero rows), the f32
  quotient ``row / scale`` cast to ``float8_e4m3fn`` (round to nearest
  even), the f32 scale's bytes in the 4 trailing lanes: the JAX package's
  ``quantize_rows_fp8`` bytes. The row's amax lands on 448, the largest
  finite e4m3 value, so nothing saturates. ``|row - deq| <= 2^-4 *
  max|row|`` per element. Runs in row chunks on the table's device."""
  table = torch.as_tensor(table)
  n, w = table.shape
  out = torch.empty((n, w + INT8_SCALE_LANES), dtype=torch.int8,
                    device=table.device)
  for r0 in range(0, n, _QUANT_CHUNK_ROWS):
    t = table[r0:r0 + _QUANT_CHUNK_ROWS].to(torch.float32)
    amax = t.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (t / scale[:, None]).to(torch.float8_e4m3fn)
    out[r0:r0 + t.shape[0], :w] = q.view(torch.int8)
    out[r0:r0 + t.shape[0], w:] = scale.view(torch.int8).view(-1, 4)
  return out


def dequantize_rows_fp8(qrows: torch.Tensor) -> torch.Tensor:
  """Inverse of :func:`quantize_rows_fp8` on the bytes (``int8`` or
  ``uint8``): the value lanes viewed as e4m3 and widened, times the row's
  f32 scale (the serve gather fuses the same, ``engine._dequant_rows``).
  Sentinel rows are zero bytes: scale 0.0, so they stay zero."""
  w = qrows.shape[-1] - INT8_SCALE_LANES
  scale = qrows[..., w:].contiguous().view(torch.float32)
  q = qrows[..., :w].contiguous().view(torch.float8_e4m3fn)
  return q.to(torch.float32) * scale


def quantize_rows(table: torch.Tensor, quantize: str) -> torch.Tensor:
  """Dispatch one mode's row codec (f32 passes through; bf16 rows widen
  exactly)."""
  if quantize == "int8":
    return quantize_rows_int8(table)
  if quantize == "fp8":
    return quantize_rows_fp8(table)
  return table.to(torch.float32)


# ---------------------------------------------------------------------------
# freeze: train state -> inference blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrozenTables:
  """Inference image of one train state (see :func:`freeze`).

  ``device_blocks[name]`` holds one serve-layout block per rank; a rank
  whose block this process does not hold (a world-N freeze with a mesh)
  is ``None``. ``emb_dense`` holds the global dense-class tables."""

  quantize: str
  step: int
  meta: Dict[str, ServeClassMeta]
  device_blocks: Dict[str, List[Optional[torch.Tensor]]]
  dense: Dict[str, torch.Tensor]                # model state_dict
  # dense-class tables, in the train state's storage type (f32 or bf16)
  emb_dense: Dict[str, torch.Tensor]


def _as_tensor(x) -> torch.Tensor:
  """Tensors pass through, detached from autograd (a train state's
  dense tensors are leaves that require grad); numpy arrays (possibly
  read-only views of another framework's buffers) are copied into a
  tensor."""
  if isinstance(x, torch.Tensor):
    return x.detach()
  return hostarrays.tensor_of(x)


def _strip_block(train_lay: PackedLayout, meta: ServeClassMeta,
                 block: torch.Tensor) -> torch.Tensor:
  """One rank's packed TRAIN block -> its serve block: unpack (the aux
  lanes fall away), optionally quantize, re-pack into the serve layout."""
  tbl, _aux = train_lay.unpack(block)
  rows = quantize_rows(tbl, meta.quantize)
  return meta.packed.pack(rows)


def serve_class_meta(plan, rule: SparseRule, quantize: str):
  """Per sparse class: its :class:`ServeClassMeta` and the TRAIN layout
  its rows strip from (the one place serve geometry derives from a
  plan)."""
  meta: Dict[str, ServeClassMeta] = {}
  full_lays: Dict[str, PackedLayout] = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    if cp.kind != "sparse":
      continue
    name = class_param_name(*key)
    rows = padded_rows(plan, key)
    full_lay = PackedLayout(rows=rows, width=cp.width, n_aux=rule.n_aux)
    full_lays[name] = full_lay
    meta[name] = ServeClassMeta(
        name=name, rows=rows, width=cp.width, tier="device",
        quantize=quantize,
        combine_rpp=(full_lay.rows_per_phys
                     if rule.n_aux and full_lay.rows_per_phys > 1 else 1))
  return meta, full_lays


def freeze(plan, rule: SparseRule, state: Dict[str, Any],
           quantize: str = "f32", store=None, mesh=None) -> FrozenTables:
  """Strip a fused train state into inference blocks.

  Args:
    rule: the TRAINING rule (its ``n_aux`` defines the stripped lanes).
    state: ``{'fused', 'emb_dense', 'dense'[, 'step']}``: packed sparse
      class buffers, dense-class tables and the model's state_dict, as
      tensors (on any device; the blocks stay there) or numpy arrays
      (the JAX package's train state, handed across as numpy).
    quantize: ``'f32'`` (bit-exact serving), ``'int8'`` or ``'fp8'``
      (int8 bytes); bf16 tables widen to f32 exactly first. Dense-class
      tables keep their storage type (a bf16 state's stay bf16, as the
      JAX package's freeze keeps them) and the model's parameters stay
      f32.
    mesh: with a world-N plan, this rank's mesh: ``state`` then holds the
      rank's blocks only (``training.init_sparse_state_direct(mesh=)``),
      and every rank calls :func:`freeze` (the dense-class tables are
      gathered to their global form).
  """
  if quantize not in QUANTIZE_MODES:
    raise ValueError(f"unknown quantize mode {quantize!r}; "
                     f"have {list(QUANTIZE_MODES)}")
  if store is not None or plan.host_tier_class_keys():
    raise NotImplementedError(
        "host-tier classes (store=): tiered serving is not ported yet "
        "(ROADMAP.md §1 item 8)")
  rank = _state_rank(plan, mesh)
  meta, layouts = serve_class_meta(plan, rule, quantize)
  device_blocks: Dict[str, List[Optional[torch.Tensor]]] = {}
  for name, m in meta.items():
    arr = _as_tensor(state["fused"][name])
    lay = layouts[name]
    if rank is None:
      device_blocks[name] = [
          _strip_block(lay, m, arr[r * lay.phys_rows:(r + 1) * lay.phys_rows])
          for r in range(plan.world_size)]
      continue
    if arr.shape[0] != lay.phys_rows:
      raise ValueError(
          f"class {name}: {arr.shape[0]} physical rows, not one rank's "
          f"{lay.phys_rows} (with a mesh the state holds this rank's "
          "blocks)")
    blocks: List[Optional[torch.Tensor]] = [None] * plan.world_size
    blocks[rank] = _strip_block(lay, m, arr)
    device_blocks[name] = blocks
  emb_dense = {k: _as_tensor(v) for k, v in state.get("emb_dense",
                                                      {}).items()}
  if rank is not None:
    emb_dense = {k: wire.gather_blocks(v.contiguous(), mesh)
                 for k, v in emb_dense.items()}
  return FrozenTables(
      quantize=quantize, step=int(state.get("step", 0)), meta=meta,
      device_blocks=device_blocks,
      dense={k: _as_tensor(v) for k, v in state.get("dense", {}).items()},
      emb_dense=emb_dense)


def _rank_rows(table: torch.Tensor, plan, rank: Optional[int]
               ) -> torch.Tensor:
  """Rank ``rank``'s block of a global ``[world * n, w]`` table (the
  whole table when ``rank`` is None)."""
  if rank is None:
    return table
  n = table.shape[0] // plan.world_size
  return table[rank * n:(rank + 1) * n]


def frozen_device_state(frozen: FrozenTables, plan, device="cuda",
                        mesh=None) -> Dict[str, Any]:
  """The serve state dict ``{'dense', 'emb_dense', 'serve'}`` on
  ``device`` (tensors already there are not copied). With a world-N
  plan the state is this rank's (``mesh``): its own serve blocks and
  dense-class rows, on the mesh's device."""
  if plan.world_size > 1 and mesh is None:
    raise ValueError(f"a world-{plan.world_size} plan is served by every "
                     "rank with its mesh (parallel.mesh.create_mesh)")
  rank = _state_rank(plan, mesh)
  dev = mesh.device if rank is not None else resolve_device(device)

  def put(x):
    return _as_tensor(x).to(dev)

  serve = {}
  for name, blocks in frozen.device_blocks.items():
    block = blocks[0 if rank is None else rank]
    if block is None:
      raise ValueError(f"class {name}: this FrozenTables does not hold "
                       f"rank {rank}'s block (it was frozen by another "
                       "rank)")
    serve[name] = put(block)
  return {"dense": {k: put(v) for k, v in frozen.dense.items()},
          "emb_dense": {k: put(_rank_rows(_as_tensor(v), plan, rank))
                        for k, v in frozen.emb_dense.items()},
          "serve": serve}


# ---------------------------------------------------------------------------
# durable artifact write / read
# ---------------------------------------------------------------------------


def export(path: str, plan, rule: SparseRule, state: Dict[str, Any],
           quantize: str = "f32", store=None,
           extra: Optional[Dict[str, Any]] = None, vocab=None,
           mesh=None) -> FrozenTables:
  """Freeze the train state and write the serve artifact at ``path``.

  The JAX package's durable protocol and format: every file fsynced and
  sealed into a crc32 + size table, the manifest (quantize mode,
  per-class geometry, plan fingerprint, step, ``extra``) written LAST,
  then an atomic rename (a previous artifact rotates to ``.old``). A
  crash at any point leaves either a manifest-less ``.tmp`` or a
  complete artifact. The model's parameters are written as the flax
  tree (``convert.dense_state_dict_to_flax``). Returns the frozen
  blocks.

  ``mesh``: a world-N state of rank blocks is exported by every rank
  with its mesh: each rank writes and seals its own block files into
  the shared ``path + '.tmp'``, rank 0 gathers the checksum tables
  (``all_gather_object``), writes ``dense.npz`` and ``emb_dense.npz``
  and publishes the manifest, and every rank returns once the artifact
  is published. Without a mesh one process writes every rank's block,
  as the JAX package's single controller does."""
  # convert imports this module (FrozenTables); import it at call time
  from ..convert import dense_state_dict_to_flax
  if vocab is not None:
    raise NotImplementedError(
        "vocab= (a dynamic-vocabulary snapshot) is not ported yet "
        "(ROADMAP.md §1 item 12, dynvocab)")
  frozen = freeze(plan, rule, state, quantize=quantize, store=store,
                  mesh=mesh)
  rank = _state_rank(plan, mesh)
  lead = rank is None or rank == 0
  tmp = path + ".tmp"
  if lead:
    if os.path.exists(tmp):
      shutil.rmtree(tmp)
    os.makedirs(tmp)
  if rank is not None:
    dist.barrier()  # the .tmp directory exists before any rank writes
  checksums: Dict[str, Dict[str, int]] = {}

  def _seal(fpath: str) -> None:
    _fsync_path(fpath)
    faultinject.fire("ckpt_write", path=fpath)
    checksums[os.path.basename(fpath)] = _crc32_file(fpath)

  for name, blocks in sorted(frozen.device_blocks.items()):
    for r, block in enumerate(blocks):
      if block is None:
        continue
      fpath = os.path.join(tmp, f"serve_{name}_r{r}.npy")
      np.save(fpath, frozen.meta[name].to_disk(_host(block)))
      _seal(fpath)
  if rank is not None:
    tables: List[Dict[str, Dict[str, int]]] = [None] * plan.world_size
    dist.all_gather_object(tables, checksums)
    for t in tables:
      checksums.update(t)
  if lead:
    parts = (("dense", dense_state_dict_to_flax(frozen.dense)),
             ("emb_dense", frozen.emb_dense))
    for part, tree in parts:
      fpath = os.path.join(tmp, f"{part}.npz")
      hostarrays.savez(fpath, _flatten_with_paths(tree))
      _seal(fpath)
    manifest: Dict[str, Any] = {
        "format_version": SERVE_FORMAT_VERSION,
        "kind": "serve",
        "step": int(frozen.step),
        "rule": {"name": rule.name, "n_aux": int(rule.n_aux)},
        "plan": _plan_fingerprint(plan),
        "serve": {
            "quantize": quantize,
            "classes": {n: m.to_json()
                        for n, m in sorted(frozen.meta.items())},
        },
        "checksums": dict(sorted(checksums.items())),
    }
    if extra is not None:
      manifest["extra"] = extra
    publish_manifest_last(tmp, path, manifest)
  if rank is not None:
    dist.barrier()  # published before any rank returns (and loads)
  return frozen


@dataclasses.dataclass
class ServeArtifact:
  """A loaded serve artifact, on its device.

  ``state`` holds ``{'dense', 'emb_dense', 'serve'}``: the model's
  state_dict, the dense-class tables and the serve-layout buffers. At
  world N it is rank ``rank``'s: its own serve blocks and dense-class
  rows (``rank`` is None at world 1, where the state is whole)."""

  quantize: str
  step: int
  meta: Dict[str, ServeClassMeta]
  state: Dict[str, Any]
  rank: Optional[int] = None

  def rank_block(self, name: str, rank: int) -> np.ndarray:
    """One rank's serve-layout block of one class, host-side
    ``[phys_rows, phys_width]`` (int8, fp8 as int8 bytes, or f32). A
    world-N artifact holds its own rank's block only; asking for another
    raises naming it."""
    m = self.meta.get(name)
    if m is None:
      raise KeyError(f"unknown serve class {name!r}; artifact has "
                     f"{sorted(self.meta)}")
    if self.rank is not None:
      if rank != self.rank:
        raise ValueError(
            f"class {name!r} rank {rank} is not held here: this world-N "
            f"load holds rank {self.rank}'s blocks only")
      return _host(self.state["serve"][name])
    lay = m.packed
    return _host(self.state["serve"][name][rank * lay.phys_rows:
                                           (rank + 1) * lay.phys_rows])


def _unflatten_paths(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
  """Path-keyed npz dict -> nested plain dict."""
  out: Dict[str, Any] = {}
  for key in sorted(flat):
    parts = key.split("/")
    d = out
    for p in parts[:-1]:
      d = d.setdefault(p, {})
    d[parts[-1]] = flat[key]
  return out


def load(path: str, plan, mesh=None, verify_integrity: bool = True,
         owned_ranks=None, device="cuda") -> ServeArtifact:
  """Load a serve artifact written by :func:`export` (or by the JAX
  package's ``serving.export``) onto ``device``.

  The plan must match the exporting run's exactly (fingerprint
  equality; a mismatch names the differing keys). With a world-N plan
  every rank loads with its mesh and reads, and verifies, only its own
  block files and the shared ones, onto the mesh's device."""
  # convert imports this module (FrozenTables); import it at call time
  from ..convert import dense_state_dict_from_flax
  if owned_ranks is not None:
    raise NotImplementedError(
        "owned_ranks= (owner-sharded fleet loads) is not ported yet "
        "(ROADMAP.md §1 item 12, fleet)")
  if plan.world_size > 1 and mesh is None:
    raise ValueError(f"a world-{plan.world_size} artifact is loaded by "
                     "every rank with its mesh (parallel.mesh.create_mesh)")
  rank = _state_rank(plan, mesh)
  dev = mesh.device if rank is not None else resolve_device(device)
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)
  if manifest.get("kind") != "serve":
    raise ValueError(
        f"{path!r} is not a serve artifact (manifest kind "
        f"{manifest.get('kind')!r})")
  if manifest["format_version"] != SERVE_FORMAT_VERSION:
    raise ValueError(f"serve artifact format {manifest['format_version']} "
                     f"unsupported (expected {SERVE_FORMAT_VERSION})")
  want = _plan_fingerprint(plan)
  if manifest["plan"] != want:
    diff = sorted(k for k in set(manifest["plan"]) | set(want)
                  if manifest["plan"].get(k) != want.get(k))
    raise ValueError(
        "serve artifact plan does not match the current plan (differs "
        f"in {diff}): serve artifacts do not re-shard — re-export from "
        "the checkpoint under this plan.")
  if manifest.get("vocab_snapshot") is not None:
    raise NotImplementedError(
        "artifact carries a dynamic-vocabulary snapshot: not ported yet "
        "(ROADMAP.md §1 item 12, dynvocab)")
  meta = {n: ServeClassMeta.from_json(n, d)
          for n, d in manifest["serve"]["classes"].items()}
  if any(m.tier != "device" for m in meta.values()):
    raise NotImplementedError(
        "artifact has host-tier classes: tiered serving is not ported yet "
        "(ROADMAP.md §1 item 8)")
  ranks = range(plan.world_size) if rank is None else [rank]
  if verify_integrity:
    needed = ["dense.npz", "emb_dense.npz"] + [
        f"serve_{name}_r{r}.npy" for name in sorted(meta) for r in ranks]
    problems = verify_dir(path, only=needed)
    if problems:
      raise ValueError(
          f"serve artifact {path!r} failed integrity verification: "
          + "; ".join(problems))

  serve = {}
  for name, m in sorted(meta.items()):
    blocks = [m.from_disk(np.load(os.path.join(path,
                                               f"serve_{name}_r{r}.npy")))
              for r in ranks]
    host = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
    serve[name] = torch.from_numpy(host).to(dev)
  trees = {}
  for part in ("dense", "emb_dense"):
    with np.load(os.path.join(path, f"{part}.npz")) as z:
      trees[part] = _unflatten_paths(dict(z))
  state = {
      "dense": {k: v.to(dev)
                for k, v in dense_state_dict_from_flax(
                    trees["dense"]).items()},
      "emb_dense": {k: _rank_rows(hostarrays.tensor_of(v), plan,
                                  rank).to(dev)
                    for k, v in trees["emb_dense"].items()},
      "serve": serve}
  return ServeArtifact(quantize=manifest["serve"]["quantize"],
                       step=int(manifest["step"]), meta=meta, state=state,
                       rank=rank)
