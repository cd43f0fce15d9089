"""Frozen tables: train state -> inference image (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/serving/export.py``.
:func:`freeze` strips the interleaved optimizer lanes from each packed
training buffer (or a tiered class's host image) into a denser inference
image:

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

Tiered plans (host-tier classes, ``tiering/``) freeze with the run's
``HostTierStore`` (``freeze(store=)``): the store is flushed against the
state, each host-tier class's cold image is stripped (and quantized) into
its serve layout on the host, and the store's observed counts, re-binned
per serve physical row, become the serve cache's priority ranking. The
artifact then also holds::

    serve_cold_<class>_r<rank>.npy  one rank's stripped cold image
    serve_ranking.npz               '<class>/r<rank>': serve physical rows
                                    in descending priority, and
                                    'counts/<class>/r<rank>': the counts

At world N each process's store owns its rank's image and replicates every
rank's counts: every rank strips and writes its own cold files, rank 0
writes the ranking file, and a rank's :func:`load` reads its own cold
files and every rank's ranking (the serve store's warm start builds every
rank's resident map).

A dynamic-vocabulary run exports its id space with the tables
(``export(vocab=)``: the read-only raw-id -> row mapping of
:func:`vocab_snapshot`, ``vocab_snapshot.npz`` and the manifest's
``vocab_snapshot`` section), and :func:`load` returns it as
``ServeArtifact.vocab``; a caller translates request ids through its
``translate`` before ``ServeEngine.predict``.

Not ported yet: owner-sharded loads (ROADMAP §1 item 12c).
"""

from __future__ import annotations

import dataclasses
import json
import math
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
  tier: str           # 'device' | 'host' (a host-tier class's cold image)
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

  ``device_blocks[name]`` holds one serve-layout block per rank of each
  device-tier class; a rank whose block this process does not hold (a
  world-N freeze with a mesh) is ``None``. ``emb_dense`` holds the global
  dense-class tables. A tiered plan's host-tier classes are in
  ``host_images`` instead (per rank, the stripped cold image in its serve
  layout, host numpy; ``None`` at ranks this process's store does not
  own), with ``ranking`` (per rank, serve physical rows in descending
  priority) and ``counts`` (per rank, the observed counts per serve
  physical row) for every rank."""

  quantize: str
  step: int
  meta: Dict[str, ServeClassMeta]
  device_blocks: Dict[str, List[Optional[torch.Tensor]]]
  dense: Dict[str, torch.Tensor]                # model state_dict
  # dense-class tables, in the train state's storage type (f32 or bf16)
  emb_dense: Dict[str, torch.Tensor]
  host_images: Dict[str, List[Optional[np.ndarray]]] = dataclasses.field(
      default_factory=dict)
  ranking: Dict[str, List[np.ndarray]] = dataclasses.field(
      default_factory=dict)
  counts: Dict[str, List[np.ndarray]] = dataclasses.field(
      default_factory=dict)


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


def _strip_image(train_lay: PackedLayout, meta: ServeClassMeta,
                 image: np.ndarray, device) -> np.ndarray:
  """One rank's packed TRAIN cold image (host numpy) -> its serve image
  (host numpy), as :func:`_strip_block` of the whole image, in chunks of
  about ``_QUANT_CHUNK_ROWS`` logical rows (a multiple of both layouts'
  rows per physical row) moved through ``device``, so the host holds one
  chunk beside the two images whatever the class's size. On a CUDA device
  the chunks pass through two page-locked staging buffers (the host
  copies into and out of them run on torch's threads)."""
  serve_lay = meta.packed
  rpp_t, rpp_s = train_lay.rows_per_phys, serve_lay.rows_per_phys
  unit = math.lcm(rpp_t, rpp_s)
  step = max(unit, _QUANT_CHUNK_ROWS // unit * unit)
  out = np.empty(serve_lay.shape, meta.np_dtype)
  src_all, dst_all = torch.from_numpy(image), torch.from_numpy(out)
  dev = torch.device(device)
  pinned = dev.type == "cuda"
  if pinned:
    stage_in = torch.empty((-(-step // rpp_t), train_lay.phys_width),
                           dtype=src_all.dtype, pin_memory=True)
    stage_out = torch.empty((-(-step // rpp_s), serve_lay.phys_width),
                            dtype=dst_all.dtype, pin_memory=True)
  for r0 in range(0, meta.rows, step):
    n = min(step, meta.rows - r0)
    part = PackedLayout(rows=n, width=train_lay.width, n_aux=train_lay.n_aux)
    src = src_all[r0 // rpp_t:r0 // rpp_t + part.phys_rows]
    if pinned:
      src = stage_in[:part.phys_rows].copy_(src)
    packed = _strip_block(part, dataclasses.replace(meta, rows=n),
                          src.to(dev, non_blocking=pinned))
    dst = dst_all[r0 // rpp_s:r0 // rpp_s + packed.shape[0]]
    if pinned:
      # a blocking copy: the staging buffers are free again after it
      packed = stage_out[:packed.shape[0]].copy_(packed)
    dst.copy_(packed)
  return out


def _serve_grp_counts(meta: ServeClassMeta, train_lay: PackedLayout,
                      counts: np.ndarray) -> np.ndarray:
  """Training observed counts (per TRAIN physical row) re-binned per SERVE
  physical row: each train row's count repeats over its logical rows and
  re-sums per serve physical row (the two layouts pack different logical
  spans a row), as the JAX package's ``_serve_grp_counts``."""
  rpp_t = train_lay.rows_per_phys
  sl = meta.packed
  logical = np.repeat(np.asarray(counts, np.int64), rpp_t)[:meta.rows]
  pad = sl.phys_rows * sl.rows_per_phys - meta.rows
  if pad:
    logical = np.concatenate([logical, np.zeros((pad,), np.int64)])
  return logical.reshape(sl.phys_rows, sl.rows_per_phys).sum(axis=1)


def _serve_ranking(per_grp: np.ndarray) -> np.ndarray:
  """Serve-physical-row counts -> rows in descending priority; ties break
  lowest row first (the store's default warm start)."""
  return np.argsort(-per_grp, kind="stable").astype(np.int32)


def serve_class_meta(plan, rule: SparseRule, quantize: str,
                     tiered_names=frozenset()):
  """Per sparse class: its :class:`ServeClassMeta` and the full-vocabulary
  TRAIN layout its rows strip from (the one place serve geometry derives
  from a plan). ``tiered_names``: the host-tier classes (``tier='host'``;
  their device buffer is compact, their stripped image covers the whole
  class)."""
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
        name=name, rows=rows, width=cp.width,
        tier="host" if name in tiered_names else "device",
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
    store: the run's ``tiering.HostTierStore`` for a tiered plan (a
      ``TieredTrainer``'s state and store). It is flushed against
      ``state['fused']`` first (the device cache holds the newest resident
      rows); each owned rank's cold image strips into ``host_images``
      (quantized on the device of the class's compact buffer, a chunk at
      a time); the counts become ``ranking``.
    mesh: with a world-N plan, this rank's mesh: ``state`` then holds the
      rank's blocks only (``training.init_sparse_state_direct(mesh=)``),
      and every rank calls :func:`freeze` (the dense-class tables are
      gathered to their global form). A tiered state's store owns this
      rank's image (``owned_ranks=(mesh.rank,)``) and replicates every
      rank's counts, so ``ranking`` and ``counts`` cover every rank.
  """
  if quantize not in QUANTIZE_MODES:
    raise ValueError(f"unknown quantize mode {quantize!r}; "
                     f"have {list(QUANTIZE_MODES)}")
  if store is None and plan.host_tier_class_keys():
    raise ValueError(
        "plan has host-tier classes but no HostTierStore was passed: "
        "the cold images hold the authoritative majority of the rows. "
        "Pass the run's store via freeze(..., store=store).")
  rank = _state_rank(plan, mesh)
  tiered_names = frozenset()
  if store is not None:
    if rank is None and not store.owns_all:
      raise NotImplementedError(
          "freeze/export without a mesh is a single-controller operation "
          "(the serving pods load the artifact read-only); a "
          "rank-owner-sharded store cannot supply every rank's image "
          "here. At world N every rank freezes with its mesh.")
    store.local_ranks(mesh)  # the store owns the ranks this process holds
    tiered_names = frozenset(store.tplan.tier_specs)
    store.flush(state["fused"])
  meta, layouts = serve_class_meta(plan, rule, quantize, tiered_names)
  device_blocks: Dict[str, List[Optional[torch.Tensor]]] = {}
  host_images: Dict[str, List[Optional[np.ndarray]]] = {}
  ranking: Dict[str, List[np.ndarray]] = {}
  grp_counts: Dict[str, List[np.ndarray]] = {}
  for name, m in meta.items():
    lay = layouts[name]
    if m.tier == "host":
      dev = _as_tensor(state["fused"][name]).device
      host_images[name] = [
          None if img is None else _strip_image(lay, m, img, dev)
          for img in store.images[name]]
      grp_counts[name] = [_serve_grp_counts(m, lay, c)
                          for c in store.counts[name]]
      ranking[name] = [_serve_ranking(c) for c in grp_counts[name]]
      continue
    arr = _as_tensor(state["fused"][name])
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
      emb_dense=emb_dense, host_images=host_images, ranking=ranking,
      counts=grp_counts)


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


def vocab_snapshot(vocab):
  """Normalize a ``vocab`` argument to the serializable read-only form:
  a live ``dynvocab.DynVocabTranslator`` is snapshotted (mapping only),
  a ``ReadonlyIdTranslator`` passes through."""
  from ..dynvocab import ReadonlyIdTranslator
  if vocab is None or isinstance(vocab, ReadonlyIdTranslator):
    return vocab
  return ReadonlyIdTranslator.from_translator(vocab)


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
  blocks. ``store``: the run's ``HostTierStore`` for a tiered plan
  (:func:`freeze`): the stripped cold images go to
  ``serve_cold_<class>_r<rank>.npy`` and the ranking with its counts to
  ``serve_ranking.npz``, each sealed like every other file.

  ``vocab``: a dynamic-vocabulary run's ``DynVocabTranslator`` (or an
  already-taken ``ReadonlyIdTranslator`` snapshot): its read-only raw-id
  -> row mapping rides the artifact as ``vocab_snapshot.npz`` with a
  ``vocab_snapshot`` manifest section (written by rank 0 at world N), so
  the serving process translates request ids against the exact id space
  the exported rows were trained under.

  ``mesh``: a world-N state of rank blocks is exported by every rank
  with its mesh: each rank writes and seals its own block files into
  the shared ``path + '.tmp'``, rank 0 gathers the checksum tables
  (``all_gather_object``), writes ``dense.npz`` and ``emb_dense.npz``
  and publishes the manifest, and every rank returns once the artifact
  is published. Without a mesh one process writes every rank's block,
  as the JAX package's single controller does. A tiered world-N export
  has each rank write its own cold images; rank 0 writes
  ``serve_ranking.npz`` from its replicated counts (the JAX package's
  single controller writes every file)."""
  # convert imports this module (FrozenTables); import it at call time
  from ..convert import dense_state_dict_to_flax
  snap = vocab_snapshot(vocab)
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
  for name, images in sorted(frozen.host_images.items()):
    for r, image in enumerate(images):
      if image is None:
        continue
      fpath = os.path.join(tmp, f"serve_cold_{name}_r{r}.npy")
      np.save(fpath, frozen.meta[name].to_disk(image))
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
    if frozen.ranking:
      fpath = os.path.join(tmp, "serve_ranking.npz")
      arrays = {f"{name}/r{r}": order
                for name, orders in sorted(frozen.ranking.items())
                for r, order in enumerate(orders)}
      arrays.update({f"counts/{name}/r{r}": cnt
                     for name, cnts in sorted(frozen.counts.items())
                     for r, cnt in enumerate(cnts)})
      np.savez(fpath, **arrays)
      _seal(fpath)
    if snap is not None:
      fpath = os.path.join(tmp, "vocab_snapshot.npz")
      np.savez(fpath, **snap.state_arrays())
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
    if snap is not None:
      manifest["vocab_snapshot"] = snap.manifest_section()
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
  state_dict, the dense-class tables and the device-tier classes'
  serve-layout buffers. At world N it is rank ``rank``'s: its own serve
  blocks and dense-class rows (``rank`` is None at world 1, where the
  state is whole). Host-tier classes are in ``host_images`` (per rank,
  host numpy; ``None`` at the ranks a world-N load does not hold) with
  every rank's ``ranking`` and ``counts``; a :class:`~.engine.ServeEngine`
  built on the artifact turns them into its cold store and hot cache.
  ``vocab`` is the exported ``dynvocab.ReadonlyIdTranslator`` snapshot
  (None for a static-vocab artifact): translate request raw ids through
  it before dispatch."""

  quantize: str
  step: int
  meta: Dict[str, ServeClassMeta]
  state: Dict[str, Any]
  rank: Optional[int] = None
  host_images: Dict[str, List[Optional[np.ndarray]]] = dataclasses.field(
      default_factory=dict)
  ranking: Dict[str, List[np.ndarray]] = dataclasses.field(
      default_factory=dict)
  counts: Dict[str, List[np.ndarray]] = dataclasses.field(
      default_factory=dict)
  vocab: Any = None

  def rank_block(self, name: str, rank: int) -> np.ndarray:
    """One rank's serve-layout block of one class, host-side
    ``[phys_rows, phys_width]`` (int8, fp8 as int8 bytes, or f32). A
    world-N artifact holds its own rank's block only; asking for another
    raises naming it."""
    m = self.meta.get(name)
    if m is None:
      raise KeyError(f"unknown serve class {name!r}; artifact has "
                     f"{sorted(self.meta)}")
    if self.rank is not None and rank != self.rank:
      raise ValueError(
          f"class {name!r} rank {rank} is not held here: this world-N "
          f"load holds rank {self.rank}'s blocks only")
    if m.tier == "host":
      return self.host_images[name][rank]
    if self.rank is not None:
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


def serve_dense_state(trees: Dict[str, Any], plan, rank: Optional[int],
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
  """An artifact's (or a delta's) ``dense.npz`` and ``emb_dense.npz``
  trees (:func:`_unflatten_paths`) -> the serve state's ``'dense'`` (the
  model's state_dict) and ``'emb_dense'`` (this rank's rows at world N)
  on ``device``."""
  # convert imports this module (FrozenTables); import it at call time
  from ..convert import dense_state_dict_from_flax
  return {
      "dense": {k: v.to(device)
                for k, v in dense_state_dict_from_flax(
                    trees["dense"]).items()},
      "emb_dense": {k: _rank_rows(hostarrays.tensor_of(v), plan,
                                  rank).to(device)
                    for k, v in trees["emb_dense"].items()}}


def load(path: str, plan, mesh=None, verify_integrity: bool = True,
         owned_ranks=None, device="cuda") -> ServeArtifact:
  """Load a serve artifact written by :func:`export` (or by the JAX
  package's ``serving.export``) onto ``device``.

  The plan must match the exporting run's exactly (fingerprint
  equality; a mismatch names the differing keys). With a world-N plan
  every rank loads with its mesh and reads, and verifies, only its own
  block files and the shared ones, onto the mesh's device. A tiered
  artifact's cold images and ranking stay on the host
  (``ServeArtifact.host_images`` / ``ranking`` / ``counts``); at world N a
  rank reads its own cold images and every rank's ranking."""
  if owned_ranks is not None:
    raise NotImplementedError(
        "owned_ranks= (owner-sharded fleet loads) is not ported yet "
        "(ROADMAP.md §1 item 12c, fleet)")
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
  meta = {n: ServeClassMeta.from_json(n, d)
          for n, d in manifest["serve"]["classes"].items()}
  tiered = any(m.tier == "host" for m in meta.values())
  ranks = range(plan.world_size) if rank is None else [rank]

  def block_file(name: str, r: int) -> str:
    prefix = "serve_cold" if meta[name].tier == "host" else "serve"
    return f"{prefix}_{name}_r{r}.npy"

  if verify_integrity:
    needed = ["dense.npz", "emb_dense.npz"] + [
        block_file(name, r) for name in sorted(meta) for r in ranks]
    if tiered:
      needed.append("serve_ranking.npz")
    if manifest.get("vocab_snapshot") is not None:
      needed.append("vocab_snapshot.npz")
    problems = verify_dir(path, only=needed)
    if problems:
      raise ValueError(
          f"serve artifact {path!r} failed integrity verification: "
          + "; ".join(problems))

  serve = {}
  host_images: Dict[str, List[Optional[np.ndarray]]] = {}
  ranking: Dict[str, List[np.ndarray]] = {}
  counts: Dict[str, List[np.ndarray]] = {}
  rank_npz: Dict[str, np.ndarray] = {}
  if tiered:
    with np.load(os.path.join(path, "serve_ranking.npz")) as z:
      rank_npz = {k: np.asarray(z[k]) for k in z.files}
  for name, m in sorted(meta.items()):
    if m.tier == "host":
      host_images[name] = [
          m.from_disk(np.load(os.path.join(path, block_file(name, r))))
          if r in ranks else None for r in range(plan.world_size)]
      # every rank's ranking: the serve store's warm start builds every
      # rank's resident map
      ranking[name] = [rank_npz[f"{name}/r{r}"]
                       for r in range(plan.world_size)]
      counts[name] = [
          np.asarray(rank_npz[f"counts/{name}/r{r}"], np.int64)
          if f"counts/{name}/r{r}" in rank_npz
          else np.zeros((m.packed.phys_rows,), np.int64)
          for r in range(plan.world_size)]
      continue
    blocks = [m.from_disk(np.load(os.path.join(path, block_file(name, r))))
              for r in ranks]
    host = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
    serve[name] = torch.from_numpy(host).to(dev)
  trees = {}
  for part in ("dense", "emb_dense"):
    with np.load(os.path.join(path, f"{part}.npz")) as z:
      trees[part] = _unflatten_paths(dict(z))
  state = dict(serve_dense_state(trees, plan, rank, dev), serve=serve)
  vocab = None
  if manifest.get("vocab_snapshot") is not None:
    from ..dynvocab import ReadonlyIdTranslator
    with np.load(os.path.join(path, "vocab_snapshot.npz")) as z:
      vocab = ReadonlyIdTranslator.from_arrays(
          {k: np.asarray(z[k]) for k in z.files})
  return ServeArtifact(quantize=manifest["serve"]["quantize"],
                       step=int(manifest["step"]), meta=meta, state=state,
                       rank=rank, host_images=host_images, ranking=ranking,
                       counts=counts, vocab=vocab)
