"""Frozen tables: train state -> inference image (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/serving/export.py`` for the
non-tiered, in-memory path. :func:`freeze` strips the interleaved
optimizer lanes from each packed training buffer into a denser
inference image:

- **f32**: the packed layout with ``n_aux=0`` (same physical-row
  machinery, just denser);
- **int8**: per-row symmetric quantization, ``scale = max|row| / 127``,
  with the row's f32 scale bit-packed into 4 trailing int8 lanes, so the
  serve gather dequantizes with one multiply and no second lookup.

Both images are byte-identical to the JAX package's for the same train
state (``tests/test_torch_serving.py``). The quantization runs in torch,
on whatever device the buffers live on (the card, in production).

Not ported yet: fp8 images, ``export``/``load`` to disk, tiered (host)
images.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops.packed_table import PackedLayout, SparseRule
from ..parallel.lookup_engine import class_param_name, padded_rows

# trailing single-byte lanes per logical row carrying the row's f32 scale
INT8_SCALE_LANES = 4

QUANTIZE_MODES = ("f32", "int8")

# rows quantized per step: bounds the f32 temporaries on large tables
_QUANT_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass(frozen=True)
class ServeClassMeta:
  """Geometry of one sparse class's inference image."""

  name: str
  rows: int           # logical rows (= padded_rows of the class)
  width: int          # table width (f32 output lanes after dequant)
  tier: str           # 'device' (host tiers are not ported yet)
  quantize: str       # 'f32' | 'int8'
  # the training layout's rows-per-physical-row when the train rule
  # interleaved aux lanes into narrow rows: the f32 serve combine then
  # reproduces the eval step's masked-window summation order
  # (engine._combine_masked_order). 1 = the plain h-axis sum.
  combine_rpp: int = 1

  @property
  def lanes(self) -> int:
    """Byte lanes (int8) or f32 lanes per stored logical row."""
    return self.width + (INT8_SCALE_LANES if self.quantize == "int8" else 0)

  @property
  def packed(self) -> PackedLayout:
    """Physical layout of the inference image (lane unit = element)."""
    return PackedLayout(rows=self.rows, width=self.lanes, n_aux=0)


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


def quantize_rows(table: torch.Tensor, quantize: str) -> torch.Tensor:
  """Dispatch one mode's row codec (f32 passes through)."""
  if quantize == "int8":
    return quantize_rows_int8(table)
  return table.to(torch.float32)


# ---------------------------------------------------------------------------
# freeze: train state -> inference blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrozenTables:
  """Inference image of one train state (see :func:`freeze`)."""

  quantize: str
  step: int
  meta: Dict[str, ServeClassMeta]
  device_blocks: Dict[str, List[torch.Tensor]]  # per rank, serve layout
  dense: Dict[str, torch.Tensor]                # model state_dict
  emb_dense: Dict[str, torch.Tensor]            # dense-class tables, f32


def _as_tensor(x) -> torch.Tensor:
  """Tensors pass through, detached from autograd (a train state's
  dense tensors are leaves that require grad); numpy arrays (possibly
  read-only views of another framework's buffers) are copied into a
  tensor."""
  if isinstance(x, torch.Tensor):
    return x.detach()
  return torch.tensor(np.asarray(x))


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
           quantize: str = "f32") -> FrozenTables:
  """Strip a fused train state into inference blocks.

  Args:
    rule: the TRAINING rule (its ``n_aux`` defines the stripped lanes).
    state: ``{'fused', 'emb_dense', 'dense'[, 'step']}``: packed sparse
      class buffers, dense-class tables and the model's state_dict, as
      tensors (on any device; the blocks stay there) or numpy arrays
      (the JAX package's train state, handed across as numpy).
    quantize: ``'f32'`` (bit-exact serving) or ``'int8'``. Dense-class
      tables and the model's parameters stay f32.
  """
  if quantize not in QUANTIZE_MODES:
    raise ValueError(f"unknown quantize mode {quantize!r}; "
                     f"have {list(QUANTIZE_MODES)} (fp8 is not ported yet)")
  if plan.host_tier_class_keys():
    raise NotImplementedError(
        "plan has host-tier classes: tiered serving is not ported yet")
  meta, layouts = serve_class_meta(plan, rule, quantize)
  device_blocks: Dict[str, List[torch.Tensor]] = {}
  for name, m in meta.items():
    arr = _as_tensor(state["fused"][name])
    lay = layouts[name]
    device_blocks[name] = [
        _strip_block(lay, m, arr[r * lay.phys_rows:(r + 1) * lay.phys_rows])
        for r in range(plan.world_size)]
  return FrozenTables(
      quantize=quantize, step=int(state.get("step", 0)), meta=meta,
      device_blocks=device_blocks,
      dense={k: _as_tensor(v) for k, v in state.get("dense", {}).items()},
      emb_dense={k: _as_tensor(v).to(torch.float32)
                 for k, v in state.get("emb_dense", {}).items()})


def frozen_device_state(frozen: FrozenTables, plan,
                        device="cuda") -> Dict[str, Any]:
  """The serve state dict ``{'dense', 'emb_dense', 'serve'}`` on
  ``device`` (tensors already there are not copied)."""
  dev = resolve_device(device)
  if plan.world_size != 1:
    raise NotImplementedError("the port serves world-1 plans only so far")

  def put(x):
    return _as_tensor(x).to(dev)

  serve = {name: put(torch.cat(blocks) if len(blocks) > 1 else blocks[0])
           for name, blocks in frozen.device_blocks.items()}
  return {"dense": {k: put(v) for k, v in frozen.dense.items()},
          "emb_dense": {k: put(v) for k, v in frozen.emb_dense.items()},
          "serve": serve}
