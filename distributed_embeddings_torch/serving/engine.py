"""The serve step + engine: inference on frozen tables (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/serving/engine.py`` for the
all-device path, at world 1 and world N. A serve step is route -> gather
(with the int8 dequant fused in) -> combine -> dense classes -> exchange
-> assemble -> model forward, with no scatter and no optimizer state:

- **f32 serving is bit-exact** against the JAX serve step on the same
  frozen image (same gathered values, and the multi-hot combine keeps the
  JAX summation order, including :func:`_combine_masked_order`);
- **int8 rows dequantize on gather** with one multiply against the row's
  bit-packed scale, the same single multiply as the JAX step.

At world N every rank runs the engine with its mesh, one process per
rank: it routes its slice of the global request, gathers and combines
against its own serve blocks, and the exchange of the port's world-N
eval step brings each rank its slice's activations. :meth:`ServeEngine.
dispatch` returns the GLOBAL predictions on every rank (the JAX engine's
batch-sharded output, gathered), so a ``MicroBatcher`` in front of it
de-interleaves by position at any world. Under ``dedup_exchange=True``
each rank gathers (and dequantizes) one row per unique id of every
requesting rank's block, and the requesting rank expands and combines
them, as in the eval step. A ragged value stream (``RaggedIds``) gathers
its rows, dequantizes them and sums each sample's segment as the eval
step does (``lookup_engine._combine_ragged``), for f32 and int8 images
alike.

Not ported yet: tiered serving.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.packed_table import PackedLayout, gather_fused_chunked
from ..parallel import wire
from ..parallel.lookup_engine import (
    DedupRouted,
    DistributedLookup,
    class_param_name,
    padded_rows,
    ragged_hotness,
)
from ..training import shard_batch
from .export import (
    INT8_SCALE_LANES,
    FrozenTables,
    ServeArtifact,
    ServeClassMeta,
    dequantize_rows_fp8,
    dequantize_rows_int8,
    frozen_device_state,
)

__all__ = ["ServeEngine", "make_serve_step", "shard_batch"]


def _dequant_rows(rows: torch.Tensor, meta: ServeClassMeta) -> torch.Tensor:
  """Gathered serve rows -> f32 table rows. int8 and fp8 rows arrive
  ``[..., width + 4]`` bytes: the trailing 4 byte lanes are the row's f32
  scale, and the dequant is one widen + multiply (fp8: the value lanes
  viewed as e4m3 first). Sentinel rows are all-zero bytes, whose scale
  decodes to 0.0, so they stay exactly zero."""
  if meta.quantize == "f32":
    return rows
  if meta.quantize == "fp8":
    return dequantize_rows_fp8(rows)
  return dequantize_rows_int8(rows)


def _combine_masked_order(engine: DistributedLookup, key,
                          rows: torch.Tensor, oids: torch.Tensor,
                          rpp: int, rs: bool) -> torch.Tensor:
  """Multi-hot combine in the eval step's masked-window order.

  A training layout that packs ``rpp`` logical rows per physical row
  makes the JAX eval (and serve) step sum the window-masked rows over the
  hotness axis first and fold the ``rpp`` windows afterwards, which
  groups the f32 additions by ``id % rpp``. This repeats that grouping
  (zeros added where a masked-out window added zeros) so f32 serving
  stays bit-exact against the JAX step.

  The order: per window, the hotness slots in sequence; then the windows
  fold by halves (window i + window i + n/2, repeated), which is the
  association XLA's CPU reduction gives the JAX form's window sum."""
  cp = engine.plan.classes[key]
  if cp.combiner is None:
    raise ValueError("combiner=None requires hotness-1 inputs in the "
                     "distributed path (2-D model-parallel outputs)")
  sentinel = padded_rows(engine.plan, key)
  valid = (oids >= 0) & (oids < sentinel)
  sub = torch.where(valid, oids, torch.zeros_like(oids)) % rpp
  zero = torch.zeros_like(rows)
  windows = []   # per window: the h-axis sum of the rows that land there
  for s in range(rpp):
    hit = (sub == s)[..., None]
    acc = torch.where(hit[:, :, 0], rows[:, :, 0], zero[:, :, 0])
    for j in range(1, rows.shape[2]):
      acc = acc + torch.where(hit[:, :, j], rows[:, :, j], zero[:, :, j])
    windows.append(acc)
  while len(windows) > 1:
    half = len(windows) // 2
    folded = [windows[i] + windows[i + half] for i in range(half)]
    windows = folded + windows[2 * half:]
  z = windows[0]
  if cp.combiner == "mean" and not rs:
    counts = (oids < sentinel).sum(dim=2).to(z.dtype)
    z = z / counts.clamp(min=1)[..., None]
  return z


def _gather_image(layout: PackedLayout, buf: torch.Tensor, ids,
                  meta: ServeClassMeta) -> torch.Tensor:
  """Gather serve rows of one image (``gather_fused_chunked``). The JAX
  gather extracts a narrow image's row (several rows a physical row) by
  adding its masked windows in the image's type; for an fp8 image that
  e4m3 add turns a ``-0.0`` byte (0x80) into ``+0.0``, in the scale lanes
  too (a scale's low byte), so the port clears those bytes alike and its
  scales stay the JAX package's."""
  rows = gather_fused_chunked(layout, buf, ids)
  if meta.quantize == "fp8" and layout.rows_per_phys > 1:
    rows = rows.masked_fill(rows == -128, 0)
  return rows


def _combine_quantized(engine: DistributedLookup, key, qrows: torch.Tensor,
                       oids: torch.Tensor, meta: ServeClassMeta,
                       rs: bool) -> torch.Tensor:
  """Multi-hot combine of int8 or fp8 rows ``[n_b, G, h, w + 4]`` (bytes)
  with the dequant fused in, in the JAX serve step's arithmetic.

  XLA fuses the dequant multiply into the h-axis sum: the first slot's
  value is rounded once (``q * scale``) and every further slot
  accumulates as one fused multiply-add, ``acc = fma(q, scale, acc)``.
  This computes each fused multiply-add in f64, where ``q * scale`` is
  exact, and rounds it to f32 once, which keeps int8 serving bit-exact
  against the JAX step."""
  cp = engine.plan.classes[key]
  if cp.combiner is None:
    raise ValueError("combiner=None requires hotness-1 inputs in the "
                     "distributed path (2-D model-parallel outputs)")
  w = meta.width
  q = qrows[..., :w]
  if meta.quantize == "fp8":
    q = q.contiguous().view(torch.float8_e4m3fn).to(torch.float32)
  scale = qrows[..., w:w + INT8_SCALE_LANES].contiguous().view(torch.float32)
  acc = q[:, :, 0].to(torch.float32) * scale[:, :, 0]
  for j in range(1, q.shape[2]):
    acc = (q[:, :, j].to(torch.float64) * scale[:, :, j].to(torch.float64)
           + acc.to(torch.float64)).to(torch.float32)
  if cp.combiner == "mean" and not rs:
    sentinel = padded_rows(engine.plan, key)
    counts = (oids < sentinel).sum(dim=2).to(acc.dtype)
    acc = acc / counts.clamp(min=1)[..., None]
  return acc


def _serve_lookup(engine: DistributedLookup,
                  serve_params: Dict[str, torch.Tensor],
                  layouts: Dict[str, PackedLayout],
                  meta: Dict[str, ServeClassMeta],
                  ids_gather: Dict[tuple, Any],
                  ids_order: Dict[tuple, Any]) -> Dict[tuple, torch.Tensor]:
  """mp-side lookup over the inference images: per sparse bucket, gather
  + dequant + combine -> ``[n_b, G, w]``."""
  z: Dict[tuple, torch.Tensor] = {}
  for bk, ids in ids_gather.items():
    key = bk.class_key
    if engine.plan.classes[key].kind != "sparse":
      continue
    name = class_param_name(*key)
    m = meta[name]
    buf = engine._squeeze_local(serve_params[name])
    if isinstance(ids, DedupRouted):
      # one row per unique id; the requesting rank expands and combines
      # them in the exchange (engine.exchange)
      z[bk] = _dequant_rows(
          _gather_image(layouts[name], buf, ids.uniq, m), m)
      continue
    if isinstance(ids, tuple):  # ragged value stream (vals, lens)
      vals, lens = ids
      rows = _dequant_rows(_gather_image(layouts[name], buf, vals, m), m)
      ovals, _ = ids_order[bk]
      z[bk] = engine._combine_ragged(rows, ovals, lens, key, bk.rs)
      continue
    raw = _gather_image(layouts[name], buf, ids, m)
    oids = ids_order[bk]
    multi_hot = oids.dim() == 3 and oids.shape[-1] > 1
    if m.quantize in ("int8", "fp8") and multi_hot:
      z[bk] = _combine_quantized(engine, key, raw, oids, m, bk.rs)
    elif m.quantize == "f32" and m.combine_rpp > 1 and multi_hot:
      z[bk] = _combine_masked_order(engine, key, raw, oids, m.combine_rpp,
                                    bk.rs)
    else:
      z[bk] = engine._combine(_dequant_rows(raw, m), oids, key, bk.rs)
  return z


def make_serve_step(model, plan, serve_meta: Dict[str, ServeClassMeta],
                    mesh=None):
  """Build the serve step over a frozen-table state.

  Returns ``step(state, numerical, cats) -> preds`` with ``state`` the
  ``{'dense', 'emb_dense', 'serve'}`` dict of :func:`frozen_device_state`
  and the request already on the device (:func:`shard_batch`). ``model``
  is called as ``model(numerical, cats, emb_acts=acts)``. With a world-N
  plan every rank calls the step with its ``mesh``, its state and its
  slice of the global request, and gets its slice's predictions.

  Plans the serve step cannot serve faithfully are refused here, as in
  the JAX package: a capped dedup capacity, and the 'error' and
  'allocate' OOV policies."""
  if getattr(plan, "dedup_capacity", None) is not None:
    raise ValueError(
        "plan.dedup_capacity is not servable: a capacity below the safe "
        "bound aliases distinct ids onto the cap's last slot — those "
        "predictions read the WRONG rows — and the serve step carries no "
        "metrics path to count it. Serve an uncapped plan (the artifact "
        "is the same), or use make_sparse_eval_step(with_metrics=True).")
  if getattr(plan, "oov", "clip") == "error":
    raise ValueError(
        "plan.oov='error' is not servable: enforcement rides the guarded "
        "train step's metrics + commit gate, and the serve step carries "
        "neither. Serve with oov='clip' (the routing clamp is identical).")
  if getattr(plan, "oov", "clip") == "allocate":
    raise ValueError(
        "plan.oov='allocate' is not servable: allocation MUTATES the id "
        "space, and an inference path must never mutate it. Serve with "
        "oov='clip' (same tables, same frozen image) and translate request "
        "ids read-only host-side.")
  if plan.world_size > 1 and mesh is None:
    raise ValueError(f"a world-{plan.world_size} plan is served by every "
                     "rank with its mesh (parallel.mesh.create_mesh)")
  engine = DistributedLookup(plan, mesh=mesh)
  layouts = {n: m.packed for n, m in serve_meta.items()}

  @torch.inference_mode()
  def local_serve(state, numerical, cats):
    cats = list(cats)
    b = numerical.shape[0]
    hotness = [ragged_hotness(c) for c in cats]
    hotness_of = lambda i: hotness[i]  # noqa: E731
    ids_all = engine.route_ids(cats, hotness_of)
    counts = engine.mean_counts(cats)
    z = _serve_lookup(engine, state["serve"], layouts, serve_meta, ids_all,
                      ids_all)
    acts = engine.finish_forward(z, state["emb_dense"], ids_all, b,
                                 hotness_of, counts)
    return model(numerical, cats, emb_acts=acts)

  return local_serve


class ServeEngine:
  """Frozen tables in, predictions out.

  ``artifact`` is a :class:`~.export.FrozenTables` (:func:`~.export.
  freeze`) or a :class:`~.export.ServeArtifact` (:func:`~.export.load`,
  already on its device). The engine places the state on ``device``
  (``"cuda"`` unless the caller asks for the CPU; with a world-N ``mesh``
  the mesh's device and this rank's blocks), loads the model's dense
  parameters from it, and answers requests: :meth:`dispatch` returns the
  device predictions without waiting for them, :meth:`predict` returns
  numpy. At world N every rank calls them with the same global
  request."""

  def __init__(self, model, plan, artifact, device="cuda", mesh=None):
    self.mesh = mesh if plan.world_size > 1 else None
    self.device = (self.mesh.device if self.mesh is not None
                   else resolve_device(device))
    if isinstance(artifact, FrozenTables):
      state = frozen_device_state(artifact, plan, device, mesh)
    elif isinstance(artifact, ServeArtifact):
      rank = None if self.mesh is None else self.mesh.rank
      if artifact.rank != rank:
        raise ValueError(f"the artifact holds rank {artifact.rank}'s "
                         f"blocks, this engine serves rank {rank}'s")
      state = {part: {k: v.to(self.device) for k, v in tree.items()}
               for part, tree in artifact.state.items()}
    else:
      raise TypeError(
          f"artifact must be a FrozenTables (export.freeze) or "
          f"ServeArtifact (export.load), got {type(artifact)!r}")
    self.plan = plan
    self.meta = artifact.meta
    self.quantize = artifact.quantize
    self.step = int(artifact.step)
    self.state = state
    model.to(self.device)
    if self.state["dense"]:
      model.load_state_dict(self.state["dense"])
    model.eval()
    self.model = model
    self._step = make_serve_step(model, plan, self.meta, self.mesh)

  @torch.inference_mode()
  def dispatch(self, numerical, cats) -> torch.Tensor:
    """One serve step on a global request; returns the global device
    predictions ``[B]`` (not synchronized; at world N gathered from every
    rank's slice, on every rank)."""
    numerical, cats = shard_batch((numerical, tuple(cats)), self.mesh,
                                  self.device)
    preds = self._step(self.state, numerical, cats)
    if self.mesh is not None:
      preds = wire.gather_blocks(preds, self.mesh)
    return preds

  def predict(self, numerical, cats) -> np.ndarray:
    """Blocking convenience wrapper: numpy predictions."""
    return self.dispatch(numerical, cats).cpu().numpy()
