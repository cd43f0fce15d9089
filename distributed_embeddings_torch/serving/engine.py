"""The serve step + engine: inference on frozen tables (PyTorch port).

Counterpart of ``distributed_embeddings_tpu/serving/engine.py`` for the
all-device, world-1 path. A serve step is route -> gather (with the int8
dequant fused in) -> combine -> dense classes -> exchange -> assemble ->
model forward, with no scatter and no optimizer state:

- **f32 serving is bit-exact** against the JAX serve step on the same
  frozen image (same gathered values, and the multi-hot combine keeps the
  JAX summation order, including :func:`_combine_masked_order`);
- **int8 rows dequantize on gather** with one multiply against the row's
  bit-packed scale, the same single multiply as the JAX step.

Not ported yet: world > 1, tiered serving, deduplicated routing, ragged
value streams, the micro-batcher.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.packed_table import PackedLayout, gather_fused_chunked
from ..parallel.lookup_engine import (
    DistributedLookup,
    class_param_name,
    padded_rows,
    ragged_hotness,
)
from .export import (
    INT8_SCALE_LANES,
    FrozenTables,
    ServeClassMeta,
    dequantize_rows_int8,
    frozen_device_state,
)


def shard_batch(batch, mesh=None, device="cuda"):
  """Place a host request on the device (``mesh=None`` only: one device).
  Nested tuples/lists keep their structure; arrays become tensors."""
  if mesh is not None:
    raise NotImplementedError("sharded batches (mesh) are not ported yet")
  dev = resolve_device(device)

  def put(x):
    if isinstance(x, (tuple, list)):
      return type(x)(put(v) for v in x)
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=dev)

  return put(batch)


def _dequant_rows(rows: torch.Tensor, meta: ServeClassMeta) -> torch.Tensor:
  """Gathered serve rows -> f32 table rows. int8 rows arrive ``[...,
  width + 4]``: the trailing 4 byte lanes are the row's f32 scale, and the
  dequant is one widen + multiply. Sentinel rows are all-zero bytes, whose
  scale decodes to 0.0, so they stay exactly zero."""
  if meta.quantize == "f32":
    return rows
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


def _combine_int8(engine: DistributedLookup, key, qrows: torch.Tensor,
                  oids: torch.Tensor, meta: ServeClassMeta,
                  rs: bool) -> torch.Tensor:
  """Multi-hot combine of int8 rows ``[n_b, G, h, w + 4]`` with the dequant
  fused in, in the JAX serve step's arithmetic.

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
    if not isinstance(ids, torch.Tensor):
      raise NotImplementedError(
          f"routed ids of type {type(ids).__name__}: deduplicated and "
          "ragged routing are not ported yet")
    name = class_param_name(*key)
    m = meta[name]
    buf = engine._squeeze_local(serve_params[name])
    raw = gather_fused_chunked(layouts[name], buf, ids)
    oids = ids_order[bk]
    multi_hot = oids.dim() == 3 and oids.shape[-1] > 1
    if m.quantize == "int8" and multi_hot:
      z[bk] = _combine_int8(engine, key, raw, oids, m, bk.rs)
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
  is called as ``model(numerical, cats, emb_acts=acts)``.

  Plans the serve step cannot serve faithfully are refused here, as in
  the JAX package: a capped dedup capacity, and the 'error' and
  'allocate' OOV policies."""
  if getattr(plan, "dedup_capacity", None) is not None:
    raise ValueError(
        "plan.dedup_capacity is not servable: a capacity below the safe "
        "bound aliases distinct ids onto the cap's last slot — those "
        "predictions read the WRONG rows — and the serve step carries no "
        "metrics path to count it. Serve an uncapped plan (the artifact "
        "is the same).")
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
  if mesh is not None or plan.world_size != 1:
    raise NotImplementedError(
        "the port serves world-1 plans on one device so far (mesh=None)")
  engine = DistributedLookup(plan)
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
  """Frozen tables in, predictions out (one device, world 1).

  Places the frozen state on ``device`` (``"cuda"`` unless the caller asks
  for the CPU), loads the model's dense parameters from it when the
  frozen state carries them, and answers requests: :meth:`dispatch`
  returns the device predictions without waiting for them, :meth:`predict`
  returns numpy."""

  def __init__(self, model, plan, artifact: FrozenTables, device="cuda",
               mesh=None):
    if not isinstance(artifact, FrozenTables):
      raise TypeError(
          f"artifact must be a FrozenTables (export.freeze), got "
          f"{type(artifact)!r}; loading artifacts from disk is not ported "
          "yet")
    if mesh is not None:
      raise NotImplementedError("mesh serving is not ported yet")
    self.device = resolve_device(device)
    self.plan = plan
    self.meta = artifact.meta
    self.quantize = artifact.quantize
    self.step = int(artifact.step)
    self.state = frozen_device_state(artifact, plan, self.device)
    model.to(self.device)
    if self.state["dense"]:
      model.load_state_dict(self.state["dense"])
    model.eval()
    self.model = model
    self._step = make_serve_step(model, plan, self.meta, mesh)

  def dispatch(self, numerical, cats) -> torch.Tensor:
    """One serve step; returns the device predictions (not synchronized)."""
    numerical, cats = shard_batch((numerical, tuple(cats)), None, self.device)
    return self._step(self.state, numerical, cats)

  def predict(self, numerical, cats) -> np.ndarray:
    """Blocking convenience wrapper: numpy predictions."""
    return self.dispatch(numerical, cats).cpu().numpy()
