"""Tiered state construction and the host-side training loop (PyTorch
port of ``tiering/train.py``).

:func:`init_tiered_state` is ``training.init_sparse_state_direct`` with a
third placement kind: host-tier classes draw their FULL packed image in
host RAM (:class:`~.store.HostTierStore`) and put only the compact hot
cache + staging buffer on the device; device-tier sparse classes and
dense classes are drawn as there.

:class:`TieredTrainer` owns the per-step protocol around
``training.make_tiered_train_step``::

    classify (host) -> stage (host gather + upload) -> device step
    -> write back (staging region -> host image) -> periodic re-rank

:meth:`TieredTrainer.run` classifies the NEXT batch while the device
computes (the step's kernels are queued asynchronously; the classify
needs only the resident map, not the step's results). The stage gather
waits for the previous write-back (a row staged twice in a row needs its
updated value), so the look-ahead is one classify. On a re-rank step the
look-ahead classify is deferred until after the re-rank: classifying
against a resident map the re-rank is about to replace could mark a
just-evicted row hot and drop its update.

At world N every process builds the trainer with its mesh and a store
that owns its rank (``HostTierStore(tplan, owned_ranks=(mesh.rank,))``),
and feeds it the same GLOBAL host batches: each process classifies every
rank's ids (the bookkeeping is replicated) and steps on its own slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.packed_table import SparseRule
from ..parallel import wire
from ..parallel.lookup_engine import DistributedLookup, class_param_name
from ..telemetry import get_registry as _registry, span as _span
from ..training import (
    OptimizerFactory,
    _drawn_tables,
    _leaf,
    _packed_tables,
    _state_device,
    _with_optimizers,
    make_tiered_train_step,
    shard_batch,
)
from .plan import TieringPlan
from .prefetch import TieredPrefetcher
from .store import HostTierStore


def _check_store(tplan: TieringPlan, store: HostTierStore, mesh) -> None:
  """A world-N process's store owns exactly its mesh rank."""
  if store.tplan is not tplan and store.tplan.geometry() != tplan.geometry():
    raise ValueError("the store was built for another TieringPlan")
  if mesh is not None and tplan.plan.world_size > 1 \
      and store.owned_ranks != (mesh.rank,):
    raise ValueError(
        f"rank {mesh.rank}'s store owns ranks {store.owned_ranks}: at "
        "world N each process's HostTierStore owns its own rank "
        "(owned_ranks=(mesh.rank,))")


def init_tiered_state(tplan: TieringPlan, store: HostTierStore,
                      rule: SparseRule, dense_params: Dict[str, Any],
                      dense_optimizer: OptimizerFactory,
                      generator: torch.Generator,
                      emb_dense_optimizer: Optional[OptimizerFactory] = None,
                      mesh=None, image_seed: Optional[int] = 0,
                      image_device=None, device="cuda",
                      dtype=torch.float32) -> Dict[str, Any]:
  """Build the fused train state of a tiered plan.

  Host-tier classes: the full packed image is drawn (or kept, see
  ``image_seed``) in ``store``'s host RAM, and the device gets the compact
  ``[cache + staging]`` buffer of the resident set
  (:meth:`HostTierStore.build_fused`). Device-tier sparse classes and
  dense classes are drawn as ``init_sparse_state_direct`` draws them,
  from ``generator`` (on the state's device).

  Args:
    image_seed: seed of the host images (``HostTierStore.init_uniform``);
      ``None`` keeps the store's current images (installed with
      ``set_image``).
    image_device: where the images are drawn: None draws with numpy (the
      JAX package's draw, bit for bit), ``"cuda"`` on the card chunk by
      chunk (the same distribution, at copy speed).
    device: the state's device without a mesh (with one: the mesh's).
  """
  _check_store(tplan, store, mesh)
  dev = _state_device(device, mesh)
  if image_seed is not None:
    store.init_uniform(image_seed, device=image_device)
  fused, emb_dense = _drawn_tables(tplan.plan, rule, generator, dev, mesh,
                                   dtype, skip=frozenset(tplan.tier_specs))
  fused.update(store.build_fused(mesh, dev))
  dense = {k: _leaf(v, dev) for k, v in dense_params.items()}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def init_tiered_state_from_params(tplan: TieringPlan, store: HostTierStore,
                                  rule: SparseRule, params: Dict[str, Any],
                                  dense_optimizer: OptimizerFactory,
                                  emb_dense_optimizer: Optional[
                                      OptimizerFactory] = None,
                                  mesh=None,
                                  emb_collection: str = "embeddings",
                                  device="cuda") -> Dict[str, Any]:
  """Build the tiered train state from simple-layout params
  (``training.init_sparse_state``'s tiered counterpart).

  ``params[emb_collection]`` maps every class name to its ``[world * rows,
  width]`` table. Host-tier classes are packed on the HOST into the
  store's images (this process's ranks), with ``rule``'s initial state
  lanes; the compact device buffers are then gathered from the resident
  set. Mainly for parity tests and for moving an existing run onto
  tiering."""
  _check_store(tplan, store, mesh)
  dev = _state_device(device, mesh)
  plan = tplan.plan
  tables = params[emb_collection]
  for name in tplan.tier_specs:
    lay = tplan.by_name(name).layout_logical
    arr = torch.as_tensor(np.asarray(tables[name]), dtype=torch.float32)
    for rank in store.local_ranks(mesh):
      block = arr[rank * lay.rows:(rank + 1) * lay.rows]
      aux = [torch.full((lay.rows, lay.width), float(v)) for v in
             rule.aux_init]
      store.set_image(name, rank, lay.pack(block, aux).numpy())
  fused, emb_dense = _packed_tables(plan, tables, rule, dev, mesh,
                                    skip=frozenset(tplan.tier_specs))
  fused.update(store.build_fused(mesh, dev))
  dense = {k: _leaf(v, dev) for k, v in params.items()
           if k != emb_collection}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def init_tiered_state_from_fused(tplan: TieringPlan, store: HostTierStore,
                                 state: Dict[str, Any], mesh=None
                                 ) -> Dict[str, Any]:
  """Move a packed train state (``training.init_sparse_state_direct``'s,
  its host-tier classes held whole on the device) onto tiering: each
  host-tier class buffer becomes this process's images in ``store`` (the
  same packed layout) and is replaced by its compact buffer of the
  resident set. Returns a new state dict that shares every other tensor
  and the optimizers with ``state``; the full buffers are dropped from
  it. For parity runs against the all-device step, and for moving an
  existing run onto tiering."""
  _check_store(tplan, store, mesh)
  fused = dict(state["fused"])
  ranks = store.local_ranks(mesh)
  dev = None
  for name in tplan.tier_specs:
    lay = tplan.by_name(name).layout_logical
    buf = fused.pop(name)
    dev = buf.device
    if tuple(buf.shape) != (len(ranks) * lay.phys_rows, lay.phys_width):
      raise ValueError(
          f"class {name}: a buffer of shape {tuple(buf.shape)}, not the "
          f"{len(ranks)} rank blocks of {lay.shape}")
    for i, r in enumerate(ranks):
      img = store.images[name][r]
      for p0 in range(0, lay.phys_rows, 1 << 16):
        p1 = min(lay.phys_rows, p0 + (1 << 16))
        img[p0:p1] = buf[i * lay.phys_rows + p0:
                         i * lay.phys_rows + p1].cpu().numpy()
    del buf
  fused.update(store.build_fused(mesh, dev if mesh is None else None))
  return {**state, "fused": fused}


def unpack_tiered_state(tplan: TieringPlan, store: HostTierStore,
                        rule: SparseRule, state: Dict[str, Any],
                        emb_collection: str = "embeddings", mesh=None):
  """Tiered state -> simple-layout params (the checkpoint / get_weights
  view), ``params[emb_collection]`` the global ``[world * rows, width]``
  tables; with a ``mesh`` every rank's blocks are gathered, so every rank
  returns the global view.

  The caller must reconcile first (``TieredTrainer.flush`` /
  ``HostTierStore.flush``): host-tier tables are read from the host
  images, which are authoritative for resident rows only after a flush."""
  plan = tplan.plan
  layouts = DistributedLookup(plan).fused_layouts(rule)

  def whole(t):
    t = t.detach()
    return t if mesh is None or mesh.world == 1 else \
        wire.gather_blocks(t, mesh)

  tables = {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    if name in tplan.tier_specs:
      # unpacked on the HOST: the image may fit no device buffer
      lay = tplan.by_name(name).layout_logical
      blocks = [torch.from_numpy(np.ascontiguousarray(
          lay.unpack(store.images[name][r])[0]))
          for r in store.local_ranks(mesh)]
      local = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
      if mesh is not None and mesh.world > 1:
        local = whole(local.to(mesh.device)).cpu()
      tables[name] = local
    elif plan.classes[key].kind == "sparse":
      layout = layouts[name]
      buf = whole(state["fused"][name])
      tables[name] = torch.cat([
          layout.unpack(buf[r * layout.phys_rows:
                            (r + 1) * layout.phys_rows])[0]
          for r in range(plan.world_size)])
    else:
      tables[name] = whole(state["emb_dense"][name])
  params = {k: v.detach() for k, v in state["dense"].items()}
  params[emb_collection] = tables
  return params


class TieredTrainer:
  """Drives tiered training: prefetch, device step, write-back, re-rank.

  Owns the mutable pieces: the train ``state``, the host
  :class:`HostTierStore`, and the cumulative hit-rate counters
  ``hits[name] = [hot_hits, staged_hits, missed, valid_total]``
  (occurrences over all steps, summed across ranks). A nonzero ``missed``
  raises: an id was neither resident nor staged, its update went to the
  sentinel, and training silently left the all-device semantics.

  ``guard=True`` builds the hardened step: a non-finite batch commits
  nothing (dense parameters, packed buffers AND the host images stay
  bit-identical, the write-back rewriting unchanged rows), and the trainer
  counts the skips (``bad_steps``) and OOV occurrences (``oov_totals``;
  ``plan.oov='error'`` raises host-side with the state untouched).

  With ``dedup_exchange=True`` the counters count UNIQUE ids per (source,
  destination) block rather than occurrences; the ``missed > 0`` contract
  is unchanged.

  ``overlap_host=True`` (the host pass on a worker thread) is not ported
  yet (ROADMAP.md §1 item 11).
  """

  def __init__(self, model, tplan: TieringPlan, store: HostTierStore,
               loss_fn: Callable, dense_optimizer: OptimizerFactory,
               rule: SparseRule, mesh, state: Dict[str, Any],
               emb_dense_optimizer: Optional[OptimizerFactory] = None,
               exact: bool = False, guard: bool = False, telemetry=None,
               overlap_host: bool = False, device="cuda"):
    if overlap_host:
      raise NotImplementedError(
          "overlap_host=True (the tiered host pass on a worker thread, "
          "pipeline.run_tiered_overlapped): not ported yet (ROADMAP.md §1 "
          "item 11, pipeline)")
    _check_store(tplan, store, mesh)
    self.tplan = tplan
    self.store = store
    self.mesh = mesh
    self.device = _state_device(device, mesh)
    self.state = state
    self.guard = guard
    self.overlap_host = overlap_host
    # hit/lookup counters emit here; the prefetcher shares the registry
    self.telemetry = telemetry if telemetry is not None else _registry()
    self.prefetcher = TieredPrefetcher(tplan, store, mesh, self.device,
                                       telemetry=self.telemetry)
    self._step_fn = make_tiered_train_step(
        model, tplan, loss_fn, dense_optimizer, rule, mesh,
        emb_dense_optimizer=emb_dense_optimizer, exact=exact, guard=guard)
    self.hits: Dict[str, np.ndarray] = {
        name: np.zeros((4,), np.int64) for name in tplan.tier_specs}
    self.steps = 0
    self.bad_steps = 0
    self.oov_totals: Dict[str, int] = {}
    self.dedup_overflow_totals: Dict[str, int] = {}

  # ---- metrics -----------------------------------------------------------
  def account_tier(self, tier: Dict[str, Any]) -> None:
    """Accumulate one step's per-class hit counters and enforce the
    ``missed > 0`` prefetch contract (split out so a wrapping
    ``ResilientTrainer(tiered=...)`` can own the guard accounting)."""
    reg = self.telemetry
    for name, m in tier.items():
      m = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m,
                     np.int64)
      self.hits[name] += m
      reg.counter(f"tiered/hits_hot/{name}").inc(int(m[0]))
      reg.counter(f"tiered/hits_staged/{name}").inc(int(m[1]))
      reg.counter(f"tiered/lookups/{name}").inc(int(m[3]))
      if m[2]:
        raise RuntimeError(
            f"class {name}: {int(m[2])} of {int(m[3])} lookups hit neither "
            "the hot cache nor the staging buffer this step — their "
            "updates were dropped at the sentinel. The prefetch contract "
            "is broken (classify ran against a stale resident map?).")

  def _account(self, metrics: Dict[str, Any]) -> None:
    self.account_tier(metrics["tier"] if self.guard else metrics)
    if self.guard:
      self.bad_steps += int(metrics["bad_step"])
      # account FIRST, enforce second: the oov='error' raise leaves the
      # totals covering the rejected batch (which committed nothing)
      counts = {name: int(v) for name, v in metrics["oov"].items()}
      for name, n in counts.items():
        self.oov_totals[name] = self.oov_totals.get(name, 0) + n
      for name, v in metrics.get("dedup_overflow", {}).items():
        n = int(v)
        if n:
          self.dedup_overflow_totals[name] = \
              self.dedup_overflow_totals.get(name, 0) + n
      from ..resilience import guards as _guards
      _guards.check_oov(self.tplan.plan, counts,
                        where="guarded tiered step")
    self.steps += 1

  def hit_rate(self, name: Optional[str] = None) -> float:
    """Hot-tier hit rate (cache hits / valid lookups), cumulative; over
    all tiered classes when ``name`` is None."""
    ms = [self.hits[name]] if name else list(self.hits.values())
    total = sum(int(m[3]) for m in ms)
    return sum(int(m[0]) for m in ms) / total if total else 0.0

  def metrics_summary(self) -> Dict[str, Any]:
    out = {
        "steps": self.steps,
        "hit_rate": self.hit_rate(),
        "per_class": {
            name: {"hot": int(m[0]), "staged": int(m[1]),
                   "missed": int(m[2]), "total": int(m[3]),
                   "hit_rate": int(m[0]) / int(m[3]) if m[3] else 0.0}
            for name, m in self.hits.items()},
        "host_gather_bytes": self.prefetcher.total_host_gather_bytes,
        "spill_steps": self.prefetcher.spill_steps,
        "host_gather_retries": self.prefetcher.host_gather_retries,
    }
    if self.guard:
      out["bad_steps"] = self.bad_steps
      out["oov"] = dict(self.oov_totals)
      if self.dedup_overflow_totals:
        out["dedup_overflow"] = dict(self.dedup_overflow_totals)
    return out

  # ---- stepping ----------------------------------------------------------
  def _dispatch(self, staged, numerical, cats, labels):
    # the device window rides its own track, from dispatch to the first
    # host sync (the write-back's download), so the look-ahead classify
    # shows inside it
    self._dev_span = _span("device/step", track="device").start()
    with _span("tiered/dispatch"):
      batch = shard_batch((numerical, list(cats), labels), self.mesh,
                          device=self.device)
      self.state, staged_out, metrics, loss = self._step_fn(
          self.state, staged.device, *batch)
    return staged_out, metrics, loss

  def _finish(self, staged, staged_out, metrics, account=None):
    """The protocol tail: write-back, accounting, re-rank, in that order
    (the accounting may raise, e.g. oov='error', and must do so with the
    write-back landed but before the re-rank). ``account`` overrides the
    accounting stage for a wrapping trainer."""
    self.prefetcher.write_back(staged, staged_out)  # syncs on the device
    self._dev_span.finish()
    (account or self._account)(metrics)
    self.state["fused"] = self.prefetcher.maybe_rerank(self.state["fused"])

  def step(self, numerical, cats, labels) -> float:
    """One synchronous train step on a GLOBAL host batch."""
    staged = self.prefetcher.prepare(cats)
    staged_out, metrics, loss = self._dispatch(staged, numerical, cats,
                                               labels)
    self._finish(staged, staged_out, metrics)
    return float(loss)

  def run(self, batches: Iterable) -> list:
    """Train over GLOBAL host batches of ``(numerical, cats, labels)``
    with the classify stage one batch ahead of the device step."""
    losses = []
    it = iter(batches)
    nxt = next(it, None)
    cold = None
    interval = self.tplan.config.rerank_interval
    while nxt is not None:
      numerical, cats, labels = nxt
      if cold is None:
        cold = self.prefetcher.classify(cats)
      staged = self.prefetcher.stage(cold)
      staged_out, metrics, loss = self._dispatch(staged, numerical, cats,
                                                 labels)
      nxt = next(it, None)
      # look-ahead classify while the device computes, except on a
      # re-rank step (the classify must see the new resident map)
      will_rerank = bool(interval) and (
          self.prefetcher.steps_since_rerank + 1 >= interval)
      cold = (self.prefetcher.classify(nxt[1])
              if nxt is not None and not will_rerank else None)
      self._finish(staged, staged_out, metrics)
      losses.append(float(loss))
    return losses

  # ---- reconciliation ----------------------------------------------------
  def flush(self) -> None:
    """Reconcile resident rows' device values into the host images (call
    before a checkpoint or a global weight view)."""
    self.store.flush(self.state["fused"])
