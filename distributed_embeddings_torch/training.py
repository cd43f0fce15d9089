"""The fused sparse train step (PyTorch port of ``training.py``).

Embedding tables live in the lane-packed fused layout
(``ops/packed_table.py``) with the sparse rule's optimizer state
interleaved; the forward gather brings the state along and the whole
backward + update of a sparse class is ONE scatter-add (kernel K1 on the
card). Small-vocab tables ride the dense classes with dense gradients and
a ``torch.optim`` optimizer, as do the model's dense parameters.

One step (:func:`make_sparse_train_step`):

1. route the ids; at world > 1 exchange them to the ranks that own the
   tables (dp -> mp);
2. fused gather per sparse class, outside autograd (per exchange round
   under ``overlap='fused'``, kernel K4 on the card);
3. the differentiable tail — dense-class lookups, the mp -> dp exchange,
   assembly, the model, the loss — on leaves that require grad: the dense
   parameters, the dense-class tables and the sparse activations ``z``.
   One ``loss.backward()`` gives the three gradients of the JAX step's
   ``value_and_grad``; the exchange's backward brings each rank the
   cotangents of the rows it owns;
4. at world > 1 the replicated dense gradients are summed over the ranks
   (``all_reduce``) and every gradient scaled by ``1 / world`` (the
   global batch mean); then the ``torch.optim`` steps on the dense
   parameters and tables, and the sparse apply under ``no_grad``, in
   place on the packed buffers.

At world > 1 every rank runs the same step in its own process with its
:class:`~.parallel.mesh.Mesh`: its slice of the batch (:func:`shard_batch`),
the replicated dense parameters, and its rank's block of every class
(``[rows, width]`` of the JAX package's ``[world * rows, width]``).

The state is a dict ``{'dense', 'dense_opt', 'emb_dense', 'emb_dense_opt',
'fused', 'step'}``; the step updates it in place (the JAX step donates
its state) and returns ``(state, loss)``, the loss averaged over the
ranks. ``dense_optimizer`` is a factory ``params ->
torch.optim.Optimizer`` (``functools.partial(torch.optim.SGD, lr=...)``
for ``optax.sgd``, ``functools.partial(Adagrad, lr=...)`` for
``optax.adagrad``).

The synthetic zoo (``models/synthetic.py``) trains through the same
step: narrow multi-hot classes with optimizer state (Adagrad on Tiny)
take the masked physical-row gather, and their update rows come from
kernel K6 (``ops/cuda_delta.py``) on the card.

Not ported yet: ``micro_batches > 1``, the non-finite guard, the tiered
step, dense-class regularizers and constraints, and ``make_train_step``
(the dense autodiff path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from .device import resolve_device
from .layers.planner import DistEmbeddingStrategy
from .ops.packed_table import SparseRule, init_packed_uniform
from .parallel import wire
from .parallel.lookup_engine import (
    DistributedLookup,
    FusedChunks,
    class_param_name,
    padded_rows,
    ragged_hotness,
)

OptimizerFactory = Callable[[list], torch.optim.Optimizer]

# the Keras default of the named uniform initializers (the JAX package's
# ``layers/embedding.py:_keras_uniform``)
_KERAS_UNIFORM_SCALE = 0.05


class Adagrad(torch.optim.Optimizer):
  """``optax.adagrad(lr, initial_accumulator_value, eps)`` as a
  ``torch.optim`` optimizer, for the dense parameters and dense-class
  tables: ``acc += g²``; ``p += -lr · (rsqrt(acc + eps) · g)`` where ``acc
  > 0``. (``torch.optim.Adagrad`` divides by ``sqrt(acc) + eps`` instead,
  another function.) Parameters without a gradient are left as they are,
  which is what optax's update does for a zero gradient."""

  def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
               eps: float = 1e-7):
    super().__init__(params, {"lr": lr, "eps": eps,
                              "initial_accumulator_value":
                                  initial_accumulator_value})

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    for group in self.param_groups:
      for p in group["params"]:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state["sum"] = torch.full_like(
              p, group["initial_accumulator_value"],
              memory_format=torch.preserve_format)
        acc = state["sum"]
        g = p.grad
        acc.add_(g * g)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros_like(acc))
        p.add_((inv * g) * -group["lr"])
    return loss


def _leaf(x, device) -> torch.Tensor:
  """A fresh f32 leaf on ``device`` that requires grad (never a view of
  the caller's tensor: the step updates it in place)."""
  t = torch.as_tensor(x).detach().to(device=device, dtype=torch.float32)
  return t.clone().requires_grad_(True)


def _with_optimizers(state: Dict[str, Any], dense_optimizer: OptimizerFactory,
                     emb_dense_optimizer: Optional[OptimizerFactory]):
  """Bind the optimizers to the state's dense tensors where the state has
  none yet (a state carried across by ``convert.train_state_from_flax``);
  the dense tensors become leaves that require grad."""
  for part in ("dense", "emb_dense"):
    for name, t in state[part].items():
      if not (t.is_leaf and t.requires_grad):
        state[part][name] = t.detach().requires_grad_(True)
  if state.get("dense_opt") is None:
    state["dense_opt"] = (dense_optimizer(list(state["dense"].values()))
                          if state["dense"] else None)
  if state.get("emb_dense_opt") is None:
    opt = emb_dense_optimizer or dense_optimizer
    state["emb_dense_opt"] = (opt(list(state["emb_dense"].values()))
                              if state["emb_dense"] else None)
  state.setdefault("step", 0)
  return state


def init_sparse_state(plan: DistEmbeddingStrategy, params: Dict[str, Any],
                      rule: SparseRule, dense_optimizer: OptimizerFactory,
                      emb_dense_optimizer: Optional[OptimizerFactory] = None,
                      emb_collection: str = "embeddings",
                      device="cuda", mesh=None) -> Dict[str, Any]:
  """Build the fused train state from initialized tables and dense params.

  ``params[emb_collection]`` maps every class name to its simple-layout
  ``[world * rows, width]`` table; the other entries are the model's dense
  parameters (its ``state_dict`` names). Sparse-class tables are packed
  with ``rule``'s optimizer-state rows at their initial values; dense-class
  tables keep the simple layout and get an optimizer. With a ``mesh`` the
  state holds this rank's blocks only, on the mesh's device."""
  dev = _state_device(device, mesh)
  ranks = _state_ranks(plan, mesh)
  engine = DistributedLookup(plan)
  layouts = engine.fused_layouts(rule)
  tables = params[emb_collection]
  dense = {k: _leaf(v, dev) for k, v in params.items()
           if k != emb_collection}
  fused, emb_dense = {}, {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    arr = torch.as_tensor(tables[name]).to(device=dev, dtype=torch.float32)
    rows = arr.shape[0] // plan.world_size
    if plan.classes[key].kind == "sparse":
      layout = layouts[name]
      # every window of every physical row gets the aux fill, the unused
      # windows of the last row too (the JAX package's pack_chunked)
      full = dataclasses.replace(
          layout, rows=layout.phys_rows * layout.rows_per_phys)
      aux = [torch.full((full.rows, layout.width), float(v),
                        dtype=torch.float32, device=dev)
             for v in rule.aux_init]
      block = torch.zeros((full.rows, layout.width), dtype=torch.float32,
                          device=dev)
      blocks = []
      for r in ranks:
        block[:rows] = arr[r * rows:(r + 1) * rows]
        blocks.append(full.pack(block, aux))
      fused[name] = torch.cat(blocks)
    else:
      emb_dense[name] = _leaf(torch.cat([arr[r * rows:(r + 1) * rows]
                                         for r in ranks]), dev)
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def _state_device(device, mesh) -> torch.device:
  """The state's device: the mesh's, else ``device`` as asked."""
  return mesh.device if mesh is not None else resolve_device(device)


def _state_ranks(plan: DistEmbeddingStrategy, mesh) -> range:
  """The rank blocks a state holds: the mesh's rank, else all of them."""
  if mesh is None:
    return range(plan.world_size)
  _check_mesh(plan, mesh)
  return range(mesh.rank, mesh.rank + 1)


def _uniform_scale(initializer) -> float:
  """The bound of a uniform(-scale, scale) table initializer: the named
  Keras uniforms (0.05) or any object carrying ``.scale``."""
  if initializer is None or (isinstance(initializer, str) and
                             initializer.lower() in ("uniform",
                                                     "random_uniform")):
    return _KERAS_UNIFORM_SCALE
  scale = getattr(initializer, "scale", None)
  if scale is None:
    raise NotImplementedError(
        f"initializer {initializer!r} has no uniform .scale; pack an "
        "explicitly initialized table instead (init_sparse_state)")
  return float(scale)


def init_scale_rows(plan: DistEmbeddingStrategy, key,
                    rank: int = 0) -> torch.Tensor:
  """Per logical row of one rank's class block, the uniform init bound of
  the table the row belongs to (0 on padding rows)."""
  cp = plan.classes[key]
  scale = torch.zeros((padded_rows(plan, key),), dtype=torch.float32)
  for sh, off in zip(cp.shards_per_rank[rank], cp.row_offsets_per_rank[rank]):
    scale[off:off + sh.input_dim] = _uniform_scale(sh.initializer)
  return scale


def init_sparse_state_direct(plan: DistEmbeddingStrategy, rule: SparseRule,
                             dense_params: Dict[str, Any],
                             dense_optimizer: OptimizerFactory,
                             generator: torch.Generator,
                             emb_dense_optimizer: Optional[
                                 OptimizerFactory] = None,
                             device="cuda", mesh=None) -> Dict[str, Any]:
  """Build the fused train state without materializing simple-layout
  tables: every sparse class is drawn straight into its packed layout
  (``init_packed_uniform``: peak memory is the buffer plus one chunk),
  every dense class row by row. Each table's rows are uniform in +-its
  initializer's bound; padding rows are zero. ``generator`` lives on the
  state's device; the draws match the JAX package's distribution, not its
  bits. With a ``mesh`` only this rank's blocks are drawn, on the mesh's
  device (seed the generator per rank); ``dense_params`` must be the same
  on every rank."""
  dev = _state_device(device, mesh)
  engine = DistributedLookup(plan)
  layouts = engine.fused_layouts(rule)
  fused, emb_dense = {}, {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    cp = plan.classes[key]
    blocks = []
    for r in _state_ranks(plan, mesh):
      scale = init_scale_rows(plan, key, r).to(dev)
      if cp.kind == "sparse":
        blocks.append(init_packed_uniform(layouts[name], generator, scale,
                                          rule.aux_init, device=dev))
      else:
        table = torch.rand((scale.shape[0], cp.width), generator=generator,
                           device=dev)
        blocks.append(table.mul_(2.0).sub_(1.0).mul_(scale[:, None]))
    block = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    if cp.kind == "sparse":
      fused[name] = block
    else:
      emb_dense[name] = block.requires_grad_(True)
  dense = {k: _leaf(v, dev) for k, v in dense_params.items()}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def unpack_sparse_state(plan: DistEmbeddingStrategy, rule: SparseRule,
                        state: Dict[str, Any],
                        emb_collection: str = "embeddings",
                        include_aux: bool = False, mesh=None):
  """Fused state -> ``(params, aux)`` in the simple layout:
  ``params[emb_collection]`` holds every class table as ``[world * rows,
  width]``, the other entries the dense parameters; with ``include_aux``,
  ``aux`` maps sparse class names to their optimizer-state tables. With a
  ``mesh`` (a state of rank blocks) every rank's blocks are gathered
  first, so every rank returns the global view."""
  layouts = DistributedLookup(plan).fused_layouts(rule)

  def whole(t):
    t = t.detach()
    return t if mesh is None else wire.gather_blocks(t, mesh)

  tables, aux_out = {}, {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    if plan.classes[key].kind != "sparse":
      tables[name] = whole(state["emb_dense"][name])
      continue
    layout = layouts[name]
    buf = whole(state["fused"][name])
    blocks = [layout.unpack(buf[r * layout.phys_rows:
                                (r + 1) * layout.phys_rows])
              for r in range(plan.world_size)]
    tables[name] = torch.cat([t for t, _ in blocks])
    if include_aux:
      aux_out[name] = tuple(torch.cat([a[j] for _, a in blocks])
                            for j in range(rule.n_aux))
  params = {k: v.detach() for k, v in state["dense"].items()}
  params[emb_collection] = tables
  return params, aux_out


def _fused_rule_and_penalties(plan: DistEmbeddingStrategy,
                              rule: SparseRule) -> SparseRule:
  """Validate regularizers and constraints for the fused path; returns the
  rule with a uniform sparse-table l2 folded in as ``weight_decay`` (decay
  on touched rows, per occurrence).

  Sparse tables with a constraint, a penalty other than pure l2, or
  unequal l2 factors raise, as in the JAX package. Dense-class tables
  with a regularizer or constraint raise too: the exact full-table
  penalty and projection of the JAX package (``plan_regularizer_fn``,
  ``plan_constraint_fn``) are not ported yet."""
  table_kind = {sh.table_id: plan._kind_of(sh)
                for shards in plan.rank_shards for sh in shards}
  lam = None
  for t, c in enumerate(plan.global_configs):
    if table_kind.get(t) != "sparse":
      if c.regularizer is not None or c.constraint is not None:
        raise NotImplementedError(
            f"table {t} is a dense-class table with a regularizer or "
            "constraint: the full-table penalty and projection are not "
            "ported yet")
      continue
    if c.constraint is not None:
      raise NotImplementedError(
          f"table {t} has an embeddings_constraint on the fused sparse "
          "path: per-occurrence deltas never materialize whole tables, so "
          "a full-table projection cannot be honored here")
    if c.regularizer is None:
      continue
    f = _l2_decay_factor(c.regularizer)
    if f is None:
      raise NotImplementedError(
          f"table {t}'s regularizer {c.regularizer!r} is not a pure l2: "
          "the fused sparse path folds only l2 decay into its "
          "per-occurrence deltas ('l2' or {'name': 'l2', 'factor': λ})")
    if lam is None:
      lam = f
    elif lam != f:
      raise NotImplementedError(
          f"sparse tables carry different l2 factors ({lam} vs {f} on "
          f"table {t}): the fused delta applies one uniform decay per rule")
  if lam:
    rule = dataclasses.replace(rule, weight_decay=float(lam))
  return rule


def _l2_decay_factor(spec) -> Optional[float]:
  """λ when ``spec`` is a pure-l2 regularizer spec, else None (the JAX
  package's ``layers/embedding.py:l2_decay_factor``)."""
  if isinstance(spec, str) and spec.lower() == "l2":
    return 0.01  # keras.regularizers.l2 default
  if isinstance(spec, dict):
    d = {str(k).lower(): v for k, v in spec.items()}
    if str(d.get("name", "")).lower() == "l2":
      return float(d.get("factor", d.get("l2", 0.01)))
  return None


def _reduce_and_apply_dense(state: Dict[str, Any], d_z, loss, mesh=None):
  """The dense tail of the step: cross-rank reduction, then the optimizer
  steps on the dense parameters and the dense-class tables (their
  gradients are in ``.grad`` after the backward), then the gradients are
  dropped. Returns ``(d_z, loss)`` for the sparse apply.

  At world > 1 the replicated dense parameters' gradients are summed over
  the ranks (one ``all_reduce`` of them flattened together) and every
  gradient — dense, dense-class, ``d_z`` — is scaled by ``1 / world``,
  which restores the global batch mean; the loss is averaged over the
  ranks. The dense-class tables are per-rank windows and are never
  summed."""
  if mesh is not None and mesh.world > 1:
    dense = list(state["dense"].values())
    for p in dense:
      if p.grad is None:
        p.grad = torch.zeros_like(p)
    if dense:
      flat = torch.cat([p.grad.reshape(-1) for p in dense])
      dist.all_reduce(flat)
      off = 0
      for p in dense:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n
    scale = 1.0 / mesh.world
    for p in dense + list(state["emb_dense"].values()):
      if p.grad is not None:
        p.grad.mul_(scale)
    d_z = {bk: (g.map(lambda c: c * scale) if isinstance(g, FusedChunks)
                else g * scale) for bk, g in d_z.items()}
    loss = loss.clone()
    dist.all_reduce(loss)
    loss = loss / mesh.world
  for opt_name in ("dense_opt", "emb_dense_opt"):
    opt = state[opt_name]
    if opt is not None:
      opt.step()
      opt.zero_grad(set_to_none=True)
  return d_z, loss


def _check_mesh(plan, mesh) -> None:
  """A world-N plan runs on an N-rank mesh; a world-1 plan needs none."""
  if plan.world_size > 1 and mesh is None:
    raise ValueError(
        f"a world-{plan.world_size} plan needs this rank's mesh "
        "(parallel.mesh.create_mesh)")
  if mesh is not None and mesh.world != plan.world_size:
    raise ValueError(f"the mesh has {mesh.world} ranks, the plan "
                     f"{plan.world_size}")


def _refuse_unported(plan, mesh, micro_batches: int, guard: bool) -> None:
  _check_mesh(plan, mesh)
  if micro_batches != 1:
    raise NotImplementedError(
        f"micro_batches={micro_batches}: the micro-batch step is not "
        "ported yet (micro_batches=1 only)")
  if guard:
    raise NotImplementedError(
        "guard=True: the non-finite guard (resilience.guards) is not "
        "ported yet")
  if getattr(plan, "dedup_capacity", None) is not None:
    raise ValueError(
        "plan.dedup_capacity requires the guarded step, which is not "
        "ported yet")
  if getattr(plan, "oov", "clip") in ("error", "allocate"):
    raise ValueError(
        f"plan.oov={plan.oov!r} requires the guarded step, which is not "
        "ported yet; use oov='clip'")


def _leaf_of(z):
  """A sparse activation (or each chunk of a :class:`FusedChunks`) as a
  fresh leaf that requires grad."""
  if isinstance(z, FusedChunks):
    return z.map(_leaf_of)
  return z.detach().requires_grad_(True)


def _grad_of(z):
  if isinstance(z, FusedChunks):
    return z.map(_grad_of)
  return z.grad if z.grad is not None else torch.zeros_like(z)


def make_sparse_train_step(model: torch.nn.Module,
                           plan: DistEmbeddingStrategy,
                           loss_fn: Callable,
                           dense_optimizer: OptimizerFactory,
                           rule: SparseRule,
                           mesh=None,
                           emb_dense_optimizer: Optional[
                               OptimizerFactory] = None,
                           exact: bool = False,
                           micro_batches: int = 1,
                           guard: bool = False):
  """Train step on the fused sparse state.

  Args:
    model: an ``nn.Module`` called as ``model(numerical, cats,
      emb_acts=acts)``; the step runs it with the state's dense tensors in
      place of its own parameters (``torch.func.functional_call``).
    loss_fn: ``loss_fn(logits, labels) -> scalar`` (batch mean).
    dense_optimizer: ``params -> torch.optim.Optimizer``, for the dense
      parameters and, unless ``emb_dense_optimizer`` is given, the
      dense-class tables.
    rule: the sparse :class:`SparseRule`.
    mesh: this rank's :class:`~.parallel.mesh.Mesh` for a world > 1 plan
      (every rank builds and calls the step), None at world 1.
    exact: the reference's deduplicated backward (sort + segment-sum).
    micro_batches, guard: 1 and False only (not ported yet).

  Returns:
    ``step(state, numerical, cats, labels) -> (state, loss)``, with this
    rank's slice of the batch on the state's device (:func:`shard_batch`);
    ``state`` is updated in place and ``loss`` is the mean over the ranks.
  """
  _refuse_unported(plan, mesh, micro_batches, guard)
  rule = _fused_rule_and_penalties(plan, rule)
  engine = DistributedLookup(plan, mesh=mesh)
  layouts = engine.fused_layouts(rule)
  # exact=True re-gathers rows at apply time; a weight decay without aux
  # lanes needs the forward-time rows saved
  keep_rows = bool(rule.weight_decay) and not rule.n_aux and not exact

  def step(state, numerical, cats, labels):
    _with_optimizers(state, dense_optimizer, emb_dense_optimizer)
    cats = list(cats)
    b = numerical.shape[0]
    hotness = [ragged_hotness(c) for c in cats]
    hotness_of = lambda i: hotness[i]  # noqa: E731
    ids_all = engine.route_ids(cats, hotness_of)
    counts = engine.mean_counts(cats)
    with torch.no_grad():
      z_sparse, residuals = engine.lookup_sparse_fused(
          state["fused"], layouts, ids_all, keep_rows=keep_rows,
          keep_aux=not exact)
    z_leaves = {bk: _leaf_of(z) for bk, z in z_sparse.items()}
    acts = engine.finish_forward(z_leaves, state["emb_dense"], ids_all, b,
                                 hotness_of, counts)
    logits = functional_call(model, state["dense"], (numerical, cats),
                             {"emb_acts": acts})
    loss = loss_fn(logits, labels)
    loss.backward()
    d_z = {bk: _grad_of(z) for bk, z in z_leaves.items()}
    d_z, loss = _reduce_and_apply_dense(state, d_z, loss.detach(), mesh)
    with torch.no_grad():
      engine.apply_sparse(state["fused"], layouts, d_z, residuals, rule,
                          state["step"], exact=exact)
    state["step"] += 1
    return state, loss

  return step


def make_sparse_eval_step(model: torch.nn.Module,
                          plan: DistEmbeddingStrategy, rule: SparseRule,
                          mesh=None, with_metrics: bool = False):
  """Forward on the fused state: ``eval(state, numerical, cats) ->
  preds``, this rank's predictions for its slice of the batch (with a
  ``mesh``, every rank calls it; the JAX step's batch-sharded output is
  these slices in rank order). Never writes the state (the JAX eval step
  never donates it). ``with_metrics`` (the OOV counters) is not ported
  yet."""
  _check_mesh(plan, mesh)
  if with_metrics or getattr(plan, "dedup_capacity", None) is not None:
    raise NotImplementedError(
        "with_metrics=True (the OOV and dedup-overflow counters) is not "
        "ported yet")
  if getattr(plan, "oov", "clip") == "allocate":
    raise ValueError("plan.oov='allocate' is not evaluable: allocation "
                     "mutates the id space; evaluate with oov='clip'")
  engine = DistributedLookup(plan, mesh=mesh)
  layouts = engine.fused_layouts(rule)

  @torch.inference_mode()
  def local_eval(state, numerical, cats):
    cats = list(cats)
    b = numerical.shape[0]
    hotness = [ragged_hotness(c) for c in cats]
    hotness_of = lambda i: hotness[i]  # noqa: E731
    ids_all = engine.route_ids(cats, hotness_of)
    counts = engine.mean_counts(cats)
    z_sparse, _ = engine.lookup_sparse_fused(state["fused"], layouts,
                                             ids_all, keep_aux=False)
    acts = engine.finish_forward(z_sparse, state["emb_dense"], ids_all, b,
                                 hotness_of, counts)
    return functional_call(model, state["dense"], (numerical, cats),
                           {"emb_acts": acts})

  return local_eval


def shard_batch(batch, mesh=None, device="cuda"):
  """This rank's slice of a global host batch, on its device.

  Every leaf's leading (batch) axis is cut into ``world`` equal slices
  and rank ``r`` keeps slice ``r`` (the JAX package's ``P(axis)`` batch
  sharding, one process per rank); a global batch the world does not
  divide is refused. Without a mesh the whole batch goes to ``device``.
  Nested tuples and lists keep their structure."""
  dev = _state_device(device, mesh)
  world = 1 if mesh is None else mesh.world

  def put(x):
    if isinstance(x, (tuple, list)):
      return type(x)(put(v) for v in x)
    x = torch.as_tensor(x)
    if world > 1 and x.dim():
      if x.shape[0] % world:
        raise ValueError(f"global batch {x.shape[0]} is not divisible by "
                         f"the world size {world}")
      n = x.shape[0] // world
      x = x[mesh.rank * n:(mesh.rank + 1) * n]
    return x.to(dev)

  return put(batch)
