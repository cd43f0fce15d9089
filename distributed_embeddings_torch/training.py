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

The dense-autodiff step (:func:`make_train_step`, the README's Quick
start and ``examples/dlrm/main.py`` without ``--sparse``) trains a model
that owns its embedding layer (``models.DLRM``): forward through the
layer's differentiable lookup, ``loss.backward()`` (a dense gradient for
every class buffer, the tables' regularizer penalties in the loss), one
``torch.optim`` step over every parameter, then the tables' constraints.
At world > 1 every rank holds its blocks of the classes and the
replicated dense parameters (a model built with the rank's mesh), and
the optimizer is wrapped in ``DistributedOptimizer``: the replicated
gradients are summed over the ranks and every gradient is scaled by
``1 / world`` before the step (``finalize_hybrid_grads``, which the
sparse step's dense tail runs too).

``make_sparse_train_step(micro_batches=N)`` loops the route, gather,
model and backward over N slices of the batch and applies once;
``guard=True`` checks the loss, the gradients and the delta streams
before anything commits and skips a poisoned step bit-exactly
(``resilience.guards``, driven by ``resilience.trainer.ResilientTrainer``).

The tiered step (:func:`make_tiered_train_step`, driven by
``tiering.TieredTrainer``) trains a plan whose host-tier classes keep only
a hot cache plus a staging region on the device: it translates their
routed ids to compact slots, writes the step's staged cold rows into the
staging region, and runs the same gather, backward and one scatter-add
per class on the compact buffers (K1, K4 under ``'fused'``), returning the
updated staging rows for the host write-back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from .device import resolve_device
from .layers.dist_model_parallel import (
    DistributedEmbedding,
    DistributedOptimizer,
    finalize_hybrid_grads,
    is_model_parallel_leaf,
)
from .layers.embedding import (
    l2_decay_factor,
    resolve_constraint,
    resolve_regularizer,
)
from .layers.planner import DistEmbeddingStrategy
from .ops.packed_table import SparseRule, _on, _weak, init_packed_uniform
from .ops.ragged import RaggedIds
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


class ScheduledSGD(torch.optim.SGD):
  """``optax.sgd(schedule[, momentum])`` as a ``torch.optim`` optimizer:
  each :meth:`step` runs at ``lr = schedule(count)`` and then advances
  ``count``, which lives in the optimizer's own state
  (``state["count"]``, 0 before the first step) as optax keeps it in its
  ``ScaleByScheduleState``. A checkpoint therefore carries the count
  itself (``1/count`` in the JAX package's ``dense_opt.npz``), not a
  value inferred from the train step."""

  def __init__(self, params, schedule: Callable[[int], Any],
               momentum: float = 0.0):
    super().__init__(params, lr=float(schedule(0)), momentum=momentum)
    self.schedule = schedule

  @property
  def count(self) -> int:
    return int(self.state.get("count", 0))

  @torch.no_grad()
  def step(self, closure=None):
    count = self.count
    lr = float(self.schedule(count))
    for group in self.param_groups:
      group["lr"] = lr
    loss = super().step(closure)
    self.state["count"] = count + 1
    return loss


class Adam(torch.optim.Optimizer):
  """``optax.adam(lr, b1, b2, eps)`` (``eps_root=0``) as a ``torch.optim``
  optimizer, for the dense parameters and dense-class tables.

  One global ``count`` (``state["count"]``, 0 before the first step, as
  optax's ``ScaleByAdamState.count``): ``mu = (1-b1) g + b1 mu``, ``nu =
  (1-b2) g² + b2 nu``, each bias-corrected by ``1 - b^(count+1)`` (an f32
  power), ``p += -lr · mu_hat / (sqrt(nu_hat) + eps)``; a schedule ``lr``
  is read at ``count``. Unlike :class:`Adagrad`, EVERY parameter steps
  every step: a parameter without a gradient takes a zero one, whose
  step still decays its moments and moves it, as optax's update does.

  The dtypes follow optax's (``mu_dtype=None``) op for op, its Python
  constants weakly typed (rounded on the host to the dtype they meet, so
  a step reads nothing back from the card): the moments start in the
  parameter's dtype and take the dtype of each update. A bf16 parameter
  (the dense-autodiff layer's bf16 sparse-class buffers, bf16 gradients)
  keeps bf16 moments and bf16 arithmetic. A bf16 dense-class table takes
  its f32 gradient, as the JAX step does: the f32 work copy the sparse
  step binds (:func:`trained_tables`), or, for a bf16 parameter of the
  dense-autodiff layer, the ``wide_grad`` its lookup leaves there
  (``lookup_engine.add_wide_grad``: this optimizer marks its narrow
  parameters for it, reads it at :meth:`step` and clears it there and at
  :meth:`zero_grad`, so each step reads the gradient of the backward
  passes since the last one); its moments start as bf16 zeros (optax's
  init on the table) and step in f32."""

  def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps})

  def add_param_group(self, param_group) -> None:
    super().add_param_group(param_group)
    for p in self.param_groups[-1]["params"]:
      if p.dtype != torch.float32:
        p.wide_grad = None  # the lookup leaves an f32 gradient here

  def zero_grad(self, set_to_none: bool = True) -> None:
    super().zero_grad(set_to_none=set_to_none)
    for group in self.param_groups:
      for p in group["params"]:
        if hasattr(p, "wide_grad"):
          p.wide_grad = None

  @property
  def count(self) -> int:
    return int(self.state.get("count", 0))

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    count = self.count
    f32 = torch.float32
    for group in self.param_groups:
      lr, b1, b2 = group["lr"], group["b1"], group["b2"]
      lr = float(lr(count)) if callable(lr) else lr
      # 1 - b^t in f32 (optax's weakly typed f32 power), t = count + 1
      t = torch.tensor(float(count + 1), dtype=f32)
      c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32), t)
      c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32), t)
      for p in group["params"]:
        st = self.state[p]
        if not st:
          dt = getattr(p, "storage_dtype", p.dtype)
          st["mu"] = torch.zeros_like(p, dtype=dt)
          st["nu"] = torch.zeros_like(p, dtype=dt)
        g = getattr(p, "wide_grad", None)
        if g is not None:
          p.wide_grad = None
        elif p.grad is not None:
          g = p.grad
        else:
          g = torch.zeros_like(p)
        mu, nu = st["mu"], st["nu"]
        mu = g * _weak(1.0 - b1, g.dtype) + mu * _weak(b1, mu.dtype)
        nu = (g * g) * _weak(1.0 - b2, g.dtype) + nu * _weak(b2, nu.dtype)
        # optax divides by the correction cast to the moment's dtype
        mu_hat = mu / _on(c1, p.device).to(mu.dtype)
        nu_hat = nu / _on(c2, p.device).to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat + 0.0)
                      + _weak(group["eps"], nu_hat.dtype))
        p.copy_((p + u * _weak(-lr, u.dtype)).to(p.dtype))
        st["mu"], st["nu"] = mu, nu
    self.state["count"] = count + 1
    return loss


def rebind_optimizer(opt: torch.optim.Optimizer,
                     params: list) -> torch.optim.Optimizer:
  """A new optimizer of ``opt``'s kind and settings over ``params``, at
  its initial state (a restored state's optimizers are built this way
  from the run's own)."""
  if isinstance(opt, ScheduledSGD):
    return ScheduledSGD(params, opt.schedule,
                        momentum=opt.defaults["momentum"])
  return type(opt)(params, **opt.defaults)


@dataclasses.dataclass
class OptaxState:
  """An optimizer state carried across from the JAX package (or read
  from a checkpoint) before the port's optimizer is bound: the optax
  state's leaves as numpy, keyed in the JAX package's path spelling
  (``1/count``, ``0/trace/<param path>``, ``0/sum_of_squares/<param
  path>``). :func:`_with_optimizers` binds the optimizer and installs it
  (``convert.install_optax_state``), so the first step uses it."""

  flat: Dict[str, Any]


def _leaf(x, device) -> torch.Tensor:
  """A fresh f32 leaf on ``device`` that requires grad (never a view of
  the caller's tensor: the step updates it in place)."""
  t = torch.as_tensor(x).detach().to(device=device, dtype=torch.float32)
  return t.clone().requires_grad_(True)


def trained_tables(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """The dense-class tables the sparse step reads and its optimizer
  updates, in ``state['emb_dense']``'s order: a bf16 table's f32 work copy
  (``state['emb_dense_work']``), any other table itself.

  Narrow storage: the JAX package's one-hot lookup of a dense class
  returns f32 rows and takes an f32 gradient, so optax updates a bf16
  table as ``bf16(f32(p) + f32(-lr * g))`` with ``g`` never rounded to
  bf16. A torch leaf's gradient has the leaf's dtype, so the step reads
  an f32 copy of each bf16 table (refreshed from the table at every step,
  exact; its ``storage_dtype`` attribute makes the lookup emit bf16 rows,
  as the JAX one does), its optimizer steps the copy, and the commit
  rounds the copy into the table (:func:`_apply_dense`)."""
  work = state.get("emb_dense_work") or {}
  return {k: work.get(k, t) for k, t in state["emb_dense"].items()}


def _bind_work_tables(state: Dict[str, Any]) -> None:
  """Give every non-f32 dense-class table an f32 work copy (see
  :func:`trained_tables`); the tables themselves then take no gradient."""
  narrow = [k for k, t in state["emb_dense"].items()
            if t.dtype != torch.float32]
  work = state.get("emb_dense_work") or {}
  if list(work) != narrow:
    work = {k: state["emb_dense"][k].detach().to(torch.float32)
            .requires_grad_(True) for k in narrow}
    for k, w in work.items():  # the lookup emits rows in this type
      w.storage_dtype = state["emb_dense"][k].dtype
  for k in narrow:
    state["emb_dense"][k] = state["emb_dense"][k].detach()
  if work:
    state["emb_dense_work"] = work
  else:
    state.pop("emb_dense_work", None)


def _sync_work_tables(state: Dict[str, Any]) -> None:
  """Refresh the f32 work copies from their bf16 tables (exact)."""
  with torch.no_grad():
    for k, w in (state.get("emb_dense_work") or {}).items():
      w.copy_(state["emb_dense"][k])


def _with_optimizers(state: Dict[str, Any], dense_optimizer: OptimizerFactory,
                     emb_dense_optimizer: Optional[OptimizerFactory]):
  """Bind the optimizers to the state's dense tensors where the state has
  none yet (a state carried across by ``convert.train_state_from_flax``
  or read by ``checkpoint.restore``), installing a carried
  :class:`OptaxState`; the dense tensors become leaves that require
  grad. A part without tensors keeps no optimizer (None). Non-f32
  dense-class tables train through f32 work copies
  (:func:`trained_tables`), which their optimizer is bound to."""
  # convert imports this module; import it at call time
  from .convert import install_optax_state
  work_before = state.get("emb_dense_work")
  _bind_work_tables(state)
  for part in ("dense", "emb_dense"):
    for name, t in state[part].items():
      if part == "emb_dense" and t.dtype != torch.float32:
        continue
      if not (t.is_leaf and t.requires_grad):
        state[part][name] = t.detach().requires_grad_(True)
  factories = {"dense": dense_optimizer,
               "emb_dense": emb_dense_optimizer or dense_optimizer}
  tables = {"dense": state["dense"], "emb_dense": trained_tables(state)}
  for part, factory in factories.items():
    opt = state.get(f"{part}_opt")
    if opt is not None and not isinstance(opt, OptaxState):
      if part == "dense" or state.get("emb_dense_work") is work_before:
        continue
      # new work copies: the bound optimizer starts over on them
      opt = None
    if not tables[part]:
      state[f"{part}_opt"] = None
      continue
    bound = factory(list(tables[part].values()))
    if opt is not None:
      install_optax_state(bound, tables[part], opt.flat)
    state[f"{part}_opt"] = bound
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
  fused, emb_dense = _packed_tables(plan, params[emb_collection], rule, dev,
                                    mesh)
  dense = {k: _leaf(v, dev) for k, v in params.items()
           if k != emb_collection}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def _packed_tables(plan: DistEmbeddingStrategy, tables: Dict[str, Any],
                   rule: SparseRule, dev, mesh, skip=()):
  """``(fused, emb_dense)`` of :func:`init_sparse_state`: every sparse
  class's table packed with ``rule``'s initial state rows, every dense
  class's table as a leaf; the class names in ``skip`` are left out (a
  tiered state's host-tier classes)."""
  ranks = _state_ranks(plan, mesh)
  layouts = DistributedLookup(plan).fused_layouts(rule)
  fused, emb_dense = {}, {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    if name in skip:
      continue
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
  return fused, emb_dense


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
                             device="cuda", mesh=None,
                             dtype=torch.float32) -> Dict[str, Any]:
  """Build the fused train state without materializing simple-layout
  tables: every sparse class is drawn straight into its packed layout
  (``init_packed_uniform``: peak memory is the buffer plus one chunk),
  every dense class row by row. Each table's rows are uniform in +-its
  initializer's bound; padding rows are zero. ``generator`` lives on the
  state's device; the draws match the JAX package's distribution, not its
  bits. With a ``mesh`` only this rank's blocks are drawn, on the mesh's
  device (seed the generator per rank); ``dense_params`` must be the same
  on every rank. ``dtype`` is the tables' storage type (narrow storage:
  ``torch.bfloat16`` stores the sparse classes' buffers, their optimizer
  lanes and the dense classes' tables in bf16, as the JAX package's
  ``dtype=``; the dense parameters stay f32)."""
  dev = _state_device(device, mesh)
  fused, emb_dense = _drawn_tables(plan, rule, generator, dev, mesh, dtype)
  dense = {k: _leaf(v, dev) for k, v in dense_params.items()}
  state = {"dense": dense, "emb_dense": emb_dense, "fused": fused, "step": 0}
  return _with_optimizers(state, dense_optimizer, emb_dense_optimizer)


def _drawn_tables(plan: DistEmbeddingStrategy, rule: SparseRule,
                  generator: torch.Generator, dev, mesh, dtype, skip=()):
  """``(fused, emb_dense)`` of :func:`init_sparse_state_direct`, drawn
  class by class; the class names in ``skip`` are left out (a tiered
  state's host-tier classes)."""
  layouts = DistributedLookup(plan).fused_layouts(rule)
  fused, emb_dense = {}, {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    if name in skip:
      continue
    cp = plan.classes[key]
    blocks = []
    for r in _state_ranks(plan, mesh):
      scale = init_scale_rows(plan, key, r).to(dev)
      if cp.kind == "sparse":
        blocks.append(init_packed_uniform(layouts[name], generator, scale,
                                          rule.aux_init, device=dev,
                                          dtype=dtype))
      else:
        table = torch.rand((scale.shape[0], cp.width), generator=generator,
                           device=dev)
        blocks.append(table.mul_(2.0).sub_(1.0).mul_(scale[:, None])
                      .to(dtype))
    block = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    if cp.kind == "sparse":
      fused[name] = block
    else:
      emb_dense[name] = block.requires_grad_(True)
  return fused, emb_dense


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


def _per_rank_windows(plan: DistEmbeddingStrategy, rank: int):
  """Per class name, rank ``rank``'s ``(row_offset, rows, table_id)``
  windows of its local class block (simple layout)."""
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    out[class_param_name(*key)] = [
        (off, sh.input_dim, sh.table_id)
        for sh, off in zip(cp.shards_per_rank[rank],
                           cp.row_offsets_per_rank[rank])]
  return out


def plan_regularizer_fn(plan: DistEmbeddingStrategy
                        ) -> Optional[Callable[[Dict[str, Any], int], Any]]:
  """The tables' regularizer term for a plan: ``fn(emb_params, rank) ->
  scalar``, each table's penalty over its shard's row window of rank
  ``rank``'s local class block, summed (class names absent from
  ``emb_params`` are skipped); None when no table has a regularizer.
  Callables apply per shard slice, exact for additive penalties (l1 and
  l2, the Keras names)."""
  regs = {t: resolve_regularizer(c.regularizer)
          for t, c in enumerate(plan.global_configs)}
  if not any(r is not None for r in regs.values()):
    return None

  def fn(emb_params, rank: int = 0):
    total = None
    for name, wins in _per_rank_windows(plan, rank).items():
      if name not in emb_params:
        continue
      buf = emb_params[name]
      for off, rows, table_id in wins:
        reg = regs[table_id]
        if reg is None:
          continue
        pen = reg(buf[off:off + rows])
        total = pen if total is None else total + pen
    return torch.zeros(()) if total is None else total

  return fn


def plan_constraint_fn(plan: DistEmbeddingStrategy
                       ) -> Optional[Callable[[Dict[str, Any], int], Any]]:
  """The tables' post-update projection for a plan: ``fn(emb_params,
  rank)`` projects each constrained table's row window of rank ``rank``'s
  local class blocks, in place, and returns ``emb_params``; None when no
  table has a constraint. Row projections are exact for whole-row shards
  (the planner refuses constraints on column-sliced tables)."""
  cons = {t: resolve_constraint(c.constraint)
          for t, c in enumerate(plan.global_configs)}
  if not any(c is not None for c in cons.values()):
    return None

  @torch.no_grad()
  def fn(emb_params, rank: int = 0):
    for name, wins in _per_rank_windows(plan, rank).items():
      if name not in emb_params:
        continue
      buf = emb_params[name]
      for off, rows, table_id in wins:
        proj = cons[table_id]
        if proj is not None:
          window = buf[off:off + rows]
          window.copy_(proj(window).to(buf.dtype))
    return emb_params

  return fn


def _fused_rule_and_penalties(plan: DistEmbeddingStrategy, rule: SparseRule):
  """Validate regularizers and constraints for the fused path; returns
  ``(rule, reg_fn, con_fn)``: the rule with a uniform sparse-table l2
  folded in as ``weight_decay`` (decay on touched rows, per occurrence),
  and the dense-class tables' exact full-table penalty and projection
  (:func:`plan_regularizer_fn`, :func:`plan_constraint_fn` over
  ``emb_dense``, as in the JAX package), or None.

  Sparse tables with a constraint, a penalty other than pure l2, or
  unequal l2 factors raise, as in the JAX package."""
  table_kind = {sh.table_id: plan._kind_of(sh)
                for shards in plan.rank_shards for sh in shards}
  lam = None
  for t, c in enumerate(plan.global_configs):
    if table_kind.get(t) != "sparse":
      continue  # dense-kind: the exact penalty and projection below
    if c.constraint is not None:
      raise NotImplementedError(
          f"table {t} has an embeddings_constraint on the fused sparse "
          "path: per-occurrence deltas never materialize whole tables, so "
          "a full-table projection cannot be honored here. Use "
          "make_train_step (the dense autodiff path) or raise "
          "dense_row_threshold to make it a dense-class table")
    if c.regularizer is None:
      continue
    f = l2_decay_factor(c.regularizer)
    if f is None:
      raise NotImplementedError(
          f"table {t}'s regularizer {c.regularizer!r} is not a pure l2: "
          "the fused sparse path folds only l2 decay into its "
          "per-occurrence deltas ('l2' or {'name': 'l2', 'factor': λ}); "
          "use make_train_step for other penalties")
    if lam is None:
      lam = f
    elif lam != f:
      raise NotImplementedError(
          f"sparse tables carry different l2 factors ({lam} vs {f} on "
          f"table {t}): the fused delta applies one uniform decay per rule")
  if lam:
    rule = dataclasses.replace(rule, weight_decay=float(lam))
  dense = [c for t, c in enumerate(plan.global_configs)
           if table_kind.get(t) == "dense"]
  # the fns skip class names absent from the param dict, so feeding them
  # emb_dense covers exactly the dense-kind windows
  reg_fn = (plan_regularizer_fn(plan)
            if any(c.regularizer is not None for c in dense) else None)
  con_fn = (plan_constraint_fn(plan)
            if any(c.constraint is not None for c in dense) else None)
  return rule, reg_fn, con_fn


def _scale_d_z(d_z, scale: float):
  """Every sparse cotangent (or each chunk of a :class:`FusedChunks`)
  times ``scale``."""
  return {bk: (g.map(lambda c: c * scale) if isinstance(g, FusedChunks)
               else g * scale) for bk, g in d_z.items()}


def _reduce_dense(state: Dict[str, Any], d_z, loss, mesh=None):
  """The cross-rank reduction of the step's dense tail; returns ``(d_z,
  loss)`` for the sparse apply. Nothing commits here.

  At world > 1 the gradients of the dense parameters and the dense-class
  tables (``mp_table_*`` names) go through :func:`finalize_hybrid_grads`
  (the replicated ones summed over the ranks, every one scaled by ``1 /
  world``, which restores the global batch mean), ``d_z`` is scaled
  alike and the loss is averaged over the ranks."""
  if mesh is not None and mesh.world > 1:
    finalize_hybrid_grads(
        list(state["dense"].items()) + list(trained_tables(state).items()),
        mesh)
    d_z = _scale_d_z(d_z, 1.0 / mesh.world)
    loss = _mean_over_ranks(loss, mesh)
  return d_z, loss


def _apply_dense(state: Dict[str, Any], mesh=None, con_fn=None,
                 commit: bool = True) -> None:
  """The commit of the step's dense tail: the optimizer steps on the
  dense parameters and the dense-class tables (their gradients are in
  ``.grad``), the dense-class tables' constraints (``con_fn``); then the
  gradients are dropped. With ``commit=False`` (a guarded step that
  failed its gate) only the gradients are dropped: the parameters, the
  optimizers' states and a schedule's count stay as they were, and no
  poisoned gradient is left to join the next step's."""
  for opt_name in ("dense_opt", "emb_dense_opt"):
    opt = state[opt_name]
    if opt is not None:
      if commit:
        opt.step()
      opt.zero_grad(set_to_none=True)
  if commit:
    with torch.no_grad():  # the f32 work copies round into their tables
      for k, w in (state.get("emb_dense_work") or {}).items():
        state["emb_dense"][k].copy_(w)
  if commit and con_fn is not None and state["emb_dense"]:
    con_fn(state["emb_dense"], 0 if mesh is None else mesh.rank)


def _make_guard_helpers(plan: DistEmbeddingStrategy, mesh=None):
  """The non-finite / OOV guard epilogue (``resilience.guards`` wiring),
  as the JAX package's ``_make_guard_helpers``.

  Returns ``(guard_gate, oov_ok, guard_metrics)``:

  - ``guard_gate(loss, grads_ok, streams, oov_ok)``: the global ok flag
    (a device bool) and the gated delta streams. Finiteness is checked on
    the loss, the dense gradients (``grads_ok``: :func:`all_finite` of
    them before the reduction) and the BUILT delta streams (NaN and inf
    cotangents propagate through every rule's delta math, so checking the
    streams covers ``d_z``). ``ok`` must agree on every rank — a skip must
    be collective; one rank committing while another skips would fork the
    replicated state — so the local verdict goes through an
    ``all_reduce(MIN)`` of an int flag over the process group (the JAX
    ``pmin``). Bad-step streams are ZEROED (``torch.where(ok, rows,
    0)``) rather than the buffers select-gated: a scatter-add of zeros is
    an exact no-op, so the packed buffers are never copied.
  - ``oov_ok(oov)``: the ``oov='error'`` commit gate (None under
    ``'clip'``), from this rank's counts before any reduction: a batch
    carrying ANY out-of-range id commits nothing, so the host-side
    ``check_oov`` raise fires with the state bit-identical to before the
    batch.
  - ``guard_metrics(ok, oov, overflow=None)``: the ``{'bad_step',
    'oov'}`` metrics dict, the counters summed over the ranks (one
    ``all_reduce(SUM)``, the JAX ``psum``), the same on every rank; with
    ``overflow`` (per-class dedup-capacity overflow counts, plans with
    ``dedup_capacity``) a ``'dedup_overflow'`` dict joins it, summed in
    the same ``all_reduce``."""
  from .resilience.guards import all_finite
  world = 1 if mesh is None else mesh.world
  oov_is_error = getattr(plan, "oov", "clip") == "error"

  def guard_gate(loss, grads_ok, streams, oov_ok=None):
    ok = torch.logical_and(all_finite((loss, streams)),
                           grads_ok.to(loss.device))
    if oov_ok is not None:
      ok = torch.logical_and(ok, oov_ok.to(ok.device))
    if world > 1:
      flag = ok.to(torch.int32)
      dist.all_reduce(flag, op=dist.ReduceOp.MIN)
      ok = flag.to(torch.bool)
    streams = {name: (ids, torch.where(ok, rows, torch.zeros_like(rows)))
               for name, (ids, rows) in streams.items()}
    return ok, streams

  def oov_ok(oov):
    if not oov_is_error or not oov:
      return None
    return torch.stack(list(oov.values())).sum() == 0

  def guard_metrics(ok, oov, overflow=None):
    counters = [("oov", n, c) for n, c in oov.items()]
    if overflow is not None:
      counters += [("dedup_overflow", n, c) for n, c in overflow.items()]
    if world > 1 and counters:
      total = torch.stack([c.to(torch.int32) for _, _, c in counters])
      dist.all_reduce(total)
      counters = [(part, n, c) for (part, n, _), c in
                  zip(counters, total.unbind())]
    out = {"bad_step": 1 - ok.to(torch.int32), "oov": {}}
    if overflow is not None:
      out["dedup_overflow"] = {}
    for part, n, c in counters:
      out[part][n] = c
    return out

  return guard_gate, oov_ok, guard_metrics


def _check_mesh(plan, mesh) -> None:
  """A world-N plan runs on an N-rank mesh; a world-1 plan needs none."""
  if plan.world_size > 1 and mesh is None:
    raise ValueError(
        f"a world-{plan.world_size} plan needs this rank's mesh "
        "(parallel.mesh.create_mesh)")
  if mesh is not None and mesh.world != plan.world_size:
    raise ValueError(f"the mesh has {mesh.world} ranks, the plan "
                     f"{plan.world_size}")


def _refuse_unported(plan, mesh, micro_batches: int, guard: bool,
                     exact: bool) -> None:
  """The JAX builder's refusals, with its messages, and the options of
  later ROADMAP items, naming them."""
  _check_mesh(plan, mesh)
  if micro_batches > 1 and exact:
    raise NotImplementedError(
        "micro_batches > 1 with exact=True: cross-micro-batch dedup would "
        "need the full occurrence stream the mode exists to avoid. Use "
        "per-occurrence semantics (exact=False) or one-shot exact.")
  if guard and exact:
    raise NotImplementedError(
        "guard=True with exact=True: the non-finite guard gates the "
        "prebuilt per-class delta streams before the scatter, but the "
        "exact path re-gathers rows and builds its deltas inside the "
        "apply. Use per-occurrence semantics (exact=False) with the "
        "guard.")
  if exact and getattr(plan, "wire_dtype", "f32") != "f32":
    raise ValueError(
        "exact=True requires wire_dtype='f32': the exact path reproduces "
        "the reference's deduplicated backward bit-for-bit, and a "
        "bf16/fp8-narrowed cotangent exchange breaks that claim before "
        "the sort ever runs. Build the plan with wire_dtype='f32' (the "
        "dedup_exchange and overlap='pipelined' knobs compose with exact "
        "fine — dedup only changes which ids reach the mp side, and the "
        "pipelined f32 wire is bit-exact pure data movement).")
  if getattr(plan, "dedup_capacity", None) is not None and not guard:
    raise ValueError(
        "plan.dedup_capacity requires make_sparse_train_step(guard=True): "
        "a capacity below the safe bound aliases distinct ids onto the "
        "cap's last slot — those occurrences gather and UPDATE the wrong "
        "rows — and only the guarded step surfaces the psum'd "
        "'dedup_overflow' counter that makes that observable. Build with "
        "guard=True or drop the capacity override.")
  oov = getattr(plan, "oov", "clip")
  if oov == "allocate":
    raise NotImplementedError(
        "plan.oov='allocate': the dynamic vocabulary is not ported yet "
        "(ROADMAP.md §1 item 12, dynvocab)")
  if oov == "error" and not guard:
    raise ValueError(
        "plan.oov='error' requires make_sparse_train_step(guard=True): "
        "under jit the ids are traced, so the unguarded step cannot see "
        "them — out-of-range ids would be silently clipped to each "
        "table's last row, exactly what oov='error' exists to forbid. "
        "Enforcement rides the guarded step's OOV metrics "
        "(resilience.guards.check_oov) plus a commit gate on the "
        "offending batch; build with guard=True or use oov='clip'.")


def _route(engine: DistributedLookup, cats, guard: bool):
  """``(ids_all, mean counts, hotness_of)`` of one (micro-)batch. The
  guarded step enforces ``oov='error'`` through its commit gate and
  metrics, never by raising half-way through a step."""
  hotness = [ragged_hotness(c) for c in cats]
  hotness_of = lambda i: hotness[i]  # noqa: E731
  ids_all = engine.route_ids(cats, hotness_of, eager_oov=not guard)
  return ids_all, engine.mean_counts(cats), hotness_of


def _fused_backward(engine: DistributedLookup, model, loss_fn, reg_fn,
                    world: int, rank: int, state, fused, layouts, routed,
                    numerical, cats, labels, keep_rows: bool, exact: bool,
                    loss_scale: float = 1.0):
  """The fused gather of ``fused`` (outside autograd), the differentiable
  tail on leaves (the dense parameters, the dense-class tables, the sparse
  activations) and one ``backward`` of ``loss * loss_scale``: the dense
  gradients land in ``.grad``; returns ``(loss, d_z, residuals)``."""
  ids_all, counts, hotness_of = routed
  with torch.no_grad():
    z_sparse, residuals = engine.lookup_sparse_fused(
        fused, layouts, ids_all, keep_rows=keep_rows, keep_aux=not exact)
  z_leaves = {bk: _leaf_of(z) for bk, z in z_sparse.items()}
  tables = trained_tables(state)
  acts = engine.finish_forward(z_leaves, tables, ids_all,
                               numerical.shape[0], hotness_of, counts)
  logits = functional_call(model, state["dense"], (numerical, cats),
                           {"emb_acts": acts})
  loss = loss_fn(logits, labels)
  if reg_fn is not None:
    # the rank's own windows, scaled by the world to survive the uniform
    # 1 / world gradient scale, as in the JAX step
    loss = loss + world * reg_fn(tables, rank)
  (loss * loss_scale if loss_scale != 1.0 else loss).backward()
  d_z = {bk: _grad_of(z) for bk, z in z_leaves.items()}
  return loss.detach(), d_z, residuals


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
    micro_batches: > 1 runs route, gather, model and backward over
      ``micro_batches`` equal slices of this rank's batch, one after the
      other: the dense gradients accumulate in ``.grad`` (each slice's
      loss scaled by ``1 / micro_batches``), each slice's per-class delta
      streams are built from the forward-gathered rows of the PRE-step
      buffers (untouched until the end) and stashed, then ONE dense
      reduction and ONE scatter per class (kernel K1) apply them. Live
      gathers, activations and backward temporaries are a slice's; the
      stashed streams are as large as the one-shot step's. The numerics
      are the one-shot step's up to the order of the scatter's and the
      gradients' additions. Requires dense (non-ragged) ``cats``, a batch
      that ``micro_batches`` divides, and ``exact=False``.
    guard: harden the step against poison batches
      (``resilience.guards``). After the backward — BEFORE anything
      commits — the step checks the loss, the dense gradients (before the
      reduction) and the built delta streams for non-finite values, and
      under ``plan.oov='error'`` the batch's out-of-range ids; the verdict
      is min-reduced over the ranks. A bad step commits NOTHING: the
      delta streams are zeroed (a scatter-add of zeros is an exact no-op,
      so the buffers are never copied), the dense optimizers do not step
      (their states and a schedule's count stay), the gradients are
      dropped and ``state['step']`` holds — the state is bit-identical to
      a run that never saw the batch. The step reads the verdict on the
      host once (torch optimizers step on the host). It then returns
      ``(state, loss, metrics)`` with ``metrics = {'bad_step': int32 0/1,
      'oov': {class: int32 count}}`` (counts summed over the ranks; the
      loss is the observed, possibly NaN, value), and with the plan's
      ``dedup_capacity`` a ``'dedup_overflow'`` dict of per-class counts
      (distinct ids aliased past the capped unique blocks, summed over
      the ranks and micro-batches; they ride the metrics, adding no host
      read). Incompatible with ``exact=True``; a capped plan requires
      it.

  Returns:
    ``step(state, numerical, cats, labels) -> (state, loss)`` (with
    ``guard``, ``-> (state, loss, metrics)``), with this rank's slice of
    the batch on the state's device (:func:`shard_batch`); ``state`` is
    updated in place and ``loss`` is the mean over the ranks.
  """
  _refuse_unported(plan, mesh, micro_batches, guard, exact)
  rule, reg_fn, con_fn = _fused_rule_and_penalties(plan, rule)
  engine = DistributedLookup(plan, mesh=mesh)
  layouts = engine.fused_layouts(rule)
  world = 1 if mesh is None else mesh.world
  rank = 0 if mesh is None else mesh.rank
  n_mb = max(1, micro_batches)
  # exact=True re-gathers rows at apply time; a weight decay without aux
  # lanes needs the forward-time rows saved
  keep_rows = bool(rule.weight_decay) and not rule.n_aux and not exact
  guard_gate, oov_ok, guard_metrics = _make_guard_helpers(plan, mesh)
  has_dedup_cap = getattr(plan, "dedup_capacity", None) is not None

  def backward(state, numerical, cats, labels, loss_scale):
    """Route, gather, forward and backward of one (micro-)batch: the
    dense gradients land in ``.grad`` (of ``loss * loss_scale``);
    returns ``(loss, d_z, residuals, overflow)``, ``d_z`` the sparse
    activations' cotangents, ``overflow`` this rank's per-class
    dedup-capacity overflow counts (None for an uncapped plan)."""
    routed = _route(engine, cats, guard)
    loss, d_z, residuals = _fused_backward(
        engine, model, loss_fn, reg_fn, world, rank, state, state["fused"],
        layouts, routed, numerical, cats, labels, keep_rows, exact,
        loss_scale)
    overflow = (engine.dedup_overflow_counts(routed[0]) if has_dedup_cap
                else None)
    return loss, d_z, residuals, overflow

  def micro_slices(numerical, cats, labels):
    """This rank's batch as ``n_mb`` equal slices (the JAX step's
    refusals first)."""
    b = numerical.shape[0]
    if b % n_mb:
      raise ValueError(f"batch {b} not divisible by micro_batches {n_mb}")
    if any(isinstance(c, RaggedIds) for c in cats):
      raise NotImplementedError(
          "micro_batches > 1 needs dense cats (ragged rows cannot be "
          "batch-sliced statically); pad to dense multi-hot first.")
    m = b // n_mb
    return [(numerical[i * m:(i + 1) * m], [c[i * m:(i + 1) * m]
                                            for c in cats],
             labels[i * m:(i + 1) * m]) for i in range(n_mb)]

  def step_mb(state, numerical, cats, labels):
    """Micro-batched: a loop of backwards, the streams stashed, then one
    dense reduction and one scatter per class."""
    narrow = sorted(k for part in ("fused", "emb_dense")
                    for k, t in state[part].items()
                    if t.dtype != torch.float32)
    if narrow:
      # the JAX micro-batched step cannot carry them either: its scan
      # accumulates f32 gradients into the bf16 tables' carry (TypeError)
      raise NotImplementedError(
          f"micro_batches > 1 with non-f32 tables {narrow}: narrow storage "
          "takes the one-shot step (ROADMAP.md §1 item 7b)")
    stash: Dict[str, tuple] = {}
    loss = overflow = None
    # d_z takes 1 / (n_mb * world) as in the JAX step: 1 / n_mb from the
    # loss scale, 1 / world here (finalize_hybrid_grads gives the dense
    # gradients theirs)
    dz_scale = 1.0 / world
    for i, mb in enumerate(micro_slices(numerical, cats, labels)):
      loss_i, d_z, residuals, ovf = backward(state, *mb, 1.0 / n_mb)
      if ovf is not None:
        # each micro-batch routes its own capped unique blocks
        overflow = ovf if overflow is None else {
            n: overflow[n] + c for n, c in ovf.items()}
      if dz_scale != 1.0:
        d_z = _scale_d_z(d_z, dz_scale)
      with torch.no_grad():
        streams = engine.sparse_delta_streams(layouts, d_z, residuals, rule,
                                              state["step"])
        # every slice's stream has the same shape: stacked [n_mb, ...] as
        # the JAX scan stacks them, written in place (a concatenation at
        # the end would hold the stash twice)
        for name, (ids, rows) in streams.items():
          if not i:
            stash[name] = (ids.new_empty((n_mb,) + ids.shape),
                           rows.new_empty((n_mb,) + rows.shape))
          stash[name][0][i] = ids
          stash[name][1][i] = rows
      del streams, d_z, residuals
      loss = loss_i / n_mb if loss is None else loss + loss_i / n_mb
    return loss, {name: (ids.reshape(-1), rows.reshape(-1, rows.shape[-1]))
                  for name, (ids, rows) in stash.items()}, overflow

  def step(state, numerical, cats, labels):
    _with_optimizers(state, dense_optimizer, emb_dense_optimizer)
    _sync_work_tables(state)
    cats = list(cats)
    if n_mb == 1 and not guard:
      loss, d_z, residuals, _ = backward(state, numerical, cats, labels, 1.0)
      d_z, loss = _reduce_dense(state, d_z, loss, mesh)
      _apply_dense(state, mesh, con_fn)
      with torch.no_grad():
        engine.apply_sparse(state["fused"], layouts, d_z, residuals, rule,
                            state["step"], exact=exact)
      state["step"] += 1
      return state, loss
    if n_mb > 1:
      loss, streams, overflow = step_mb(state, numerical, cats, labels)
      grads_ok = _grads_ok(state, guard)
      _, loss = _reduce_dense(state, {}, loss, mesh)
    else:
      loss, d_z, residuals, overflow = backward(state, numerical, cats,
                                                labels, 1.0)
      # checked before the reduction (the JAX step's grads_chk), as a
      # device flag: the reduction scales .grad in place
      grads_ok = _grads_ok(state, guard)
      d_z, loss = _reduce_dense(state, d_z, loss, mesh)
      with torch.no_grad():
        streams = engine.sparse_delta_streams(layouts, d_z, residuals, rule,
                                              state["step"])
    commit, metrics = True, None
    if guard:
      # the guard sees the whole step: the accumulated gradients and every
      # micro-batch's streams
      oov = engine.oov_counts(cats)
      with torch.no_grad():
        ok, streams = guard_gate(loss, grads_ok, streams, oov_ok(oov))
      metrics = guard_metrics(ok, oov, overflow)
    with torch.no_grad():
      engine.apply_sparse_streams(state["fused"], layouts, streams, rule,
                                  state["step"])
    if guard:
      commit = bool(ok)  # the step's one host read of the verdict
    _apply_dense(state, mesh, con_fn, commit=commit)
    # the counter only advances on COMMITTED steps: schedules and resume
    # offsets see the same step sequence as a run that never met the
    # poison batch
    state["step"] += int(commit)
    if guard:
      return state, loss, metrics
    return state, loss

  return step


def make_tiered_train_step(model: torch.nn.Module, tplan,
                           loss_fn: Callable,
                           dense_optimizer: OptimizerFactory,
                           rule: SparseRule,
                           mesh=None,
                           emb_dense_optimizer: Optional[
                               OptimizerFactory] = None,
                           exact: bool = False,
                           guard: bool = False):
  """Train step over tiered storage: host-tier classes hold only a hot
  cache and a staging region on the device (``tiering/``), fed by a host
  prefetch stage (``tiering.TieredPrefetcher``) that runs AHEAD of the
  step.

  Per call the step takes, besides this rank's batch, the prefetcher's
  staging upload ``staged = {'grps', 'rows', 'resident'}`` (this rank's
  blocks, ``TieredPrefetcher.stage(...).device``):

  - routed LOGICAL ids of host-tier classes become compact cache or
    staging slots (``DistributedLookup.translate_tiered_ids``); routing,
    bucketing and sentinel semantics are untouched;
  - the staged cold rows are written into each compact buffer's staging
    region (``install_staging``), so the fused gather and the ONE
    scatter-add per class of :func:`make_sparse_train_step` cover both
    tiers (K1; K4 under ``overlap='fused'``). The step's effective
    layouts come from this step's staged size ``S``: a spill step
    (``S > staging_grps``) applies on an extended copy of the buffer of
    ``cache + S`` rows, whose cache region is copied back into the
    persistent buffer after the apply (``trim_spill``), so
    ``state['fused']`` keeps its tensors;
  - after the update the staging regions are copied out and returned for
    the host write-back, with per-class counters ``[hot, staged, missed,
    total]`` summed over the ranks (one ``all_reduce``); ``missed > 0``
    means the prefetch contract broke and those updates were dropped.

  ``guard=True`` is :func:`make_sparse_train_step`'s guard extended to the
  third tier: a bad batch zeroes the delta streams before the scatter, so
  the staging rows come back as they were staged and the host images
  stay bit-identical after the write-back. Incompatible with
  ``exact=True``.

  Returns:
    ``step(state, staged, numerical, cats, labels) -> (state, staged_out,
    metrics, loss)``: ``state`` updated in place, ``staged_out`` class
    name -> post-update staging rows, ``metrics`` class name -> int32
    ``[4]`` counters; with ``guard``, ``metrics = {'tier': {class: [4]},
    'bad_step', 'oov'[, 'dedup_overflow']}``.
  """
  from .ops.packed_table import PackedLayout
  plan = tplan.plan
  tier_specs = tplan.tier_specs
  _check_mesh(plan, mesh)
  if getattr(plan, "oov", "clip") == "allocate":
    raise NotImplementedError(
        "plan.oov='allocate' with tiered storage: the tiered prefetcher "
        "classifies RAW ids host-side, so the dynamic-id translation and "
        "the classify stage would have to compose into one host pass — "
        "an open follow-on (ROADMAP, dynamic-vocab direction). Keep "
        "dynamic tables device-resident (host_row_threshold=None) or "
        "use a static oov policy for tiered plans. (ROADMAP.md §1 item "
        "12)")
  if getattr(plan, "oov", "clip") == "error" and not guard:
    raise ValueError(
        "plan.oov='error' requires make_tiered_train_step(guard=True): "
        "under jit the ids are traced, so the unguarded step cannot see "
        "them — out-of-range ids would be silently clipped to each "
        "table's last row, exactly what oov='error' exists to forbid. "
        "Enforcement rides the guarded step's OOV metrics plus a commit "
        "gate on the offending batch; build with guard=True or use "
        "oov='clip'.")
  if guard and exact:
    raise NotImplementedError(
        "guard=True with exact=True: the non-finite guard gates the "
        "prebuilt per-class delta streams before the scatter, but the "
        "exact path re-gathers rows and builds its deltas inside the "
        "apply. Use per-occurrence semantics (exact=False) with the "
        "guard.")
  if exact and getattr(plan, "wire_dtype", "f32") != "f32":
    raise ValueError(
        "exact=True requires wire_dtype='f32' (same contract as "
        "make_sparse_train_step): the deduplicated backward's bit-for-bit "
        "claim cannot survive a bf16/fp8-narrowed cotangent exchange. "
        "Build the plan with wire_dtype='f32'.")
  has_dedup_cap = getattr(plan, "dedup_capacity", None) is not None
  if has_dedup_cap and not guard:
    raise ValueError(
        "plan.dedup_capacity requires make_tiered_train_step(guard=True): "
        "a capacity below the safe bound aliases distinct ids onto the "
        "cap's last slot — those occurrences gather and UPDATE the wrong "
        "rows — and only the guarded step surfaces the psum'd "
        "'dedup_overflow' counter that makes that observable. Build with "
        "guard=True or drop the capacity override.")
  rule, reg_fn, con_fn = _fused_rule_and_penalties(plan, rule)
  engine = DistributedLookup(plan, mesh=mesh)
  base_layouts = engine.fused_layouts(rule,
                                      rows_overrides=tplan.rows_overrides)
  world = 1 if mesh is None else mesh.world
  rank = 0 if mesh is None else mesh.rank
  keep_rows = bool(rule.weight_decay) and not rule.n_aux and not exact
  guard_gate, oov_ok, guard_metrics = _make_guard_helpers(plan, mesh)
  names = sorted(tier_specs)

  def step(state, staged, numerical, cats, labels):
    _with_optimizers(state, dense_optimizer, emb_dense_optimizer)
    _sync_work_tables(state)
    cats = list(cats)
    narrow = [n for n in names if state["fused"][n].dtype != torch.float32]
    if narrow:
      raise NotImplementedError(
          f"tiered classes {narrow} on non-f32 buffers: the host images "
          "are f32 (narrow tiered storage is not in the JAX package)")
    # effective layouts from THIS step's staged size: a spill step stages
    # S > staging_grps rows, and the compact buffer grows with it (K1's
    # and K4's row bounds are the layout's)
    layouts = dict(base_layouts)
    for name, spec in tier_specs.items():
      s = staged["grps"][name].shape[0]
      layouts[name] = PackedLayout(
          rows=(spec.cache_grps + s) * spec.rpp,
          width=base_layouts[name].width, n_aux=rule.n_aux)
    ids_all, counts, hotness_of = _route(engine, cats, guard)
    ids_all, tier_metrics = engine.translate_tiered_ids(
        ids_all, tier_specs, staged["resident"], staged["grps"])
    with torch.no_grad():
      fused_in = engine.install_staging(state["fused"], tier_specs,
                                        staged["rows"])
    loss, d_z, residuals = _fused_backward(
        engine, model, loss_fn, reg_fn, world, rank, state, fused_in,
        layouts, (ids_all, counts, hotness_of), numerical, cats, labels,
        keep_rows, exact)
    grads_ok = _grads_ok(state, guard)
    d_z, loss = _reduce_dense(state, d_z, loss, mesh)
    commit, metrics = True, None
    if guard:
      oov = engine.oov_counts(cats)
      ovf = engine.dedup_overflow_counts(ids_all) if has_dedup_cap else None
      with torch.no_grad():
        streams = engine.sparse_delta_streams(layouts, d_z, residuals, rule,
                                              state["step"])
        ok, streams = guard_gate(loss, grads_ok, streams, oov_ok(oov))
        metrics = guard_metrics(ok, oov, ovf)
        # zeroed streams scatter-add nothing: the cache AND staging
        # regions come back bit-identical
        engine.apply_sparse_streams(fused_in, layouts, streams, rule,
                                    state["step"])
      commit = bool(ok)  # the step's one host read of the verdict
      _apply_dense(state, mesh, con_fn, commit=commit)
    else:
      _apply_dense(state, mesh, con_fn)
      with torch.no_grad():
        engine.apply_sparse(fused_in, layouts, d_z, residuals, rule,
                            state["step"], exact=exact)
    with torch.no_grad():
      staged_out = engine.staged_regions(fused_in, tier_specs,
                                         staged["grps"])
      engine.trim_spill(state["fused"], fused_in, tier_specs)
    del fused_in
    dev = staged["resident"][names[0]].device
    stacked = torch.stack([
        tier_metrics[n] if n in tier_metrics
        else torch.zeros((4,), dtype=torch.int32, device=dev)
        for n in names])
    if world > 1:
      dist.all_reduce(stacked)
    tier_metrics = dict(zip(names, stacked.unbind()))
    state["step"] += int(commit)
    if guard:
      return state, staged_out, {"tier": tier_metrics, **metrics}, loss
    return state, staged_out, tier_metrics, loss

  return step


def _grads_ok(state: Dict[str, Any], guard: bool):
  """:func:`~.resilience.guards.all_finite` of the gradients the backward
  left on the dense parameters and the dense-class tables (the JAX
  step's ``grads_chk``; a device bool), or None without the guard."""
  if not guard:
    return None
  from .resilience.guards import all_finite
  return all_finite([t.grad for part in (state["dense"], trained_tables(state))
                     for t in part.values() if t.grad is not None])


def make_sparse_eval_step(model: torch.nn.Module,
                          plan: DistEmbeddingStrategy, rule: SparseRule,
                          mesh=None, with_metrics: bool = False):
  """Forward on the fused state: ``eval(state, numerical, cats) ->
  preds``, this rank's predictions for its slice of the batch (with a
  ``mesh``, every rank calls it; the JAX step's batch-sharded output is
  these slices in rank order). Never writes the state (the JAX eval step
  never donates it).

  ``with_metrics=True`` returns ``(preds, metrics)`` with ``metrics =
  {'oov': {class_name: int32 count}}``: the per-class out-of-vocabulary
  occurrence counters the guarded train step surfaces, summed over the
  ranks (the same on every rank). Under ``oov='error'`` such a batch is
  then counted, not refused. A plan with ``dedup_capacity`` adds a
  ``'dedup_overflow'`` dict (distinct ids aliased past the capped unique
  blocks: those predictions read the wrong rows) and requires
  ``with_metrics``."""
  _check_mesh(plan, mesh)
  has_dedup_cap = getattr(plan, "dedup_capacity", None) is not None
  if has_dedup_cap and not with_metrics:
    raise ValueError(
        "plan.dedup_capacity requires make_sparse_eval_step("
        "with_metrics=True): a capacity below the safe bound aliases "
        "distinct ids onto the cap's last slot — those predictions read "
        "the WRONG rows — and only the metrics path surfaces the psum'd "
        "'dedup_overflow' counter that makes that observable.")
  if getattr(plan, "oov", "clip") == "allocate":
    raise ValueError("plan.oov='allocate' is not evaluable: allocation "
                     "mutates the id space; evaluate with oov='clip'")
  engine = DistributedLookup(plan, mesh=mesh)
  layouts = engine.fused_layouts(rule)
  _, _, guard_metrics = _make_guard_helpers(plan, mesh)

  @torch.inference_mode()
  def local_eval(state, numerical, cats):
    cats = list(cats)
    b = numerical.shape[0]
    hotness = [ragged_hotness(c) for c in cats]
    hotness_of = lambda i: hotness[i]  # noqa: E731
    ids_all = engine.route_ids(cats, hotness_of, eager_oov=not with_metrics)
    counts = engine.mean_counts(cats)
    z_sparse, _ = engine.lookup_sparse_fused(state["fused"], layouts,
                                             ids_all, keep_aux=False)
    acts = engine.finish_forward(z_sparse, state["emb_dense"], ids_all, b,
                                 hotness_of, counts)
    preds = functional_call(model, state["dense"], (numerical, cats),
                            {"emb_acts": acts})
    if not with_metrics:
      return preds
    metrics = guard_metrics(
        torch.ones((), dtype=torch.bool), engine.oov_counts(cats),
        engine.dedup_overflow_counts(ids_all) if has_dedup_cap else None)
    del metrics["bad_step"]
    return preds, metrics

  return local_eval


def shard_batch(batch, mesh=None, device="cuda"):
  """This rank's slice of a global host batch, on its device.

  Every leaf's leading (batch) axis is cut into ``world`` equal slices
  and rank ``r`` keeps slice ``r`` (the JAX package's ``P(axis)`` batch
  sharding, one process per rank); a global batch the world does not
  divide is refused. Without a mesh the whole batch goes to ``device``.
  Nested tuples, lists and dicts keep their structure (a dict of
  :func:`~.parallel.lookup_engine.pack_mp_inputs` arrays gives each rank
  its ``[1, ...]`` block).

  A :class:`RaggedIds` leaf at world N is either the JAX package's global
  form, the ranks' blocks stacked (``values`` ``[world * V]``,
  ``row_splits`` ``[world * (B + 1)]``, each block's splits from 0), of
  which rank ``r`` keeps block ``r``; or one CSR stream over the global
  batch (``row_splits`` ``[world * B + 1]``), which is cut into the
  ranks' sample blocks, each rebased and padded to a common capacity, the
  smallest power of two that holds the largest block (one host read of
  the splits)."""
  dev = _state_device(device, mesh)
  world = 1 if mesh is None else mesh.world

  def put(x):
    if isinstance(x, (tuple, list)):
      return type(x)(put(v) for v in x)
    if isinstance(x, dict):
      return {k: put(v) for k, v in x.items()}
    if isinstance(x, RaggedIds):
      return _shard_ragged(x, mesh, dev)
    x = torch.as_tensor(x)
    if world > 1 and x.dim():
      if x.shape[0] % world:
        raise ValueError(f"global batch {x.shape[0]} is not divisible by "
                         f"the world size {world}")
      n = x.shape[0] // world
      x = x[mesh.rank * n:(mesh.rank + 1) * n]
    return x.to(dev)

  return put(batch)


def _pow2_at_least(n: int) -> int:
  """The smallest power of two ``>= n`` (0 for 0)."""
  return 0 if n <= 0 else 1 << (int(n) - 1).bit_length()


def _shard_ragged(x: RaggedIds, mesh, dev) -> RaggedIds:
  """This rank's :class:`RaggedIds` block of a global one (see
  :func:`shard_batch`), on ``dev``."""
  values = torch.as_tensor(x.values)
  splits = torch.as_tensor(x.row_splits)
  world = 1 if mesh is None else mesh.world
  if world == 1:
    return RaggedIds(values.to(dev), splits.to(dev))
  r = mesh.rank
  if splits.shape[0] % world == 0:  # the ranks' blocks, stacked
    if values.shape[0] % world:
      raise ValueError(f"RaggedIds values of {values.shape[0]} do not split "
                       f"into {world} rank blocks")
    n, cap = splits.shape[0] // world, values.shape[0] // world
    return RaggedIds(values[r * cap:(r + 1) * cap].to(dev),
                     splits[r * n:(r + 1) * n].to(dev))
  g = splits.shape[0] - 1
  if g % world:
    raise ValueError(f"global batch {g} is not divisible by the world size "
                     f"{world}")
  b = g // world
  host = splits.cpu().long()
  bounds = host[::b].tolist()  # the ranks' block bounds, world + 1 of them
  cap = _pow2_at_least(max(bounds[q + 1] - bounds[q] for q in range(world)))
  lo, hi = bounds[r], bounds[r + 1]
  block = torch.zeros(cap, dtype=values.dtype, device=values.device)
  block[:hi - lo] = values[lo:hi]
  return RaggedIds(block.to(dev),
                   (splits[r * b:(r + 1) * b + 1] - lo).to(dev))


# ---------------------------------------------------------------------------
# The dense-autodiff path
# ---------------------------------------------------------------------------


def _refuse_dense_step(plan: Optional[DistEmbeddingStrategy]) -> None:
  """The JAX ``make_train_step``'s refusals."""
  if plan is None:
    return
  oov = getattr(plan, "oov", "clip")
  if oov == "error":
    raise NotImplementedError(
        "plan.oov='error' is only enforced by the guarded sparse step "
        "(make_sparse_train_step(guard=True)); this dense-autodiff builder "
        "has no OOV metrics, so out-of-range ids would be silently "
        "clipped, the policy's failure mode. Use oov='clip'.")
  if oov == "allocate":
    raise NotImplementedError(
        "plan.oov='allocate' (dynamic vocabulary) rides the fused sparse "
        "path: the translator allocates into the packed class buffers and "
        "re-zeroes recycled rows' optimizer lanes, which this "
        "dense-autodiff builder does not hold. Use a static oov policy.")
  if getattr(plan, "dedup_capacity", None) is not None:
    raise NotImplementedError(
        "plan.dedup_capacity caps the dedup'd exchange's unique blocks "
        "below their safe bound, which is only legal next to the overflow "
        "counter that makes aliasing observable — this dense-autodiff "
        "builder has no metrics path. Use "
        "make_sparse_train_step(guard=True) (psum'd 'dedup_overflow' "
        "metric) or drop the capacity override.")


def _check_on(model: torch.nn.Module, dev: torch.device) -> None:
  if dev.type == "cuda" and dev.index is None:
    dev = torch.device("cuda", torch.cuda.current_device())
  for name, p in model.named_parameters():
    if p.device != dev:
      raise ValueError(f"parameter {name} lies on {p.device}, the step runs "
                       f"on {dev}: move the model first (shard_params)")


def _check_blocks(model: torch.nn.Module, mesh) -> None:
  """At world > 1 every embedding layer of ``model`` holds this rank's
  blocks: it was built with the mesh."""
  if mesh is None or mesh.world == 1:
    return
  for name, mod in model.named_modules():
    if not isinstance(mod, DistributedEmbedding):
      continue
    if mod.mesh is None or mod.mesh.rank != mesh.rank or \
        mod.plan.world_size != mesh.world:
      raise ValueError(
          f"embedding layer {name or '<model>'} holds no rank-{mesh.rank} "
          f"blocks of a world-{mesh.world} plan: build it with world_size="
          f"{mesh.world} and this rank's mesh, or cut a global state_dict "
          "with shard_params(params, mesh)")
    for key in mod.plan.class_keys:
      p = getattr(mod, class_param_name(*key))
      want = (padded_rows(mod.plan, key), mod.plan.classes[key].width)
      if tuple(p.shape) != want:
        raise ValueError(f"{name}.{class_param_name(*key)} has shape "
                         f"{tuple(p.shape)}, the rank block is {want}")


def _mean_over_ranks(loss: torch.Tensor, mesh) -> torch.Tensor:
  """The loss averaged over the ranks (the JAX step's ``pmean``)."""
  if mesh is None or mesh.world == 1:
    return loss
  loss = loss.clone()
  dist.all_reduce(loss)
  return loss / mesh.world


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module, mesh=None,
                    plan: Optional[DistEmbeddingStrategy] = None,
                    emb_collection: str = "embeddings", device="cuda"):
  """The dense-autodiff train step (the JAX ``make_train_step``).

  Args:
    loss_fn: ``loss_fn(model, numerical, cats, labels) -> scalar`` (mean
      over this rank's batch), running the model's forward through its
      embedding layer.
    optimizer: a ``torch.optim`` optimizer over the model's parameters,
      the class buffers included (``torch.optim.SGD`` for ``optax.sgd``).
      With a mesh it is wrapped in :class:`DistributedOptimizer`.
    model: the model; its embedding layer is the submodule
      ``emb_collection`` (a ``DistributedEmbedding``). With a mesh, every
      rank's model was built with its mesh (this rank's blocks, the
      replicated dense parameters equal on every rank:
      ``broadcast_variables``).
    mesh: this rank's :class:`~.parallel.mesh.Mesh` at world > 1 (every
      rank builds and calls the step), None at world 1.
    plan: when given, its tables' ``regularizer`` / ``constraint`` are
      honored: the penalties over this rank's class blocks join the loss
      (scaled by the world, so that they survive the ``1 / world`` of the
      gradients), and the constraints project this rank's tables after
      the update. Its ``oov`` policy must be ``'clip'`` and it may carry
      no ``dedup_capacity``, as in the JAX builder.
    device: where the model lies without a mesh (with one: the mesh's
      device); ``"cuda"`` unless the caller asks for the CPU.

  Returns:
    ``step(numerical, cats, labels) -> loss``, with this rank's slice of
    the batch (:func:`shard_batch`): the model and the optimizer are
    updated in place (the JAX step donates them); the loss includes the
    penalties and is averaged over the ranks. The gradients are dense,
    and dropped after the update (``zero_grad(set_to_none=True)``), so
    they hold memory only inside a step."""
  _refuse_dense_step(plan)
  if mesh is not None and plan is not None:
    _check_mesh(plan, mesh)
  dev = _state_device(device, mesh)
  _check_on(model, dev)
  _check_blocks(model, mesh)
  world = 1 if mesh is None else mesh.world
  rank = 0 if mesh is None else mesh.rank
  if world > 1 and not isinstance(optimizer, DistributedOptimizer):
    optimizer = DistributedOptimizer(optimizer, model, mesh)
  reg_fn = plan_regularizer_fn(plan) if plan is not None else None
  con_fn = plan_constraint_fn(plan) if plan is not None else None

  def emb_params():
    return dict(getattr(model, emb_collection).named_parameters())

  def step(numerical, cats, labels):
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, numerical, cats, labels)
    if reg_fn is not None:
      # this rank's windows, scaled by the world to survive the uniform
      # 1 / world gradient scale, as in the JAX step
      loss = loss + world * reg_fn(emb_params(), rank)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    if con_fn is not None:
      con_fn(emb_params(), rank)
    return _mean_over_ranks(loss.detach(), mesh)

  return step


def make_eval_step(pred_fn: Callable, model: torch.nn.Module, mesh=None):
  """The distributed forward for evaluation on simple-layout params (the
  JAX ``make_eval_step``): ``eval(*batch) -> pred_fn(model, *batch)``
  without autograd; it never writes the model. With a mesh every rank
  calls it on its slice of the batch (:func:`shard_batch`) and gets the
  global predictions, the ranks' slices in rank order (the batch's
  positional order)."""
  _check_blocks(model, mesh)

  @torch.inference_mode()
  def local_eval(*batch):
    preds = pred_fn(model, *batch)
    return preds if mesh is None else wire.gather_blocks(preds, mesh)

  return local_eval


def shard_params(params, mesh=None, device="cuda"):
  """Place a model or a dict of parameters on the step's device (the JAX
  ``shard_params``).

  Without a mesh: a module moves in place and is returned; a dict comes
  back as a new dict on ``device``. With a mesh: a dict of global leaves
  (a ``state_dict``, e.g. a JAX param tree through ``convert``) comes
  back with rank ``r``'s rows ``[r * rows, (r + 1) * rows)`` of every
  2-D ``mp_table_*`` leaf (``rows`` = its rows over the world) and every
  other leaf whole, all on the mesh's device; a module must already hold
  this rank's blocks (built with the mesh) and moves to the mesh's
  device."""
  if mesh is None:
    dev = resolve_device(device)
    if isinstance(params, torch.nn.Module):
      return params.to(dev)
    return {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
  if isinstance(params, torch.nn.Module):
    _check_blocks(params, mesh)
    return params.to(mesh.device)
  out = {}
  for name, leaf in params.items():
    t = torch.as_tensor(leaf)
    if is_model_parallel_leaf(name, t):
      if t.shape[0] % mesh.world:
        raise ValueError(f"{name}: {t.shape[0]} rows do not split into "
                         f"{mesh.world} rank blocks")
      n = t.shape[0] // mesh.world
      t = t[mesh.rank * n:(mesh.rank + 1) * n]
    out[name] = t.to(mesh.device).clone()
  return out
