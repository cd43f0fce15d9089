"""DistributedEmbedding: the hybrid model-parallel embedding layer
(PyTorch port of ``layers/dist_model_parallel.py``).

The layer owns one ``nn.Parameter`` per (width, combiner) class of its
plan, named by ``class_param_name`` (``mp_table_w128_cat``, ...). Without
a mesh it holds all ranks' fused tables stacked row-wise, ``[world *
padded_rows, width]``, rank r's block at rows ``[r * padded_rows, (r + 1)
* padded_rows)``, as the JAX layer's class params (at world 1 the whole
table; at world > 1 the buffers serve :func:`get_weights` /
:func:`set_weights`, which are plan arithmetic at any world size). With a
``mesh`` (one process per rank over ``torch.distributed``) it holds only
this rank's block of every class, ``[padded_rows, width]``: what the
JAX layer's ``shard_map`` cuts out of the global array.

Its forward is the lookup engine's differentiable lookup
(``parallel/lookup_engine.py: DistributedLookup.forward``), so a loss's
``backward()`` gives every class buffer its dense gradient; at world > 1
the wire's backward brings each rank the cotangents of the rows it owns.

The hybrid-parallel training helpers follow (the JAX package's
``:388-500``). JAX replicates the dense parameters by sharding; the port
runs a process per rank, so its helpers do real work:
:func:`finalize_hybrid_grads` sums the replicated gradients over the
ranks and scales every gradient by ``1 / world``,
:class:`DistributedOptimizer` runs it before each step, and
:func:`broadcast_variables` copies the replicated parameters from a root
rank.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..parallel.lookup_engine import (
    DistributedLookup,
    class_param_name,
    padded_rows,
)
from .embedding import resolve_initializer
from .planner import DistEmbeddingStrategy

MP_PARAM_PREFIX = "mp_table_"


def is_model_parallel_param(path_element_names: Sequence[str]) -> bool:
  """True if a parameter path (its names, e.g. ``name.split(".")``)
  belongs to a sharded embedding table."""
  return any(str(p).startswith(MP_PARAM_PREFIX) for p in path_element_names)


def make_class_initializer(plan: DistEmbeddingStrategy, key,
                           rank: Optional[int] = None):
  """Initializer of one class buffer: ``init(generator, dtype=
  torch.float32, device=None)``, ``[world * padded_rows, width]``, or with
  ``rank`` only that rank's block ``[padded_rows, width]``.

  Each member shard's rows are drawn from its own table's initializer at
  the shard's shape (column slices draw independently, as in the
  reference, where each slice is its own variable), one shard after
  another from the one generator; padding rows are zero. The JAX
  initializer splits a key per shard instead: the two match in
  distribution, not in bits."""
  cp = plan.classes[key]
  ranks = range(plan.world_size) if rank is None else [rank]
  rows = padded_rows(plan, key)

  def init(generator, dtype=torch.float32, device=None):
    out = torch.zeros((len(ranks) * rows, cp.width), dtype=dtype,
                      device=device)
    for i, r in enumerate(ranks):
      r0 = i * rows
      for sh, off in zip(cp.shards_per_rank[r], cp.row_offsets_per_rank[r]):
        fn = resolve_initializer(sh.initializer)
        out[r0 + off:r0 + off + sh.input_dim] = fn(
            generator, (sh.input_dim, cp.width), dtype, device)
    return out

  return init


class DistributedEmbedding(nn.Module):
  """Hybrid-parallel distributed embedding layer.

  Args:
    embeddings: global list of ``TableConfig``s / ``Embedding`` layer
      configs / dicts.
    strategy: 'basic' | 'memory_balanced' | 'memory_optimized'.
    column_slice_threshold / row_slice / input_table_map / world_size /
      dense_row_threshold / input_hotness / batch_hint: the planner's
      arguments, as for the JAX layer.
    dp_input: True: data-parallel inputs, this rank's ``[B]`` / ``[B, H]``
      ids or :class:`~..ops.ragged.RaggedIds` (declare a ragged input with
      a negative ``input_hotness`` entry so the planner keeps its table
      sparse). False: model-parallel inputs, this rank's block of
      :func:`~..parallel.lookup_engine.pack_mp_inputs` (packed with this
      layer's ``input_hotness``); no id exchange runs.
    overlap / exchange_chunks: the plan's wire schedule (``'none'``,
      ``'pipelined'`` or ``'fused'``; the JAX layer's plan always takes
      ``'none'``). All three give the same values.
    wire_dtype / dedup_exchange: the plan's wire compression (the
      README's ``'f32'`` / ``'bf16'`` / ``'fp8'`` float wire and the
      deduplicated exchange; the JAX layer's plan takes the defaults). The
      f32 dedup forward gives the raw exchange's values bit for bit.
    mesh: this rank's :class:`~..parallel.mesh.Mesh` (``mesh.world ==
      world_size``): the layer then holds this rank's blocks only, on the
      mesh's device, and its forward runs the exchanges over the mesh's
      process group (every rank calls it on its slice of the batch).
    device: where the class buffers live without a mesh; ``"cuda"``
      unless the caller asks for the CPU.
    generator: the ``torch.Generator`` of the initial draws (on the
      buffers' device; None takes PyTorch's default generator). With a
      mesh only this rank's shards are drawn: seed it per rank.
  """

  def __init__(self, embeddings: Sequence[Any], strategy: str = "basic",
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None, dp_input: bool = True,
               input_table_map: Optional[Sequence[int]] = None,
               world_size: int = 1, dense_row_threshold: int = 0,
               input_hotness: Optional[Sequence[int]] = None,
               batch_hint: Optional[int] = None, overlap: str = "none",
               exchange_chunks: int = 1, wire_dtype: str = "f32",
               dedup_exchange: bool = False, mesh=None, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    if row_slice is not None and (isinstance(row_slice, bool)
                                  or not isinstance(row_slice, int)):
      raise TypeError(
          f"row_slice must be an int element threshold, got {row_slice!r}")
    self.dp_input = dp_input
    self.input_hotness = (list(input_hotness) if input_hotness is not None
                          else None)
    dev = mesh.device if mesh is not None else resolve_device(device)
    self.plan = DistEmbeddingStrategy(
        list(embeddings), world_size, strategy,
        input_table_map=(list(input_table_map)
                         if input_table_map is not None else None),
        column_slice_threshold=column_slice_threshold,
        dense_row_threshold=dense_row_threshold,
        row_slice_threshold=row_slice,
        input_hotness=(list(input_hotness)
                       if input_hotness is not None else None),
        batch_hint=batch_hint, overlap=overlap,
        exchange_chunks=exchange_chunks, wire_dtype=wire_dtype,
        dedup_exchange=dedup_exchange)
    self.mesh = mesh
    self.engine = DistributedLookup(self.plan, mesh=mesh)
    rank = None if mesh is None else mesh.rank
    for key in self.plan.class_keys:
      self.register_parameter(
          class_param_name(*key),
          nn.Parameter(make_class_initializer(self.plan, key, rank)(
              generator, torch.float32, dev)))

  def class_params(self) -> Dict[str, torch.Tensor]:
    """Class name -> its buffer (the parameters themselves)."""
    return {class_param_name(*k): getattr(self, class_param_name(*k))
            for k in self.plan.class_keys}

  def forward(self, inputs, return_oov: bool = False):
    """Per global input its ``[B, output_dim]`` activations (``B`` this
    rank's batch). With ``return_oov``, ``(activations, oov)``: the
    per-class counts of ids outside their table's vocabulary in this
    batch (``oov_<class>`` -> int32 scalar, the JAX layer's opt-in
    ``'metrics'`` collection), summed over the ranks at world > 1 as the
    JAX layer psums them. Model-parallel inputs (``dp_input=False``)
    arrive routed and clipped by ``pack_mp_inputs``: their dict is empty,
    as the JAX layer records nothing for them."""
    if not self.dp_input:
      outs = self.engine.forward_mp(self.class_params(), inputs,
                                    hotness=self.input_hotness)
      return (outs, {}) if return_oov else outs
    outs = self.engine.forward(self.class_params(), inputs)
    if not return_oov:
      return outs
    oov = self.engine.oov_counts(inputs)
    if self.mesh is not None and self.mesh.world > 1:
      names = list(oov)
      total = torch.stack([oov[n] for n in names])
      dist.all_reduce(total)
      oov = dict(zip(names, total.unbind()))
    return outs, {f"oov_{name}": c for name, c in oov.items()}


# ---------------------------------------------------------------------------
# Global-view checkpoint get/set (reference `dist_model_parallel.py:471-664`)
# ---------------------------------------------------------------------------


def _rows_of(arr, row0: int, n: int) -> np.ndarray:
  if isinstance(arr, torch.Tensor):
    return arr[row0:row0 + n].detach().cpu().numpy()
  return np.asarray(arr[row0:row0 + n])


def get_weights(plan: DistEmbeddingStrategy,
                class_params: Dict[str, Any]) -> List[np.ndarray]:
  """The global per-table weights from class-stacked params (tensors or
  numpy arrays ``[world * padded_rows, width]``), as numpy: each rank's
  fused rows unstacked, concat fusion undone by the shards' row offsets,
  column (or row) slices concatenated in order. The inverse of
  :func:`set_weights`."""
  weights = []
  for t in range(len(plan.global_configs)):
    parts = []
    row_sliced = False
    for rank, shard in plan.table_shard_map(t):
      key = plan.class_key_of(shard)
      cp = plan.classes[key]
      idx = cp.shards_per_rank[rank].index(shard)
      row0 = rank * padded_rows(plan, key) + \
          cp.row_offsets_per_rank[rank][idx]
      parts.append(_rows_of(class_params[class_param_name(*key)], row0,
                            shard.input_dim))
      row_sliced = shard.row_sliced
    if len(parts) == 1:
      weights.append(parts[0])
    else:
      # table_shard_map orders by (col_start, row_start); a table is
      # sliced along exactly one dim, so this is a plain concat either way
      weights.append(np.concatenate(parts, axis=0 if row_sliced else 1))
  return weights


def set_weights(plan: DistEmbeddingStrategy,
                weights: Sequence[Union[np.ndarray, str]]
                ) -> Dict[str, np.ndarray]:
  """Class-stacked params ``name -> [world * padded_rows, width]`` (numpy
  f32) from global per-table weights (``[input_dim, output_dim]`` arrays
  or ``.npy`` paths, memory-mapped); padding rows are zero. Load them into
  a layer with ``layer.load_state_dict({k: torch.as_tensor(v) ...},
  strict=False)`` or copy them into its parameters."""
  if len(weights) != len(plan.global_configs):
    raise ValueError(
        f"Expected {len(plan.global_configs)} weights, got {len(weights)}")
  loaded = [np.load(w, mmap_mode="r") if isinstance(w, str) else np.asarray(w)
            for w in weights]
  for t, (w, cfg) in enumerate(zip(loaded, plan.global_configs)):
    if w.shape != (cfg.input_dim, cfg.output_dim):
      raise ValueError(f"weights[{t}] has shape {w.shape}, expected "
                       f"{(cfg.input_dim, cfg.output_dim)}")
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    rows = padded_rows(plan, key)
    blocks = []
    for rank in range(plan.world_size):
      block = np.zeros((rows, cp.width), np.float32)
      for idx, shard in enumerate(cp.shards_per_rank[rank]):
        row0 = cp.row_offsets_per_rank[rank][idx]
        block[row0:row0 + shard.input_dim] = (
            loaded[shard.table_id][
                shard.row_start:shard.row_start + shard.input_dim,
                shard.col_start:shard.col_end])
      blocks.append(block)
    out[class_param_name(*key)] = np.concatenate(blocks)
  return out


# ---------------------------------------------------------------------------
# Hybrid-parallel training utilities (the JAX package's `:388-500`,
# replacing the reference Horovod shims, `dist_model_parallel.py:696-799`)
# ---------------------------------------------------------------------------


def _named_leaves(tree, prefix: str = ""):
  """``(name, leaf)`` pairs of a module (its parameters), a mapping
  (nested mappings joined with ``"."``) or an iterable of pairs."""
  if isinstance(tree, nn.Module):
    yield from tree.named_parameters()
    return
  items = tree.items() if isinstance(tree, Mapping) else tree
  for name, leaf in items:
    path = f"{prefix}.{name}" if prefix else str(name)
    if isinstance(leaf, Mapping):
      yield from _named_leaves(leaf, path)
    else:
      yield path, leaf


def is_model_parallel_leaf(name: str, leaf) -> bool:
  """True for a class buffer: a 2-D leaf under an ``mp_table_*`` name
  (dotted), cut by rows over the ranks; every other leaf is
  replicated."""
  return (is_model_parallel_param(name.split("."))
          and getattr(leaf, "ndim", 0) == 2)


def hybrid_partition_specs(tree):
  """The hybrid partition of a named tree: the same structure with each
  leaf replaced by ``"mp"`` (a 2-D leaf under an ``mp_table_*`` name: a
  class buffer, cut by rows over the ranks) or ``"replicated"``
  (everything else: the dense parameters, scalars). ``tree`` is a module
  (its ``named_parameters``), a ``state_dict``, or nested mappings, such
  as a ``torch.optim`` optimizer's state keyed by parameter name
  (``{name: optimizer.state[p] for name, p in model.named_parameters()}``:
  Adagrad's ``sum`` of a class buffer is ``"mp"``, its ``step``
  ``"replicated"``). The JAX package returns ``PartitionSpec``s of the
  same split."""
  if isinstance(tree, nn.Module):
    tree = dict(tree.named_parameters())

  def spec(node, prefix):
    out = {}
    for name, leaf in node.items():
      path = f"{prefix}.{name}" if prefix else str(name)
      if isinstance(leaf, Mapping):
        out[name] = spec(leaf, path)
      else:
        out[name] = "mp" if is_model_parallel_leaf(path, leaf) else "replicated"
    return out

  return spec(tree, "")


def _world_of(mesh) -> int:
  if mesh is not None:
    return mesh.world
  return dist.get_world_size() if dist.is_initialized() else 1


def finalize_hybrid_grads(named_params, mesh=None) -> None:
  """Turn every rank's local-mean gradients into the global-batch-mean
  gradients, in place (``.grad``).

  ``named_params`` is a module, a mapping or ``(name, parameter)`` pairs
  (the same on every rank). Each rank's ``loss.backward()`` on its local
  batch mean leaves, per leaf:

  - replicated (dense) parameters: this rank's gradient only. They are
    summed over the ranks with one ``all_reduce`` of all of them
    flattened together (a missing gradient counts as zeros, so every
    rank sends the same shape);
  - ``mp_table_*`` class blocks: the gradient of this rank's rows from
    every rank's samples, which the wire's reverse exchange already
    brought here. They are never summed.

  Both are then ``world`` times the global-batch-mean gradient, so every
  gradient is scaled by ``1 / world``. At world 1 nothing changes."""
  world = _world_of(mesh)
  if world == 1:
    return
  params = list(_named_leaves(named_params))
  dense = [p for name, p in params if not is_model_parallel_leaf(name, p)]
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
  scale = 1.0 / world
  for _, p in params:
    if p.grad is not None:
      p.grad.mul_(scale)
    if getattr(p, "wide_grad", None) is not None:
      p.wide_grad.mul_(scale)  # a class block's f32 gradient, never summed


class DistributedOptimizer:
  """A ``torch.optim`` optimizer for the hybrid-parallel step (the JAX
  package's optax wrapper): :meth:`step` runs
  :func:`finalize_hybrid_grads` over ``model``'s parameters and then the
  inner optimizer's step, so the ``mp_table_*`` blocks update locally and
  the replicated parameters alike on every rank. ``zero_grad``,
  ``state_dict`` and ``param_groups`` are the inner optimizer's."""

  def __init__(self, optimizer: torch.optim.Optimizer, model: nn.Module,
               mesh=None):
    self.optimizer = optimizer
    self.model = model
    self.mesh = mesh

  def step(self, closure=None):
    finalize_hybrid_grads(self.model, self.mesh)
    return self.optimizer.step(closure)

  def zero_grad(self, set_to_none: bool = True) -> None:
    self.optimizer.zero_grad(set_to_none=set_to_none)

  def state_dict(self):
    return self.optimizer.state_dict()

  @property
  def param_groups(self):
    return self.optimizer.param_groups


@torch.no_grad()
def broadcast_variables(variables, root_rank: int = 0, mesh=None):
  """Copy every replicated leaf of ``variables`` (a module's parameters
  and buffers, or a mapping of tensors) from ``root_rank`` to every rank,
  in place, with one ``broadcast`` of them flattened together; the
  ``mp_table_*`` blocks, which differ by rank, are left alone. Returns
  ``variables``. The JAX package's replicated parameters are one buffer
  by construction, so its version returns them unchanged; so does this
  one at world 1."""
  if _world_of(mesh) == 1:
    return variables
  if isinstance(variables, nn.Module):
    leaves = list(variables.named_parameters()) + list(
        variables.named_buffers())
  else:
    leaves = list(_named_leaves(variables))
  rep = [t for name, t in leaves if not is_model_parallel_leaf(name, t)]
  if rep:
    flat = torch.cat([t.detach().reshape(-1) for t in rep])
    dist.broadcast(flat, root_rank)
    off = 0
    for t in rep:
      n = t.numel()
      t.copy_(flat[off:off + n].view_as(t))
      off += n
  return variables


def DistributedGradientTape(*args, **kwargs):
  """The reference patches Horovod's tape to mix local (model-parallel)
  and all-reduced (data-parallel) gradients in one backward
  (`dist_model_parallel.py:715-740`). PyTorch has no tape: call
  ``loss.backward()`` and step a :class:`DistributedOptimizer`, or pass
  the gradients through :func:`finalize_hybrid_grads`."""
  raise NotImplementedError(
      "PyTorch has no gradient tape: call loss.backward() and step a "
      "DistributedOptimizer, or run finalize_hybrid_grads on the "
      "gradients before the optimizer step, for hybrid parallel")


class BroadcastGlobalVariablesCallback:
  """The reference's Keras callback (`dist_model_parallel.py:776-799`):
  on its first ``on_batch_end`` it broadcasts the replicated variables
  from ``root_rank`` (:func:`broadcast_variables`), and does nothing
  after that, so ranks that started from different draws train one
  model."""

  def __init__(self, root_rank: int = 0, variables=None, mesh=None):
    self.root_rank = root_rank
    self.variables = variables
    self.mesh = mesh
    self.broadcast_done = False

  def on_batch_end(self, batch, logs=None):
    del batch, logs
    if self.broadcast_done:
      return
    broadcast_variables(self.variables, self.root_rank, self.mesh)
    self.broadcast_done = True
