"""DistributedEmbedding: the hybrid model-parallel embedding layer
(PyTorch port of ``layers/dist_model_parallel.py``).

The layer owns one ``nn.Parameter`` per (width, combiner) class of its
plan, named by ``class_param_name`` (``mp_table_w128_cat``, ...): all
ranks' fused tables stacked row-wise, ``[world * padded_rows, width]``,
rank r's block at rows ``[r * padded_rows, (r + 1) * padded_rows)``, as
the JAX layer's class params. Its forward is the lookup engine's
differentiable lookup (``parallel/lookup_engine.py:
DistributedLookup.forward``), so a loss's ``backward()`` gives every class
buffer its dense gradient.

The forward runs at world 1. A world > 1 layer can be built (its plan and
its global buffers, for :func:`get_weights` / :func:`set_weights`, which
are plan arithmetic at any world size), but its forward raises: the
lookup over the wire's autograd Functions, ``DistributedOptimizer`` and
``finalize_hybrid_grads`` are not ported yet (``ROADMAP.md``, queue C).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
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


def make_class_initializer(plan: DistEmbeddingStrategy, key):
  """Initializer of one class buffer ``[world * padded_rows, width]``:
  ``init(generator, dtype=torch.float32, device=None)``.

  Each member shard's rows are drawn from its own table's initializer at
  the shard's shape (column slices draw independently, as in the
  reference, where each slice is its own variable), one shard after
  another from the one generator; padding rows are zero. The JAX
  initializer splits a key per shard instead: the two match in
  distribution, not in bits."""
  cp = plan.classes[key]
  world = plan.world_size
  rows = padded_rows(plan, key)

  def init(generator, dtype=torch.float32, device=None):
    out = torch.zeros((world * rows, cp.width), dtype=dtype, device=device)
    for rank in range(world):
      r0 = rank * rows
      for sh, off in zip(cp.shards_per_rank[rank],
                         cp.row_offsets_per_rank[rank]):
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
    dp_input: True (data-parallel ``[B]`` / ``[B, H]`` inputs); the packed
      model-parallel inputs (False) are not ported yet.
    device: where the class buffers live; ``"cuda"`` unless the caller asks
      for the CPU.
    generator: the ``torch.Generator`` of the initial draws (on
      ``device``; None takes PyTorch's default generator).
  """

  def __init__(self, embeddings: Sequence[Any], strategy: str = "basic",
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None, dp_input: bool = True,
               input_table_map: Optional[Sequence[int]] = None,
               world_size: int = 1, dense_row_threshold: int = 0,
               input_hotness: Optional[Sequence[int]] = None,
               batch_hint: Optional[int] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    if row_slice is not None and (isinstance(row_slice, bool)
                                  or not isinstance(row_slice, int)):
      raise TypeError(
          f"row_slice must be an int element threshold, got {row_slice!r}")
    if not dp_input:
      raise NotImplementedError(
          "dp_input=False (packed model-parallel inputs, forward_mp / "
          "pack_mp_inputs) is not ported yet: ROADMAP.md open items, "
          "queue C")
    dev = resolve_device(device)
    self.plan = DistEmbeddingStrategy(
        list(embeddings), world_size, strategy,
        input_table_map=(list(input_table_map)
                         if input_table_map is not None else None),
        column_slice_threshold=column_slice_threshold,
        dense_row_threshold=dense_row_threshold,
        row_slice_threshold=row_slice,
        input_hotness=(list(input_hotness)
                       if input_hotness is not None else None),
        batch_hint=batch_hint)
    self.engine = DistributedLookup(self.plan)
    for key in self.plan.class_keys:
      self.register_parameter(
          class_param_name(*key),
          nn.Parameter(make_class_initializer(self.plan, key)(
              generator, torch.float32, dev)))

  def class_params(self) -> Dict[str, torch.Tensor]:
    """Class name -> its buffer (the parameters themselves)."""
    return {class_param_name(*k): getattr(self, class_param_name(*k))
            for k in self.plan.class_keys}

  def forward(self, inputs: Sequence, return_oov: bool = False):
    """Per global input its ``[B, output_dim]`` activations. With
    ``return_oov``, ``(activations, oov)``: the per-class counts of ids
    outside their table's vocabulary in this batch (``oov_<class>`` ->
    int32 scalar, the JAX layer's opt-in ``'metrics'`` collection). At
    ``world_size > 1`` the engine's forward raises: not ported yet."""
    outs = self.engine.forward(self.class_params(), inputs)
    if not return_oov:
      return outs
    return outs, {f"oov_{name}": c
                  for name, c in self.engine.oov_counts(inputs).items()}


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
