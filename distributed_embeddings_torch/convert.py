"""Carry weights and frozen tables across from the JAX package.

The JAX package's state is handed over as numpy arrays (the caller turns
its ``jax.Array`` leaves into numpy first; this module imports no JAX):

- :func:`dlrm_state_dict_from_flax`: the flax DLRM params
  ``{bottom_mlp, top_mlp}/dense_i/{kernel, bias}`` -> the port's
  ``DLRM.state_dict()`` (kernels ``[in, out]`` transpose to
  ``nn.Linear.weight [out, in]``);
- :func:`synthetic_state_dict_from_flax`: the flax ``SyntheticModel``
  params ``mlp/dense_i/{kernel, bias}`` -> the port's
  ``SyntheticModel.state_dict()``;
- :func:`train_state_from_flax`: a JAX sparse train state
  (``{'fused', 'emb_dense', 'dense', 'step'}``) -> the state the port's
  ``training.make_sparse_train_step`` steps and ``serving.freeze``
  freezes (:func:`zoo_train_state_from_flax` for the synthetic zoo);
- :func:`serve_state_from_frozen`: a JAX ``FrozenTables`` (its
  ``device_blocks``, ``emb_dense`` and ``dense``) -> the port's
  :class:`~.serving.export.FrozenTables`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .device import resolve_device
from .serving.export import FrozenTables, ServeClassMeta


def _tensor(x) -> torch.Tensor:
  return torch.tensor(np.asarray(x))


def _mlps_state_dict(params: Dict[str, Any], mlps
                     ) -> Dict[str, torch.Tensor]:
  """flax ``<mlp>/dense_i/{kernel, bias}`` subtrees (numpy leaves) -> the
  port's ``<mlp>.layers.i.{weight, bias}``; any other subtree raises."""
  out: Dict[str, torch.Tensor] = {}
  for mlp in mlps:
    layers = params.get(mlp, {})
    for i in range(len(layers)):
      dense = layers[f"dense_{i}"]
      out[f"{mlp}.layers.{i}.weight"] = _tensor(dense["kernel"]).t() \
          .contiguous()
      out[f"{mlp}.layers.{i}.bias"] = _tensor(dense["bias"])
  unknown = set(params) - set(mlps)
  if unknown:
    raise ValueError(f"unexpected flax param subtrees {sorted(unknown)}")
  return out


def dlrm_state_dict_from_flax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
  """flax DLRM dense params (numpy leaves) -> the port's DLRM state_dict.
  An empty tree (a model without dense params) maps to ``{}``."""
  return _mlps_state_dict(params, ("bottom_mlp", "top_mlp"))


def synthetic_state_dict_from_flax(params: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
  """flax ``SyntheticModel`` dense params (``mlp/dense_i/...``, numpy
  leaves) -> the port's ``SyntheticModel.state_dict()``."""
  return _mlps_state_dict(params, ("mlp",))


def split_rank_state(state: Dict[str, Any], world: int,
                     rank: int) -> Dict[str, Any]:
  """A JAX world-``world`` train state (numpy leaves) -> rank ``rank``'s
  view: rows ``[rank * n, (rank + 1) * n)`` of every fused buffer and every
  dense-class block (``n`` = the buffer's rows over ``world``: the JAX
  package stacks the rank blocks along the row axis), the dense params
  and the step as they are (replicated)."""

  def block(arr):
    arr = np.asarray(arr)
    if arr.shape[0] % world:
      raise ValueError(f"{arr.shape[0]} rows do not split into {world} "
                       "rank blocks")
    n = arr.shape[0] // world
    return arr[rank * n:(rank + 1) * n]

  out = dict(state)
  for part in ("fused", "emb_dense"):
    out[part] = {k: block(v) for k, v in state[part].items()}
  return out


def join_rank_states(states) -> Dict[str, Any]:
  """The reverse of :func:`split_rank_state`: rank views in rank order ->
  the global state (the dense params and the step taken from rank 0)."""
  out = dict(states[0])
  for part in ("fused", "emb_dense"):
    out[part] = {k: np.concatenate([np.asarray(s[part][k]) for s in states])
                 for k in states[0][part]}
  return out


def train_state_from_flax(state: Dict[str, Any], device="cuda",
                          mesh=None,
                          dense_state_dict: Callable = dlrm_state_dict_from_flax
                          ) -> Dict[str, Any]:
  """JAX sparse train state (numpy leaves) -> the port's train state on
  ``device``: every packed buffer whole (table and optimizer-state lanes),
  the dense-class tables, the dense params as the model's state_dict
  (``dense_state_dict``: the DLRM's by default), and the step. The optax
  states are not carried: the port's train step binds its ``torch.optim``
  optimizers on first use, at their initial state (SGD keeps none; for
  Adagrad this is exact for a state that has not stepped yet). With a
  ``mesh`` the state is this rank's view (:func:`split_rank_state`), on
  the mesh's device."""
  if mesh is not None:
    state = split_rank_state(state, mesh.world, mesh.rank)
    device = mesh.device
  dev = resolve_device(device)
  return {
      "fused": {k: _tensor(v).to(dev) for k, v in state["fused"].items()},
      "emb_dense": {k: _tensor(v).to(dev)
                    for k, v in state["emb_dense"].items()},
      "dense": {k: v.to(dev)
                for k, v in dense_state_dict(state["dense"]).items()},
      "step": int(np.asarray(state.get("step", 0))),
  }


def zoo_train_state_from_flax(state: Dict[str, Any], device="cuda",
                              mesh=None) -> Dict[str, Any]:
  """A JAX sparse train state of a ``SyntheticModel`` (e.g. from
  ``init_sparse_state_direct``; numpy leaves) -> the port's train state,
  as :func:`train_state_from_flax`."""
  return train_state_from_flax(state, device, mesh,
                               synthetic_state_dict_from_flax)


def serve_state_from_frozen(frozen) -> FrozenTables:
  """JAX ``serving.export.FrozenTables`` -> the port's ``FrozenTables``
  (non-tiered: ``host_images`` must be empty)."""
  if frozen.host_images:
    raise NotImplementedError("tiered frozen tables are not ported yet")
  meta = {
      name: ServeClassMeta(name=m.name, rows=m.rows, width=m.width,
                           tier=m.tier, quantize=m.quantize,
                           combine_rpp=m.combine_rpp)
      for name, m in frozen.meta.items()}
  return FrozenTables(
      quantize=frozen.quantize, step=int(frozen.step), meta=meta,
      device_blocks={name: [_tensor(b) for b in blocks]
                     for name, blocks in frozen.device_blocks.items()},
      dense=dlrm_state_dict_from_flax(frozen.dense),
      emb_dense={k: _tensor(v) for k, v in frozen.emb_dense.items()})
