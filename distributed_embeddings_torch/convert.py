"""Carry weights and frozen tables across from the JAX package.

The JAX package's state is handed over as numpy arrays (the caller turns
its ``jax.Array`` leaves into numpy first; this module imports no JAX):

- :func:`dlrm_state_dict_from_flax`: the flax DLRM params
  ``{bottom_mlp, top_mlp}/dense_i/{kernel, bias}`` -> the port's
  ``DLRM.state_dict()`` (kernels ``[in, out]`` transpose to
  ``nn.Linear.weight [out, in]``);
- :func:`train_state_from_flax`: a JAX sparse train state
  (``{'fused', 'emb_dense', 'dense', 'step'}``) -> the state the port's
  ``training.make_sparse_train_step`` steps and ``serving.freeze``
  freezes;
- :func:`serve_state_from_frozen`: a JAX ``FrozenTables`` (its
  ``device_blocks``, ``emb_dense`` and ``dense``) -> the port's
  :class:`~.serving.export.FrozenTables`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .serving.export import FrozenTables, ServeClassMeta


def _tensor(x) -> torch.Tensor:
  return torch.tensor(np.asarray(x))


def dlrm_state_dict_from_flax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
  """flax DLRM dense params (numpy leaves) -> the port's DLRM state_dict.
  An empty tree (a model without dense params) maps to ``{}``."""
  out: Dict[str, torch.Tensor] = {}
  for mlp in ("bottom_mlp", "top_mlp"):
    layers = params.get(mlp, {})
    for i in range(len(layers)):
      dense = layers[f"dense_{i}"]
      out[f"{mlp}.layers.{i}.weight"] = _tensor(dense["kernel"]).t() \
          .contiguous()
      out[f"{mlp}.layers.{i}.bias"] = _tensor(dense["bias"])
  unknown = set(params) - {"bottom_mlp", "top_mlp"}
  if unknown:
    raise ValueError(f"unexpected flax param subtrees {sorted(unknown)}")
  return out


def train_state_from_flax(state: Dict[str, Any],
                          device="cuda") -> Dict[str, Any]:
  """JAX sparse train state (numpy leaves) -> the port's train state on
  ``device``: every packed buffer whole (table and optimizer-state lanes),
  the dense-class tables, the dense params as a DLRM state_dict, and the
  step. The optax states are not carried: the port's train step binds its
  ``torch.optim`` optimizers on first use (SGD keeps no state)."""
  dev = resolve_device(device)
  return {
      "fused": {k: _tensor(v).to(dev) for k, v in state["fused"].items()},
      "emb_dense": {k: _tensor(v).to(dev)
                    for k, v in state["emb_dense"].items()},
      "dense": {k: v.to(dev)
                for k, v in dlrm_state_dict_from_flax(state["dense"]).items()},
      "step": int(np.asarray(state.get("step", 0))),
  }


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
