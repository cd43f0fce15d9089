"""Carry weights and frozen tables across from the JAX package.

The JAX package's state is handed over as numpy arrays (the caller turns
its ``jax.Array`` leaves into numpy first; this module imports no JAX):

- :func:`dlrm_state_dict_from_flax`: the flax DLRM params
  ``{bottom_mlp, top_mlp}/dense_i/{kernel, bias}`` -> the port's
  ``DLRM.state_dict()`` (kernels ``[in, out]`` transpose to
  ``nn.Linear.weight [out, in]``); with ``embeddings/mp_table_*`` (a
  model that owns its tables, the dense-autodiff path) the class buffers
  become ``embeddings.mp_table_*`` (with ``mesh=``, this rank's blocks of
  a world-N tree). :func:`dlrm_state_dict_to_flax` is the way back;
- :func:`synthetic_state_dict_from_flax`: the flax ``SyntheticModel``
  params ``mlp/dense_i/{kernel, bias}`` (and ``embeddings/mp_table_*``;
  with ``mesh=``, this rank's blocks) -> the port's
  ``SyntheticModel.state_dict()``, :func:`synthetic_state_dict_to_flax`
  the way back; :func:`dense_state_dict_to_flax` and
  :func:`dense_state_dict_from_flax` pick the pair by model family (the
  serve artifact's ``dense.npz`` holds the flax tree);
- :func:`train_state_from_flax`: a JAX sparse train state
  (``{'fused', 'emb_dense', 'dense', 'dense_opt', 'emb_dense_opt',
  'step'}``) -> the state the port's ``training.make_sparse_train_step``
  steps and ``serving.freeze`` freezes (:func:`zoo_train_state_from_flax`
  for the synthetic zoo); :func:`train_state_to_flax` is the way back.
  bf16 leaves (narrow storage, ``ml_dtypes.bfloat16`` arrays) cross as
  their bits (``hostarrays``: no ``ml_dtypes`` import);
- :func:`optax_state_of` and :func:`install_optax_state`: a dense
  optimizer's state both ways between the port's ``torch.optim``
  optimizers and optax's, flattened in the JAX package's path spelling
  (``optax.sgd(lr)``: no leaves; ``optax.sgd(schedule)``: ``1/count``;
  momentum: ``0/trace/<param path>``; ``optax.adagrad``:
  ``0/sum_of_squares/<param path>``). Kernels are ``[in, out]`` in flax
  and ``[out, in]`` in torch; their optimizer states transpose alike;
- :func:`serve_state_from_frozen`: a JAX ``FrozenTables`` (its
  ``device_blocks``, ``emb_dense`` and ``dense``) -> the port's
  :class:`~.serving.export.FrozenTables`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .device import resolve_device
from .hostarrays import numpy_of, tensor_of
from .serving.export import FrozenTables, ServeClassMeta
from .training import Adagrad, Adam, OptaxState, ScheduledSGD, shard_params


def _tensor(x) -> torch.Tensor:
  return tensor_of(x)


def _mlps_state_dict(params: Dict[str, Any], mlps
                     ) -> Dict[str, torch.Tensor]:
  """flax ``<mlp>/dense_i/{kernel, bias}`` subtrees (numpy leaves) -> the
  port's ``<mlp>.layers.i.{weight, bias}``, and an ``embeddings`` subtree
  of class buffers -> ``embeddings.<class name>``; any other subtree
  raises."""
  out: Dict[str, torch.Tensor] = {
      f"embeddings.{name}": _tensor(buf)
      for name, buf in params.get("embeddings", {}).items()}
  params = {k: v for k, v in params.items() if k != "embeddings"}
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


def dlrm_state_dict_from_flax(params: Dict[str, Any], mesh=None
                              ) -> Dict[str, torch.Tensor]:
  """flax DLRM dense params (numpy leaves) -> the port's DLRM state_dict.
  An empty tree (a model without dense params) maps to ``{}``. With a
  ``mesh`` the tree is a world-N init (class buffers ``[world * rows,
  width]``) and the result is this rank's: its block of every class, the
  MLPs whole, on the mesh's device (``training.shard_params``), ready for
  ``load_state_dict`` into a model built with the mesh."""
  out = _mlps_state_dict(params, ("bottom_mlp", "top_mlp"))
  return out if mesh is None else shard_params(out, mesh)


def _flax_path(name: str, mlps) -> Tuple[str, bool]:
  """A state_dict entry's path in the flax tree and whether its value
  transposes on the way (``<mlp>.layers.i.weight`` [out, in] ->
  ``<mlp>/dense_i/kernel`` [in, out]; ``embeddings.<class name>`` ->
  ``embeddings/<class name>``; ``mlp`` in ``mlps``); any other entry
  raises."""
  parts = name.split(".")
  if parts[0] == "embeddings" and len(parts) == 2:
    return f"embeddings/{parts[1]}", False
  if len(parts) == 4 and parts[0] in mlps and parts[1] == "layers":
    mlp, _, i, leaf = parts
    return (f"{mlp}/dense_{i}/{'kernel' if leaf == 'weight' else leaf}",
            leaf == "weight")
  raise ValueError(f"no flax place for state_dict entry {name!r}")


def _mlps_to_flax(state_dict: Dict[str, torch.Tensor], mlps
                  ) -> Dict[str, Any]:
  """The port's ``<mlp>.layers.i.{weight, bias}`` (``mlp`` in ``mlps``)
  and ``embeddings.<class name>`` -> the flax tree as numpy
  (``<mlp>/dense_i/{kernel, bias}`` with kernels ``[in, out]``,
  ``embeddings/<class name>``; bf16 class buffers as their ``uint16``
  bits); any other entry raises."""
  tree: Dict[str, Any] = {}
  for key, t in state_dict.items():
    path, transpose = _flax_path(key, mlps)
    arr = numpy_of(t)
    *parents, leaf = path.split("/")
    node = tree
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = arr.T.copy() if transpose else arr
  return tree


def dlrm_state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, Any]:
  """The port's DLRM ``state_dict`` -> the flax DLRM param tree as numpy
  (``embeddings/<class name>``, ``<mlp>/dense_i/{kernel, bias}``): the
  inverse of :func:`dlrm_state_dict_from_flax`."""
  return _mlps_to_flax(state_dict, ("bottom_mlp", "top_mlp"))


def synthetic_state_dict_from_flax(params: Dict[str, Any], mesh=None
                                   ) -> Dict[str, torch.Tensor]:
  """flax ``SyntheticModel`` params (``mlp/dense_i/...`` and, for a model
  that owns its tables, ``embeddings/mp_table_*``; numpy leaves) -> the
  port's ``SyntheticModel.state_dict()``. With a ``mesh`` the tree is a
  world-N init and the result is this rank's: its block of every class,
  the MLP whole, on the mesh's device, as for
  :func:`dlrm_state_dict_from_flax`."""
  out = _mlps_state_dict(params, ("mlp",))
  return out if mesh is None else shard_params(out, mesh)


def synthetic_state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                                 ) -> Dict[str, Any]:
  """The port's ``SyntheticModel.state_dict()`` -> the flax param tree
  as numpy (``mlp/dense_i/{kernel, bias}``): the inverse of
  :func:`synthetic_state_dict_from_flax`."""
  return _mlps_to_flax(state_dict, ("mlp",))


def _is_synthetic(names) -> bool:
  """The model family of a state_dict's or flax tree's top-level names:
  the synthetic zoo's single ``mlp``, else the DLRM's two MLPs."""
  return any(n.split(".")[0] == "mlp" for n in names)


def dense_state_dict_to_flax(state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, Any]:
  """A model's ``state_dict`` -> its flax param tree (numpy), by model
  family (:class:`~.models.SyntheticModel` or :class:`~.models.DLRM`):
  the form of the serve artifact's ``dense.npz``."""
  if _is_synthetic(state_dict):
    return synthetic_state_dict_to_flax(state_dict)
  return dlrm_state_dict_to_flax(state_dict)


def dense_state_dict_from_flax(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
  """Inverse of :func:`dense_state_dict_to_flax`."""
  if _is_synthetic(params):
    return synthetic_state_dict_from_flax(params)
  return dlrm_state_dict_from_flax(params)


def flatten_paths(tree) -> Dict[str, Any]:
  """A pytree of dicts, tuples and namedtuples (an optax state, a flax
  param tree; numpy or tensor leaves) -> ``{'a/0/b': leaf}``, keyed as
  the JAX package's ``flatten_with_paths`` spells a path: dict keys,
  namedtuple field names, sequence indices, joined by ``/``. An already
  flat path-keyed dict comes back as it is; a namedtuple without fields
  (optax's ``EmptyState``) and None have no leaves."""
  flat: Dict[str, Any] = {}

  def walk(prefix, node):
    if node is None:
      return
    if isinstance(node, dict):
      items = node.items()
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
      items = ((f, getattr(node, f)) for f in node._fields)
    elif isinstance(node, (tuple, list)):
      items = enumerate(node)
    else:
      flat[prefix] = node
      return
    for k, v in items:
      walk(f"{prefix}/{k}" if prefix else str(k), v)

  walk("", tree)
  return flat


def optax_param_paths(names) -> Dict[str, Tuple[str, bool]]:
  """Per parameter name of a train state's ``dense`` part (a model's
  state_dict names) or ``emb_dense`` part (class names): its path in the
  optax state's parameter tree and whether its value transposes on the
  way (flax kernels ``[in, out]``, torch weights ``[out, in]``)."""
  names = list(names)
  mlps = ("mlp",) if _is_synthetic(names) else ("bottom_mlp", "top_mlp")
  # a class table (emb_dense) keeps its name
  return {name: (name, False) if "." not in name else _flax_path(name, mlps)
          for name in names}


def _optax_form(opt) -> Tuple[Tuple[str, ...], bool]:
  """``(slots, scheduled)`` of a port dense optimizer: its per-parameter
  optax slots (``('trace',)``, ``('sum_of_squares',)``, ``('mu', 'nu')``
  or none) and whether its optax state carries a schedule count
  (``1/count``). Optimizers without an optax counterpart in the port
  raise, naming what is supported."""
  if isinstance(opt, Adagrad):
    return ("sum_of_squares",), False
  if isinstance(opt, Adam):
    return ("mu", "nu"), callable(opt.defaults["lr"])
  if isinstance(opt, torch.optim.SGD):
    g = opt.defaults
    if g.get("nesterov") or g.get("dampening") or g.get("weight_decay") \
        or g.get("maximize"):
      raise NotImplementedError(
          "torch.optim.SGD with nesterov, dampening, weight_decay or "
          "maximize has no optax.sgd state to carry")
    return (("trace",) if g["momentum"] else ()), isinstance(opt,
                                                            ScheduledSGD)
  raise NotImplementedError(
      f"dense optimizer {type(opt).__name__}: the port carries the states "
      "of optax.sgd (torch.optim.SGD, training.ScheduledSGD for a "
      "schedule, momentum included), optax.adagrad (training.Adagrad) and "
      "optax.adam (training.Adam) only")


# optax slot -> the port optimizer's per-parameter state key
_OPTAX_SLOTS = {"trace": "momentum_buffer", "sum_of_squares": "sum",
                "mu": "mu", "nu": "nu"}


def _slot_fill(opt, slot: str, p: torch.Tensor) -> torch.Tensor:
  """A slot's initial value, before the optimizer's first step: Adagrad's
  ``initial_accumulator_value``, zeros otherwise; Adam's moments in the
  parameter's storage dtype (optax's init on a bf16 table)."""
  if slot == "sum_of_squares":
    return torch.full_like(p, opt.defaults["initial_accumulator_value"])
  return torch.zeros_like(p, dtype=getattr(p, "storage_dtype", p.dtype)
                          if slot in ("mu", "nu") else p.dtype)


def _host_leaf(t: torch.Tensor, transpose: bool):
  """A slot tensor as a host leaf: f32 numpy (a copy: on the CPU the array
  would alias the optimizer's state), or a bf16 slot (Adam's moments of a
  bf16 parameter) as a bf16 CPU tensor, which the checkpoint writes as
  its bits under the JAX package's ``'<V2'`` descr."""
  t = t.detach()
  if t.dtype == torch.bfloat16:
    t = t.cpu()
    return (t.T if transpose else t).contiguous().clone()
  arr = t.to(torch.float32).cpu().numpy()
  return arr.T.copy() if transpose else arr.copy()


def _leaf_tensor(x) -> torch.Tensor:
  """A flattened optax leaf (numpy, a bf16 ``ml_dtypes`` array, the
  2-byte voids ``np.load`` gives for one, or a tensor) as a CPU tensor of
  its bits."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu()
  return tensor_of(x)


def optax_state_of(opt, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
  """The port optimizer ``opt`` bound to ``params`` (name -> tensor, a
  train state's ``dense`` or ``emb_dense`` part) -> its optax state
  flattened in the JAX package's spelling, on the host: numpy, but bf16
  slots as bf16 CPU tensors (:func:`_host_leaf`). ``opt`` may be None for
  a part without tensors (no leaves then). A slot the torch optimizer has
  not created yet (before its first step) is its initial value
  (:func:`_slot_fill`). Adam adds its ``0/count``."""
  if opt is None:
    return {}
  slots, scheduled = _optax_form(opt)
  flat: Dict[str, Any] = {}
  if isinstance(opt, Adam):
    flat["0/count"] = np.asarray(opt.count, np.int32)
  for slot in slots:
    for name, (path, transpose) in optax_param_paths(params).items():
      p = params[name]
      val = opt.state.get(p, {}).get(_OPTAX_SLOTS[slot])
      if val is None:
        val = _slot_fill(opt, slot, p)
      flat[f"0/{slot}/{path}"] = _host_leaf(val, transpose)
  if scheduled:
    flat["1/count"] = np.asarray(opt.count, np.int32)
  return flat


def install_optax_state(opt, params: Dict[str, torch.Tensor],
                        flat: Dict[str, Any]) -> None:
  """Install a flattened optax state (:func:`optax_state_of`'s form,
  e.g. a JAX ``dense_opt.npz``) into the port optimizer ``opt`` bound to
  ``params``, so that its next step continues from it. Every leaf the
  optimizer keeps must be there with its shape (the JAX package's
  messages); leaves it does not keep are ignored, as the JAX restore
  ignores them, except a per-parameter slot of an optax optimizer the
  port has no counterpart for, which is refused by name. Adam's moments
  keep the leaf's dtype (bf16 moments as their bits), the other slots
  take the parameter's."""
  foreign = sorted(k for k in flat
                   if k not in ("0/count", "1/count") and k.split("/")[1:2]
                   and k.split("/")[1] not in _OPTAX_SLOTS)
  if foreign:
    raise NotImplementedError(
        f"optax state leaves {foreign[:4]} belong to an optimizer the port "
        "has no counterpart for: the port carries optax.sgd (schedule, "
        "momentum), optax.adagrad and optax.adam states")
  slots, scheduled = _optax_form(opt)
  for slot in slots:
    for name, (path, transpose) in optax_param_paths(params).items():
      key = f"0/{slot}/{path}"
      if key not in flat:
        raise ValueError(f"checkpoint is missing leaf {key!r}")
      p = params[name]
      val = _leaf_tensor(flat[key])
      want = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
      if tuple(val.shape) != want:
        raise ValueError(f"leaf {key!r} has shape {tuple(val.shape)} in "
                         f"the checkpoint, expected {want}")
      if transpose:
        val = val.T
      # Adam's moments keep the leaf's dtype (optax's own, e.g. a bf16
      # table's moments before its first step), other slots the param's
      dtype = val.dtype if slot in ("mu", "nu") else p.dtype
      opt.state[p][_OPTAX_SLOTS[slot]] = val.to(
          device=p.device, dtype=dtype).contiguous()
  if isinstance(opt, Adam):
    if "0/count" not in flat:
      raise ValueError("checkpoint is missing leaf '0/count'")
    opt.state["count"] = int(np.asarray(flat["0/count"]))
  if scheduled:
    if "1/count" not in flat:
      raise ValueError("checkpoint is missing leaf '1/count'")
    opt.state["count"] = int(np.asarray(flat["1/count"]))


def _row_leaf(key: str, names) -> bool:
  """Whether a flattened ``emb_dense_opt`` leaf is per-row state of a
  dense-class table (its path ends in the class name)."""
  return key.split("/")[-1] in names


def split_rank_state(state: Dict[str, Any], world: int,
                     rank: int) -> Dict[str, Any]:
  """A JAX world-``world`` train state (numpy leaves) -> rank ``rank``'s
  view: rows ``[rank * n, (rank + 1) * n)`` of every fused buffer, every
  dense-class block and every per-row optimizer leaf of the dense-class
  tables (``n`` = the buffer's rows over ``world``: the JAX package
  stacks the rank blocks along the row axis; ``emb_dense_opt`` comes
  back flattened), the dense params, their optimizer state and the step
  as they are (replicated)."""

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
  if state.get("emb_dense_opt") is not None:
    names = set(state["emb_dense"])
    out["emb_dense_opt"] = {
        k: block(v) if _row_leaf(k, names) else v
        for k, v in flatten_paths(state["emb_dense_opt"]).items()}
  return out


def join_rank_states(states) -> Dict[str, Any]:
  """The reverse of :func:`split_rank_state`: rank views in rank order ->
  the global state (the dense params and the step taken from rank 0)."""
  out = dict(states[0])
  for part in ("fused", "emb_dense"):
    out[part] = {k: np.concatenate([np.asarray(s[part][k]) for s in states])
                 for k in states[0][part]}
  if states[0].get("emb_dense_opt") is not None:
    names = set(states[0]["emb_dense"])
    flats = [flatten_paths(s["emb_dense_opt"]) for s in states]
    out["emb_dense_opt"] = {
        k: (np.concatenate([np.asarray(f[k]) for f in flats])
            if _row_leaf(k, names) else v)
        for k, v in flats[0].items()}
  return out


def _carried_opt(opt_state) -> Any:
  """A JAX optax state (a pytree or its flattened dict; numpy leaves) as
  the port state's pending :class:`~.training.OptaxState`, or None."""
  if opt_state is None:
    return None
  return OptaxState({k: np.asarray(v)
                     for k, v in flatten_paths(opt_state).items()})


def train_state_from_flax(state: Dict[str, Any], device="cuda",
                          mesh=None,
                          dense_state_dict: Callable = dlrm_state_dict_from_flax
                          ) -> Dict[str, Any]:
  """JAX sparse train state (numpy leaves) -> the port's train state on
  ``device``: every packed buffer whole (table and optimizer-state lanes),
  the dense-class tables, the dense params as the model's state_dict
  (``dense_state_dict``: the DLRM's by default), their optax states
  (``dense_opt``, ``emb_dense_opt``: optax pytrees or their flattened
  dicts, numpy leaves) and the step. The optax states ride the state as
  :class:`~.training.OptaxState`: the port's train step binds its
  ``torch.optim`` optimizers on first use and installs them
  (:func:`install_optax_state`), so a JAX run's Adagrad accumulators,
  momentum traces and schedule count continue. A state without them
  starts the optimizers at their initial state. With a ``mesh`` the state
  is this rank's view (:func:`split_rank_state`), on the mesh's
  device."""
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
      "dense_opt": _carried_opt(state.get("dense_opt")),
      "emb_dense_opt": _carried_opt(state.get("emb_dense_opt")),
      "step": int(np.asarray(state.get("step", 0))),
  }


def train_state_to_flax(state: Dict[str, Any],
                        dense_state_dict: Callable = dense_state_dict_to_flax
                        ) -> Dict[str, Any]:
  """The port's train state -> the JAX package's ``{'fused', 'emb_dense',
  'dense', 'step'}`` as numpy on the host (the way back of
  :func:`train_state_from_flax`, optimizer states aside: see
  :func:`optax_state_of`). bf16 buffers and tables come back as their
  ``uint16`` bits (``.view(ml_dtypes.bfloat16)`` on the JAX side); the
  dense parameters as the flax tree (``dense_state_dict``: picked by
  model family by default)."""
  return {
      "fused": {k: numpy_of(v) for k, v in state["fused"].items()},
      "emb_dense": {k: numpy_of(v) for k, v in state["emb_dense"].items()},
      "dense": dense_state_dict({k: v.detach().cpu()
                                 for k, v in state["dense"].items()}),
      "step": np.asarray(int(state.get("step", 0)), np.int32),
  }


def zoo_train_state_from_flax(state: Dict[str, Any], device="cuda",
                              mesh=None) -> Dict[str, Any]:
  """A JAX sparse train state of a ``SyntheticModel`` (e.g. from
  ``init_sparse_state_direct``; numpy leaves) -> the port's train state,
  as :func:`train_state_from_flax`."""
  return train_state_from_flax(state, device, mesh,
                               synthetic_state_dict_from_flax)


def _image_bytes(t: torch.Tensor) -> torch.Tensor:
  """An fp8 serve image (``ml_dtypes.float8_e4m3fn`` on the JAX side) as
  the port holds it, its int8 bytes; other images pass through."""
  return t.view(torch.int8) if t.dtype == torch.float8_e4m3fn else t


def _host_image(a):
  """A JAX host image (numpy; fp8 as ``ml_dtypes.float8_e4m3fn``) as the
  port holds it: numpy, an fp8 image as its int8 bytes."""
  if a is None:
    return None
  a = np.asarray(a)
  if a.dtype.itemsize == 1 and a.dtype not in (np.int8, np.uint8):
    return a.view(np.int8)
  return a


def serve_state_from_frozen(frozen) -> FrozenTables:
  """JAX ``serving.export.FrozenTables`` -> the port's ``FrozenTables``,
  tiered ones included (host images, ranking and counts carried as host
  numpy; fp8 images as their int8 bytes)."""
  meta = {
      name: ServeClassMeta(name=m.name, rows=m.rows, width=m.width,
                           tier=m.tier, quantize=m.quantize,
                           combine_rpp=m.combine_rpp)
      for name, m in frozen.meta.items()}
  return FrozenTables(
      quantize=frozen.quantize, step=int(frozen.step), meta=meta,
      device_blocks={name: [_image_bytes(_tensor(b)) for b in blocks]
                     for name, blocks in frozen.device_blocks.items()},
      dense=dlrm_state_dict_from_flax(frozen.dense),
      emb_dense={k: _tensor(v) for k, v in frozen.emb_dense.items()},
      host_images={name: [_host_image(img) for img in images]
                   for name, images in frozen.host_images.items()},
      ranking={name: [np.asarray(r) for r in orders]
               for name, orders in frozen.ranking.items()},
      counts={name: [np.asarray(c, np.int64) for c in cnts]
              for name, cnts in getattr(frozen, "counts", {}).items()})
