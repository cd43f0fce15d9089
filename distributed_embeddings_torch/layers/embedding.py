"""Embedding layers (PyTorch port of ``layers/embedding.py``).

- :class:`Embedding`: plain and combiner (multi-hot) lookups over dense,
  ragged and sparse ids, the reference's Keras ``Embedding`` as an
  ``nn.Module``;
- :class:`ConcatOneHotEmbedding`: N one-hot tables fused into one weight;
- :class:`TableConfig`: the plain-data table description the planner
  reads (``from_layer`` / ``to_layer``);
- the Keras-named initializers, regularizers and constraints, resolved to
  callables.

An initializer here is ``init(generator, shape, dtype, device) ->
tensor``: the ``torch.Generator`` stands where ``jax.random`` takes a key.
The two frameworks draw different numbers from the same seed, so an
initializer matches its JAX twin's distribution, not its bits.

Regularizer penalties are recorded per forward in the layer's ``losses``
dict (the JAX layer sows them into its ``"losses"`` collection): the
table penalty once, overwritten on every call; the activity penalty
summed over the calls. :func:`collect_regularization_losses` sums them
and starts a new collection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.embedding_lookup import embedding_lookup
from ..ops.ragged import RaggedIds, SparseIds

Initializer = Callable[..., torch.Tensor]

# flax's truncated normal keeps [-2, 2] standard units and rescales the
# stddev by this, so the draw keeps the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _keras_uniform(scale=0.05):
  def init(generator, shape, dtype=torch.float32, device=None):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -scale, scale, generator=generator)
  # read by the direct packed-state initializer
  # (training.init_sparse_state_direct)
  init.scale = scale
  return init


def _normal(stddev=0.05):
  def init(generator, shape, dtype=torch.float32, device=None):
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, stddev, generator=generator)
  return init


def _constant(value):
  def init(generator, shape, dtype=torch.float32, device=None):
    del generator
    return torch.full(shape, float(value), dtype=dtype, device=device)
  return init


def _variance_scaling(scale: float, mode: str, distribution: str):
  """flax's ``variance_scaling`` for a ``[..., fan_in, fan_out]`` shape."""

  def init(generator, shape, dtype=torch.float32, device=None):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    n = {"fan_in": fan_in, "fan_out": fan_out,
         "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / max(1.0, n)
    out = torch.empty(shape, dtype=dtype, device=device)
    if distribution == "uniform":
      lim = math.sqrt(3.0 * var)
      return out.uniform_(-lim, lim, generator=generator)
    std = math.sqrt(var) / _TRUNC_STD
    return nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
  return init


_NAMED_INITIALIZERS = {
    "uniform": _keras_uniform,
    "random_uniform": _keras_uniform,
    "normal": lambda: _normal(0.05),
    "random_normal": lambda: _normal(0.05),
    "zeros": lambda: _constant(0.0),
    "ones": lambda: _constant(1.0),
    "glorot_uniform": lambda: _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorot_normal": lambda: _variance_scaling(1.0, "fan_avg",
                                               "truncated_normal"),
    "he_uniform": lambda: _variance_scaling(2.0, "fan_in", "uniform"),
    "he_normal": lambda: _variance_scaling(2.0, "fan_in", "truncated_normal"),
}


def resolve_initializer(spec: Union[str, Initializer, None]) -> Initializer:
  """A named initializer (Keras-style), a callable, or None (the Keras
  uniform)."""
  if spec is None:
    return _keras_uniform()
  if callable(spec):
    return spec
  if isinstance(spec, str):
    key = spec.lower()
    if key in _NAMED_INITIALIZERS:
      return _NAMED_INITIALIZERS[key]()
    raise ValueError(f"Unknown initializer {spec!r}")
  raise TypeError(f"Cannot resolve initializer from {spec!r}")


# ---------------------------------------------------------------------------
# Regularizers and constraints (Keras names resolve to plain callables)
# ---------------------------------------------------------------------------


def _l1(factor=0.01):
  return lambda w: factor * torch.sum(torch.abs(w))


def _l2(factor=0.01):
  return lambda w: factor * torch.sum(torch.square(w))


def _l1_l2(l1=0.01, l2=0.01):
  return lambda w: (l1 * torch.sum(torch.abs(w))
                    + l2 * torch.sum(torch.square(w)))


_NAMED_REGULARIZERS = {"l1": _l1, "l2": _l2, "l1_l2": _l1_l2}


def resolve_regularizer(spec) -> Optional[Callable[[torch.Tensor],
                                                   torch.Tensor]]:
  """``None`` | Keras name ('l1'/'l2'/'l1_l2') | ``{'name': .., 'factor':
  ..}`` | callable -> callable mapping a weight tensor to a scalar penalty
  (Keras semantics and defaults)."""
  if spec is None:
    return None
  if callable(spec):
    return spec
  if isinstance(spec, dict):
    d = {str(k).lower(): v for k, v in spec.items()}
    name = str(d.get("name", "")).lower()
    if name in ("l1", "l2"):
      factor = float(d.get("factor", d.get(name, 0.01)))
      return (_l1 if name == "l1" else _l2)(factor)
    if name == "l1_l2":
      return _l1_l2(float(d.get("l1", 0.01)), float(d.get("l2", 0.01)))
    raise ValueError(f"Unknown regularizer spec {spec!r}")
  if isinstance(spec, str):
    key = spec.lower()
    if key in _NAMED_REGULARIZERS:
      return _NAMED_REGULARIZERS[key]()
    raise ValueError(f"Unknown regularizer {spec!r}")
  raise TypeError(f"Cannot resolve regularizer from {spec!r}")


def l2_decay_factor(spec) -> Optional[float]:
  """λ when ``spec`` is a recognizable pure-l2 regularizer, else None (the
  one penalty the fused sparse path folds into its per-occurrence deltas,
  ``SparseRule.weight_decay``)."""
  if isinstance(spec, str) and spec.lower() == "l2":
    return 0.01  # keras.regularizers.l2 default
  if isinstance(spec, dict):
    d = {str(k).lower(): v for k, v in spec.items()}
    if str(d.get("name", "")).lower() == "l2":
      return float(d.get("factor", d.get("l2", 0.01)))
  return None


def _max_norm(max_value=2.0, eps=1e-7):
  def project(w):
    norms = torch.sqrt(torch.sum(torch.square(w), dim=-1, keepdim=True))
    desired = torch.clamp(norms, 0, max_value)
    return w * (desired / (eps + norms))
  return project


def _unit_norm(eps=1e-7):
  def project(w):
    return w / (eps + torch.sqrt(torch.sum(torch.square(w), dim=-1,
                                           keepdim=True)))
  return project


_NAMED_CONSTRAINTS = {
    "non_neg": lambda: (lambda w: torch.clamp(w, min=0.0)),
    "max_norm": _max_norm,
    "unit_norm": _unit_norm,
}


def resolve_constraint(spec) -> Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]]:
  """``None`` | Keras name ('non_neg'/'max_norm'/'unit_norm') | callable ->
  a projection of a weight tensor, applied after each optimizer update
  (Keras semantics; per-row norms along the last axis)."""
  if spec is None:
    return None
  if callable(spec):
    return spec
  if isinstance(spec, str):
    key = spec.lower()
    if key in _NAMED_CONSTRAINTS:
      return _NAMED_CONSTRAINTS[key]()
    raise ValueError(f"Unknown constraint {spec!r}")
  raise TypeError(f"Cannot resolve constraint from {spec!r}")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
  """Turns indices into vectors of fixed size; optional multi-hot reduce
  (the reference's ``Embedding``). With a ``combiner``: N-D integer ids
  ``(d1, ..., dn)`` -> ``(d1, ..., dn-1, output_dim)`` (N >= 2), and 2-D
  :class:`RaggedIds` / :class:`SparseIds` -> ``(batch, output_dim)``.
  Without: ``ids.shape + (output_dim,)``.

  Penalties land in :attr:`losses` on every forward (module docstring);
  :meth:`apply_constraint` is the post-update projection.

  Args:
    input_dim / output_dim: vocabulary size and width.
    embeddings_initializer: named or callable initializer.
    embeddings_regularizer / activity_regularizer: None | 'l1' / 'l2' /
      'l1_l2' | dict | callable.
    embeddings_constraint: None | 'non_neg' / 'max_norm' / 'unit_norm' |
      callable.
    combiner: None, 'sum' or 'mean'.
    device: where the table lives; ``"cuda"`` unless the caller asks for
      the CPU.
    generator: the ``torch.Generator`` of the initial draw (on ``device``).
  """

  def __init__(self, input_dim: int, output_dim: int,
               embeddings_initializer: Any = "uniform",
               embeddings_regularizer: Any = None,
               activity_regularizer: Any = None,
               embeddings_constraint: Any = None,
               combiner: Optional[str] = None,
               param_dtype=torch.float32, name: Optional[str] = None,
               device="cuda", generator: Optional[torch.Generator] = None):
    super().__init__()
    if input_dim <= 0 or output_dim <= 0:
      raise ValueError(
          "Both input_dim and output_dim should be positive, "
          f"found {input_dim} and {output_dim}")
    dev = resolve_device(device)
    self.input_dim = int(input_dim)
    self.output_dim = int(output_dim)
    self.embeddings_initializer = embeddings_initializer
    self.embeddings_regularizer = embeddings_regularizer
    self.activity_regularizer = activity_regularizer
    self.embeddings_constraint = embeddings_constraint
    self.combiner = combiner
    self.name = name
    self.embeddings = nn.Parameter(resolve_initializer(
        embeddings_initializer)(generator, (self.input_dim, self.output_dim),
                                param_dtype, dev))
    self.losses = {}

  def forward(self, inputs) -> torch.Tensor:
    out = self.lookup(self.embeddings, inputs)
    reg = resolve_regularizer(self.embeddings_regularizer)
    if reg is not None:
      # a layer called N times counts its table penalty once
      self.losses["embeddings_regularizer"] = reg(self.embeddings)
    act_reg = resolve_regularizer(self.activity_regularizer)
    if act_reg is not None:
      # the activity penalty counts every call's output
      prev = self.losses.get("activity_regularizer")
      pen = act_reg(out)
      self.losses["activity_regularizer"] = pen if prev is None \
          else prev + pen
    return out

  def apply_constraint(self, embeddings: torch.Tensor) -> torch.Tensor:
    """The post-update projection of a table (Keras constraint
    semantics)."""
    proj = resolve_constraint(self.embeddings_constraint)
    return embeddings if proj is None else proj(embeddings)

  def lookup(self, embeddings: torch.Tensor, inputs) -> torch.Tensor:
    """Input normalization + lookup (reference ``embedding.py:108-133``)."""
    if isinstance(inputs, (RaggedIds, SparseIds)):
      return embedding_lookup(embeddings, inputs, combiner=self.combiner)
    inputs = torch.as_tensor(inputs, device=embeddings.device)
    if inputs.dtype.is_floating_point or inputs.dtype == torch.bool:
      inputs = inputs.to(torch.int32)
    out_shape = None
    if inputs.dim() == 1:
      if self.combiner is not None:
        raise ValueError(
            "1D input with combiner is ambiguous. Please create batch "
            "dimension.")
      inputs = inputs.reshape(-1, 1)
      out_shape = (-1, self.output_dim)
    elif inputs.dim() > 2:
      if self.combiner is None:
        out_shape = tuple(inputs.shape) + (self.output_dim,)
      else:
        out_shape = tuple(inputs.shape[:-1]) + (self.output_dim,)
      inputs = inputs.reshape(-1, inputs.shape[-1])
    out = embedding_lookup(embeddings, inputs, combiner=self.combiner)
    if out_shape is not None:
      out = out.reshape(out_shape)
    return out

  def get_config(self) -> dict:
    return {
        "input_dim": self.input_dim,
        "output_dim": self.output_dim,
        "embeddings_initializer": self.embeddings_initializer,
        "embeddings_regularizer": self.embeddings_regularizer,
        "activity_regularizer": self.activity_regularizer,
        "embeddings_constraint": self.embeddings_constraint,
        "combiner": self.combiner,
        "name": self.name,
    }

  @classmethod
  def from_config(cls, config, **kwargs) -> "Embedding":
    """A layer from a config (Keras-only fields dropped, as the JAX layer
    drops them); ``kwargs`` (``device``, ``generator``) go to the
    constructor."""
    config = dict(config)
    config.pop("mask_zero", None)
    config.pop("input_length", None)
    config.pop("name", None)
    return cls(**config, **kwargs)


def collect_regularization_losses(source) -> torch.Tensor:
  """The sum of every penalty recorded since the last collection.

  ``source`` is a module (every submodule's ``losses`` dict is read, then
  emptied, so the next forward starts a new collection) or a dict of
  penalties."""
  if isinstance(source, nn.Module):
    vals = []
    for mod in source.modules():
      found = getattr(mod, "losses", None)
      if isinstance(found, dict) and found:
        vals.extend(found.values())
        found.clear()
  else:
    vals = list(source.get("losses", source).values())
  if not vals:
    return torch.zeros(())
  return sum(torch.sum(torch.as_tensor(v)) for v in vals)


@dataclasses.dataclass
class TableConfig:
  """One embedding table as the planner sees it (the reference's layer
  config dict fields); ``from_layer`` / ``to_layer`` convert to and from
  :class:`Embedding`."""

  input_dim: int
  output_dim: int
  combiner: Optional[str] = None
  initializer: Any = "uniform"
  regularizer: Any = None
  constraint: Any = None
  name: Optional[str] = None
  # dynamic-vocabulary cap (plan oov='allocate' only); the planner
  # refuses it on static plans, exactly as the JAX planner does
  vocab_capacity: Optional[int] = None

  def size(self) -> int:
    return self.input_dim * self.output_dim

  @classmethod
  def from_layer(cls, layer: Embedding) -> "TableConfig":
    if layer.activity_regularizer is not None:
      raise ValueError(
          "activity_regularizer is not supported in the distributed path "
          f"(table {layer.name!r}): apply it to the layer outputs in the "
          "model's loss instead")
    return cls(input_dim=layer.input_dim, output_dim=layer.output_dim,
               combiner=layer.combiner,
               initializer=layer.embeddings_initializer,
               regularizer=layer.embeddings_regularizer,
               constraint=layer.embeddings_constraint, name=layer.name)

  def to_layer(self, device="cuda",
               generator: Optional[torch.Generator] = None) -> Embedding:
    return Embedding(input_dim=self.input_dim, output_dim=self.output_dim,
                     embeddings_initializer=self.initializer,
                     embeddings_regularizer=self.regularizer,
                     embeddings_constraint=self.constraint,
                     combiner=self.combiner, device=device,
                     generator=generator)


class ConcatOneHotEmbedding(nn.Module):
  """N one-hot tables concatenated row-wise into one weight (the
  reference's ``ConcatOneHotEmbedding``): the lookup clamps each
  feature's id to its own table, adds the feature's row offset and
  gathers once. Inputs ``[..., N]`` -> ``[..., N, width]``."""

  def __init__(self, feature_sizes, embedding_width: int,
               params_initializer: Any = "uniform", device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    dev = resolve_device(device)
    self.feature_sizes = tuple(int(v) for v in feature_sizes)
    self.embedding_width = int(embedding_width)
    offsets = np.concatenate([[0], np.cumsum(self.feature_sizes)])
    self.register_buffer("offsets", torch.as_tensor(offsets[:-1],
                                                    device=dev),
                         persistent=False)
    self.register_buffer("sizes", torch.as_tensor(self.feature_sizes,
                                                  device=dev),
                         persistent=False)
    self.embeddings = nn.Parameter(resolve_initializer(params_initializer)(
        generator, (int(offsets[-1]), self.embedding_width), torch.float32,
        dev))

  def forward(self, inputs) -> torch.Tensor:
    inputs = torch.as_tensor(inputs, device=self.embeddings.device)
    if inputs.shape[-1] != len(self.feature_sizes):
      raise ValueError(f"Expected {len(self.feature_sizes)} features, got "
                       f"{inputs.shape[-1]}")
    # clamp per feature so a bad id cannot bleed into the next table's rows
    clamped = torch.minimum(inputs.long().clamp(min=0), self.sizes - 1)
    return self.embeddings[clamped + self.offsets]
