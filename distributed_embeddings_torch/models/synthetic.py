"""Synthetic recommender model zoo (PyTorch port of ``models/synthetic.py``).

The model-size table and embedding specs are NVIDIA's published synthetic
benchmark models (the reference's ``examples/benchmarks/synthetic_models/
config_v3.py``), transcribed as the JAX package has them; the inputs are
power-law ids drawn with numpy exactly as the JAX package draws them
(:func:`power_law_ids`, :func:`generate_batch`: same seed, same arrays).
The model (:class:`SyntheticModel`) concatenates the sum-combined
embedding activations, applies the optional strided average pool (the
reference's bandwidth-limited "interaction"), appends the numerical
features and runs an MLP to one logit. It owns its embedding layer, a
``DistributedEmbedding`` over every table, as the JAX model does; the
sparse train step hands it its activations through ``emb_acts`` instead,
as for the DLRM.

| config   | tables | embedding GiB |
|----------|--------|---------------|
| tiny     |     55 |           4.2 |
| small    |    107 |          26.3 |
| medium   |    311 |         206.2 |
| large    |    612 |         773.8 |
| jumbo    |   1022 |        3109.5 |
| colossal |   2002 |       22327.4 |
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..layers.dist_model_parallel import DistributedEmbedding
from ..layers.embedding import TableConfig
from .dlrm import MLP


@dataclasses.dataclass(frozen=True)
class EmbeddingGroup:
  """A group of identical tables (reference ``EmbeddingConfig``). ``nnz``
  lists the hotness of each input reading the table; ``len(nnz) > 1``
  requires ``shared`` (several inputs, one table)."""

  num_tables: int
  nnz: Tuple[int, ...]
  num_rows: int
  width: int
  shared: bool


@dataclasses.dataclass(frozen=True)
class SyntheticModelConfig:
  name: str
  embedding_groups: Tuple[EmbeddingGroup, ...]
  mlp_sizes: Tuple[int, ...]
  num_numerical_features: int
  interact_stride: Optional[int]


def _cfg(name, groups, mlp, numerical, stride):
  return SyntheticModelConfig(
      name=name,
      embedding_groups=tuple(EmbeddingGroup(*g) for g in groups),
      mlp_sizes=tuple(mlp),
      num_numerical_features=numerical,
      interact_stride=stride)


# (num_tables, nnz, rows, width, shared) per group, as published
# (config_v3.py:30-142)
SYNTHETIC_MODELS = {
    "criteo": _cfg("Criteo-dlrm-like",
                   [(26, (1,), 100_000, 128, False)],
                   [512, 256, 128], 13, None),
    "tiny": _cfg("Tiny V3",
                 [(1, (1, 10), 10_000, 8, True),
                  (1, (1, 10), 1_000_000, 16, True),
                  (1, (1, 10), 25_000_000, 16, True),
                  (1, (1,), 25_000_000, 16, False),
                  (16, (1,), 10, 8, False),
                  (10, (1,), 1_000, 8, False),
                  (4, (1,), 10_000, 8, False),
                  (2, (1,), 100_000, 16, False),
                  (19, (1,), 1_000_000, 16, False)],
                 [256, 128], 10, None),
    "small": _cfg("Small V3",
                  [(5, (1, 30), 10_000, 16, True),
                   (3, (1, 30), 4_000_000, 32, True),
                   (1, (1, 30), 50_000_000, 32, True),
                   (1, (1,), 50_000_000, 32, False),
                   (30, (1,), 10, 16, False),
                   (30, (1,), 1_000, 16, False),
                   (5, (1,), 10_000, 16, False),
                   (5, (1,), 100_000, 32, False),
                   (27, (1,), 4_000_000, 32, False)],
                  [512, 256, 128], 10, None),
    "medium": _cfg("Medium v3",
                   [(20, (1, 50), 100_000, 64, True),
                    (5, (1, 50), 10_000_000, 64, True),
                    (1, (1, 50), 100_000_000, 128, True),
                    (1, (1,), 100_000_000, 128, False),
                    (80, (1,), 10, 32, False),
                    (60, (1,), 1_000, 32, False),
                    (80, (1,), 100_000, 64, False),
                    (24, (1,), 200_000, 64, False),
                    (40, (1,), 10_000_000, 64, False)],
                   [1024, 512, 256, 128], 25, 7),
    "large": _cfg("Large v3",
                  [(40, (1, 100), 100_000, 64, True),
                   (16, (1, 100), 15_000_000, 64, True),
                   (1, (1, 100), 200_000_000, 128, True),
                   (1, (1,), 200_000_000, 128, False),
                   (100, (1,), 10, 32, False),
                   (100, (1,), 10_000, 32, False),
                   (160, (1,), 100_000, 64, False),
                   (50, (1,), 500_000, 64, False),
                   (144, (1,), 15_000_000, 64, False)],
                  [2048, 1024, 512, 256], 100, 8),
    "jumbo": _cfg("Jumbo v3",
                  [(50, (1, 200), 100_000, 128, True),
                   (24, (1, 200), 20_000_000, 128, True),
                   (1, (1, 200), 400_000_000, 256, True),
                   (1, (1,), 400_000_000, 256, False),
                   (100, (1,), 10, 32, False),
                   (200, (1,), 10_000, 64, False),
                   (350, (1,), 100_000, 128, False),
                   (80, (1,), 1_000_000, 128, False),
                   (216, (1,), 20_000_000, 128, False)],
                  [2048, 1024, 512, 256], 200, 20),
    "colossal": _cfg("Colossal v3",
                     [(100, (1, 300), 100_000, 128, True),
                      (50, (1, 300), 40_000_000, 256, True),
                      (1, (1, 300), 2_000_000_000, 256, True),
                      (1, (1,), 1_000_000_000, 256, False),
                      (100, (1,), 10, 32, False),
                      (400, (1,), 10_000, 128, False),
                      (100, (1,), 100_000, 128, False),
                      (800, (1,), 1_000_000, 128, False),
                      (450, (1,), 40_000_000, 256, False)],
                     [4096, 2048, 1024, 512, 256], 500, 30),
}


def expand_tables(config: SyntheticModelConfig
                  ) -> Tuple[List[TableConfig], List[int], List[int]]:
  """-> (table configs, input_table_map, per-input hotness)."""
  tables: List[TableConfig] = []
  input_table_map: List[int] = []
  hotness: List[int] = []
  for group in config.embedding_groups:
    if len(group.nnz) > 1 and not group.shared:
      raise NotImplementedError(
          "Non-shared multi-hot embedding groups are not supported "
          "(the reference's synthetic_models.py has the same restriction)")
    for _ in range(group.num_tables):
      tables.append(TableConfig(input_dim=group.num_rows,
                                output_dim=group.width, combiner="sum"))
      for h in group.nnz:
        input_table_map.append(len(tables) - 1)
        hotness.append(h)
  return tables, input_table_map, hotness


def model_size_gib(config: SyntheticModelConfig) -> float:
  tables, _, _ = expand_tables(config)
  return sum(t.input_dim * t.output_dim for t in tables) * 4 / 2**30


def power_law_ids(rng: np.random.Generator, batch: int, hotness: int,
                  num_rows: int, alpha: float) -> np.ndarray:
  """Power-law distributed ids in ``[0, num_rows)`` (the reference's
  ``power_law``): inverse-CDF transform of uniform samples with exponent
  ``alpha``; ``alpha=0`` degenerates to uniform."""
  if alpha == 0:
    return rng.integers(0, num_rows, size=(batch, hotness), dtype=np.int64)
  gamma = 1.0 - alpha
  r = rng.random(batch * hotness)
  lo, hi = 1.0, float(num_rows + 1)
  y = (r * (hi**gamma - lo**gamma) + lo**gamma) ** (1.0 / gamma)
  return (y.astype(np.int64) - 1).clip(0, num_rows - 1).reshape(batch, hotness)


def generate_batch(config: SyntheticModelConfig, global_batch: int,
                   alpha: float = 0.0, seed: int = 0,
                   ) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
  """One synthetic ``(numerical, categorical list, labels)`` batch (the
  reference's ``InputGenerator``), as numpy arrays."""
  rng = np.random.default_rng(seed)
  tables, input_table_map, hotness = expand_tables(config)
  cats = [
      power_law_ids(rng, global_batch, h, tables[t].input_dim, alpha)
      .astype(np.int32)
      for t, h in zip(input_table_map, hotness)
  ]
  numerical = rng.uniform(0, 100, size=(
      global_batch, config.num_numerical_features)).astype(np.float32)
  labels = rng.integers(0, 2, size=(global_batch,)).astype(np.float32)
  return numerical, cats, labels


def _pool_geometry(n: int, stride: int) -> Tuple[int, int, int]:
  """``(outputs, pad_lo, pad_hi)`` of a window-``stride``, stride-``stride``
  pool over ``n`` features with ``padding="SAME"`` (flax/XLA's split: the
  smaller half of the padding in front)."""
  out = -(-n // stride)
  pad = max(0, (out - 1) * stride + stride - n)
  return out, pad // 2, pad - pad // 2


def avg_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
  """``[B, n]`` -> ``[B, ceil(n / stride)]``: flax ``avg_pool(window=stride,
  strides=stride, padding="SAME")`` over the feature axis, padded cells
  counted (``count_include_pad=True``: each window's sum over ``stride``)."""
  out, lo, hi = _pool_geometry(x.shape[1], stride)
  x = torch.nn.functional.pad(x, (lo, hi))
  return x.view(x.shape[0], out, stride).sum(dim=2) / stride


def mlp_in_features(config: SyntheticModelConfig) -> int:
  """The MLP's input width: every input's activation (pooled when the
  config has an ``interact_stride``) and the numerical features."""
  tables, tmap, _ = expand_tables(config)
  n = sum(tables[t].output_dim for t in tmap)
  if config.interact_stride is not None:
    n = _pool_geometry(n, config.interact_stride)[0]
  return n + config.num_numerical_features


class SyntheticModel(nn.Module):
  """Synthetic benchmark model (the reference's ``SyntheticModelTFDE``):
  sum-combined embeddings over power-law inputs, the optional strided
  average pool, the numerical features, an MLP to one logit. It owns its
  embedding layer (a :class:`~..layers.dist_model_parallel.
  DistributedEmbedding` over every table of ``config``, submodule
  ``embeddings``), as the JAX model does, so the dense-autodiff step
  (``training.make_train_step``) trains its tables; the sparse step
  hands it its activations instead (``emb_acts``).

  Args:
    config: a :class:`SyntheticModelConfig` (``SYNTHETIC_MODELS[name]``).
    world_size / strategy / column_slice_threshold / row_slice /
      dp_input / dense_row_threshold / batch_hint: the embedding layer's
      plan, as in the JAX model.
    compute_dtype: dtype of the pool and MLP compute (parameters stay f32).
    mesh: this rank's :class:`~..parallel.mesh.Mesh` at world > 1: the
      embedding layer holds this rank's blocks only and the MLP is
      replicated, all on the mesh's device (``world_size`` must be the
      mesh's).
    tables: build the embedding layer with its class buffers; False for a
      model that is handed its activations (``emb_acts``), as the sparse
      train step and the serve engine do.
    device: where the parameters live without a mesh; ``"cuda"`` unless
      the caller asks for the CPU.
    generator: CPU ``torch.Generator`` for the MLP's initial weights.
    table_generator: ``torch.Generator`` on the tables' device for their
      initial draws (None takes PyTorch's default generator); with a mesh
      it draws this rank's shards only, so seed it per rank.
  """

  def __init__(self, config: SyntheticModelConfig, world_size: int = 1,
               strategy: str = "memory_balanced",
               column_slice_threshold: Optional[int] = None,
               row_slice: Optional[int] = None, dp_input: bool = True,
               compute_dtype=torch.float32, dense_row_threshold: int = 2048,
               batch_hint: Optional[int] = None, mesh=None, tables: bool = True,
               device="cuda", generator: Optional[torch.Generator] = None,
               table_generator: Optional[torch.Generator] = None):
    super().__init__()
    dev = mesh.device if mesh is not None else resolve_device(device)
    self.config = config
    self.compute_dtype = compute_dtype
    self.mlp = MLP(mlp_in_features(config), tuple(config.mlp_sizes) + (1,),
                   dtype=compute_dtype, generator=generator)
    self.to(dev)
    self.embeddings = None
    if tables:
      table_cfgs, tmap, hotness = expand_tables(config)
      self.embeddings = DistributedEmbedding(
          table_cfgs, strategy=strategy,
          column_slice_threshold=column_slice_threshold,
          row_slice=row_slice, dp_input=dp_input, input_table_map=tmap,
          world_size=world_size, dense_row_threshold=dense_row_threshold,
          input_hotness=hotness, batch_hint=batch_hint, mesh=mesh,
          device=dev, generator=table_generator)

  def forward(self, numerical: torch.Tensor, categorical=None,
              emb_acts: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
    """numerical ``[B, num_numerical]``; categorical: per input its ids
    (``[B]``, ``[B, 1]`` or ``[B, H]``), looked up through the embedding
    layer; ``emb_acts`` overrides the lookup with per-input ``[B, width]``
    activations. Returns ``[B]`` f32 logits."""
    if emb_acts is None:
      if self.embeddings is None:
        raise ValueError(
            "this SyntheticModel was built with tables=False: pass its "
            "embedding activations through emb_acts")
      emb_acts = self.embeddings(categorical)
    cd = self.compute_dtype
    x = torch.cat([o.to(cd) for o in emb_acts], dim=1)
    if self.config.interact_stride is not None:
      x = avg_pool_same(x, self.config.interact_stride)
    x = torch.cat([x, numerical.to(cd)], dim=1)
    return self.mlp(x).squeeze(-1).float()


def synthetic_plan(config: SyntheticModelConfig, world_size: int = 1,
                   strategy: str = "basic", dense_row_threshold: int = 2048,
                   batch_hint: Optional[int] = None,
                   tables: Optional[Sequence[TableConfig]] = None):
  """The placement plan of ``tools/bench_synthetic.py``: every table of
  ``config`` (or the given ``tables``, e.g. with cut vocabularies), its
  input map and hotness, small-vocab tables in dense classes."""
  from ..layers.planner import DistEmbeddingStrategy

  full, tmap, hotness = expand_tables(config)
  return DistEmbeddingStrategy(
      list(full if tables is None else tables), world_size, strategy,
      input_table_map=tmap, dense_row_threshold=dense_row_threshold,
      input_hotness=hotness, batch_hint=batch_hint)
