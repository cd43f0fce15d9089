"""Shared plan-scale harness for the synthetic zoo configs (PyTorch port
of ``utils/zoo_bench.py``).

One parameterized recipe: shrink the vocabularies (the plan and step cost
under test is per table, not per row), clamp the generated ids to the
shrunken tables, plan with ``memory_balanced``, draw the fused state with
an Adagrad rule, run ONE sparse train step over the mesh and time the
pieces.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..telemetry import timed


def zoo_tables(name: str, vocab_cap: int = 2000):
  """``(config, tables, input_table_map, hotness)`` of zoo config
  ``name`` with every table's rows scaled so the largest has
  ``vocab_cap`` (at least 8 rows each)."""
  from ..models import SYNTHETIC_MODELS, expand_tables

  cfg = SYNTHETIC_MODELS[name]
  tables, tmap, hotness = expand_tables(cfg)
  scale = vocab_cap / max(t.input_dim for t in tables)
  tables = [dataclasses.replace(t, input_dim=max(8, int(t.input_dim * scale)))
            for t in tables]
  return cfg, tables, tmap, hotness


def zoo_batch(name: str, batch: int, vocab_cap: int = 2000):
  """The recipe's global batch ``(numerical, cats, labels)`` as numpy:
  ``generate_batch(alpha=1.05, seed=0)``, ids clamped to the shrunken
  tables, one-hot inputs as ``[B]``."""
  from ..models import generate_batch

  cfg, tables, tmap, hotness = zoo_tables(name, vocab_cap)
  numerical, cats, labels = generate_batch(cfg, batch, alpha=1.05, seed=0)
  cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
          for c, t in zip(cats, tmap)]
  cats = [c if h > 1 else c[:, 0] for c, h in zip(cats, hotness)]
  return numerical, cats, labels


def run_zoo_plan_step(name: str, mesh, world: int, b_local: int = 2,
                      vocab_cap: int = 2000, dense_row_threshold: int = 16,
                      state: Optional[Dict[str, Any]] = None,
                      device="cuda") -> Dict[str, Any]:
  """Build the ``name`` zoo config at shrunken vocabulary and run one
  sparse train step over ``mesh`` (None at world 1; every rank calls it
  with its own). Returns the timings and the loss, under the JAX
  package's keys.

  ``state``: the train state to step (e.g. a JAX init carried across by
  ``convert.zoo_train_state_from_flax``, this rank's view); by default
  ``init_sparse_state_direct`` draws one (Adagrad 0.01, the MLP from seed
  0, the tables from seed 1 plus the rank). ``device``: where it runs
  without a mesh, ``"cuda"`` unless the caller asks for the CPU."""
  from ..device import resolve_device
  from ..layers.planner import DistEmbeddingStrategy
  from ..models import SyntheticModel, bce_loss
  from ..ops.packed_table import adagrad_rule
  from ..training import (
      Adagrad,
      init_sparse_state_direct,
      make_sparse_train_step,
      shard_batch,
  )

  cfg, tables, tmap, hotness = zoo_tables(name, vocab_cap)
  batch = b_local * world
  dev = resolve_device(device) if mesh is None else mesh.device

  with timed("zoo/plan") as t_plan:
    plan = DistEmbeddingStrategy(tables, world, "memory_balanced",
                                 input_table_map=tmap,
                                 dense_row_threshold=dense_row_threshold,
                                 input_hotness=hotness, batch_hint=batch)

  numerical, cats, labels = zoo_batch(name, batch, vocab_cap)
  rule = adagrad_rule(0.01)
  opt = functools.partial(Adagrad, lr=0.01)
  with timed("zoo/init") as t_init:
    model = SyntheticModel(cfg, world_size=world,
                           dense_row_threshold=dense_row_threshold,
                           tables=False, device=dev,
                           generator=torch.Generator().manual_seed(0))
    if state is None:
      rank = 0 if mesh is None else mesh.rank
      state = init_sparse_state_direct(
          plan, rule, model.state_dict(), opt,
          torch.Generator(device=dev).manual_seed(1 + rank),
          device=dev, mesh=mesh)
  batch_tree = shard_batch((numerical, cats, labels), mesh, device=dev)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, mesh=mesh)
  with timed("zoo/step") as t_step:
    state, loss = step(state, *batch_tree)
    loss = float(loss)
  return {
      "name": name,
      "tables": len(tables),
      "inputs": len(cats),
      "classes": len(plan.class_keys),
      "plan_s": t_plan.elapsed,
      "init_s": t_init.elapsed,
      "step_s": t_step.elapsed,
      "loss": loss,
  }
