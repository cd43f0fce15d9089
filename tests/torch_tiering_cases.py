"""The tiered cell shared by the port's tiering tests: ``tests/
test_tiering.py``'s configuration (vocabularies ``[5000, 300, 40]``, width
16, ``host_row_threshold=1000`` so the 5,000-row table is host-tier,
Adagrad 0.05 on the sparse classes, power-law ids at alpha 1.05) at
world 1 or 4, with the JAX side's runs and their numpy results.

The JAX runs mirror ``tests/test_tiering.py: _paired_runs``: a JAX
``TieredTrainer`` over a tiered plan, initialized from the simple-layout
params of an untiered plan's DLRM init (``set_weights`` re-lays them out
for the tiered plan), dense side ``optax.adam``.
"""

import functools

import numpy as np

VOCAB = [5000, 300, 40]
WIDTH = 16
NUM = 13
HOST_THR = 1000
LR = 0.05
ADAM_LR = 1e-3
B = 32


def jax_batch(seed, batch=B, alpha=1.05, vocab=VOCAB):
  from distributed_embeddings_tpu.models.synthetic import power_law_ids
  r = np.random.default_rng(seed)
  numerical = r.standard_normal((batch, NUM)).astype(np.float32)
  cats = [power_law_ids(r, batch, 1, v, alpha).astype(np.int32)[:, 0]
          for v in vocab]
  labels = r.integers(0, 2, batch).astype(np.float32)
  return numerical, cats, labels


def jax_tables(vocab=VOCAB):
  from distributed_embeddings_tpu.layers.embedding import TableConfig
  from distributed_embeddings_tpu.models.dlrm import _dlrm_initializer
  return [TableConfig(input_dim=v, output_dim=WIDTH,
                      initializer=_dlrm_initializer(v)) for v in vocab]


def torch_tables(vocab=VOCAB):
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.models.dlrm import _dlrm_initializer
  return [TableConfig(input_dim=v, output_dim=WIDTH,
                      initializer=_dlrm_initializer(v)) for v in vocab]


def jax_plan(world, host_thr=HOST_THR, **kw):
  from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
  return DistEmbeddingStrategy(jax_tables(), world, "memory_balanced",
                               dense_row_threshold=0,
                               host_row_threshold=host_thr, **kw)


def torch_plan(world, host_thr=HOST_THR, **kw):
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  return DistEmbeddingStrategy(torch_tables(), world, "memory_balanced",
                               dense_row_threshold=0,
                               host_row_threshold=host_thr, **kw)


def jax_model(world):
  from distributed_embeddings_tpu.models import DLRM
  return DLRM(vocab_sizes=VOCAB, embedding_dim=WIDTH, bottom_mlp=(32, WIDTH),
              top_mlp=(32, 1), world_size=world, strategy="memory_balanced",
              dense_row_threshold=0)


def torch_model():
  from distributed_embeddings_torch.models import DLRM
  return DLRM(VOCAB, WIDTH, bottom_mlp=(32, WIDTH), top_mlp=(32, 1),
              num_numerical=NUM, tables=False, device="cpu")


def jax_params(world, plan_kw=None):
  """``(dense flax params, tiered-plan tables)`` of one DLRM init, numpy:
  the untiered plan's tables re-laid out for the tiered plan. Fresh
  copies of one cached init per ``(world, plan_kw)``."""
  import copy
  return copy.deepcopy(_jax_params(world, tuple(sorted(
      (plan_kw or {}).items()))))


@functools.lru_cache(maxsize=None)
def _jax_params(world, plan_items):
  import jax
  from distributed_embeddings_tpu.layers.dist_model_parallel import (
      get_weights,
      set_weights,
  )
  plan_b = jax_plan(world, None)
  plan_t = jax_plan(world, **dict(plan_items))
  b0 = jax_batch(100)
  params = jax.device_get(jax_model(world).init(
      jax.random.PRNGKey(0), b0[0], b0[1])["params"])
  tables = set_weights(plan_t, get_weights(plan_b, params["embeddings"]))
  dense = {k: v for k, v in params.items() if k != "embeddings"}
  return (jax.tree_util.tree_map(np.asarray, dense),
          {k: np.asarray(v) for k, v in tables.items()})


def jax_run(world, cfg, batches, plan_kw=None, rule_name="adagrad",
            guard=False, dense="adam"):
  """A JAX ``TieredTrainer`` over ``batches``; returns the losses, the
  final tables (``get_weights`` view), the metrics summary, the hit
  counters and the store's resident groups per rank."""
  import jax
  import jax.numpy as jnp
  import optax
  from distributed_embeddings_tpu.layers.dist_model_parallel import \
      get_weights
  from distributed_embeddings_tpu.models import bce_loss
  from distributed_embeddings_tpu.ops.packed_table import sparse_rule
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringPlan,
      init_tiered_state_from_params,
      unpack_tiered_state,
  )
  from distributed_embeddings_tpu.training import shard_params
  plan = jax_plan(world, **(plan_kw or {}))
  rule = sparse_rule(rule_name, LR)
  opt = optax.adam(ADAM_LR) if dense == "adam" else optax.adagrad(LR)
  mesh = create_mesh(world) if world > 1 else None
  dense_p, tables = jax_params(world, plan_kw)
  params = dict(dense_p)
  params["embeddings"] = {k: jnp.asarray(v) for k, v in tables.items()}
  tplan = TieringPlan(plan, rule, cfg)
  store = HostTierStore(tplan)
  state = init_tiered_state_from_params(tplan, store, rule, params, opt,
                                        mesh=mesh)
  if mesh is not None:
    state = shard_params(state, mesh)
  trainer = TieredTrainer(jax_model(world), tplan, store, bce_loss, opt,
                          rule, mesh, state, batches[0], donate=False,
                          guard=guard)
  losses = trainer.run(batches)
  trainer.flush()
  p = unpack_tiered_state(tplan, store, rule, jax.device_get(trainer.state))
  weights = [np.asarray(w) for w in get_weights(plan, p["embeddings"])]
  return {"losses": losses, "weights": weights,
          "summary": trainer.metrics_summary(),
          "hits": {k: v.copy() for k, v in trainer.hits.items()},
          "resident": {k: [g.copy() for g in v]
                       for k, v in store.resident_grps.items()},
          "counts": {k: [c.copy() for c in v]
                     for k, v in store.counts.items()}}
