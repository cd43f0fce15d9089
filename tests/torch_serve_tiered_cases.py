"""The tiered serve cell shared by the port's tiered serving tests:
``tests/test_serving.py: _tiered_fixture`` (vocabularies ``[5000, 300,
40]``, width 16, ``host_row_threshold=1000`` so the 5,000-row table is
host-tier, Adagrad 0.05 on the sparse classes, ``optax.adam`` on the dense
side, a training tier plan of ``cache_fraction=0.3, staging_grps=64``) at
world 1 or 4, with observed counts from classifying power-law batches
(so the serve ranking is not the default order), the JAX package's frozen
tables and its tiered ``ServeEngine``'s answers.

The port's side of a case comes from the same arrays: its train state by
``convert.train_state_from_flax`` and its ``HostTierStore`` by copying the
JAX store's images, resident sets and counts (:func:`port_store`).
"""

import numpy as np

import torch_tiering_cases as C

SERVE_CFG = dict(cache_fraction=0.3, staging_grps=64)
SPILL_CFG = dict(cache_fraction=0.3, staging_grps=2)
COUNT_BATCHES = (201, 202, 203)  # classified to fill the observed counts
REQUESTS = (7, 8)                # the requests' seeds (7: the JAX fixture's)
QUANTIZE = ("f32", "int8", "fp8")
PRED_TOL = dict(rtol=1e-5, atol=1e-6)


def request(seed):
  numerical, cats, _ = C.jax_batch(seed)
  return numerical, cats


class JaxActs:
  """JAX model stub returning the concatenated embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    import jax.numpy as jnp
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


def jax_case(world, source_world=None):
  """The JAX side at ``world``: ``{plan_b, plan_t, model, mesh, rule,
  state_b, state_t, store, tplan}`` (states device-placed, the store's
  counts filled by classifying :data:`COUNT_BATCHES`). ``source_world``:
  take the tables (and dense parameters) of that world's init, laid out
  anew for this world's plans (the same logical tables)."""
  import jax.numpy as jnp
  import optax
  from distributed_embeddings_tpu.ops.packed_table import sparse_rule
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.tiering import (
      HostTierStore,
      TieredPrefetcher,
      TieringConfig,
      TieringPlan,
      init_tiered_state_from_params,
  )
  from distributed_embeddings_tpu.training import (
      init_sparse_state,
      shard_params,
  )
  from distributed_embeddings_tpu.layers.dist_model_parallel import (
      get_weights,
      set_weights,
  )

  plan_b = C.jax_plan(world, None)
  plan_t = C.jax_plan(world)
  rule = sparse_rule("adagrad", C.LR)
  opt = optax.adam(C.ADAM_LR)
  mesh = create_mesh(world) if world > 1 else None
  dense, tables_t = C.jax_params(source_world or world)
  if source_world not in (None, world):
    tables_t = {k: np.asarray(v) for k, v in set_weights(
        plan_t, get_weights(C.jax_plan(source_world), tables_t)).items()}

  def placed(state):
    return shard_params(state, mesh) if mesh is not None else state

  params_b = dict(dense)
  params_b["embeddings"] = {
      k: jnp.asarray(v) for k, v in set_weights(
          plan_b, get_weights(plan_t, tables_t)).items()}
  state_b = placed(init_sparse_state(plan_b, params_b, rule, opt))
  params_t = dict(dense)
  params_t["embeddings"] = {k: jnp.asarray(v) for k, v in tables_t.items()}
  tplan = TieringPlan(plan_t, rule, TieringConfig(**SERVE_CFG))
  store = HostTierStore(tplan)
  state_t = placed(init_tiered_state_from_params(tplan, store, rule,
                                                 params_t, opt, mesh=mesh))
  pf = TieredPrefetcher(tplan, store, mesh)
  for seed in COUNT_BATCHES:
    pf.classify(request(seed)[1])
  return {"plan_b": plan_b, "plan_t": plan_t, "model": C.jax_model(world),
          "mesh": mesh, "rule": rule, "state_b": state_b,
          "state_t": state_t, "store": store, "tplan": tplan}


def numpy_state(state):
  import jax
  return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def store_arrays(store):
  """A JAX store's images, resident maps and groups and counts, numpy."""
  return {part: {name: [np.asarray(a).copy() for a in per]
                 for name, per in getattr(store, part).items()}
          for part in ("images", "resident_map", "resident_grps", "counts")}


def port_store(tplan, arrays, owned_ranks=None):
  """The port's ``HostTierStore`` over ``tplan`` holding a JAX store's
  arrays (:func:`store_arrays`; images of the owned ranks only)."""
  from distributed_embeddings_torch.tiering import HostTierStore
  store = HostTierStore(tplan, owned_ranks=owned_ranks)
  for name, per in arrays["images"].items():
    for r in store.owned_ranks:
      store.set_image(name, r, per[r])
  for part in ("resident_map", "resident_grps", "counts"):
    for name, per in arrays[part].items():
      getattr(store, part)[name] = [a.copy() for a in per]
  return store


def torch_plans(world):
  return C.torch_plan(world, None), C.torch_plan(world)


def torch_tplan(plan_t):
  from distributed_embeddings_torch.ops.packed_table import adagrad_rule
  from distributed_embeddings_torch.tiering import TieringConfig, TieringPlan
  rule = adagrad_rule(C.LR)
  return rule, TieringPlan(plan_t, rule, TieringConfig(**SERVE_CFG))


def bytes_of(a) -> np.ndarray:
  """An image's bytes (fp8 as ``ml_dtypes`` on the JAX side, int8 here)."""
  a = np.ascontiguousarray(np.asarray(a))
  return a.view(np.uint8)
