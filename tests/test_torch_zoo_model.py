"""The synthetic zoo's model that owns its tables: the port's
``SyntheticModel`` with its own ``DistributedEmbedding`` against the JAX
``SyntheticModel``, its flax params carried by
``convert.synthetic_state_dict_from_flax``.

- **World 1, forward**: Tiny with every table cut to at most 1,000 rows
  (``tests/test_models.py:214``'s cut) and ``dense_row_threshold=100``
  (the 10-row tables ride a dense class, one-hot): the plan equals the JAX
  model's, the embedding activations are bit-exact and the logits in the
  f32 class (rtol 1e-5, atol 1e-6: the MLP's products add in each BLAS's
  order).
- **World 1, the dense-autodiff step and its optax state**: three
  ``make_train_step`` steps with ``training.Adagrad`` against the JAX step
  with ``optax.adagrad``, losses, every parameter and the accumulators
  (``convert.optax_state_of``) in the f32 class; the JAX optax state
  installed into a fresh port optimizer (``install_optax_state``)
  continues the JAX trajectory.
- **World 4** (four gloo ranks, ``tests/torch_ranks.py: zoo_dense_job``):
  ten Adagrad steps of ``tests/test_models.py:214``'s recipe (the default
  ``dense_row_threshold``: every cut table in a dense class) and of the
  same model with ``dense_row_threshold=100`` (the shared multi-hot tables
  in narrow sparse classes), per-step losses and the final class buffers
  in the f32 class of the JAX world-4 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    flatten_paths,
    install_optax_state,
    optax_state_of,
    synthetic_state_dict_from_flax,
)
from distributed_embeddings_torch.models import bce_loss as tbce
from distributed_embeddings_torch.models import synthetic as tsyn
from distributed_embeddings_tpu.models import bce_loss as jbce
from distributed_embeddings_tpu.models import synthetic as jsyn
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import (
    make_train_step,
    shard_batch,
    shard_params,
)
from test_torch_planner import plan_fields
from torch_ranks import spawn_start, spawn_wait

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
CAP = 1000
SPARSE_THRESHOLD = 100
LR = 0.002
W4_STEPS = 10


def _configs():
  """Tiny with every table cut to at most ``CAP`` rows, in both
  packages."""
  def cut(mod):
    cfg = mod.SYNTHETIC_MODELS["tiny"]
    return dataclasses.replace(cfg, embedding_groups=tuple(
        dataclasses.replace(g, num_rows=min(g.num_rows, CAP))
        for g in cfg.embedding_groups))
  return cut(tsyn), cut(jsyn)


def _batch(cfg, b, seed):
  numerical, cats, labels = jsyn.generate_batch(cfg, b, alpha=1.05,
                                                seed=seed)
  tables, tmap, _ = jsyn.expand_tables(cfg)
  cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
          for c, t in zip(cats, tmap)]
  return numerical, cats, labels


def _jax_init(model, batch):
  return jax.tree_util.tree_map(np.asarray, model.init(
      jax.random.PRNGKey(0), jnp.asarray(batch[0]),
      [jnp.asarray(c) for c in batch[1]])["params"])


def _port_model(tcfg, params, **kw):
  model = tsyn.SyntheticModel(tcfg, device="cpu", **kw)
  model.load_state_dict(synthetic_state_dict_from_flax(params))
  return model


def _cats(batch):
  return [torch.tensor(c) for c in batch[1]]


def test_world1_forward_matches_jax():
  tcfg, jcfg = _configs()
  batch = _batch(jcfg, 32, seed=3)
  jmodel = jsyn.SyntheticModel(config=jcfg, world_size=1,
                               dense_row_threshold=SPARSE_THRESHOLD)
  params = _jax_init(jmodel, batch)
  model = _port_model(tcfg, params, dense_row_threshold=SPARSE_THRESHOLD)
  tables, tmap, hotness = tsyn.expand_tables(tcfg)
  assert plan_fields(model.embeddings.plan) == plan_fields(
      tsyn.synthetic_plan(tcfg, strategy="memory_balanced",
                          dense_row_threshold=SPARSE_THRESHOLD))
  kinds = {cp.kind for cp in model.embeddings.plan.classes.values()}
  assert kinds == {"sparse", "dense"}
  want_acts = jmodel.apply({"params": params},
                           [jnp.asarray(c) for c in batch[1]],
                           method=lambda m, c: m.embeddings(c))
  with torch.no_grad():
    acts = model.embeddings(_cats(batch))
    logits = model(torch.tensor(batch[0]), _cats(batch))
  assert len(acts) == len(tmap)
  for i, (a, w) in enumerate(zip(acts, want_acts)):
    np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                  err_msg=f"input {i}")
  want = np.asarray(jmodel.apply({"params": params},
                                 jnp.asarray(batch[0]),
                                 [jnp.asarray(c) for c in batch[1]]))
  np.testing.assert_allclose(logits.numpy(), want, **TOL)
  # one-hot inputs as [B] give the [B, 1] activations
  flat = [c[:, 0] if h == 1 else c for c, h in zip(_cats(batch), hotness)]
  with torch.no_grad():
    for a, b in zip(model.embeddings(flat), acts):
      assert torch.equal(a, b)


def test_world1_adagrad_steps_and_optax_state_match_jax():
  tcfg, jcfg = _configs()
  batch = _batch(jcfg, 16, seed=4)
  jmodel = jsyn.SyntheticModel(config=jcfg, world_size=1,
                               dense_row_threshold=SPARSE_THRESHOLD)
  params = _jax_init(jmodel, batch)
  jb = (jnp.asarray(batch[0]), [jnp.asarray(c) for c in batch[1]],
        jnp.asarray(batch[2]))

  def loss_fn(p, numerical, cats, labels):
    return jbce(jmodel.apply({"params": p}, numerical, cats), labels)

  opt = optax.adagrad(LR)
  p = jax.tree_util.tree_map(jnp.asarray, params)
  s = opt.init(p)
  step = make_train_step(loss_fn, opt, None, p, s, jb, donate=False)
  want_losses, snaps = [], []
  for _ in range(4):
    p, s, loss = step(p, s, *jb)
    want_losses.append(float(loss))
    snaps.append((jax.tree_util.tree_map(np.asarray, p),
                  jax.tree_util.tree_map(np.asarray, s)))

  model = _port_model(tcfg, params, dense_row_threshold=SPARSE_THRESHOLD)
  topt = ttr.Adagrad(model.parameters(), lr=LR)
  tstep = ttr.make_train_step(lambda m, n, c, y: tbce(m(n, c), y),
                              topt, model, device="cpu")
  tb = (torch.tensor(batch[0]), _cats(batch), torch.tensor(batch[2]))
  losses = [float(tstep(*tb)) for _ in range(3)]
  np.testing.assert_allclose(losses, want_losses[:3], **TOL)
  want_p, want_s = snaps[2]
  got = synthetic_state_dict_from_flax(want_p)
  named = dict(model.named_parameters())
  for name, t in got.items():
    np.testing.assert_allclose(named[name].detach().numpy(), t.numpy(),
                               err_msg=name, **TOL)
  flat = optax_state_of(topt, named)
  want_flat = {k: np.asarray(v) for k, v in flatten_paths(want_s).items()}
  assert sorted(flat) == sorted(want_flat)
  assert any("embeddings/mp_table_" in k for k in flat)
  for k, v in want_flat.items():
    np.testing.assert_allclose(flat[k], v, err_msg=k, **TOL)
  # the JAX state after three steps continues in the port
  model2 = _port_model(tcfg, want_p, dense_row_threshold=SPARSE_THRESHOLD)
  opt2 = ttr.Adagrad(model2.parameters(), lr=LR)
  install_optax_state(opt2, dict(model2.named_parameters()), want_flat)
  step2 = ttr.make_train_step(lambda m, n, c, y: tbce(m(n, c), y),
                              opt2, model2, device="cpu")
  np.testing.assert_allclose(float(step2(*tb)), want_losses[3], **TOL)
  final = synthetic_state_dict_from_flax(snaps[3][0])
  named2 = dict(model2.named_parameters())
  for name, t in final.items():
    np.testing.assert_allclose(named2[name].detach().numpy(), t.numpy(),
                               err_msg=name, **TOL)


def _jax_world4(jcfg, threshold, params, batch):
  model = jsyn.SyntheticModel(config=jcfg, world_size=WORLD,
                              dense_row_threshold=threshold)
  mesh = create_mesh(WORLD)
  jb = (jnp.asarray(batch[0]), [jnp.asarray(c) for c in batch[1]],
        jnp.asarray(batch[2]))
  opt = optax.adagrad(LR)
  p = shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
  s = shard_params(opt.init(p), mesh)

  def loss_fn(q, numerical, cats, labels):
    return jbce(model.apply({"params": q}, numerical, cats), labels)

  step = make_train_step(loss_fn, opt, mesh, p, s, jb, donate=False)
  sharded = shard_batch(jb, mesh)
  losses = []
  for _ in range(W4_STEPS):
    p, s, loss = step(p, s, *sharded)
    losses.append(float(loss))
  return losses, {k: np.asarray(v) for k, v in p["embeddings"].items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tcfg, jcfg = _configs()
  batch = _batch(jcfg, 2 * WORLD, seed=4)
  runs, want = [], {}
  for name, threshold in (("recipe", 2048), ("sparse", SPARSE_THRESHOLD)):
    params = _jax_init(jsyn.SyntheticModel(
        config=jcfg, world_size=WORLD, dense_row_threshold=threshold), batch)
    runs.append({"name": name, "dense_row_threshold": threshold,
                 "init": params})
  started = spawn_start(tmp_path_factory.mktemp("zoo_w4"), WORLD,
                        "zoo_dense_job", {"config": tcfg, "lr": LR,
                                          "steps": W4_STEPS, "batch": batch,
                                          "runs": runs})
  for run in runs:
    want[run["name"]] = _jax_world4(jcfg, run["dense_row_threshold"],
                                    run["init"], batch)
  return want, spawn_wait(started)


@pytest.mark.parametrize("name", ["recipe", "sparse"])
def test_world4_adagrad_steps_match_jax(world4, name):
  want, got = world4
  want_losses, classes = want[name]
  assert want_losses[-1] < want_losses[0]
  for rank_out in got:
    res = rank_out[name]
    np.testing.assert_allclose(res["losses"], want_losses, **TOL)
    assert sorted(res["classes"]) == sorted(classes)
    for k, v in classes.items():
      np.testing.assert_allclose(res["classes"][k], v, err_msg=k, **TOL)
  if name == "sparse":
    assert any(not k.endswith("_dense") for k in classes)
