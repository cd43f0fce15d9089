"""The dense-autodiff train step (the README's Quick start) in the port
against the JAX package's, world 1.

A small DLRM that owns its tables (4 tables, one under
``dense_row_threshold``, D=8) gets the JAX model's initial params through
``convert.dlrm_state_dict_from_flax``; three batches go through the JAX
``make_train_step`` with ``optax.sgd`` and through the port's
``training.make_train_step`` with ``torch.optim.SGD``. At f32 the losses
and every final tensor agree in the f32 class (rtol 1e-5, atol 1e-6); at
bf16 compute in the train-golden class (``train_golden.LOSS_TOL``, each
tensor within ``UPDATE_TOL`` of its largest update). One f32 run carries
an l2 regularizer on a sparse-class table and a max_norm constraint on
the dense-class one through the ``plan``. ``make_eval_step`` and the
JAX builder's refusals are held too (the world > 1 step is
``tests/test_torch_dense_train_world4.py``'s).

``tests/data/torch_dense_train_golden.npz`` (the JAX runs the card
replays) is regenerated here and must be identical to the committed
file; its f32 run replays through the port on the CPU in the f32 class.
Regenerate it after a deliberate change with
``python tests/test_torch_dense_train.py --write``.

The fused sparse step shares the plan's dense-class penalties
(``plan_regularizer_fn`` / ``plan_constraint_fn``): it is held to the JAX
sparse step with an l1 regularizer and a unit_norm constraint on a
dense-class table. And one dense step and one sparse SGD step from one
state agree (``train_golden.dense_vs_sparse_step``, the check the card
runs at full width).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    dlrm_state_dict_from_flax,
    dlrm_state_dict_to_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.models import \
    dlrm_embedding_plan as torch_plan
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    make_eval_step,
    make_sparse_train_step,
    make_train_step,
    unpack_sparse_state,
)

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [40, 300, 1000, 120]
D = 8
NUM = 4
B = 32
BOTTOM = (16, D)
TOP = (16, 8, 1)
THRESHOLD = 64  # table 0 is a dense class, the others sparse
LR = port_golden.LR  # optax.sgd(0.1): larger steps amplify bf16 roundings
COMPUTE = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _batches(seed=0, vocab=VOCAB, b=B, num=NUM, steps=3):
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((b, num)).astype(np.float32),
           [rng.integers(0, v, (b,)).astype(np.int32) for v in vocab],
           rng.integers(0, 2, (b,)).astype(np.float32))
          for _ in range(steps)]


def _jax_model(compute):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=BOTTOM,
              top_mlp=TOP, dense_row_threshold=THRESHOLD,
              compute_dtype=COMPUTE[compute][0])


def _jax_params(batches):
  numerical, cats, _ = batches[0]
  params = _jax_model("f32").init(
      jax.random.PRNGKey(0), jnp.asarray(numerical),
      [jnp.asarray(c) for c in cats])["params"]
  return jax.tree_util.tree_map(np.asarray, params)


def _plan_configs(mod, penalties):
  return [mod(input_dim=v, output_dim=D,
              regularizer=penalties.get(("reg", i)),
              constraint=penalties.get(("con", i)))
          for i, v in enumerate(VOCAB)]


def _run_jax(compute, params, batches, penalties=None):
  model = _jax_model(compute)

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  plan = (DistEmbeddingStrategy(_plan_configs(TableConfig, penalties), 1,
                                dense_row_threshold=THRESHOLD)
          if penalties else None)
  opt = optax.sgd(LR)
  params = jax.tree_util.tree_map(jnp.asarray, params)
  step = make_train_step(loss_fn, opt, None, params, opt.init(params),
                         batches[0], plan=plan, donate=False)
  state = opt.init(params)
  losses = []
  for numerical, cats, labels in batches:
    params, state, loss = step(params, state, jnp.asarray(numerical),
                               [jnp.asarray(c) for c in cats],
                               jnp.asarray(labels))
    losses.append(float(loss))
  return losses, port_golden.flax_paths(
      jax.tree_util.tree_map(np.asarray, params))


def _torch_model(compute, params):
  model = TDLRM(VOCAB, D, bottom_mlp=BOTTOM, top_mlp=TOP, num_numerical=NUM,
                compute_dtype=COMPUTE[compute][1],
                dense_row_threshold=THRESHOLD, device="cpu")
  model.load_state_dict(dlrm_state_dict_from_flax(params))
  return model


def _run_torch(compute, params, batches, penalties=None):
  model = _torch_model(compute, params)
  plan = (TStrategy(_plan_configs(TTableConfig, penalties), 1,
                    dense_row_threshold=THRESHOLD) if penalties else None)
  if plan is not None:
    assert plan.class_keys == model.embeddings.plan.class_keys
  opt = torch.optim.SGD(model.parameters(), lr=LR)
  step = ttr.make_train_step(port_golden.dense_loss, opt, model, plan=plan,
                             device="cpu")
  losses = [float(step(torch.tensor(n), [torch.tensor(c) for c in cats],
                       torch.tensor(l)))
            for n, cats, l in batches]
  return losses, port_golden.flax_paths(
      dlrm_state_dict_to_flax(model.state_dict()))


@pytest.mark.parametrize("compute,penalties", [
    ("f32", None), ("bf16", None),
    ("f32", {("reg", 1): "l2", ("con", 0): "max_norm"})])
def test_dense_train_step_matches_jax(compute, penalties):
  batches = _batches()
  params = _jax_params(batches)
  want_losses, want = _run_jax(compute, params, batches, penalties)
  got_losses, got = _run_torch(compute, params, batches, penalties)
  assert sorted(got) == sorted(want)
  assert any(k.startswith("embeddings/") and k.endswith("_dense")
             for k in got), "a dense class trains"
  if compute == "f32":
    np.testing.assert_allclose(got_losses, want_losses, **TOL)
    for k in want:
      np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    return
  np.testing.assert_allclose(got_losses, want_losses,
                             **port_golden.LOSS_TOL)
  init = port_golden.flax_paths(params)
  port_golden._update_share(init, want, got, "params")


def test_max_norm_constraint_projects_the_dense_class_rows():
  """The constraint run's dense-class table ends with rows of norm at most
  2 (max_norm's default), the unconstrained run's does not."""
  batches = _batches(seed=4)
  params = _jax_params(batches)
  name = next(k for k in port_golden.flax_paths(params)
              if k.endswith("_dense"))
  params = jax.tree_util.tree_map(np.copy, params)
  params["embeddings"][name.split("/")[1]] *= 20.0  # rows of norm > 2
  _, free = _run_torch("f32", params, batches[:1])
  _, held = _run_torch("f32", params, batches[:1], {("con", 0): "max_norm"})
  norms = np.linalg.norm(held[name][:VOCAB[0]], axis=-1)
  assert norms.max() <= 2.0 + 1e-5
  assert np.linalg.norm(free[name][:VOCAB[0]], axis=-1).max() > 2.5


def test_eval_step_matches_jax():
  batches = _batches(seed=1)
  params = _jax_params(batches)
  numerical, cats, _ = batches[0]
  model = _jax_model("f32")

  def pred(p, numerical, cats):
    return model.apply({"params": p}, numerical, cats)

  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  want = np.asarray(make_eval_step(pred, None, jparams, batches[0][:2])(
      jparams, jnp.asarray(numerical), [jnp.asarray(c) for c in cats]))
  tmodel = ttr.shard_params(_torch_model("f32", params), device="cpu")
  got = ttr.make_eval_step(lambda m, n, c: m(n, c), tmodel)(
      torch.tensor(numerical), [torch.tensor(c) for c in cats])
  np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_make_train_step_refusals():
  model = TDLRM(VOCAB, D, bottom_mlp=BOTTOM, top_mlp=TOP, num_numerical=NUM,
                dense_row_threshold=THRESHOLD, device="cpu")
  opt = torch.optim.SGD(model.parameters(), lr=LR)
  args = (port_golden.dense_loss, opt, model)
  for kw, match in ((dict(oov="error"), "oov='error'"),
                    (dict(oov="allocate", vocab_capacity=32),
                     "oov='allocate'"),
                    (dict(dedup_capacity=4, dedup_exchange=True),
                     "dedup_capacity")):
    plan = TStrategy(_plan_configs(TTableConfig, {}), 1,
                     dense_row_threshold=THRESHOLD, **kw)
    with pytest.raises(NotImplementedError, match=match) as et:
      ttr.make_train_step(*args, plan=plan, device="cpu")
    if "dedup_capacity" in kw:
      # the JAX builder's refusal, word for word
      jplan = DistEmbeddingStrategy(_plan_configs(TableConfig, {}), 1,
                                    dense_row_threshold=THRESHOLD, **kw)
      with pytest.raises(NotImplementedError) as ej:
        make_train_step(lambda p, *b: 0.0, optax.sgd(LR), None, {}, {},
                        (), plan=jplan)
      assert str(et.value) == str(ej.value)
  with pytest.raises(ValueError, match="lies on"):
    ttr.make_train_step(*args, device="meta")


def test_sparse_step_dense_class_penalties_match_jax():
  """The fused sparse step with an l1 regularizer and a unit_norm
  constraint on its dense-class table: the penalty joins the loss, the
  projection follows the update, as in the JAX sparse step."""
  penalties = {("reg", 0): "l1", ("con", 0): "unit_norm"}
  jplan = DistEmbeddingStrategy(_plan_configs(TableConfig, penalties), 1,
                                dense_row_threshold=THRESHOLD)
  tplan = TStrategy(_plan_configs(TTableConfig, penalties), 1,
                    dense_row_threshold=THRESHOLD)
  batches = _batches(seed=2)
  params = _jax_params(batches)
  emb = params.pop("embeddings")
  dmodel = DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=BOTTOM,
                top_mlp=TOP, dense_row_threshold=THRESHOLD)
  rule = jpt.sgd_rule(LR)
  state = init_sparse_state(jplan, {"embeddings": emb, **params}, rule,
                            optax.sgd(LR))
  step = make_sparse_train_step(dmodel, jplan, bce_loss, optax.sgd(LR), rule,
                                None, state, batches[0], donate=False)
  tstate = ttr.init_sparse_state(
      tplan, {"embeddings": {k: torch.tensor(v) for k, v in emb.items()},
              **dlrm_state_dict_from_flax(params)},
      tpt.sgd_rule(LR), lambda p: torch.optim.SGD(p, lr=LR), device="cpu")
  tmodel = TDLRM(VOCAB, D, bottom_mlp=BOTTOM, top_mlp=TOP, num_numerical=NUM,
                 dense_row_threshold=THRESHOLD, tables=False, device="cpu")
  tstep = ttr.make_sparse_train_step(
      tmodel, tplan, torch_bce, lambda p: torch.optim.SGD(p, lr=LR),
      tpt.sgd_rule(LR))
  for numerical, cats, labels in batches:
    state, loss = step(state, jnp.asarray(numerical),
                       [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    tstate, tloss = tstep(tstate, torch.tensor(numerical),
                          [torch.tensor(c) for c in cats],
                          torch.tensor(labels))
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
  want, _ = unpack_sparse_state(jplan, rule, state)
  for name, table in state["emb_dense"].items():
    got = tstate["emb_dense"][name].detach().numpy()
    np.testing.assert_allclose(got, np.asarray(table), **TOL)
    rows = np.linalg.norm(got[:VOCAB[0]], axis=-1)
    np.testing.assert_allclose(rows, 1.0, rtol=1e-5)  # unit_norm held
  assert want["embeddings"]


def test_dense_and_sparse_steps_agree_from_one_state():
  batches = _batches(seed=3)
  params = _jax_params(batches)
  model = _torch_model("bf16", params)
  plan = torch_plan(VOCAB, D, dense_row_threshold=THRESHOLD)
  numerical, cats, labels = batches[0]
  got = port_golden.dense_vs_sparse_step(
      model, plan, torch.tensor(numerical), [torch.tensor(c) for c in cats],
      torch.tensor(labels), lr=LR)
  assert got["dense_loss"] == got["sparse_loss"]
  assert got["class_max_dup_share"] <= 1.0
  # the dense step moved the model: its tables are not the initial ones
  moved = dlrm_state_dict_to_flax(model.state_dict())["embeddings"]
  assert any(not np.array_equal(moved[k], v)
             for k, v in params["embeddings"].items())


# ---------------------------------------------------------------------------
# the committed golden
# ---------------------------------------------------------------------------

G_VOCAB = [3, 10, 24, 40, 64, 100, 160, 300]
G_DIM = 16
G_BOTTOM = (32, 16)
G_TOP = (32, 16, 1)
G_NUM = 13
G_B = 128
G_THRESHOLD = 32


def make_golden():
  """The dense golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(0)
  numerical = rng.standard_normal((port_golden.STEPS, G_B, G_NUM)) \
      .astype(np.float32)
  cats = np.stack([np.stack([rng.integers(0, v, (G_B,)) for v in G_VOCAB])
                   for _ in range(port_golden.STEPS)]).astype(np.int32)
  labels = rng.integers(0, 2, (port_golden.STEPS, G_B)).astype(np.float32)
  out = {"vocab": np.asarray(G_VOCAB, np.int64), "dim": np.int64(G_DIM),
         "bottom_mlp": np.asarray(G_BOTTOM, np.int64),
         "top_mlp": np.asarray(G_TOP, np.int64),
         "dense_row_threshold": np.int64(G_THRESHOLD),
         "numerical": numerical, "cats": cats, "labels": labels}
  init = None
  for compute, (jdt, _) in COMPUTE.items():
    model = DLRM(vocab_sizes=G_VOCAB, embedding_dim=G_DIM,
                 bottom_mlp=G_BOTTOM, top_mlp=G_TOP,
                 dense_row_threshold=G_THRESHOLD, compute_dtype=jdt)
    if init is None:
      init = model.init(jax.random.PRNGKey(0), jnp.asarray(numerical[0]),
                        [jnp.asarray(c) for c in cats[0]])["params"]
      for path, arr in port_golden.flax_paths(init).items():
        out[f"init/{path}"] = arr

    def loss_fn(p, numerical, cats, labels, model=model):
      return bce_loss(model.apply({"params": p}, numerical, cats), labels)

    opt = optax.sgd(port_golden.LR)
    step = make_train_step(loss_fn, opt, None, init, opt.init(init),
                           (numerical[0], list(cats[0]), labels[0]),
                           donate=False)
    params, state, losses = init, opt.init(init), []
    for i in range(port_golden.STEPS):
      params, state, loss = step(params, state, jnp.asarray(numerical[i]),
                                 [jnp.asarray(c) for c in cats[i]],
                                 jnp.asarray(labels[i]))
      losses.append(np.float32(loss))
    out[f"{compute}_losses"] = np.asarray(losses, np.float32)
    first = port_golden.flax_paths(init)
    for path, arr in port_golden.flax_paths(params).items():
      out[f"{compute}_moved/{path}"] = arr - first[path]
  return out


@pytest.fixture(scope="module")
def committed():
  return port_golden.load(port_golden.DENSE_PATH)


def test_committed_dense_golden_is_current(committed):
  assert port_golden.DENSE_PATH.stat().st_size < 2 * 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # both kinds of class train in it
  assert any(k.startswith("f32_moved/embeddings/") and k.endswith("_dense")
             for k in fresh)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_port_replays_dense_golden_on_cpu(committed, compute):
  losses, got = port_golden.replay_dense(committed, compute, device="cpu")
  assert np.all(np.isfinite(losses))
  worst = port_golden.compare_dense(committed, losses, got, compute)
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL
  if compute == "f32":
    np.testing.assert_allclose(losses, committed["f32_losses"], **TOL)
    want = port_golden.dense_final(committed, "f32")
    for k, w in want.items():
      np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_dense_train.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.DENSE_PATH, **make_golden())
  print(port_golden.DENSE_PATH, port_golden.DENSE_PATH.stat().st_size)
