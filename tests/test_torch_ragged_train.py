"""Ragged value streams through the port's world-1 steps, against the JAX
package's.

- **The sparse step** (``make_sparse_train_step``): a DLRM of six D=16
  tables, two in a dense class, one padded 3-hot ``sum`` input and three
  ``RaggedIds`` inputs (``sum`` and ``mean``, lengths 0-8, a fifth of
  the ids -1, declared by negative ``input_hotness``); three SGD and
  Adagrad (four logical rows a physical row) steps from one JAX state:
  losses and every final array in the f32 class (rtol 1e-5, atol 1e-6),
  the eval step's predictions too and its OOV metrics equal. The guarded
  step counts an out-of-range id inside a sample's window, and not one
  in the dead tail past ``row_splits[-1]``, as the JAX step does. The
  ragged step agrees with its padded twin (``ragged_to_padded`` of the
  same batch) in the same class. ``micro_batches > 1`` with ragged cats
  is refused with the JAX message.
- **The dense-autodiff step** (``make_train_step`` over a model owning a
  ``DistributedEmbedding`` with ragged inputs): three SGD steps against
  the JAX step in the f32 class.
- **Serving**: the serve step's activations on f32 and int8 images,
  bit-exact against the JAX serve step; ``ServeEngine.predict`` of a
  ragged request bit-equal to the eval step's predictions and across two
  calls; ``MicroBatcher`` requests carrying ``RaggedIds`` get exactly
  the rows ``ServeEngine`` gives each request alone.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import serving as tserving
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.layers.dist_model_parallel import \
    DistributedEmbedding as TDistributedEmbedding
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.ops.ragged import RaggedIds as TRagged
from distributed_embeddings_torch.parallel.lookup_engine import \
    ragged_to_padded as t_ragged_to_padded
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.layers.dist_model_parallel import (
    DistributedEmbedding,
)
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.serving.engine import \
    make_serve_step as jmake_serve_step
from distributed_embeddings_tpu.serving.export import \
    frozen_device_state as jfrozen_device_state
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_eval_step,
    make_sparse_eval_step,
    make_sparse_train_step,
    make_train_step,
)
from torch_ragged_cases import (
    TOL,
    jax_batch,
    port_batch,
    ragged_batches,
    to_jax,
    to_port,
)

VOCAB = [40, 9, 200, 14, 120, 300]
D = 16
NUM = 4
B = 32
LR = 0.1
THRESHOLD = 16  # the 9- and 14-row tables ride a dense class
RAGGED = {2: 8, 4: 5, 5: 8}  # input -> max hotness
PADDED = {0: 3}
COMBINER = {0: "sum", 2: "sum", 4: "mean", 5: "sum"}
HOTNESS = [3, 1, -8, 1, -5, -8]
STEPS = 3


def _configs(mod):
  return [mod(input_dim=v, output_dim=D, combiner=COMBINER.get(i))
          for i, v in enumerate(VOCAB)]


def _plans(**kw):
  return (DistEmbeddingStrategy(_configs(TableConfig), 1,
                                dense_row_threshold=THRESHOLD,
                                input_hotness=HOTNESS, **kw),
          TStrategy(_configs(TTableConfig), 1, dense_row_threshold=THRESHOLD,
                    input_hotness=HOTNESS, **kw))


def _batches(n=STEPS, seed=0):
  out = []
  rng = np.random.default_rng(seed + 100)
  for numerical, cats, labels in ragged_batches(n, VOCAB, RAGGED, 1, B, NUM,
                                                seed):
    x = rng.integers(0, VOCAB[0], (B, PADDED[0])).astype(np.int32)
    x[rng.random(x.shape) < 0.3] = -1
    cats[0] = x
    out.append((numerical, cats, labels))
  return out


def _jax_model():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=(16, D),
              top_mlp=(16, 1))


def _tmodel():
  return TDLRM(VOCAB, D, bottom_mlp=(16, D), top_mlp=(16, 1),
               num_numerical=NUM, tables=False, device="cpu")


def _jax_state(jplan, jrule):
  dense = _jax_model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
      emb_acts=[jnp.zeros((2, D)) for _ in VOCAB])["params"]
  return init_sparse_state_direct(jplan, jrule, dense, optax.sgd(LR),
                                  jax.random.PRNGKey(1))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _assert_fused(tstate, jstate, tol=TOL):
  for name, buf in jstate["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **tol)
  for name, table in jstate["emb_dense"].items():
    np.testing.assert_allclose(tstate["emb_dense"][name].detach().numpy(),
                               np.asarray(table), err_msg=name, **tol)


def _ints(m):
  return jax.tree_util.tree_map(int, m)


@pytest.fixture(scope="module", params=["sgd", "adagrad"])
def trained(request):
  """Three steps of both packages' sparse step from one JAX state, then
  the eval step with metrics."""
  jplan, tplan = _plans()
  jrule = getattr(jpt, f"{request.param}_rule")(LR)
  trule = getattr(tpt, f"{request.param}_rule")(LR)
  state = _jax_state(jplan, jrule)
  batches = _batches()
  jstep = make_sparse_train_step(_jax_model(), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 jax_batch(batches[0]), donate=False)
  tstep = ttr.make_sparse_train_step(
      _tmodel(), tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
      trule)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstate = state
  losses = []
  for batch in batches:
    jstate, jloss = jstep(jstate, *jax_batch(batch))
    tstate, tloss = tstep(tstate, *port_batch(batch))
    losses.append((float(tloss), float(jloss)))
  numerical, cats, _ = _batches(1, seed=9)[0]
  jev = make_sparse_eval_step(_jax_model(), jplan, jrule, None, jstate,
                              jax_batch((numerical, cats)),
                              with_metrics=True)
  tev = ttr.make_sparse_eval_step(_tmodel(), tplan, trule,
                                  with_metrics=True)
  want = jev(jstate, *jax_batch((numerical, cats)))
  got = tev(tstate, *port_batch((numerical, cats)))
  return {"losses": losses, "tstate": tstate, "jstate": jstate,
          "eval": (got, want), "plans": (jplan, tplan),
          "rules": (jrule, trule), "state": state, "batches": batches}


def test_sparse_step_matches_jax(trained):
  for tloss, jloss in trained["losses"]:
    np.testing.assert_allclose(tloss, jloss, **TOL)
  _assert_fused(trained["tstate"], trained["jstate"])
  assert trained["tstate"]["step"] == int(trained["jstate"]["step"]) == STEPS


def test_eval_step_with_metrics_matches_jax(trained):
  (tpreds, tm), (jpreds, jm) = trained["eval"]
  np.testing.assert_allclose(tpreds.numpy(), np.asarray(jpreds), **TOL)
  assert _ints(tm) == _ints(jm)


def test_ragged_step_agrees_with_its_padded_twin(trained):
  """The same batches padded by ``ragged_to_padded`` through the port's
  step from the same state."""
  _, tplan = trained["plans"]
  _, trule = trained["rules"]
  padded_plan = TStrategy(_configs(TTableConfig), 1,
                          dense_row_threshold=THRESHOLD)
  tstep = ttr.make_sparse_train_step(
      _tmodel(), padded_plan, torch_bce,
      functools.partial(torch.optim.SGD, lr=LR), trule)
  tstate = train_state_from_flax(_numpy_state(trained["state"]),
                                 device="cpu")
  for (tloss, _), batch in zip(trained["losses"], trained["batches"]):
    numerical, cats, labels = port_batch(batch)
    cats = [t_ragged_to_padded(c, RAGGED[i]) if i in RAGGED else c
            for i, c in enumerate(cats)]
    tstate, loss = tstep(tstate, numerical, cats, labels)
    np.testing.assert_allclose(float(loss), tloss, **TOL)
  for name, buf in trained["tstate"]["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(), buf.numpy(),
                               err_msg=name, **TOL)


def test_guarded_step_counts_live_oov_ids_only_as_in_jax():
  jplan, tplan = _plans()
  jrule, trule = jpt.adagrad_rule(LR), tpt.adagrad_rule(LR)
  state = _jax_state(jplan, jrule)
  batches = _batches(2, seed=3)
  # one out-of-range id in a live window, one in the dead tail
  rg = batches[1][1][2]
  values = np.asarray(rg.values).copy()
  end = int(np.asarray(rg.row_splits)[-1])
  values[0] = VOCAB[2] + 3
  values[end:] = VOCAB[2] + 9
  batches[1][1][2] = TRagged(values, np.asarray(rg.row_splits))
  jstep = make_sparse_train_step(_jax_model(), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 jax_batch(batches[0]), donate=False,
                                 guard=True)
  tstep = ttr.make_sparse_train_step(
      _tmodel(), tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
      trule, guard=True)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstate = state
  for batch in batches:
    jstate, jloss, jm = jstep(jstate, *jax_batch(batch))
    tstate, tloss, tm = tstep(tstate, *port_batch(batch))
    assert _ints(tm) == _ints(jm)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  assert sum(_ints(tm)["oov"].values()) == 1
  _assert_fused(tstate, jstate)


def test_micro_batches_refuse_ragged_cats_with_the_jax_message():
  jplan, tplan = _plans()
  jrule, trule = jpt.sgd_rule(LR), tpt.sgd_rule(LR)
  state = _jax_state(jplan, jrule)
  batch = _batches(1)[0]
  jstep = make_sparse_train_step(_jax_model(), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 jax_batch(batch), donate=False,
                                 micro_batches=2)
  tstep = ttr.make_sparse_train_step(
      _tmodel(), tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
      trule, micro_batches=2)
  with pytest.raises(NotImplementedError) as ej:
    jstep(state, *jax_batch(batch))
  with pytest.raises(NotImplementedError) as et:
    tstep(train_state_from_flax(_numpy_state(state), device="cpu"),
          *port_batch(batch))
  assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the dense-autodiff step
# ---------------------------------------------------------------------------

DENSE_VOCAB = [60, 90, 30, 120]
DENSE_COMBINER = {0: "sum", 1: "mean", 3: "sum"}
DENSE_RAGGED = {0: 6, 1: 4, 3: 7}
DENSE_HOTNESS = [-6, -4, 1, -7]


class _JaxTiny(fnn.Module):
  """The numerical features and every input's activation concatenated
  into one linear head."""

  @fnn.compact
  def __call__(self, numerical, cats):
    embs = DistributedEmbedding(
        embeddings=tuple(TableConfig(input_dim=v, output_dim=D,
                                     combiner=DENSE_COMBINER.get(i))
                         for i, v in enumerate(DENSE_VOCAB)),
        input_hotness=tuple(DENSE_HOTNESS), name="embeddings")(list(cats))
    x = jnp.concatenate([numerical] + list(embs), axis=1)
    return fnn.Dense(1, name="head")(x)[:, 0]


class _TorchTiny(torch.nn.Module):

  def __init__(self):
    super().__init__()
    self.embeddings = TDistributedEmbedding(
        [TTableConfig(input_dim=v, output_dim=D,
                      combiner=DENSE_COMBINER.get(i))
         for i, v in enumerate(DENSE_VOCAB)], input_hotness=DENSE_HOTNESS,
        device="cpu")
    self.head = torch.nn.Linear(NUM + D * len(DENSE_VOCAB), 1)

  def forward(self, numerical, cats):
    x = torch.cat([numerical] + list(self.embeddings(cats)), dim=1)
    return self.head(x)[:, 0]


def test_dense_autodiff_step_matches_jax():
  batches = ragged_batches(STEPS + 1, DENSE_VOCAB, DENSE_RAGGED, 1, B, NUM,
                           seed=4)
  model = _JaxTiny()
  params = model.init(jax.random.PRNGKey(0),
                      *jax_batch(batches[0])[:2])["params"]
  opt = optax.sgd(LR)

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  jstep = make_train_step(loss_fn, opt, None, params, opt.init(params),
                          jax_batch(batches[0]), donate=False)
  tmodel = _TorchTiny()
  init = {f"embeddings.{k}": torch.as_tensor(np.asarray(v))
          for k, v in params["embeddings"].items()}
  init["head.weight"] = torch.as_tensor(
      np.asarray(params["head"]["kernel"]).T.copy())
  init["head.bias"] = torch.as_tensor(np.asarray(params["head"]["bias"]))
  tmodel.load_state_dict(init)
  tstep = ttr.make_train_step(lambda m, n, c, y: torch_bce(m(n, c), y),
                              torch.optim.SGD(tmodel.parameters(), lr=LR),
                              tmodel, device="cpu")
  p, s = params, opt.init(params)
  for batch in batches[:STEPS]:
    p, s, jloss = jstep(p, s, *jax_batch(batch))
    tloss = tstep(*port_batch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
  for name, v in p["embeddings"].items():
    np.testing.assert_allclose(
        getattr(tmodel.embeddings, name).detach().numpy(), np.asarray(v),
        err_msg=name, **TOL)
  numerical, cats, _ = batches[STEPS]
  jev = make_eval_step(lambda q, n, c: model.apply({"params": q}, n, c),
                       None, p, jax_batch((numerical, cats)))
  tev = ttr.make_eval_step(lambda m, n, c: m(n, c), tmodel)
  np.testing.assert_allclose(
      tev(*port_batch((numerical, cats))).numpy(),
      np.asarray(jev(p, *jax_batch((numerical, cats)))), **TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class _JaxActs:
  """The concatenated activations: serve parity at the lookup layer."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


class _TorchActs(torch.nn.Module):

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.cat(list(emb_acts), dim=-1)

  def load_state_dict(self, state_dict, strict=True):
    del state_dict, strict  # no dense parameters to take from an artifact


def _serve_state(rule_name="adagrad"):
  jplan, tplan = _plans()
  jrule = getattr(jpt, f"{rule_name}_rule")(LR)
  trule = getattr(tpt, f"{rule_name}_rule")(LR)
  state = _jax_state(jplan, jrule)
  # one step, so the optimizer lanes and tables are not the init draw
  jstep = make_sparse_train_step(_jax_model(), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 jax_batch(_batches(1)[0]), donate=False)
  state, _ = jstep(state, *jax_batch(_batches(1)[0]))
  return jplan, tplan, jrule, trule, state


@pytest.mark.parametrize("q", ["f32", "int8"])
def test_serve_step_is_bit_exact_against_jax(q):
  jplan, tplan, jrule, trule, state = _serve_state()
  numerical, cats, _ = _batches(1, seed=11)[0]
  frozen = jserving.freeze(jplan, jrule, state, quantize=q)
  sstate = jfrozen_device_state(frozen, jplan, None)
  jstep = jmake_serve_step(_JaxActs(), jplan, frozen.meta, None, sstate,
                           jax_batch((numerical, cats)))
  want = np.asarray(jstep(sstate, *jax_batch((numerical, cats))))
  tfrozen = tserving.freeze(
      tplan, trule, train_state_from_flax(_numpy_state(state), device="cpu"),
      q)
  tstate = tserving.frozen_device_state(tfrozen, tplan, "cpu")
  tstep = tserving.make_serve_step(_TorchActs(), tplan, tfrozen.meta)
  got = tstep(tstate, *port_batch((numerical, cats))).numpy()
  np.testing.assert_array_equal(got, want)


def test_serve_engine_and_batcher_answer_ragged_requests():
  _, tplan, _, trule, state = _serve_state("sgd")
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  frozen = tserving.freeze(tplan, trule, tstate, "f32")
  eng = tserving.ServeEngine(_tmodel(), tplan, frozen, device="cpu")
  numerical, cats, _ = _batches(1, seed=12)[0]
  first = eng.predict(numerical, cats)
  np.testing.assert_array_equal(eng.predict(numerical, cats), first)
  ev = ttr.make_sparse_eval_step(_tmodel(), tplan, trule)
  np.testing.assert_array_equal(
      ev(tstate, *port_batch((numerical, cats))).numpy(), first)

  acts = tserving.ServeEngine(_TorchActs(), tplan, frozen, device="cpu")
  batcher = tserving.MicroBatcher(acts.dispatch, max_batch=B, start=False)
  rng = np.random.default_rng(13)
  requests = []
  for n in (5, 11, 3, 9):
    num_r, cats_r, _ = _batches(1, seed=int(rng.integers(1 << 20)))[0]
    cats_r = [c[:n] if not isinstance(c, TRagged) else TRagged(
        np.asarray(c.values), np.asarray(c.row_splits)[:n + 1])
              for c in cats_r]
    requests.append((num_r[:n], cats_r))
  futures = [batcher.submit(n_r, c_r) for n_r, c_r in requests]
  while batcher.flush_now():
    pass
  for fut, (n_r, c_r) in zip(futures, requests):
    np.testing.assert_array_equal(fut.result(timeout=10),
                                  acts.predict(n_r, c_r))
  batcher.close()


def test_ragged_to_padded_matches_jax():
  from distributed_embeddings_tpu.parallel.lookup_engine import \
      ragged_to_padded
  numerical, cats, _ = _batches(1, seed=14)[0]
  for i, h in RAGGED.items():
    for max_hot in (1, h, h + 3):
      np.testing.assert_array_equal(
          t_ragged_to_padded(to_port(cats[i]), max_hot).numpy(),
          np.asarray(ragged_to_padded(to_jax(cats[i]), max_hot)))
