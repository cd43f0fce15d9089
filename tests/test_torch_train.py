"""The port's sparse train step against the JAX package's, world 1.

One JAX fused train state (``init_sparse_state_direct``) is carried
across by ``convert.train_state_from_flax``; then three batches go
through the JAX ``make_sparse_train_step(mesh=None)`` and through the
port's ``training.make_sparse_train_step`` on the CPU. The per-step
losses and the final state (every packed buffer with its optimizer-state
lanes, the dense-class tables, the dense params) must agree in the f32
class: rtol = 1e-5, atol = 1e-6 (the two CPU BLAS libraries sum the MLP
products in their own orders; everything else is the same arithmetic).

The cases cover SGD (the scale-only apply) at D=128, Adagrad at D=16
(eight logical rows per physical row: the lane expansion, a non-scale
delta), momentum and Adam, padded multi-hot sum inputs, a
``dense_row_threshold`` that makes dense classes, a uniform l2 on the
sparse tables (the forward-time rows saved for the decay), the
deduplicated ``exact=True`` apply, and ``make_sparse_eval_step``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    dlrm_state_dict_from_flax,
    train_state_from_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.lookup_engine import \
    DistributedLookup
from distributed_embeddings_torch.parallel.mesh import Mesh
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    unpack_sparse_state,
)

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [50, 7, 300, 12, 90, 4000]
NUM = 4
B = 32
STEPS = 3
LR = 0.5
PAD_ID = -1

# name -> (width, rule, dense_row_threshold, exact, multi-hot inputs
# (input -> hotness), l2 on the sparse tables)
CASES = {
    "sgd_d128": (128, "sgd", 64, False, {}, False),
    "adagrad_d16": (16, "adagrad", 64, False, {}, False),
    "adagrad_d16_exact": (16, "adagrad", 64, True, {}, False),
    "sgd_d16_multihot": (16, "sgd", 64, False, {0: 3, 5: 4}, False),
    "adagrad_d128_multihot": (128, "adagrad", 64, False, {2: 3}, False),
    "momentum_d16_no_dense": (16, "momentum", 0, False, {}, False),
    "adam_d128": (128, "adam", 64, False, {5: 2}, False),
    "sgd_d16_l2": (16, "sgd", 64, False, {}, True),
    "sgd_d128_l2_exact": (128, "sgd", 64, True, {4: 2}, True),
}


def _configs(mod, d, hot, l2, thr):
  return [mod(input_dim=v, output_dim=d,
              combiner="sum" if i in hot else None,
              regularizer="l2" if (l2 and v > thr) else None)
          for i, v in enumerate(VOCAB)]


def _batches(hot, seed=0):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(STEPS):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in hot:
        ids = rng.integers(0, v, (B, hot[i])).astype(np.int32)
        ids[rng.random((B, hot[i])) < 0.3] = PAD_ID  # padded bags
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


def _rules(name):
  # Adam's first steps divide g by |g| + eps: an f32 summation-order
  # error in a gradient entry near eps would be amplified up to |g|/eps
  # fold, so its case takes an eps that keeps the comparison f32-class
  kw = {"eps": 1e-3} if name == "adam" else {}
  return (getattr(jpt, f"{name}_rule")(LR, **kw),
          getattr(tpt, f"{name}_rule")(LR, **kw))


def _jax_model(d):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=d, bottom_mlp=(32, d),
              top_mlp=(32, 16, 1))


def _jax_dense_params(d):
  acts = [jnp.zeros((2, d)) for _ in VOCAB]
  cats = [jnp.zeros((2,), jnp.int32) for _ in VOCAB]
  return _jax_model(d).init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                            cats, emb_acts=acts)["params"]


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _setup(case):
  d, rule_name, thr, exact, hot, l2 = CASES[case]
  jplan = DistEmbeddingStrategy(_configs(TableConfig, d, hot, l2, thr), 1,
                                dense_row_threshold=thr)
  tplan = TStrategy(_configs(TTableConfig, d, hot, l2, thr), 1,
                    dense_row_threshold=thr)
  jrule, trule = _rules(rule_name)
  state = init_sparse_state_direct(jplan, jrule, _jax_dense_params(d),
                                   optax.sgd(LR), jax.random.PRNGKey(1))
  tmodel = TDLRM(VOCAB, d, bottom_mlp=(32, d), top_mlp=(32, 16, 1),
                 num_numerical=NUM, tables=False, device="cpu")
  return (d, exact, hot, jplan, tplan, jrule, trule, state, tmodel)


def _run_both(case):
  d, exact, hot, jplan, tplan, jrule, trule, state, tmodel = _setup(case)
  batches = _batches(hot)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 batches[0], exact=exact, donate=False)
  tstep = ttr.make_sparse_train_step(
      tmodel, tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
      trule, exact=exact)
  jl, tl = [], []
  for numerical, cats, labels in batches:
    state, loss = jstep(state, jnp.asarray(numerical),
                        [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    jl.append(float(loss))
    tstate, loss = tstep(tstate, torch.tensor(numerical),
                         [torch.tensor(c) for c in cats],
                         torch.tensor(labels))
    tl.append(float(loss))
  return jplan, tplan, jrule, trule, state, tstate, jl, tl, tmodel, d


@pytest.fixture(scope="module")
def trained():
  return {}


def _trained(trained, case):
  if case not in trained:
    trained[case] = _run_both(case)
  return trained[case]


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(trained, case):
  _, tplan, _, _, state, tstate, jl, tl, _, _ = _trained(trained, case)
  np.testing.assert_allclose(tl, jl, **TOL)
  assert tstate["step"] == int(state["step"]) == STEPS
  assert set(tstate["fused"]) == set(state["fused"]) and tstate["fused"]
  for name, buf in state["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **TOL)
  assert set(tstate["emb_dense"]) == set(state["emb_dense"])
  for name, table in state["emb_dense"].items():
    np.testing.assert_allclose(tstate["emb_dense"][name].detach().numpy(),
                               np.asarray(table), err_msg=name, **TOL)
  want_dense = dlrm_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, state["dense"]))
  assert set(want_dense) == set(tstate["dense"])
  for name, p in want_dense.items():
    np.testing.assert_allclose(tstate["dense"][name].detach().numpy(),
                               p.numpy(), err_msg=name, **TOL)
  kinds = {cp.kind for cp in tplan.classes.values()}
  assert "sparse" in kinds


@pytest.mark.parametrize("case", ["sgd_d128", "adagrad_d16_exact",
                                  "sgd_d16_multihot"])
def test_eval_step_matches_jax(trained, case):
  jplan, tplan, jrule, trule, state, tstate, _, _, tmodel, d = \
      _trained(trained, case)
  numerical, cats, _ = _batches(CASES[case][4], seed=5)[0]
  jeval = make_sparse_eval_step(_jax_model(d), jplan, jrule, None, state,
                                (numerical, cats))
  want = np.asarray(jeval(state, jnp.asarray(numerical),
                          [jnp.asarray(c) for c in cats]))
  teval = ttr.make_sparse_eval_step(tmodel, tplan, trule)
  before = {k: v.clone() for k, v in tstate["fused"].items()}
  got = teval(tstate, torch.tensor(numerical),
              [torch.tensor(c) for c in cats]).numpy()
  assert got.shape == want.shape == (B,)
  np.testing.assert_allclose(got, want, **TOL)
  for k, v in before.items():  # eval never writes the state
    assert torch.equal(tstate["fused"][k], v)


@pytest.mark.parametrize("case", ["adagrad_d16", "adam_d128"])
def test_init_and_unpack_match_jax(case):
  """The port packs simple-layout tables as the JAX ``init_sparse_state``
  does (optimizer-state lanes at their initial values), and unpacks a
  packed state as the JAX ``unpack_sparse_state`` does."""
  d, _, _, jplan, tplan, jrule, trule, drawn, tmodel = _setup(case)
  params, _ = unpack_sparse_state(jplan, jrule, drawn)
  jparams = {**_jax_dense_params(d), "embeddings": params["embeddings"]}
  state = init_sparse_state(jplan, jparams, jrule, optax.sgd(LR))
  params, aux = unpack_sparse_state(jplan, jrule, state, include_aux=True)
  tables = {k: torch.tensor(np.asarray(v))
            for k, v in params["embeddings"].items()}
  dense = dlrm_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, _jax_dense_params(d)))
  tstate = ttr.init_sparse_state(
      tplan, {"embeddings": tables, **dense}, trule,
      functools.partial(torch.optim.SGD, lr=LR), device="cpu")
  for name, buf in state["fused"].items():
    np.testing.assert_array_equal(tstate["fused"][name].numpy(),
                                  np.asarray(buf), err_msg=name)
  tparams, taux = ttr.unpack_sparse_state(tplan, trule, tstate,
                                          include_aux=True)
  for name, table in params["embeddings"].items():
    np.testing.assert_array_equal(tparams["embeddings"][name].numpy(),
                                  np.asarray(table), err_msg=name)
  assert set(taux) == set(aux)
  for name, arrs in aux.items():
    for a, b in zip(taux[name], arrs):
      np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("rule_name,d,hot", [("sgd", 16, {5: 3}),
                                             ("adagrad", 128, {2: 3}),
                                             ("adagrad", 16, {5: 3})])
def test_chunked_and_stream_applies_match_one_shot(rule_name, d, hot):
  """``apply_sparse``'s chunked escape hatch (``apply_chunk``) and the
  prebuilt-stream form (``sparse_delta_streams`` then
  ``apply_sparse_streams``) update the buffers as the one-shot apply
  does; chunks only reorder the f32 adds of duplicate ids."""
  tplan = TStrategy(_configs(TTableConfig, d, hot, False, 64), 1,
                    dense_row_threshold=64)
  _, rule = _rules(rule_name)
  state = ttr.init_sparse_state_direct(
      tplan, rule, {}, functools.partial(torch.optim.SGD, lr=LR),
      torch.Generator().manual_seed(0), device="cpu")
  _, cats, _ = _batches(hot)[0]
  engine = DistributedLookup(tplan)
  layouts = engine.fused_layouts(rule)
  ids_all = engine.route_ids([torch.tensor(c) for c in cats])
  z, residuals = engine.lookup_sparse_fused(state["fused"], layouts, ids_all)
  rng = np.random.default_rng(3)
  d_z = {bk: torch.tensor(rng.standard_normal(tuple(v.shape))
                          .astype(np.float32)) for bk, v in z.items()}

  def applied(how):
    bufs = {k: v.clone() for k, v in state["fused"].items()}
    if how == "one_shot":
      engine.apply_sparse(bufs, layouts, d_z, residuals, rule, 0)
    elif how == "chunked":
      DistributedLookup(tplan, apply_chunk=5).apply_sparse(
          bufs, layouts, d_z, residuals, rule, 0)
    else:
      streams = engine.sparse_delta_streams(layouts, d_z, residuals, rule, 0)
      engine.apply_sparse_streams(bufs, layouts, streams, rule, 0)
    return bufs

  want = applied("one_shot")
  for how in ("chunked", "streams"):
    got = applied(how)
    for name, buf in want.items():
      assert not torch.equal(buf, state["fused"][name])
      np.testing.assert_allclose(got[name].numpy(), buf.numpy(),
                                 err_msg=f"{how} {name}", **TOL)


def test_init_direct_draws_the_packed_layout():
  tplan = TStrategy(_configs(TTableConfig, 16, {}, False, 64), 1,
                    dense_row_threshold=64)
  rule = tpt.adagrad_rule(LR)
  dense = {k: v for k, v in TDLRM(VOCAB, 16, bottom_mlp=(32, 16),
                                  top_mlp=(32, 16, 1), num_numerical=NUM,
                                  tables=False,
                                  device="cpu").state_dict().items()}
  state = ttr.init_sparse_state_direct(
      tplan, rule, dense, functools.partial(torch.optim.SGD, lr=LR),
      torch.Generator().manual_seed(0), device="cpu")
  params, aux = ttr.unpack_sparse_state(tplan, rule, state,
                                        include_aux=True)
  for name, table in params["embeddings"].items():
    assert table.abs().max() <= 0.05 and table.abs().max() > 0.04, name
  for (acc,) in aux.values():
    assert torch.all(acc == 0.1)
  assert state["dense_opt"] is not None and state["emb_dense_opt"]


def test_unported_options_raise():
  tplan = TStrategy(_configs(TTableConfig, 16, {5: 3}, False, 64), 1,
                    dense_row_threshold=64)
  model = TDLRM(VOCAB, 16, bottom_mlp=(32, 16), top_mlp=(32, 16, 1),
                num_numerical=NUM, tables=False, device="cpu")
  sgd = functools.partial(torch.optim.SGD, lr=LR)
  args = (model, tplan, torch_bce, sgd, tpt.sgd_rule(LR))
  # a plan runs on a mesh of its own world size (world > 1 plans:
  # tests/test_torch_train_world4.py)
  four = Mesh(rank=0, world=4, device=torch.device("cpu"), backend="gloo")
  with pytest.raises(ValueError, match="the mesh has 4 ranks"):
    ttr.make_sparse_train_step(*args, mesh=four)
  plan4 = TStrategy(_configs(TTableConfig, 16, {}, False, 64), 4,
                    dense_row_threshold=64)
  with pytest.raises(ValueError, match="needs this rank's mesh"):
    ttr.make_sparse_train_step(model, plan4, *args[2:])
  with pytest.raises(ValueError, match="needs this rank's mesh"):
    ttr.make_sparse_eval_step(model, plan4, tpt.sgd_rule(LR))
  # micro_batches > 1 and guard=True are ported
  # (tests/test_torch_micro_batch.py, tests/test_torch_guard.py); with
  # exact=True each is refused, as in the JAX builder
  with pytest.raises(NotImplementedError, match="micro_batches"):
    ttr.make_sparse_train_step(*args, micro_batches=2, exact=True)
  with pytest.raises(NotImplementedError, match="guard"):
    ttr.make_sparse_train_step(*args, guard=True, exact=True)
  # narrow multi-hot ids with optimizer state are ported (the masked
  # physical-row gather, tests/test_torch_train_zoo.py): the step runs
  rule = tpt.adagrad_rule(LR)
  state = ttr.init_sparse_state_direct(
      tplan, rule, model.state_dict(), sgd, torch.Generator().manual_seed(0),
      device="cpu")
  step = ttr.make_sparse_train_step(model, tplan, torch_bce, sgd, rule)
  numerical, cats, labels = _batches({5: 3})[0]
  _, loss = step(state, torch.tensor(numerical),
                 [torch.tensor(c) for c in cats], torch.tensor(labels))
  assert torch.isfinite(loss)


def test_state_constructors_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  tplan = TStrategy(_configs(TTableConfig, 16, {}, False, 64), 1,
                    dense_row_threshold=64)
  sgd = functools.partial(torch.optim.SGD, lr=LR)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ttr.init_sparse_state_direct(tplan, tpt.sgd_rule(LR), {}, sgd,
                                 torch.Generator())
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    train_state_from_flax({"fused": {}, "emb_dense": {}, "dense": {}})
