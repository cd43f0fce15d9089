"""The port's micro-batched sparse train step
(``make_sparse_train_step(micro_batches=N)``) against the JAX package's.

- **World 1, against the JAX micro-batch step.** One JAX fused train
  state crosses by ``convert.train_state_from_flax``; three batches go
  through the JAX step with ``micro_batches=4`` and through the port's:
  losses and every final array in the f32 class (rtol 1e-5, atol 1e-6),
  for the SGD (scale-only), Adagrad (D=16, eight logical rows a physical
  row), momentum and Adam rules, with padded multi-hot inputs, a dense
  class and an l2 on a dense-class table. The port's micro-batch step
  also matches its own one-shot step in that class.
- **World 4, against the JAX one-shot mesh step** (four gloo ranks,
  ``tests/torch_ranks.py: mb_guard_job``, against a 4-device CPU mesh):
  ``micro_batches=2`` under ``overlap='none'`` and ``'fused'`` with row
  slicing and a dense class, up to the order of the scatter's and the
  dense gradients' additions. The JAX mesh micro-batch step does not
  build on this jax (ROADMAP.md §3), so its documented contract — the
  one-shot step's numerics up to scatter order — is the oracle.
- **The refusals**, with the JAX package's messages: ``exact=True``, a
  batch that ``micro_batches`` does not divide, ragged ids.
- **With the guard**: a NaN batch skipped bit-exactly with
  ``micro_batches=2``, its metrics equal to the JAX guarded micro-batch
  step's.
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
from distributed_embeddings_torch.ops.ragged import RaggedIds
from distributed_embeddings_torch.resilience import faultinject
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    shard_batch,
    shard_params,
    unpack_sparse_state,
)
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [50, 7, 300, 12, 90, 400]
HOT = {0: 3, 5: 4}  # padded multi-hot sum inputs
NUM = 4
B = 32
STEPS = 3
LR = 0.1
N_MB = 4
THRESHOLD = 16  # the two smallest tables ride a dense class
PAD_ID = -1


def _configs(mod, d):
  return [mod(input_dim=v, output_dim=d,
              combiner="sum" if i in HOT else None,
              regularizer={"name": "l2", "factor": 1e-3} if i == 1 else None)
          for i, v in enumerate(VOCAB)]


def _batches(seed=0, n=STEPS, b=B):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in HOT:
        ids = rng.integers(0, v, (b, HOT[i])).astype(np.int32)
        ids[rng.random((b, HOT[i])) < 0.3] = PAD_ID
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, b).astype(np.int32))
    out.append((rng.standard_normal((b, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, b).astype(np.float32)))
  return out


def _rules(name):
  # Adam divides g by |g| + eps: a summation-order error in an entry near
  # eps would be amplified, so its case takes an eps that keeps it f32-class
  kw = {"eps": 1e-3} if name == "adam" else {}
  return (getattr(jpt, f"{name}_rule")(LR, **kw),
          getattr(tpt, f"{name}_rule")(LR, **kw))


def _jax_model(d):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=d, bottom_mlp=(16, d),
              top_mlp=(16, 1))


def _jax_state(jplan, jrule, d):
  acts = [jnp.zeros((2, d)) for _ in VOCAB]
  cats = [jnp.zeros((2,), jnp.int32) for _ in VOCAB]
  dense = _jax_model(d).init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                             cats, emb_acts=acts)["params"]
  return init_sparse_state_direct(jplan, jrule, dense, optax.sgd(LR),
                                  jax.random.PRNGKey(1))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step")}


def _tmodel(d):
  return TDLRM(VOCAB, d, bottom_mlp=(16, d), top_mlp=(16, 1),
               num_numerical=NUM, tables=False, device="cpu")


def _port_run(tstep, tstate, batches):
  losses = []
  for numerical, cats, labels in batches:
    out = tstep(tstate, torch.tensor(numerical),
                [torch.tensor(c) for c in cats], torch.tensor(labels))
    tstate = out[0]
    losses.append(float(out[1]))
  return tstate, losses


def _assert_state(tstate, jstate, tol=TOL):
  for name, buf in jstate["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(),
                               np.asarray(buf), err_msg=name, **tol)
  for name, table in jstate["emb_dense"].items():
    np.testing.assert_allclose(tstate["emb_dense"][name].detach().numpy(),
                               np.asarray(table), err_msg=name, **tol)
  want = dlrm_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, jstate["dense"]))
  for name, p in want.items():
    np.testing.assert_allclose(tstate["dense"][name].detach().numpy(),
                               p.numpy(), err_msg=name, **tol)
  assert tstate["step"] == int(jstate["step"])


def _setup(rule_name, d):
  jplan = DistEmbeddingStrategy(_configs(TableConfig, d), 1,
                                dense_row_threshold=THRESHOLD)
  tplan = TStrategy(_configs(TTableConfig, d), 1,
                    dense_row_threshold=THRESHOLD)
  jrule, trule = _rules(rule_name)
  return jplan, tplan, jrule, trule, _jax_state(jplan, jrule, d)


def _port_step(tplan, trule, d, **kw):
  return ttr.make_sparse_train_step(
      _tmodel(d), tplan, torch_bce, functools.partial(torch.optim.SGD, lr=LR),
      trule, **kw)


@pytest.mark.parametrize("rule_name,d", [("sgd", 128), ("adagrad", 16),
                                         ("momentum", 16), ("adam", 128)])
def test_micro_batch_matches_jax_at_world_1(rule_name, d):
  jplan, tplan, jrule, trule, state = _setup(rule_name, d)
  batches = _batches()
  kinds = {cp.kind for cp in tplan.classes.values()}
  assert kinds == {"sparse", "dense"}
  jstep = make_sparse_train_step(_jax_model(d), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 batches[0], donate=False,
                                 micro_batches=N_MB)
  jstate, jl = state, []
  for numerical, cats, labels in batches:
    jstate, loss = jstep(jstate, jnp.asarray(numerical),
                         [jnp.asarray(c) for c in cats],
                         jnp.asarray(labels))
    jl.append(float(loss))
  tstate, tl = _port_run(_port_step(tplan, trule, d, micro_batches=N_MB),
                         train_state_from_flax(_numpy_state(state),
                                               device="cpu"), batches)
  np.testing.assert_allclose(tl, jl, **TOL)
  _assert_state(tstate, jstate)
  # and the port's one-shot step, in the same class
  one, ol = _port_run(_port_step(tplan, trule, d),
                      train_state_from_flax(_numpy_state(state),
                                            device="cpu"), batches)
  np.testing.assert_allclose(tl, ol, **TOL)
  for name, buf in one["fused"].items():
    np.testing.assert_allclose(tstate["fused"][name].numpy(), buf.numpy(),
                               err_msg=name, **TOL)


def test_micro_batch_refusals_are_the_jax_messages():
  jplan, tplan, jrule, trule, state = _setup("sgd", 16)
  batch = _batches(n=1)[0]

  def both(fn_t, fn_j, exc):
    with pytest.raises(exc) as et:
      fn_t()
    with pytest.raises(exc) as ej:
      fn_j()
    assert str(et.value) == str(ej.value)
    return str(et.value)

  msg = both(lambda: _port_step(tplan, trule, 16, micro_batches=2,
                                exact=True),
             lambda: make_sparse_train_step(
                 _jax_model(16), jplan, bce_loss, optax.sgd(LR), jrule,
                 None, state, batch, donate=False, micro_batches=2,
                 exact=True), NotImplementedError)
  assert "exact=True" in msg
  numerical, cats, labels = batch
  jstep = make_sparse_train_step(_jax_model(16), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state, batch,
                                 donate=False, micro_batches=5)
  tstep = _port_step(tplan, trule, 16, micro_batches=5)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  before = {k: v.clone() for k, v in tstate["fused"].items()}
  msg = both(lambda: tstep(tstate, torch.tensor(numerical),
                           [torch.tensor(c) for c in cats],
                           torch.tensor(labels)),
             lambda: jstep(state, jnp.asarray(numerical),
                           [jnp.asarray(c) for c in cats],
                           jnp.asarray(labels)), ValueError)
  assert "not divisible by micro_batches 5" in msg
  assert all(torch.equal(tstate["fused"][k], v) for k, v in before.items())
  # ragged ids: the JAX message (the port's RaggedIds)
  tstep2 = _port_step(tplan, trule, 16, micro_batches=2)
  rag = [RaggedIds.from_dense(torch.tensor(c)) if c.ndim == 2
         else torch.tensor(c) for c in cats]
  with pytest.raises(NotImplementedError,
                     match="micro_batches > 1 needs dense cats"):
    tstep2(tstate, torch.tensor(numerical), rag, torch.tensor(labels))


def test_micro_batch_with_the_guard_skips_a_nan_batch():
  """The guard sees the accumulated gradients and streams: a NaN batch
  skipped with ``micro_batches=2`` leaves the state bit-equal to a run
  that never saw it, and the metrics equal the JAX guarded micro-batch
  step's."""
  jplan, tplan, jrule, trule, state = _setup("adagrad", 16)
  batches = _batches(seed=3)
  poisoned = list(faultinject.nan_batches(batches, at_steps={1}))
  jstep = make_sparse_train_step(_jax_model(16), jplan, bce_loss,
                                 optax.sgd(LR), jrule, None, state,
                                 batches[0], donate=False, guard=True,
                                 micro_batches=2)
  tstep = _port_step(tplan, trule, 16, micro_batches=2, guard=True)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstate = state
  for numerical, cats, labels in poisoned:
    jstate, jloss, jm = jstep(jstate, jnp.asarray(numerical),
                              [jnp.asarray(c) for c in cats],
                              jnp.asarray(labels))
    tstate, tloss, tm = tstep(tstate, torch.tensor(numerical),
                              [torch.tensor(c) for c in cats],
                              torch.tensor(labels))
    assert int(tm["bad_step"]) == int(jm["bad_step"])
    assert {k: int(v) for k, v in tm["oov"].items()} == \
        {k: int(v) for k, v in jm["oov"].items()}
    assert np.isnan(float(tloss)) == np.isnan(float(jloss))
  assert tstate["step"] == 2
  _assert_state(tstate, jstate)
  clean = train_state_from_flax(_numpy_state(state), device="cpu")
  clean, _ = _port_run(tstep, clean, [batches[0], batches[2]])
  for name, buf in clean["fused"].items():
    assert torch.equal(tstate["fused"][name], buf), name
  for part in ("dense", "emb_dense"):
    for name, t in clean[part].items():
      assert torch.equal(tstate[part][name], t), name


# ---------------------------------------------------------------------------
# world 4
# ---------------------------------------------------------------------------

W_VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
W_DIM = 16
W_B = 32  # global: 8 per rank
W_THRESHOLD = 32
W_ROW_SLICE = 256 * W_DIM  # tables of more than 256 rows are row-sliced


def _w_plan(world, overlap):
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=W_DIM) for v in W_VOCAB], world,
      "memory_balanced", dense_row_threshold=W_THRESHOLD,
      row_slice_threshold=W_ROW_SLICE, batch_hint=W_B, overlap=overlap,
      exchange_chunks=1 if overlap == "none" else 2)


def _w_model(world):
  return DLRM(vocab_sizes=W_VOCAB, embedding_dim=W_DIM, bottom_mlp=(16, W_DIM),
              top_mlp=(16, 1), world_size=world, row_slice=W_ROW_SLICE,
              dense_row_threshold=W_THRESHOLD)


def w_batches(n, seed=5):
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((W_B, NUM)).astype(np.float32),
           [rng.integers(0, v, W_B).astype(np.int32) for v in W_VOCAB],
           rng.integers(0, 2, W_B).astype(np.float32)) for _ in range(n)]


def w_initial(world=4):
  plan, model = _w_plan(world, "none"), _w_model(world)
  dense = model.init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
                     [jnp.zeros((2,), jnp.int32) for _ in W_VOCAB],
                     emb_acts=[jnp.zeros((2, W_DIM)) for _ in W_VOCAB]
                     )["params"]
  return init_sparse_state_direct(plan, jpt.adagrad_rule(LR), dense,
                                  optax.sgd(LR), jax.random.PRNGKey(1))


def w_spec(state, runs, batches):
  return {"vocab": W_VOCAB, "dim": W_DIM, "combiner": {}, "world": 4,
          "strategy": "memory_balanced", "dense_row_threshold": W_THRESHOLD,
          "row_slice": W_ROW_SLICE, "batch": W_B, "bottom": (16, W_DIM),
          "top": (16, 1), "num": NUM, "rule": "adagrad", "lr": LR,
          "state": _numpy_state(state), "batches": batches, "runs": runs}


def w_jax_run(state, batches, guard=False, overlap="none", oov="clip",
              eval_batch=None):
  """The JAX one-shot mesh step over a 4-device CPU mesh: losses, the
  metrics (guarded) and the final state unpacked to the simple layout;
  with ``eval_batch`` also the eval step's metrics and predictions on the
  final state."""
  mesh = create_mesh(4)
  plan = _w_plan(4, overlap)
  if oov != "clip":
    plan.oov = oov
  st = shard_params(state, mesh)
  step = make_sparse_train_step(_w_model(4), plan, bce_loss, optax.sgd(LR),
                                jpt.adagrad_rule(LR), mesh, st,
                                shard_batch(batches[0], mesh), donate=False,
                                guard=guard)
  losses, metrics = [], []
  for numerical, cats, labels in batches:
    out = step(st, *shard_batch((numerical, list(cats), labels), mesh))
    st = out[0]
    losses.append(float(out[1]))
    if guard:
      metrics.append({"bad_step": int(out[2]["bad_step"]),
                      "oov": {k: int(v) for k, v in out[2]["oov"].items()}})
  params, aux = unpack_sparse_state(plan, jpt.adagrad_rule(LR),
                                    jax.device_get(st), include_aux=True)
  final = jax.tree_util.tree_map(np.asarray, (params, aux))
  if eval_batch is None:
    return losses, metrics, final
  ev = make_sparse_eval_step(_w_model(4), plan, jpt.adagrad_rule(LR), mesh,
                             st, eval_batch, with_metrics=True)
  preds, m = ev(st, *shard_batch(eval_batch, mesh))
  evaluated = {"oov": {k: int(v) for k, v in m["oov"].items()},
               "preds": np.asarray(preds)}
  return losses, metrics, final, evaluated


def assert_w_final(res, params, aux, tol=TOL):
  got_params, got_aux = res["unpacked"]
  for name, t in params["embeddings"].items():
    np.testing.assert_allclose(got_params[name], t, err_msg=name, **tol)
  for name, lanes in aux.items():
    for j, a in enumerate(lanes):
      np.testing.assert_allclose(got_aux[name][j], a, err_msg=name, **tol)
  want = dlrm_state_dict_from_flax(
      {k: v for k, v in params.items() if k != "embeddings"})
  for name, p in want.items():
    np.testing.assert_allclose(res["dense"][name], p.numpy(), err_msg=name,
                               **tol)


@pytest.fixture(scope="module")
def world4_mb(tmp_path_factory):
  state = w_initial()
  batches = w_batches(2)
  runs = [{"name": f"mb2_{ov}", "overlap": ov, "micro_batches": 2,
           "guard": False} for ov in ("none", "fused")]
  res = spawn(tmp_path_factory.mktemp("mb4"), 4, "mb_guard_job",
              w_spec(state, runs, batches))
  return state, batches, res


@pytest.mark.parametrize("overlap", ["none", "fused"])
def test_micro_batch_at_world_4_matches_the_jax_one_shot_step(world4_mb,
                                                              overlap):
  state, batches, res = world4_mb
  losses, _, (params, aux) = w_jax_run(state, batches, overlap=overlap)
  for r in res:
    got = r[f"mb2_{overlap}"]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert got["step"] == len(batches)
  assert_w_final(res[0][f"mb2_{overlap}"], params, aux)
