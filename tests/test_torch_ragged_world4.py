"""Ragged value streams at world 4: four gloo ranks (one spawn of
``tests/torch_ranks.py: multi_job``) against the JAX package over a
4-device CPU mesh, on the cell of ``tests/torch_wire_cases.py`` (nine
D=16 tables, three in a dense class, two row-sliced) with its three
multi-hot inputs arriving as ``RaggedIds`` (``sum``, ``mean`` and a
``mean`` input on a row-sliced table; lengths 0-6, a fifth of the ids
-1; declared by negative ``input_hotness``). Every rank passes its own
block of the JAX package's global (stacked) batch.

- **Forward** (``wire_forward_job``): the activations under
  ``overlap='none'``, ``'pipelined'`` and ``'fused'`` (2 chunks), with and
  without ``dedup_exchange`` (deduplicated padded buckets beside raw
  ragged ones), bit-exact against the JAX forward, and the exchanged
  ``(vals, lens)`` of every ragged bucket too.
- **The sparse step** (``mb_guard_job``): three guarded SGD steps under
  each schedule and three Adagrad steps under ``'fused'`` against the JAX
  mesh step in the f32 class (losses, every final table and optimizer
  lane, the dense parameters, the eval step's predictions); the guard's
  and the eval step's OOV counts equal the JAX ones (an id past the
  vocabulary in a live window counts, one in the dead tail does not);
  the schedules are bit-exact against ``'none'``.
- **The dense-autodiff step** (``dense_extras_job``): ``make_train_step(
  mesh=)`` over a model owning a ``DistributedEmbedding`` with ragged
  inputs, Adagrad, under ``'none'`` and ``'fused'``, against the JAX
  world-4 step in the f32 class.
- **Serving** (``serve_job``): ragged requests through ``ServeEngine`` on
  the port's artifact, the JAX package's and the frozen tables, f32 and
  int8, bit-equal to each other and (f32) to the port's eval step, and
  in the f32 class of the JAX eval step; a request whose ragged inputs
  come as one global CSR stream (a ``MicroBatcher`` dispatch's form) gets
  the stacked form's answers bit for bit.
- **Model-parallel inputs** (``mp_input_job``): ``forward_mp`` of a global
  batch bit-exact against the JAX ``forward_mp`` and the dp-input
  forward, its gradients those of the dp-input forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_wire_cases as C
from distributed_embeddings_torch.ops.ragged import RaggedIds as TRagged
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from test_torch_ragged_engine import _jax_world_forward, _jax_world_mp, _mp_case
from test_torch_wire_train import assert_final
from torch_ragged_cases import jax_batch, ragged_batches, single_stream
from torch_ranks import spawn_start, spawn_wait

RAGGED = {4: 6, 5: 4, 8: 5}  # input -> max hotness (8: the row-sliced table)
HOTNESS = [1, 1, 1, 1, -6, -4, 1, 1, -5]
HOT_KW = {"input_hotness": HOTNESS}
SCHEDULES = {"none": {"overlap": "none"},
             "pipelined": {"overlap": "pipelined", "chunks": 3},
             "fused": {"overlap": "fused", "chunks": 2}}
B_LOCAL = C.B // C.WORLD


def _batches(n, seed):
  return ragged_batches(n, C.VOCAB, RAGGED, C.WORLD, B_LOCAL, C.NUM, seed)


def _with_oov(batch):
  """One id of input 4 past its vocabulary in a live window of rank 1's
  block, and one in the dead tail of rank 2's (which must not count)."""
  numerical, cats, labels = batch
  rg = cats[4]
  values = np.asarray(rg.values).copy()
  splits = np.asarray(rg.row_splits)
  cap, n = values.shape[0] // C.WORLD, splits.shape[0] // C.WORLD
  end1 = int(splits[2 * n - 1])
  assert end1 > 0
  values[cap] = C.VOCAB[4] + 3
  end2 = int(splits[3 * n - 1])
  if end2 < cap:
    values[2 * cap + end2] = C.VOCAB[4] + 9
  cats = list(cats)
  cats[4] = TRagged(values, splits)
  return numerical, cats, labels


def _forward_cases():
  rng = np.random.default_rng(21)
  weights = [rng.standard_normal((v, C.DIM)).astype(np.float32)
             for v in C.VOCAB]
  numerical, cats, _ = _batches(1, seed=22)[0]
  del numerical
  cases = {}
  for name, knobs in {
      "none": {}, "pipelined": {"overlap": "pipelined",
                                "exchange_chunks": 2},
      "fused": {"overlap": "fused", "exchange_chunks": 2},
      "dedup": {"dedup_exchange": True},
      "dedup_fused": {"dedup_exchange": True, "overlap": "fused",
                      "exchange_chunks": 2}}.items():
    kw = dict(dense_row_threshold=C.THRESHOLD,
              row_slice_threshold=C.ROW_SLICE, batch_hint=C.B, **HOT_KW,
              **knobs)
    jplan = DistEmbeddingStrategy(
        [TableConfig(input_dim=v, output_dim=C.DIM,
                     combiner=C.COMBINER.get(i))
         for i, v in enumerate(C.VOCAB)], C.WORLD, "memory_balanced", **kw)
    cases[name] = (jplan, {
        "tables": [(v, C.DIM, C.COMBINER.get(i))
                   for i, v in enumerate(C.VOCAB)],
        "strategy": "memory_balanced", "plan_kw": kw,
        "params": set_weights(jplan, weights), "inputs": cats,
        "route": True})
  return cases


# the dense-autodiff cell: a DistributedEmbedding with ragged inputs
DENSE_COMBINER = dict(C.COMBINER)
DENSE_SCHEDULES = (("none", 1), ("fused", 2))


def _jax_tiny():
  import flax.linen as fnn
  from distributed_embeddings_tpu.layers.dist_model_parallel import (
      DistributedEmbedding,
  )

  class Tiny(fnn.Module):

    @fnn.compact
    def __call__(self, numerical, cats):
      embs = DistributedEmbedding(
          embeddings=tuple(TableConfig(input_dim=v, output_dim=C.DIM,
                                       combiner=DENSE_COMBINER.get(i))
                           for i, v in enumerate(C.VOCAB)),
          strategy="memory_balanced", row_slice=C.ROW_SLICE,
          world_size=C.WORLD, dense_row_threshold=C.THRESHOLD,
          name="embeddings")(list(cats))
      x = jnp.concatenate([numerical] + list(embs), axis=1)
      return fnn.Dense(1, name="head")(x)[:, 0]

  return Tiny()


def _jax_train(model, params, batches, eval_batch, opt):
  """Three steps of the JAX world-4 ``make_train_step`` on JAX batches,
  then its eval step: ``(losses, final params, global preds)``."""
  from distributed_embeddings_tpu.models import bce_loss
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.training import (
      make_eval_step,
      make_train_step,
      shard_batch,
      shard_params,
  )
  mesh = create_mesh(C.WORLD)

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  p = shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
  s = shard_params(opt.init(p), mesh)
  step = make_train_step(loss_fn, opt, mesh, p, s, batches[0], donate=False)
  losses = []
  for batch in batches:
    p, s, loss = step(p, s, *shard_batch(batch, mesh))
    losses.append(np.float32(loss))
  ev = make_eval_step(lambda q, n, c: model.apply({"params": q}, n, c), mesh,
                      p, eval_batch)
  preds = np.asarray(ev(p, *shard_batch(eval_batch, mesh)))
  return (np.asarray(losses, np.float32),
          jax.tree_util.tree_map(np.asarray, p), preds)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("ragged_w4")
  batches = _batches(C.STEPS, seed=23)
  batches[1] = _with_oov(batches[1])
  ev = _batches(1, seed=24)[0][:2]
  sgd_state, ada_state = C.initial("sgd"), C.initial("adagrad")
  runs = [dict(name=n, micro_batches=1, guard=True, plan_kw=HOT_KW, eval=ev,
               **kw) for n, kw in SCHEDULES.items()]
  forward = _forward_cases()
  mp_jplan, _, mp_case = _mp_case(C.WORLD, seed=25, g=C.B)
  # the dense-autodiff cell
  dense_batches = _batches(C.STEPS, seed=26)
  dense_ev = _batches(1, seed=27)[0][:2]
  tiny = _jax_tiny()
  init = jax.tree_util.tree_map(np.asarray, tiny.init(
      jax.random.PRNGKey(0), *jax_batch(dense_batches[0][:2]))["params"])
  dense_spec = {"vocab": C.VOCAB, "dim": C.DIM, "num": C.NUM,
                "combiner": DENSE_COMBINER, "penalties": {},
                "row_slice": C.ROW_SLICE,
                "dense_row_threshold": C.THRESHOLD, "lr": C.LR,
                "init": init, "batches": dense_batches,
                "eval_batch": dense_ev, "schedules": DENSE_SCHEDULES}
  # serving: the SGD state exported by the JAX package
  jax_dir = str(tmp / "jax")
  serve_plan = C.plan("fused", 2, **HOT_KW)
  numpy_state = C.numpy_state(sgd_state)
  for q in ("f32", "int8"):
    jserving.export(os.path.join(jax_dir, q), serve_plan,
                    C.rule_of("sgd"), numpy_state, quantize=q)
  requests = [_batches(1, seed=28 + i)[0][:2] for i in range(2)]
  # the first request again, its ragged inputs as one global CSR stream
  # (what a MicroBatcher dispatches): shard_batch cuts it per rank
  requests.append((requests[0][0], [
      single_stream(c, C.WORLD) if isinstance(c, TRagged) else c
      for c in requests[0][1]]))
  serve_spec = dict(C.spec(sgd_state, "sgd", [], []), requests=requests,
                    quantize=("f32", "int8"), jax=jax_dir,
                    port=str(tmp / "port"), plan_kw=HOT_KW)
  started = spawn_start(tmp, C.WORLD, "multi_job", {"jobs": {
      "forward": ("wire_forward_job", {"cases": {
          n: c for n, (_, c) in forward.items()}}),
      "sgd": ("mb_guard_job", C.spec(sgd_state, "sgd", runs, batches)),
      "adagrad": ("mb_guard_job", C.spec(ada_state, "adagrad", [dict(
          name="fused", overlap="fused", chunks=2, micro_batches=1,
          guard=False, plan_kw=HOT_KW, eval=ev, rule="adagrad")], batches)),
      "dense": ("dense_extras_job", dense_spec),
      "serve": ("serve_job", serve_spec),
      "mp": ("mp_input_job", {"cases": {"mp": mp_case}})}})
  jb = [jax_batch(b) for b in batches]
  want = {
      "forward": {n: _jax_world_forward(p, c["params"], c["inputs"],
                                        C.WORLD)
                  for n, (p, c) in forward.items()
                  if n in ("none", "dedup")},
      "sgd": C.jax_run(sgd_state, "sgd", jb, guard=True,
                       eval_batch=jax_batch(ev), **HOT_KW),
      "adagrad": C.jax_run(ada_state, "adagrad", jb, eval_batch=jax_batch(ev),
                           **HOT_KW),
      "dense": _jax_train(tiny, init, [jax_batch(b) for b in dense_batches],
                          jax_batch(dense_ev), optax.adagrad(C.LR)),
      "serve": [C.jax_run(sgd_state, "sgd", [], eval_batch=jax_batch(r),
                          overlap="fused", chunks=2, **HOT_KW)["eval"]
                for r in requests[:2]],
      "mp": _jax_world_mp(mp_jplan, mp_case, C.WORLD)}
  return want, spawn_wait(started)


@pytest.mark.parametrize("name", ["none", "pipelined", "fused", "dedup",
                                  "dedup_fused"])
def test_forward_and_exchanged_streams_are_bit_exact(world4, name):
  want, got = world4
  outs, routed = want["forward"]["dedup" if "dedup" in name else "none"]
  for rank, rank_out in enumerate(got):
    res = rank_out["forward"][name]
    for t, (a, b) in enumerate(zip(res["outs"], outs)):
      np.testing.assert_array_equal(a, b, err_msg=f"{name} input {t}")
    assert sorted(res["routed"]) == sorted(routed) and routed
    for k, (v, l) in res["routed"].items():
      np.testing.assert_array_equal(v, routed[k][0][rank], err_msg=k)
      np.testing.assert_array_equal(l, routed[k][1][rank], err_msg=k)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_guarded_sgd_step_matches_jax(world4, name):
  want, got = world4
  w = want["sgd"]
  for rank_out in got:
    res = rank_out["sgd"][name]
    np.testing.assert_allclose(res["losses"], w["losses"], **C.TOL)
    assert res["metrics"] == [
        {"bad_step": m["bad_step"], "oov": m["oov"]} for m in w["metrics"]]
    assert sum(res["metrics"][1]["oov"].values()) == 1
    np.testing.assert_allclose(res["eval"]["preds"], w["eval"]["preds"],
                               **C.TOL)
    assert res["eval"]["oov"] == w["eval"]["oov"]
  assert_final(got[0]["sgd"][name], w["final"])


@pytest.mark.parametrize("name", ["pipelined", "fused"])
def test_schedules_are_bit_exact_against_none(world4, name):
  _, got = world4
  base, res = got[0]["sgd"]["none"], got[0]["sgd"][name]
  assert res["losses"] == base["losses"]
  for part in (0, 1):
    for k, arr in base["unpacked"][part].items():
      np.testing.assert_array_equal(res["unpacked"][part][k], arr,
                                    err_msg=k)
  np.testing.assert_array_equal(res["eval"]["preds"], base["eval"]["preds"])


def test_adagrad_step_matches_jax(world4):
  want, got = world4
  w = want["adagrad"]
  for rank_out in got:
    res = rank_out["adagrad"]["fused"]
    np.testing.assert_allclose(res["losses"], w["losses"], **C.TOL)
    np.testing.assert_allclose(res["eval"]["preds"], w["eval"]["preds"],
                               **C.TOL)
  assert_final(got[0]["adagrad"]["fused"], w["final"])
  assert got[0]["adagrad"]["fused"]["unpacked"][1]


@pytest.mark.parametrize("schedule", [f"{o}/{c}" for o, c in
                                      DENSE_SCHEDULES])
def test_dense_autodiff_step_matches_jax(world4, schedule):
  want, got = world4
  want_losses, params, want_preds = want["dense"]
  for rank_out in got:
    losses, final, preds = rank_out["dense"][schedule]
    np.testing.assert_allclose(losses, want_losses, **C.TOL)
    for name, buf in params["embeddings"].items():
      np.testing.assert_allclose(final[f"embeddings.{name}"], buf,
                                 err_msg=name, **C.TOL)
    np.testing.assert_allclose(preds, want_preds, **C.TOL)


@pytest.mark.parametrize("q", ["f32", "int8"])
def test_ragged_serving_is_bit_equal_across_sources_and_to_eval(world4, q):
  want, got = world4
  base = got[0]["serve"][q]["port"]
  for rank_out in got:
    for source in ("port", "jax", "frozen"):
      for g, b in zip(rank_out["serve"][q][source], base):
        assert g.shape == (C.B,) and np.all(np.isfinite(g))
        np.testing.assert_array_equal(g, b, err_msg=source)
    # the global CSR stream serves the first request's samples alike
    np.testing.assert_array_equal(rank_out["serve"][q]["port"][2],
                                  rank_out["serve"][q]["port"][0])
    if q == "f32":
      for g, e in zip(rank_out["serve"][q]["port"],
                      rank_out["serve"][q]["eval"]):
        np.testing.assert_array_equal(g, e)
      for g, w in zip(rank_out["serve"][q]["port"], want["serve"]):
        np.testing.assert_allclose(g, w["preds"], **C.TOL)


def test_mp_input_forward_matches_jax_and_the_dp_input_forward(world4):
  want, got = world4
  packed, outs = want["mp"]
  for rank_out in got:
    res = rank_out["mp"]["mp"]
    for k in packed:
      np.testing.assert_array_equal(res["packed"][k], packed[k])
    for form in ("mp", "dp"):
      for a, b in zip(res[form]["outs"], outs):
        np.testing.assert_array_equal(a, b, err_msg=form)
    for a, b in zip(res["layer"], outs):
      np.testing.assert_array_equal(a, b)
    for k, g in res["dp"]["grads"].items():
      np.testing.assert_allclose(res["mp"]["grads"][k], g, err_msg=k,
                                 **C.TOL)
