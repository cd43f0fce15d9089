"""Column-sliced tables at world 4: four gloo ranks (one spawn of
``tests/torch_ranks.py: multi_job``) against the JAX package over a
4-device CPU mesh.

The DLRM cell of ``tests/torch_wire_cases.py`` (nine width-16 tables,
three in a dense class; padded multi-hot ``sum`` and ``mean`` inputs) is
planned with ``column_slice_threshold=512``: the tables of more than 512
elements split into two 8-lane slices (40 and 64 rows, the ``sum``
multi-hot input among them) or four 4-lane slices (100-600 rows, both
``mean`` multi-hot inputs), so every sparse class is narrow and packs
8-32 rows into a physical row, and the multi-hot buckets of the Adagrad
runs take the window-masked gather.

- **Plans** (the oracles ``tests/test_dist_model_parallel.py:172,178``):
  the explicit threshold, the auto threshold with fewer tables than ranks
  and a plan of 2-lane slices, field by field against the JAX planner.
- **Forward** (``wire_forward_job``): the activations under
  ``overlap='none'``, ``'pipelined'``, ``'fused'`` and with
  ``dedup_exchange`` bit-exact against the JAX forward, the slices
  concatenated in ``output_pieces`` order; the class gradients of ``sum(out
  * ct)`` (the reverse exchange's cotangents per slice) bit-exact against
  JAX's too (with dedup in the f32 class: the unique ids' cotangents are
  summed before the exchange).
- **The sparse step** (``mb_guard_job``, the oracle
  ``tests/test_sparse_training.py:310``): three SGD and three Adagrad steps
  under each schedule, with dedup (Adagrad against the JAX dedup step) and
  with ``exact=True``, in the f32 class (rtol 1e-5, atol 1e-6) of the JAX
  mesh step (losses, every final table
  and optimizer lane, the dense parameters, the eval predictions); the
  schedules bit-exact against ``'none'``.
- **Serving** (``serve_job``): the f32 and int8 images the ranks export
  byte-identical to the JAX package's (int8 scales per slice row), every
  answer bit-equal across the two artifacts and the frozen tables, and f32
  bit-equal to the eval step.
- **Checkpoints** (``ckpt_job``, Adagrad): the ranks' checkpoint restores
  in JAX bit-equal, and a JAX checkpoint restores in the port bit-equal;
  each continues in the f32 class of the other's straight run.
- **Dense autodiff** (``dense_extras_job``): ``make_train_step(mesh=)``
  over a ``DistributedEmbedding(column_slice_threshold=)``, Adagrad, three
  steps against the JAX world-4 step in the f32 class.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import torch_wire_cases as C
from distributed_embeddings_torch.layers.embedding import (
    TableConfig as TTableConfig,
)
from distributed_embeddings_torch.layers.planner import (
    DistEmbeddingStrategy as TStrategy,
)
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu import serving as jserving
from distributed_embeddings_tpu.compat import shard_map
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel import lookup_engine as jle
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    shard_batch,
    shard_params,
    unpack_sparse_state,
)
from test_torch_checkpoint_world4 import _compare, _jax_flat, _rank_view
from test_torch_planner import plan_fields
from test_torch_ragged_world4 import _jax_train
from test_torch_wire_train import assert_final
from torch_ranks import spawn_start, spawn_wait

SLICE = 512  # elements: 40-64 rows -> two 8-lane slices, 100+ -> four 4-lane
SL = {"column_slice_threshold": SLICE}
SCHEDULES = {"none": {"overlap": "none"},
             "pipelined": {"overlap": "pipelined", "chunks": 3},
             "fused": {"overlap": "fused", "chunks": 2}}
# the port's extra runs: name -> (run knobs, the JAX run it is held to
# under SGD, under Adagrad); Adagrad's dedup semantics (once per unique id
# and source block) differ from the raw step's, SGD's do not
EXTRA = {"dedup": ({"overlap": "fused", "chunks": 2,
                    "plan_kw": {**SL, "dedup_exchange": True}},
                   ("raw", "dedup")),
         "exact": ({"overlap": "none", "exact": True}, ("exact", "exact"))}
# forward cases: name -> (tables, plan knobs); "auto" has fewer tables
# than ranks and no threshold, "narrow" slices width-8 tables to 2 lanes
AUTO = [(300, 16, "sum"), (50, 8, None)]
NARROW = [(200, 8, "sum"), (90, 8, None), (500, 16, "mean")]
NARROW_SLICE = 100
FWD_HOT = {"auto": {0: 3}, "narrow": {0: 3, 2: 4}}


def _cell_tables():
  return [(v, C.DIM, C.COMBINER.get(i)) for i, v in enumerate(C.VOCAB)]


def _plan_kw(name):
  base = dict(dense_row_threshold=C.THRESHOLD, row_slice_threshold=C.ROW_SLICE,
              batch_hint=C.B)
  if name == "auto":
    return {"batch_hint": C.B}
  if name == "narrow":
    return {"batch_hint": C.B, "column_slice_threshold": NARROW_SLICE}
  knobs = {"none": {}, "pipelined": {"overlap": "pipelined",
                                     "exchange_chunks": 2},
           "fused": {"overlap": "fused", "exchange_chunks": 2},
           "dedup": {"dedup_exchange": True},
           "dedup_fused": {"dedup_exchange": True, "overlap": "fused",
                           "exchange_chunks": 2}}[name]
  return {**base, **SL, **knobs}


def _tables_of(name):
  return {"auto": AUTO, "narrow": NARROW}.get(name, _cell_tables())


def _jax_plan(name):
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=w, combiner=c)
       for v, w, c in _tables_of(name)], C.WORLD, "memory_balanced",
      **_plan_kw(name))


def _port_plan(name):
  return TStrategy(
      [TTableConfig(input_dim=v, output_dim=w, combiner=c)
       for v, w, c in _tables_of(name)], C.WORLD, "memory_balanced",
      **_plan_kw(name))


@pytest.mark.parametrize("name", ["none", "auto", "narrow"])
def test_sliced_plans_equal_jax_field_by_field(name):
  want, got = _jax_plan(name), _port_plan(name)
  assert plan_fields(got) == plan_fields(want)
  assert got.sliced_out_ranges and got.sliced_out_ranges == \
      want.sliced_out_ranges
  widths = {key[0] for key in got.class_keys}
  assert widths == {"none": {16, 8, 4}, "auto": {8, 4},
                    "narrow": {2, 4}}[name], widths


def _sliced_initial(rule_name, dense_opt=None):
  """The JAX initial state of the sliced cell under ``rule_name`` (its
  dense optimizer ``dense_opt``, SGD by default)."""
  dense = C.model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, C.NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in C.VOCAB],
      emb_acts=[jnp.zeros((2, C.DIM)) for _ in C.VOCAB])["params"]
  return init_sparse_state_direct(C.plan(**SL), C.rule_of(rule_name), dense,
                                  dense_opt or optax.sgd(C.LR),
                                  jax.random.PRNGKey(1))


def _jax_run(state, rule_name, batches, eval_batch, exact=False, **kw):
  """The JAX mesh step of the sliced plan (``kw``: more plan knobs) over
  the batches and its eval step: losses, the final state unpacked, the
  predictions."""
  mesh = create_mesh(C.WORLD)
  p = C.plan(**SL, **kw)
  rule = C.rule_of(rule_name)
  st = shard_params(state, mesh)
  step = make_sparse_train_step(C.model(), p, C.bce_loss, optax.sgd(C.LR),
                                rule, mesh, st, shard_batch(batches[0], mesh),
                                donate=False, exact=exact)
  losses = []
  for numerical, cats, labels in batches:
    st, loss = step(st, *shard_batch((numerical, list(cats), labels), mesh))
    losses.append(float(loss))
  params, aux = unpack_sparse_state(p, rule, jax.device_get(st),
                                    include_aux=True)
  ev = make_sparse_eval_step(C.model(), p, rule, mesh, st, eval_batch)
  return {"losses": losses,
          "final": jax.tree_util.tree_map(np.asarray, (params, aux)),
          "preds": np.asarray(ev(st, *shard_batch(eval_batch, mesh)))}


def _jax_forward_grads(plan, params, inputs, cts):
  """The JAX world-4 forward of global ``inputs`` and the class gradients
  of ``sum(out * ct)`` over the ranks."""
  engine = jle.DistributedLookup(plan)
  mesh = create_mesh(C.WORLD)

  def fwd(p, xs, cs):
    def loss(q):
      outs = engine.forward(q, list(xs))
      return sum(jnp.sum(o * c) for o, c in zip(outs, cs)), outs
    grads, outs = jax.grad(loss, has_aux=True)(p)
    return tuple(outs), grads

  specs = {n: P("mp", None) for n in params}
  outs, grads = jax.jit(shard_map(
      fwd, mesh=mesh,
      in_specs=(specs, tuple(P("mp") for _ in inputs),
                tuple(P("mp") for _ in cts)),
      out_specs=(tuple(P("mp") for _ in inputs), specs)))(
          {k: jnp.asarray(v) for k, v in params.items()},
          tuple(jnp.asarray(x) for x in inputs),
          tuple(jnp.asarray(c) for c in cts))
  return ([np.asarray(o) for o in outs],
          {k: np.asarray(v) for k, v in grads.items()})


def _forward_case(name, rng):
  tables = _tables_of(name)
  hot = FWD_HOT.get(name, C.HOT)
  weights = [rng.standard_normal((v, w)).astype(np.float32)
             for v, w, _ in tables]
  inputs = []
  for i, (v, _, _) in enumerate(tables):
    if i in hot:
      ids = rng.integers(0, v, (C.B, hot[i])).astype(np.int32)
      ids[rng.random((C.B, hot[i])) < 0.25] = -1
    else:
      ids = rng.integers(0, v, C.B).astype(np.int32)
    inputs.append(ids)
  cts = [rng.standard_normal((C.B, w)).astype(np.float32)
         for _, w, _ in tables]
  return {"tables": tables, "strategy": "memory_balanced",
          "plan_kw": _plan_kw(name),
          "params": set_weights(_jax_plan(name), weights),
          "inputs": inputs, "ct": cts}


def _ckpt_spec(mode, path, state):
  return {"vocab": C.VOCAB, "dim": C.DIM, "combiner": C.COMBINER,
          "world": C.WORLD, "strategy": "memory_balanced",
          "dense_row_threshold": C.THRESHOLD, "row_slice": C.ROW_SLICE,
          "batch": C.B, "bottom": C.BOTTOM, "top": C.TOP, "num": C.NUM,
          "overlap": "fused", "chunks": 2, "opt": "adagrad",
          "rule": "adagrad", "lr": C.LR, "plan_kw": SL,
          "state": jax.tree_util.tree_map(np.asarray, jax.device_get(state)),
          "batches": C.batches(CKPT_STEPS, seed=41), "n": CKPT_N,
          "mode": mode, "path": path}


CKPT_N, CKPT_STEPS = 1, 3


def _jax_ckpt_run(state, batches):
  """The JAX Adagrad mesh step of the sliced plan over the batches: the
  state after ``CKPT_N`` steps, the final state and the losses."""
  mesh = create_mesh(C.WORLD)
  p = C.plan("fused", 2, **SL)
  st = shard_params(state, mesh)
  step = make_sparse_train_step(C.model(), p, C.bce_loss,
                                optax.adagrad(C.LR), C.rule_of("adagrad"),
                                mesh, st, shard_batch(batches[0], mesh),
                                donate=False)
  losses, half = [], None
  for numerical, cats, labels in batches:
    st, loss = step(st, *shard_batch((numerical, list(cats), labels), mesh))
    losses.append(float(loss))
    if len(losses) == CKPT_N:
      half = st
  return half, st, losses


def _jax_dense_model():
  import flax.linen as fnn
  from distributed_embeddings_tpu.layers.dist_model_parallel import (
      DistributedEmbedding,
  )

  class Tiny(fnn.Module):

    @fnn.compact
    def __call__(self, numerical, cats):
      embs = DistributedEmbedding(
          embeddings=tuple(TableConfig(input_dim=v, output_dim=C.DIM,
                                       combiner=C.COMBINER.get(i))
                           for i, v in enumerate(C.VOCAB)),
          strategy="memory_balanced", column_slice_threshold=SLICE,
          row_slice=C.ROW_SLICE, world_size=C.WORLD,
          dense_row_threshold=C.THRESHOLD, name="embeddings")(list(cats))
      x = jnp.concatenate([numerical] + list(embs), axis=1)
      return fnn.Dense(1, name="head")(x)[:, 0]

  return Tiny()


DENSE_SCHEDULES = (("none", 1), ("fused", 2))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("colslice_w4")
  batches, ev = C.batches(C.STEPS, seed=31), C.batches(1, seed=32)[0][:2]
  rng = np.random.default_rng(33)
  cell = _forward_case("none", rng)
  forward = {name: dict(cell, plan_kw=_plan_kw(name)) for name in
             ("none", "pipelined", "fused", "dedup", "dedup_fused")}
  forward.update({name: _forward_case(name, rng)
                  for name in ("auto", "narrow")})
  states = {r: _sliced_initial(r) for r in ("sgd", "adagrad")}
  knobs = {**SCHEDULES, **{n: kw for n, (kw, _) in EXTRA.items()}}
  runs = {r: [{"name": n, "micro_batches": 1, "guard": False, "plan_kw": SL,
               "eval": ev, "rule": r, **kw} for n, kw in knobs.items()]
          for r in states}
  # serving: the SGD state exported by the JAX package
  jax_dir = str(tmp / "jax")
  serve_plan = C.plan("fused", 2, **SL)
  for q in ("f32", "int8"):
    jserving.export(os.path.join(jax_dir, q), serve_plan, C.rule_of("sgd"),
                    C.numpy_state(states["sgd"]), quantize=q)
  requests = [C.batches(1, seed=34 + i)[0][:2] for i in range(2)]
  serve_spec = dict(C.spec(states["sgd"], "sgd", [], []), requests=requests,
                    quantize=("f32", "int8"), jax=jax_dir,
                    port=str(tmp / "port"), plan_kw=SL)
  # checkpoints: Adagrad on both sides, the JAX one written first
  ckpt_state = _sliced_initial("adagrad", optax.adagrad(C.LR))
  ckpt_batches = C.batches(CKPT_STEPS, seed=41)
  half, straight, ckpt_losses = _jax_ckpt_run(ckpt_state, ckpt_batches)
  jax_ckpt = str(tmp / "jax_ckpt")
  jck.save(jax_ckpt, C.plan("fused", 2, **SL), C.rule_of("adagrad"), half)
  port_ckpt = str(tmp / "port_ckpt")
  # the dense-autodiff cell
  dense_batches = C.batches(C.STEPS, seed=36)
  dense_ev = C.batches(1, seed=37)[0][:2]
  tiny = _jax_dense_model()
  init = jax.tree_util.tree_map(np.asarray, tiny.init(
      jax.random.PRNGKey(0), jnp.asarray(dense_batches[0][0]),
      [jnp.asarray(c) for c in dense_batches[0][1]])["params"])
  dense_spec = {"vocab": C.VOCAB, "dim": C.DIM, "num": C.NUM,
                "combiner": C.COMBINER, "penalties": {},
                "row_slice": C.ROW_SLICE, "dense_row_threshold": C.THRESHOLD,
                "lr": C.LR, "init": init, "batches": dense_batches,
                "eval_batch": dense_ev, "schedules": DENSE_SCHEDULES,
                "plan_kw": SL}
  started = spawn_start(tmp, C.WORLD, "multi_job", {"jobs": {
      "forward": ("wire_forward_job", {"cases": forward}),
      "sgd": ("mb_guard_job", C.spec(states["sgd"], "sgd", runs["sgd"],
                                     batches)),
      "adagrad": ("mb_guard_job", C.spec(states["adagrad"], "adagrad",
                                         runs["adagrad"], batches)),
      "serve": ("serve_job", serve_spec),
      "ckpt_save": ("ckpt_job", _ckpt_spec("save", port_ckpt, ckpt_state)),
      "ckpt_restore": ("ckpt_job", _ckpt_spec("restore", jax_ckpt,
                                              ckpt_state)),
      "dense": ("dense_extras_job", dense_spec)}})
  want = {"forward": {}}
  for name in ("none", "auto", "narrow"):
    case = forward[name]
    want["forward"][name] = _jax_forward_grads(
        _jax_plan(name), case["params"], case["inputs"], case["ct"])
  for r, state in states.items():
    want[r] = {"raw": _jax_run(state, r, batches, ev),
               "exact": _jax_run(state, r, batches, ev, exact=True)}
  want["adagrad"]["dedup"] = _jax_run(states["adagrad"], "adagrad", batches,
                                      ev, dedup_exchange=True)
  mesh = create_mesh(C.WORLD)
  want["serve"] = {}
  for q in ("f32", "int8"):
    eng = jserving.ServeEngine(C.model(), serve_plan, jserving.load(
        os.path.join(jax_dir, q), serve_plan, mesh=mesh), mesh=mesh)
    want["serve"][q] = [np.asarray(eng.predict(n, tuple(c)))
                        for n, c in requests]
  want["ckpt_straight"] = (straight, ckpt_losses)
  want["ckpt_half"] = half
  want["dense"] = _jax_train(tiny, init, [(jnp.asarray(n), [
      jnp.asarray(c) for c in cats], jnp.asarray(y))
      for n, cats, y in dense_batches],
      (jnp.asarray(dense_ev[0]), [jnp.asarray(c) for c in dense_ev[1]]),
      optax.adagrad(C.LR))
  got = spawn_wait(started)
  return want, got, {"jax_dir": jax_dir, "port_ckpt": port_ckpt,
                     "ckpt_state": ckpt_state, "requests": requests}


@pytest.mark.parametrize("name", ["none", "pipelined", "fused", "dedup",
                                  "dedup_fused", "auto", "narrow"])
def test_sliced_forward_and_gradients_are_bit_exact(world4, name):
  want, got, _ = world4
  outs, grads = want["forward"][name if name in ("auto", "narrow")
                                else "none"]
  for rank_out in got:
    res = rank_out["forward"][name]
    for t, (a, b) in enumerate(zip(res["outs"], outs)):
      np.testing.assert_array_equal(a, b, err_msg=f"{name} input {t}")
    assert sorted(res["grads"]) == sorted(grads)
    for k, g in grads.items():
      if "dedup" in name:
        # the unique ids' cotangents are summed before the exchange, in
        # another order than JAX's raw scatter: the f32 class
        np.testing.assert_allclose(res["grads"][k], g, err_msg=k, **C.TOL)
      else:
        np.testing.assert_array_equal(res["grads"][k], g, err_msg=k)


def _assert_run(res, w):
  np.testing.assert_allclose(res["losses"], w["losses"], **C.TOL)
  np.testing.assert_allclose(res["eval"]["preds"], w["preds"], **C.TOL)
  assert res["step"] == C.STEPS


@pytest.mark.parametrize("rule", ["sgd", "adagrad"])
@pytest.mark.parametrize("name", list(SCHEDULES) + list(EXTRA))
def test_sliced_sparse_step_matches_jax(world4, rule, name):
  want, got, _ = world4
  w = want[rule][EXTRA[name][1][rule == "adagrad"] if name in EXTRA
                 else "raw"]
  for rank_out in got:
    _assert_run(rank_out[rule][name], w)
  assert_final(got[0][rule][name], w["final"])
  if rule == "adagrad":
    assert got[0][rule][name]["unpacked"][1], "Adagrad's lanes compared"


@pytest.mark.parametrize("rule", ["sgd", "adagrad"])
@pytest.mark.parametrize("name", ["pipelined", "fused"])
def test_sliced_schedules_are_bit_exact_against_none(world4, rule, name):
  _, got, _ = world4
  base, res = got[0][rule]["none"], got[0][rule][name]
  assert res["losses"] == base["losses"]
  for part in (0, 1):
    for k, arr in base["unpacked"][part].items():
      np.testing.assert_array_equal(res["unpacked"][part][k], arr,
                                    err_msg=k)
  np.testing.assert_array_equal(res["eval"]["preds"], base["eval"]["preds"])


@pytest.mark.parametrize("q", ["f32", "int8"])
def test_sliced_serving_matches_jax_images_and_eval(world4, q):
  from distributed_embeddings_torch import checkpoint as tckpt
  want, got, ctx = world4
  base = got[0]["serve"][q]["port"]
  for rank_out in got:
    for source in ("port", "jax", "frozen"):
      for g, b in zip(rank_out["serve"][q][source], base):
        assert g.shape == (C.B,) and np.all(np.isfinite(g))
        np.testing.assert_array_equal(g, b, err_msg=source)
    if q == "f32":
      for g, e in zip(rank_out["serve"][q]["port"],
                      rank_out["serve"][q]["eval"]):
        np.testing.assert_array_equal(g, e)
  for g, w in zip(base, want["serve"][q]):
    np.testing.assert_allclose(g, w, **C.TOL)
  # the images: every serve block byte-identical to the JAX package's
  port_dir = os.path.join(os.path.dirname(ctx["jax_dir"]), "port", q)
  pm = tckpt.read_manifest(port_dir)
  jm = tckpt.read_manifest(os.path.join(ctx["jax_dir"], q))
  assert pm["serve"] == jm["serve"]
  serve_files = [f for f in pm["checksums"] if f.startswith("serve_")]
  assert len(serve_files) == C.WORLD * len(pm["serve"]["classes"])
  for f in serve_files:
    assert pm["checksums"][f] == jm["checksums"][f], f


def test_sliced_port_checkpoint_restores_in_jax(world4):
  want, got, ctx = world4
  mesh = create_mesh(C.WORLD)
  p = C.plan("fused", 2, **SL)
  state = ctx["ckpt_state"]
  restored = jck.restore(ctx["port_ckpt"], p, C.rule_of("adagrad"),
                         shard_params(state, mesh), mesh=mesh)
  names = set(state["emb_dense"])
  flat = _jax_flat(restored)
  assert flat["step"] == CKPT_N
  for rank, out in enumerate(got):
    _compare(out["ckpt_save"]["at_ckpt"], _rank_view(flat, rank, names),
             exact=True)
  _, losses = want["ckpt_straight"]
  for out in got:
    np.testing.assert_allclose(out["ckpt_save"]["losses"], losses, **C.TOL)


def test_sliced_jax_checkpoint_restores_in_the_port(world4):
  want, got, ctx = world4
  names = set(ctx["ckpt_state"]["emb_dense"])
  straight, losses = want["ckpt_straight"]
  at_ckpt, final = _jax_flat(want["ckpt_half"]), _jax_flat(straight)
  for rank, out in enumerate(got):
    res = out["ckpt_restore"]
    _compare(res["at_ckpt"], _rank_view(at_ckpt, rank, names), exact=True)
    np.testing.assert_allclose(res["losses"], losses[CKPT_N:], **C.TOL)
    _compare(res["final"], _rank_view(final, rank, names), exact=False)


@pytest.mark.parametrize("schedule", [f"{o}/{c}" for o, c in
                                      DENSE_SCHEDULES])
def test_sliced_dense_autodiff_step_matches_jax(world4, schedule):
  want, got, _ = world4
  want_losses, params, want_preds = want["dense"]
  assert any(k.startswith("mp_table_w4") for k in params["embeddings"])
  for rank_out in got:
    losses, final, preds = rank_out["dense"][schedule]
    np.testing.assert_allclose(losses, want_losses, **C.TOL)
    for name, buf in params["embeddings"].items():
      np.testing.assert_allclose(final[f"embeddings.{name}"], buf,
                                 err_msg=name, **C.TOL)
    np.testing.assert_allclose(preds, want_preds, **C.TOL)
