"""Narrow storage's remaining id forms and rules at world 4: four gloo
ranks (one spawn of ``tests/torch_ranks.py: narrow_job``) against the JAX
package over a 4-device CPU mesh.

The DLRM cell of ``tests/torch_wire_cases.py`` (nine width-16 tables,
three in a dense class, two row-sliced; padded multi-hot ``sum`` and
``mean`` inputs) drawn by the JAX ``init_sparse_state_direct(dtype=
jnp.bfloat16)``: bf16 packed buffers with bf16 optimizer lanes, bf16
dense-class tables. Two steps of each run, then the eval step:

- the deduplicated exchange (``dedup_exchange=True`` with a
  ``dedup_capacity`` the batches overflow, so the guarded step) under
  ``'none'``, ``'pipelined'`` and ``'fused'``, the momentum rule: the
  unique rows gathered from bf16 buffers (K4's bf16 form on the card under
  ``'fused'``), expanded and combined on the source rank;
- the Adam rule (two bf16 lanes a row) on padded ids under ``'none'``;
- a ragged ``sum`` bucket (input 4 as ``RaggedIds``, lengths 0-6, a fifth
  of the ids -1) under the Adam rule and ``'fused'``.

In the same spawn, the dense-autodiff layer with bf16 class buffers: the
world-4 DLRM of ``tests/test_torch_dense_train_world4.py`` (a dense class,
two row-sliced tables) trained by a hand-written ``zero_grad`` /
``loss.backward()`` / ``DistributedOptimizer.step`` loop over
``training.Adam``, against the JAX mesh ``make_train_step`` with
``optax.adam`` on the same params with their ``mp_table_*`` leaves cast
to bf16.

Every buffer stays bf16; every final table and optimizer-lane cell within
``ULPS`` bf16 ulps of the JAX mesh step's (``torch_narrow_cases.ulps``), at
least
``BIT_EQUAL_SHARE_W4`` of them bit-equal (each cell's scale is set out in
``test_bf16_step_matches_jax``); losses in the f32 class,
predictions within ``PRED_TOL``; the guarded runs' ``dedup_overflow`` and
``bad_step`` equal to the JAX step's; the dedup schedules bit-equal to
``'none'``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest

import test_torch_dense_train_world4 as DW
import torch_narrow_cases as nc
from torch_narrow_cases import one_torch_thread  # noqa: F401 (autouse)
import torch_wire_cases as C
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.lookup_engine import \
    DistributedLookup
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    unpack_sparse_state,
)
from torch_ragged_cases import jax_batch, ragged_batches
from torch_ranks import spawn_start, spawn_wait

CAP = 6  # below the safe bound: some destination blocks overflow
DEDUP = {"dedup_exchange": True, "dedup_capacity": CAP}
RAGGED = {4: 6}
RAGGED_KW = {"input_hotness": [1, 1, 1, 1, -6, 1, 1, 1, 1]}
# name -> (rule, overlap, exchange chunks, plan knobs, guard)
RUNS = {
    "momentum_dedup_none": ("momentum", "none", 1, DEDUP, True),
    "momentum_dedup_pipelined": ("momentum", "pipelined", 2, DEDUP, True),
    "momentum_dedup_fused": ("momentum", "fused", 2, DEDUP, True),
    "adam_none": ("adam", "none", 1, {}, False),
    "adam_ragged_fused": ("adam", "fused", 2, RAGGED_KW, False),
}
# Adam's step at the cell's SGD rate (0.1) is about +-0.1 on every touched
# cell, more than most of the cell's table values: a cotangent that sums
# over the ranks in another order than the JAX mesh step's, and so
# differs in the f32 class, flips a step now and then and the two runs
# part by whole steps. The Adam runs take a tenth of it.
RULE_LR = {"adam": C.LR / 10}
PRED_TOL = dict(rtol=1e-3, atol=1e-5)
STEPS = 2  # steps a run: the second reads the lanes the first wrote
DENSE_ADAM_LR = 0.01
DENSE_STEPS = 3


def _bf16_initial(rule_name):
  dense = C.model().init(
      jax.random.PRNGKey(0), jnp.zeros((2, C.NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in C.VOCAB],
      emb_acts=[jnp.zeros((2, C.DIM)) for _ in C.VOCAB])["params"]
  return init_sparse_state_direct(C.plan(), C.rule_of(rule_name), dense,
                                  optax.sgd(C.LR), jax.random.PRNGKey(1),
                                  dtype=jnp.bfloat16)


def _ragged_sets():
  train = ragged_batches(STEPS, C.VOCAB, RAGGED, C.WORLD,
                         C.B // C.WORLD, C.NUM, seed=61)
  ev = ragged_batches(1, C.VOCAB, RAGGED, C.WORLD, C.B // C.WORLD, C.NUM,
                      seed=62)[0][:2]
  return train, ev


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("narrow_dedup_w4")
  batches, ev = C.batches(STEPS, seed=51), C.batches(1, seed=52)[0][:2]
  rtrain, rev = _ragged_sets()
  states = {r: _bf16_initial(r) for r in ("momentum", "adam")}
  runs = []
  for name, (rule, overlap, chunks, kw, guard) in RUNS.items():
    run = {"name": name, "rule": rule, "overlap": overlap, "chunks": chunks,
           "plan_kw": kw, "guard": guard,
           "rule_lr": RULE_LR.get(rule, C.LR)}
    if "ragged" in name:
      run["batches"] = "ragged"
    runs.append(run)
  spec = dict(C.spec(states["momentum"], "momentum", [], batches),
              states={r: C.numpy_state(st) for r, st in states.items()},
              runs=runs, eval=ev, batch_sets={"ragged": (rtrain, rev)})
  dense_batches, dense_init = _dense_inputs()
  dense_spec = {"model": _DENSE_MODEL, "init": dense_init,
                "lr": DENSE_ADAM_LR, "batches": dense_batches}
  started = spawn_start(tmp, C.WORLD, "multi_job", {"jobs": {
      "narrow": ("narrow_job", spec),
      "dense_loop": ("dense_bf16_loop_job", dense_spec)}})
  want = {}
  for name, (rule, overlap, chunks, kw, guard) in RUNS.items():
    if "ragged" in name:
      tb, eb = [jax_batch(b) for b in rtrain], jax_batch(rev)
    else:
      tb, eb = batches, ev
    want[name] = C.jax_run(states[rule], rule, tb, guard=guard,
                           eval_batch=eb, overlap=overlap, chunks=chunks,
                           rule_lr=RULE_LR.get(rule, C.LR), **kw)
  init = {r: jax.tree_util.tree_map(np.asarray, unpack_sparse_state(
      C.plan(), C.rule_of(r), C.numpy_state(st), include_aux=True))
          for r, st in states.items()}
  bf16_init = _bf16_class_buffers(dense_init)
  dense_want = DW._jax_train(DW._jax_dlrm("f32"), bf16_init, dense_batches,
                             dense_batches[0][:2], optax.adam(DENSE_ADAM_LR))
  results = spawn_wait(started)
  return (want, [r["narrow"] for r in results], init,
          (bf16_init, dense_want, [r["dense_loop"] for r in results]))


_DENSE_MODEL = dict(vocab_sizes=DW.VOCAB, embedding_dim=DW.DIM,
                    bottom_mlp=DW.BOTTOM, top_mlp=DW.TOP, num_numerical=DW.NUM,
                    strategy="memory_balanced", row_slice=DW.ROW_SLICE,
                    dense_row_threshold=DW.DENSE_ROW_THRESHOLD)


def _dense_inputs():
  """The dense-autodiff cell's batches and its f32 JAX init."""
  batches = DW._batches(np.random.default_rng(71), DW.VOCAB, DENSE_STEPS)
  init = jax.tree_util.tree_map(np.asarray, DW._jax_dlrm("f32").init(
      jax.random.PRNGKey(7), *DW._as_jax(batches[0][:2]))["params"])
  return batches, init


def _bf16_class_buffers(params):
  """``params`` with every ``mp_table_*`` leaf cast to bf16."""
  out = jax.tree_util.tree_map(np.asarray, params)
  out["embeddings"] = {
      k: v.astype(ml_dtypes.bfloat16) if k.startswith("mp_table_") else v
      for k, v in out["embeddings"].items()}
  return out


@pytest.mark.parametrize("name", list(RUNS))
def test_bf16_step_matches_jax(world4, name, capsys):
  """A table cell is compared in ulps of the larger of its initial
  magnitude and its table's largest move over the run (the magnitudes its
  adds ran at: Adam moves a touched cell by about its learning rate a
  step), an optimizer lane's cell in ulps of at least
  ``nc.STATE_FLOOR_W4`` of the lane's largest magnitude."""
  want, got, init, _ = world4
  w = want[name]
  params, aux = w["final"]
  params0, _ = init[RUNS[name][0]]
  res = got[0][name]
  pairs = []
  for k, v in params["embeddings"].items():
    start = nc.f32(params0["embeddings"][k])
    move = np.abs(nc.f32(v) - start).max()
    pairs.append((f"table/{k}", res["tables"][k], v,
                  np.maximum(np.abs(start), move)))
  for k, lanes in aux.items():
    for i, (a, b) in enumerate(zip(res["aux"][k], lanes)):
      floor = nc.STATE_FLOOR_W4 * np.abs(nc.f32(b)).max()
      pairs.append((f"aux/{k}/{i}", a, b, np.full(np.shape(b), floor)))
  assert aux, "the rule keeps optimizer lanes"
  for _, g, v, _ in pairs:
    assert v.dtype == ml_dtypes.bfloat16 and g.dtype == np.uint16
  out = nc.compare_cells(pairs, nc.BIT_EQUAL_SHARE_W4)
  with capsys.disabled():
    print(f"\n{name}: {out['share']:.6%} of {out['cells']} bf16 cells "
          f"bit-equal to the JAX mesh step, worst {out['worst']} ulps")
  for rank_out in got:
    res = rank_out[name]
    assert set(res["dtypes"].values()) == {"torch.bfloat16"}
    np.testing.assert_allclose(res["losses"], w["losses"], **C.TOL)
    np.testing.assert_allclose(res["preds"], w["eval"]["preds"], **PRED_TOL)
    if RUNS[name][4]:
      for gm, wm in zip(res["metrics"], w["metrics"]):
        assert gm["bad_step"] == wm["bad_step"] == 0
        assert gm["dedup_overflow"] == wm["dedup_overflow"]
  if RUNS[name][4]:
    assert any(v for m in w["metrics"] for v in m["dedup_overflow"].values())


@pytest.mark.parametrize("schedule", ["pipelined", "fused"])
def test_dedup_schedules_are_bit_exact_against_none(world4, schedule):
  _, got, _, _ = world4
  for rank_out in got:
    base = rank_out["momentum_dedup_none"]
    res = rank_out[f"momentum_dedup_{schedule}"]
    assert res["losses"] == base["losses"]
    assert res["metrics"] == base["metrics"]
    np.testing.assert_array_equal(res["preds"], base["preds"])
    for k, t in base["tables"].items():
      np.testing.assert_array_equal(res["tables"][k], t, err_msg=k)
    for k, lanes in base["aux"].items():
      for a, b in zip(res["aux"][k], lanes):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_dedup_plan_routes_unique_blocks_on_bf16():
  """The dedup plan the spawned runs train deduplicates every sparse
  class's exchange, and the momentum rule gives each a bf16 lane."""
  plan = TStrategy([TTableConfig(input_dim=v, output_dim=C.DIM,
                                 combiner=C.COMBINER.get(i))
                    for i, v in enumerate(C.VOCAB)], C.WORLD,
                   "memory_balanced", dense_row_threshold=C.THRESHOLD,
                   row_slice_threshold=C.ROW_SLICE, batch_hint=C.B, **DEDUP)
  engine = DistributedLookup(plan)
  sparse = [k for k in plan.class_keys if plan.classes[k].kind == "sparse"]
  assert sparse and all(engine._dedup_class(k) for k in sparse)
  layouts = engine.fused_layouts(tpt.momentum_rule(C.LR))
  assert layouts and all(lay.n_aux == 1 for lay in layouts.values())


def test_dense_autodiff_bf16_hand_written_loop_matches_jax(world4, capsys):
  """Three steps of the hand-written loop on bf16 class buffers: the
  losses in the f32 class on every rank, each class buffer's cells in the
  narrow class (in ulps of the larger of the cell's initial magnitude and
  its buffer's largest move), the MLPs in the f32 class."""
  _, _, _, (init, (losses, final, _), got) = world4
  start = port_golden.flax_paths(init)
  want = port_golden.flax_paths(final)
  pairs = []
  for path, w in want.items():
    if "mp_table_" not in path:
      continue
    assert w.dtype == ml_dtypes.bfloat16
    move = np.abs(nc.f32(w) - nc.f32(start[path])).max()
    g = got[0]["params"][path].astype(ml_dtypes.bfloat16).view(np.uint16)
    pairs.append((path, g, w,
                  np.maximum(np.abs(nc.f32(start[path])), move)))
  assert pairs
  out = nc.compare_cells(pairs, nc.BIT_EQUAL_SHARE_W4)
  with capsys.disabled():
    print(f"\ndense loop: {out['share']:.6%} of {out['cells']} bf16 cells "
          f"bit-equal to the JAX mesh step, worst {out['worst']} ulps")
  for rank_out in got:
    np.testing.assert_allclose(rank_out["losses"], losses, **C.TOL)
    for path, arr in rank_out["params"].items():
      if "mp_table_" in path:
        np.testing.assert_array_equal(arr, got[0]["params"][path])
      else:
        np.testing.assert_allclose(arr, want[path], rtol=1e-4, atol=1e-5,
                                   err_msg=path)
