"""The port's world-4 hybrid-parallel train step against the JAX package's.

The JAX ``make_sparse_train_step`` runs over a 4-device CPU mesh (one
``shard_map`` program); the port runs the same step as four gloo
processes (``tests/torch_ranks.py``), each with its rank's block of every
embedding class and its quarter of the global batch. Both start from one
JAX state (``convert.train_state_from_flax(..., mesh=...)`` cuts each
rank's view out of it) and take three steps on the same batches.

- **The committed golden** ``tests/data/torch_train_world4_golden.npz``
  (:func:`make_golden`: 9 tables at D=128, two row-sliced and three in a
  dense class, global batch 64, SGD, ``overlap='fused'`` with two chunks,
  f32 and bf16 compute from one initial state) is regenerated here and
  must equal the file, so it cannot go stale; ``chip_smoke.py`` replays
  its bf16 run on the card.
- The port replays its f32 run under ``overlap='none'``, ``'pipelined'``
  and ``'fused'``: losses, every final tensor (the gathered global view of
  the fused buffers and dense-class tables, the dense params) and the
  eval step's predictions agree with the JAX step in the f32 class (rtol
  = 1e-5, atol = 1e-6: the CPU BLAS libraries sum the MLP products in
  their own orders), and the three schedules are bit-exact against each
  other (they move the same bytes to the same places). The bf16 run
  replays within the tolerance ``chip_smoke.py`` applies.
- An Adagrad plan with multi-hot sum inputs (one of them on a row-sliced
  table) runs the optimizer-state lanes through the fused schedule's
  per-round gathers and reassembly, against the JAX fused step.

Regenerate the golden after a deliberate change with
``python tests/test_torch_train_world4.py --write``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    init_sparse_state_direct,
    make_sparse_eval_step,
    make_sparse_train_step,
    shard_batch,
    shard_params,
    unpack_sparse_state,
)
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
DIM = 128
BOTTOM = (64, 128)
TOP = (64, 32, 1)
NUM = 13
B = 64  # global: 16 per rank
DENSE_ROW_THRESHOLD = 32
ROW_SLICE = 256 * DIM  # tables of more than 256 rows are row-sliced
CHUNKS = 2
SEED = 0
SCHEDULES = (("none", 1), ("pipelined", 2), ("fused", 2), ("fused", 3))
COMPUTE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _flat(out, prefix, tree):
  for mlp, layers in tree.items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"{prefix}/{mlp}/{layer}/{leaf}"] = np.asarray(arr)


def _jax_model(vocab, world, compute="f32"):
  return DLRM(vocab_sizes=vocab, embedding_dim=DIM, bottom_mlp=BOTTOM,
              top_mlp=TOP, world_size=world, row_slice=ROW_SLICE,
              dense_row_threshold=DENSE_ROW_THRESHOLD,
              compute_dtype=COMPUTE[compute])


def _jax_params(model, vocab):
  return model.init(jax.random.PRNGKey(SEED), jnp.zeros((2, NUM)),
                    [jnp.zeros((2,), jnp.int32) for _ in vocab],
                    emb_acts=[jnp.zeros((2, DIM)) for _ in vocab])["params"]


def _jax_train(model, plan, rule, state, batches, eval_batch):
  """Three steps of the JAX world-4 step, then its eval step: ``(losses,
  final state as numpy, preds)``."""
  mesh = create_mesh(WORLD)
  opt = optax.sgd(port_golden.LR)
  st = shard_params(state, mesh)
  batches = [(numerical, list(cats), labels)
             for numerical, cats, labels in batches]
  first = shard_batch(batches[0], mesh)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, mesh, st,
                                first, donate=False)
  losses = []
  for numerical, cats, labels in batches:
    st, loss = step(st, *shard_batch((numerical, cats, labels), mesh))
    losses.append(np.float32(loss))
  ev = make_sparse_eval_step(model, plan, rule, mesh, st, eval_batch)
  preds = np.asarray(ev(st, *shard_batch(eval_batch, mesh)))
  final = {k: jax.tree_util.tree_map(np.asarray, st[k])
           for k in ("fused", "emb_dense", "dense")}
  return np.asarray(losses, np.float32), final, preds


def make_golden():
  """The world-4 golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(SEED)
  steps = port_golden.STEPS
  numerical = rng.standard_normal((steps, B, NUM)).astype(np.float32)
  cats = np.stack([np.stack([rng.integers(0, v, (B,)) for v in VOCAB])
                   for _ in range(steps)]).astype(np.int32)
  labels = rng.integers(0, 2, (steps, B)).astype(np.float32)
  eval_numerical = rng.standard_normal((B, NUM)).astype(np.float32)
  eval_cats = np.stack([rng.integers(0, v, (B,))
                        for v in VOCAB]).astype(np.int32)
  model = _jax_model(VOCAB, WORLD)
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], WORLD,
      "memory_balanced", dense_row_threshold=DENSE_ROW_THRESHOLD,
      row_slice_threshold=ROW_SLICE, overlap="fused",
      exchange_chunks=CHUNKS)
  rule = jpt.sgd_rule(port_golden.LR)
  state = init_sparse_state_direct(plan, rule, _jax_params(model, VOCAB),
                                   optax.sgd(port_golden.LR),
                                   jax.random.PRNGKey(SEED + 1))
  out = {"vocab": np.asarray(VOCAB, np.int64), "dim": np.int64(DIM),
         "bottom_mlp": np.asarray(BOTTOM, np.int64),
         "top_mlp": np.asarray(TOP, np.int64),
         "dense_row_threshold": np.int64(DENSE_ROW_THRESHOLD),
         "row_slice": np.int64(ROW_SLICE), "world": np.int64(WORLD),
         "exchange_chunks": np.int64(CHUNKS),
         "numerical": numerical, "cats": cats, "labels": labels,
         "eval_numerical": eval_numerical, "eval_cats": eval_cats}
  init = {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense")}
  for part in ("fused", "emb_dense"):
    for name, arr in init[part].items():
      out[f"{part}0/{name}"] = arr
  _flat(out, "dense0", init["dense"])
  for compute in COMPUTE:
    losses, final, preds = _jax_train(
        _jax_model(VOCAB, WORLD, compute), plan, rule, state,
        [(numerical[i], cats[i], labels[i]) for i in range(steps)],
        (eval_numerical, list(eval_cats)))
    out[f"{compute}_losses"] = losses
    for part in ("fused", "emb_dense"):
      for name, arr in final[part].items():
        out[f"{compute}_{part}_moved/{name}"] = arr - init[part][name]
    _flat(out, f"{compute}_dense3", final["dense"])
    out[f"{compute}_preds"] = preds
  return out


@pytest.fixture(scope="module")
def committed():
  return port_golden.load(port_golden.WORLD4_PATH)


@pytest.fixture(scope="module")
def replayed(committed, tmp_path_factory):
  del committed  # the ranks load the committed file themselves
  schedules = [s + ("f32",) for s in SCHEDULES] + [("fused", 2, "bf16")]
  return spawn(tmp_path_factory.mktemp("w4golden"), WORLD, "golden_job",
               {"schedules": schedules})[0]


def test_committed_world4_golden_is_current(committed):
  assert port_golden.WORLD4_PATH.stat().st_size < 2 * 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # every kind of class trains in it, row-sliced tables included
  plan = port_golden.world4_plan(committed)
  kinds = {cp.kind for cp in plan.classes.values()}
  assert kinds == {"sparse", "dense"}
  assert any(sh.row_sliced for shards in plan.rank_shards for sh in shards)
  for compute in COMPUTE:
    for part in ("fused", "emb_dense"):
      prefix = f"{compute}_{part}_moved/"
      assert any(k.startswith(prefix) and np.any(v)
                 for k, v in committed.items())


@pytest.mark.parametrize("schedule", [f"{ov}/{ch}" for ov, ch in SCHEDULES])
def test_three_steps_match_jax(committed, replayed, schedule):
  losses, got, preds = replayed[f"{schedule}/f32"]
  np.testing.assert_allclose(losses, committed["f32_losses"], **TOL)
  want = port_golden.world4_final_state(committed)
  for part, tensors in want.items():
    assert sorted(tensors) == sorted(got[part]) and tensors, part
    for name, w in tensors.items():
      np.testing.assert_allclose(got[part][name], w, err_msg=name, **TOL)
  np.testing.assert_allclose(preds, committed["f32_preds"], **TOL)
  assert preds.shape == (B,)


@pytest.mark.parametrize("schedule", [f"{ov}/{ch}" for ov, ch in SCHEDULES
                                      if ov != "none"])
def test_schedules_are_bit_exact_against_none(replayed, schedule):
  base_losses, base, base_preds = replayed["none/1/f32"]
  losses, got, preds = replayed[f"{schedule}/f32"]
  assert losses == base_losses
  for part, tensors in base.items():
    for name, arr in tensors.items():
      np.testing.assert_array_equal(got[part][name], arr, err_msg=name)
  np.testing.assert_array_equal(preds, base_preds)


def test_the_golden_replay_holds_on_the_chip_tolerance(committed, replayed):
  """The check ``chip_smoke.py`` applies on the card (the bf16 run)
  passes on the CPU."""
  losses, got, preds = replayed["fused/2/bf16"]
  worst = port_golden.compare_world4(committed, losses, got, preds)
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL


# ---------------------------------------------------------------------------
# Adagrad, multi-hot sum inputs: optimizer-state lanes through the fused
# schedule
# ---------------------------------------------------------------------------

HOT = {4: 2, 8: 3}  # input -> hotness (input 8's table is row-sliced)
ADAGRAD_SCHEDULES = (("none", 1), ("fused", 2))


def _adagrad_batches(steps, seed):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(steps):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in HOT:
        ids = rng.integers(0, v, (B, HOT[i])).astype(np.int32)
        ids[rng.random((B, HOT[i])) < 0.3] = -1  # padded bags
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


@pytest.fixture(scope="module")
def adagrad(tmp_path_factory):
  combiner = {i: "sum" for i in HOT}
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM, combiner=combiner.get(i))
       for i, v in enumerate(VOCAB)], WORLD, "memory_balanced",
      dense_row_threshold=DENSE_ROW_THRESHOLD,
      row_slice_threshold=ROW_SLICE, batch_hint=B, overlap="fused",
      exchange_chunks=2)
  rule = jpt.adagrad_rule(port_golden.LR)
  model = _jax_model(VOCAB, WORLD)
  state = init_sparse_state_direct(plan, rule, _jax_params(model, VOCAB),
                                   optax.sgd(port_golden.LR),
                                   jax.random.PRNGKey(SEED + 2))
  numpy_state = {k: jax.tree_util.tree_map(np.asarray, state[k])
                 for k in ("fused", "emb_dense", "dense", "step")}
  batches = _adagrad_batches(port_golden.STEPS, SEED + 3)
  numerical, cats, _ = _adagrad_batches(1, SEED + 4)[0]
  want = _jax_train(model, plan, rule, state, batches, (numerical, cats))
  want_unpacked = unpack_sparse_state(plan, rule, want[1], include_aux=True)
  # the JAX package's packing of simple-layout tables, for the port's
  # per-rank init_sparse_state
  tables, _ = unpack_sparse_state(plan, rule, state)
  packed = init_sparse_state(
      plan, {**_jax_params(model, VOCAB), "embeddings": tables["embeddings"]},
      rule, optax.sgd(port_golden.LR))
  spec = {"vocab": VOCAB, "dim": DIM, "combiner": combiner, "world": WORLD,
          "strategy": "memory_balanced",
          "dense_row_threshold": DENSE_ROW_THRESHOLD, "row_slice": ROW_SLICE,
          "batch": B, "bottom": BOTTOM, "top": TOP, "num": NUM,
          "rule": "adagrad", "lr": port_golden.LR, "state": numpy_state,
          "batches": batches, "eval_batch": (numerical, cats),
          "schedules": ADAGRAD_SCHEDULES,
          "tables": {k: np.asarray(v)
                     for k, v in tables["embeddings"].items()}}
  got = spawn(tmp_path_factory.mktemp("w4adagrad"), WORLD, "train_job",
              spec)
  return want, got, want_unpacked, packed


@pytest.mark.parametrize("overlap", [ov for ov, _ in ADAGRAD_SCHEDULES])
def test_adagrad_multihot_matches_jax(adagrad, overlap):
  (want_losses, want, want_preds), got, _, _ = adagrad
  for rank_out in got:  # every rank ends with the same global view
    out = rank_out[overlap]
    np.testing.assert_allclose(out["losses"], want_losses, **TOL)
    assert out["step"] == port_golden.STEPS
    for name, buf in want["fused"].items():
      np.testing.assert_allclose(out["fused"][name], buf, err_msg=name,
                                 **TOL)
    for name, table in want["emb_dense"].items():
      np.testing.assert_allclose(out["emb_dense"][name], table,
                                 err_msg=name, **TOL)
    dense = dlrm_state_dict_from_flax(want["dense"])
    for name, p in dense.items():
      np.testing.assert_allclose(out["dense"][name], p.numpy(),
                                 err_msg=name, **TOL)
    np.testing.assert_allclose(out["preds"], want_preds, **TOL)
  fused, none = got[0]["fused"], got[0]["none"]
  for name, buf in none["fused"].items():
    np.testing.assert_array_equal(fused["fused"][name], buf, err_msg=name)


def test_per_rank_pack_and_unpack_match_jax(adagrad):
  """``init_sparse_state`` with a mesh packs each rank's block as the JAX
  ``init_sparse_state`` packs the global buffers (bit-exact), and
  ``unpack_sparse_state`` with a mesh gathers the global simple-layout
  view of the tables and optimizer state, as the JAX one returns it."""
  _, got, (want_params, want_aux), packed = adagrad
  for rank_out in got:
    assert set(rank_out["init_fused"]) == set(packed["fused"])
    for name, buf in packed["fused"].items():
      np.testing.assert_array_equal(rank_out["init_fused"][name],
                                    np.asarray(buf), err_msg=name)
    tables, aux = rank_out["fused"]["unpacked"]
    assert set(tables) == set(want_params["embeddings"]) and aux
    for name, table in want_params["embeddings"].items():
      np.testing.assert_allclose(tables[name], np.asarray(table),
                                 err_msg=name, **TOL)
    for name, arrs in want_aux.items():
      for a, b in zip(aux[name], arrs):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_train_world4.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.WORLD4_PATH, **make_golden())
  print(port_golden.WORLD4_PATH, port_golden.WORLD4_PATH.stat().st_size)
