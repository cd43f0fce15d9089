"""The README's Quick start at world 4: the port's dense-autodiff step
over a process group against the JAX ``make_train_step`` over a 4-device
CPU mesh.

The port runs four gloo processes (``tests/torch_ranks.py``); each holds
its rank's block of every embedding class (a model built with its mesh)
and the replicated dense layers, and trains on its quarter of the global
batch through ``make_train_step(mesh=)`` (``DistributedOptimizer``:
``finalize_hybrid_grads`` before every step). Both packages start from
one JAX init, cut per rank by ``convert.dlrm_state_dict_from_flax(...,
mesh=)`` (``training.shard_params``), and take three steps on the same
batches; then the eval step's global predictions.

- **The committed golden** ``tests/data/torch_dense_train_world4_golden.npz``
  (:func:`make_golden`: a DLRM of 9 tables at D=16, two row-sliced and
  three in a dense class, global batch 64, ``optax.sgd``, f32 and bf16
  compute from one initial tree) is regenerated here and must equal the
  file; ``chip_smoke.py`` replays its f32 run on the card (see
  :func:`test_bf16_replay_within_the_train_golden_tolerance` for why not
  the bf16 one).
- The port replays its f32 run under ``overlap='none'``, ``'pipelined'``
  and ``'fused'``: the losses, every final tensor (the class blocks
  gathered, compared as buffers and through ``get_weights`` table by
  table) and the global predictions agree with the JAX step in the f32
  class (rtol 1e-5, atol 1e-6), and the three schedules are bit-exact
  against each other.
- A model with a multi-hot ``mean`` input on a row-sliced table, an l2
  regularizer and a max_norm constraint from the plan (the penalty
  scaled by the world), and ``optax.adagrad`` against the port's
  ``training.Adagrad``, against the JAX step in the same class.

Regenerate the golden after a deliberate change with
``python tests/test_torch_dense_train_world4.py --write``.
"""

import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch.layers import get_weights as port_get_weights
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_tpu.layers.dist_model_parallel import (
    DistributedEmbedding,
)
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.training import (
    make_eval_step,
    make_train_step,
    shard_batch,
    shard_params,
)
from torch_ranks import spawn

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300, 600]
DIM = 16
BOTTOM = (32, 16)
TOP = (32, 16, 1)
NUM = 13
B = 64  # global: 16 per rank
DENSE_ROW_THRESHOLD = 32  # the 3-, 10- and 24-row tables: one dense class
ROW_SLICE = 256 * DIM  # the 300- and 600-row tables are row-sliced
CHUNKS = 2
SEED = 0
SCHEDULES = (("none", 1), ("pipelined", 2), ("fused", 2))
COMPUTE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _jax_dlrm(compute):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=BOTTOM,
              top_mlp=TOP, world_size=WORLD, strategy="memory_balanced",
              row_slice=ROW_SLICE, dense_row_threshold=DENSE_ROW_THRESHOLD,
              compute_dtype=COMPUTE[compute])


def _as_jax(batch):
  numerical, cats, *rest = batch
  return (jnp.asarray(numerical), [jnp.asarray(c) for c in cats],
          *[jnp.asarray(r) for r in rest])


def _jax_train(model, params, batches, eval_batch, opt, plan=None):
  """Three steps of the JAX world-4 ``make_train_step``, then its eval
  step: ``(losses, final params as numpy, global preds)``."""
  mesh = create_mesh(WORLD)

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  p = shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
  s = shard_params(opt.init(p), mesh)
  step = make_train_step(loss_fn, opt, mesh, p, s, _as_jax(batches[0]),
                         plan=plan, donate=False)
  losses = []
  for batch in batches:
    p, s, loss = step(p, s, *shard_batch(_as_jax(batch), mesh))
    losses.append(np.float32(loss))
  ev = make_eval_step(lambda q, n, c: model.apply({"params": q}, n, c), mesh,
                      p, _as_jax(eval_batch))
  preds = np.asarray(ev(p, *shard_batch(_as_jax(eval_batch), mesh)))
  return (np.asarray(losses, np.float32),
          jax.tree_util.tree_map(np.asarray, p), preds)


def _batches(rng, vocab, steps, hot=None):
  """``steps`` batches ``(numerical, cats, labels)``; ``hot`` maps an
  input to its hotness (``[B, h]`` ids, 30 % of them padding)."""
  out = []
  for _ in range(steps):
    cats = []
    for i, v in enumerate(vocab):
      if hot and i in hot:
        ids = rng.integers(0, v, (B, hot[i])).astype(np.int32)
        ids[rng.random((B, hot[i])) < 0.3] = -1
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, (B,)).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, (B,)).astype(np.float32)))
  return out


def make_golden():
  """The world-4 dense golden's arrays, from the JAX package on the CPU."""
  steps = port_golden.STEPS
  batches = _batches(np.random.default_rng(SEED), VOCAB, steps)
  (eval_numerical, eval_cats, _), = _batches(np.random.default_rng(SEED + 1),
                                             VOCAB, 1)
  out = {"vocab": np.asarray(VOCAB, np.int64), "dim": np.int64(DIM),
         "bottom_mlp": np.asarray(BOTTOM, np.int64),
         "top_mlp": np.asarray(TOP, np.int64),
         "dense_row_threshold": np.int64(DENSE_ROW_THRESHOLD),
         "row_slice": np.int64(ROW_SLICE), "world": np.int64(WORLD),
         "exchange_chunks": np.int64(CHUNKS),
         "numerical": np.stack([b[0] for b in batches]),
         "cats": np.stack([np.stack(b[1]) for b in batches]),
         "labels": np.stack([b[2] for b in batches]),
         "eval_numerical": eval_numerical,
         "eval_cats": np.stack(eval_cats)}
  init = jax.tree_util.tree_map(np.asarray, _jax_dlrm("f32").init(
      jax.random.PRNGKey(SEED), *_as_jax(batches[0][:2]))["params"])
  first = port_golden.flax_paths(init)
  for path, arr in first.items():
    out[f"init/{path}"] = arr
  for compute in COMPUTE:
    losses, final, preds = _jax_train(
        _jax_dlrm(compute), init, batches, (eval_numerical, eval_cats),
        optax.sgd(port_golden.LR))
    out[f"{compute}_losses"] = losses
    for path, arr in port_golden.flax_paths(final).items():
      out[f"{compute}_moved/{path}"] = arr - first[path]
    out[f"{compute}_preds"] = preds
  return out


def _port_plan(penalties=None, combiner=None):
  penalties, combiner = penalties or {}, combiner or {}
  return TStrategy(
      [TTableConfig(input_dim=v, output_dim=DIM, combiner=combiner.get(i),
                    regularizer=penalties.get(("reg", i)),
                    constraint=penalties.get(("con", i)))
       for i, v in enumerate(VOCAB)], WORLD, "memory_balanced",
      dense_row_threshold=DENSE_ROW_THRESHOLD, row_slice_threshold=ROW_SLICE)


def _tables(plan, paths, prefix):
  """Per table, its global weights from class buffers at ``prefix<class
  name>`` of ``paths`` (``get_weights``)."""
  return port_get_weights(plan, {k[len(prefix):]: v for k, v in paths.items()
                                 if k.startswith(prefix)})


@pytest.fixture(scope="module")
def committed():
  return port_golden.load(port_golden.DENSE_WORLD4_PATH)


@pytest.fixture(scope="module")
def replayed(committed, tmp_path_factory):
  del committed  # the ranks load the committed file themselves
  schedules = [s + ("f32",) for s in SCHEDULES] + [("fused", CHUNKS, "bf16")]
  return spawn(tmp_path_factory.mktemp("w4dense"), WORLD, "dense_golden_job",
               {"schedules": schedules})


def test_committed_dense_world4_golden_is_current(committed):
  assert port_golden.DENSE_WORLD4_PATH.stat().st_size < 2 * 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # every kind of class trains in it, row-sliced tables included
  plan = _port_plan()
  assert {cp.kind for cp in plan.classes.values()} == {"sparse", "dense"}
  assert any(sh.row_sliced for shards in plan.rank_shards for sh in shards)
  for compute in COMPUTE:
    moved = [k for k, v in committed.items()
             if k.startswith(f"{compute}_moved/embeddings/") and np.any(v)]
    assert any(k.endswith("_dense") for k in moved)
    assert any(not k.endswith("_dense") for k in moved)


@pytest.mark.parametrize("schedule", [f"{ov}/{ch}" for ov, ch in SCHEDULES])
def test_three_steps_match_jax(committed, replayed, schedule):
  want = port_golden.dense_final(committed, "f32")
  plan = _port_plan()
  want_tables = _tables(plan, want, "embeddings/")
  for rank_out in replayed:  # every rank ends with the same global view
    losses, got, preds = rank_out[f"{schedule}/f32"]
    np.testing.assert_allclose(losses, committed["f32_losses"], **TOL)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
      np.testing.assert_allclose(got[path], w, err_msg=path, **TOL)
    for t, (g, w) in enumerate(zip(_tables(plan, got, "embeddings/"),
                                   want_tables)):
      np.testing.assert_allclose(g, w, err_msg=f"table {t}", **TOL)
    assert preds.shape == (B,)
    np.testing.assert_allclose(preds, committed["f32_preds"], **TOL)


@pytest.mark.parametrize("schedule", [f"{ov}/{ch}" for ov, ch in SCHEDULES
                                      if ov != "none"])
def test_schedules_are_bit_exact_against_none(replayed, schedule):
  base_losses, base, base_preds = replayed[0]["none/1/f32"]
  losses, got, preds = replayed[0][f"{schedule}/f32"]
  assert losses == base_losses
  for path, arr in base.items():
    np.testing.assert_array_equal(got[path], arr, err_msg=path)
  np.testing.assert_array_equal(preds, base_preds)


def test_the_chip_replay_check_passes(committed, replayed):
  """The check ``chip_smoke.py`` applies on the card (the f32 run, whose
  interaction the card computes in bf16) passes on the CPU."""
  losses, got, preds = replayed[0][f"fused/{CHUNKS}/f32"]
  worst = port_golden.compare_dense_world4(committed, losses, got, preds,
                                           "f32")
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL


def test_bf16_replay_within_the_train_golden_tolerance(committed, replayed):
  """The bf16 run within the train-golden tolerances. The JAX step sums
  the replicated gradients of a bf16-compute model in bf16 (its
  ``shard_map`` psum lands after the parameters' cast), the port in f32
  (``finalize_hybrid_grads``, as both packages' sparse steps do), so this
  run carries that rounding on top of the frameworks' bf16 flips."""
  losses, got, preds = replayed[0][f"fused/{CHUNKS}/bf16"]
  worst = port_golden.compare_dense_world4(committed, losses, got, preds,
                                           "bf16")
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL


# ---------------------------------------------------------------------------
# penalties, a multi-hot mean input, Adagrad
# ---------------------------------------------------------------------------

HOT = {8: 3}  # input 8 (the 600-row, row-sliced table): 3-hot mean bags
COMBINER = {8: "mean"}
# l2 on a sparse-class table, max_norm on a dense-class one
PENALTIES = {("reg", 5): "l2", ("con", 1): "max_norm"}
EXTRA_SCHEDULES = (("none", 1), ("fused", CHUNKS))


class _JaxTiny(fnn.Module):
  """The numerical features and every input's activation concatenated
  into one linear head (``tests/torch_ranks.py: _tiny_rec``)."""

  @fnn.compact
  def __call__(self, numerical, cats):
    embs = DistributedEmbedding(
        embeddings=tuple(TableConfig(input_dim=v, output_dim=DIM,
                                     combiner=COMBINER.get(i))
                         for i, v in enumerate(VOCAB)),
        strategy="memory_balanced", row_slice=ROW_SLICE, world_size=WORLD,
        dense_row_threshold=DENSE_ROW_THRESHOLD, name="embeddings")(
            list(cats))
    x = jnp.concatenate([numerical] + list(embs), axis=1)
    return fnn.Dense(1, name="head")(x)[:, 0]


@pytest.fixture(scope="module")
def extras(tmp_path_factory):
  batches = _batches(np.random.default_rng(SEED + 2), VOCAB,
                     port_golden.STEPS, HOT)
  (numerical, cats, _), = _batches(np.random.default_rng(SEED + 3), VOCAB, 1,
                                   HOT)
  model = _JaxTiny()
  init = jax.tree_util.tree_map(np.asarray, model.init(
      jax.random.PRNGKey(SEED), *_as_jax(batches[0][:2]))["params"])
  dense_name = next(k for k in init["embeddings"] if k.endswith("_dense"))
  # rows of norm above max_norm's 2, so that the constraint projects
  init["embeddings"][dense_name] = init["embeddings"][dense_name] * 20.0
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM, combiner=COMBINER.get(i),
                   regularizer=PENALTIES.get(("reg", i)),
                   constraint=PENALTIES.get(("con", i)))
       for i, v in enumerate(VOCAB)], WORLD, "memory_balanced",
      dense_row_threshold=DENSE_ROW_THRESHOLD, row_slice_threshold=ROW_SLICE)
  want = _jax_train(model, init, batches, (numerical, cats),
                    optax.adagrad(port_golden.LR), plan=plan)
  spec = {"vocab": VOCAB, "dim": DIM, "num": NUM, "combiner": COMBINER,
          "penalties": PENALTIES, "row_slice": ROW_SLICE,
          "dense_row_threshold": DENSE_ROW_THRESHOLD, "lr": port_golden.LR,
          "init": init, "batches": batches, "eval_batch": (numerical, cats),
          "schedules": EXTRA_SCHEDULES}
  got = spawn(tmp_path_factory.mktemp("w4extras"), WORLD, "dense_extras_job",
              spec)
  return want, got


@pytest.mark.parametrize("schedule",
                         [f"{ov}/{ch}" for ov, ch in EXTRA_SCHEDULES])
def test_penalties_mean_input_and_adagrad_match_jax(extras, schedule):
  (want_losses, want, want_preds), got = extras
  plan = _port_plan(PENALTIES, COMBINER)
  want_tables = port_get_weights(plan, want["embeddings"])
  for rank_out in got:
    losses, final, preds = rank_out[schedule]
    np.testing.assert_allclose(losses, want_losses, **TOL)
    for name, buf in want["embeddings"].items():
      np.testing.assert_allclose(final[f"embeddings.{name}"], buf,
                                 err_msg=name, **TOL)
    got_tables = port_get_weights(
        plan, {k.split(".", 1)[1]: v for k, v in final.items()
               if k.startswith("embeddings.")})
    for t, (g, w) in enumerate(zip(got_tables, want_tables)):
      np.testing.assert_allclose(g, w, err_msg=f"table {t}", **TOL)
    np.testing.assert_allclose(final["head.weight"],
                               want["head"]["kernel"].T, **TOL)
    np.testing.assert_allclose(final["head.bias"], want["head"]["bias"],
                               **TOL)
    np.testing.assert_allclose(preds, want_preds, **TOL)
  # the constraint held: table 1's rows (dense class) at norm <= 2
  assert np.linalg.norm(want_tables[1], axis=-1).max() <= 2.0 + 1e-5
  base = got[0]["none/1"]
  for name, arr in got[0][f"fused/{CHUNKS}"][1].items():
    np.testing.assert_array_equal(arr, base[1][name], err_msg=name)


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_dense_train_world4.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.DENSE_WORLD4_PATH, **make_golden())
  print(port_golden.DENSE_WORLD4_PATH,
        port_golden.DENSE_WORLD4_PATH.stat().st_size)
