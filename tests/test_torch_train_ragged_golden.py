"""The JAX ragged train golden that the port replays on the card.

``tests/data/torch_train_ragged_golden.npz`` is made by :func:`make_golden`
from the JAX package alone: the small DLRM of
``distributed_embeddings_torch/train_golden.py: ragged_plan`` (eight
D=128 tables with ``combiner='sum'``, inputs 2, 3, 5 and 7 as
``RaggedIds`` with lengths uniform in ``[1, h]`` and a capacity of
``ceil(1.05 * B * (1 + h) / 2 / 8) * 8``), bf16 compute, its tables from
a numpy seed packed by ``init_sparse_state``, three steps of
``make_sparse_train_step`` (SGD rule, ``optax.sgd``) on the CPU. This test
regenerates it and requires the committed file to be identical, then
replays it through the port on the CPU with ``train_golden.replay_ragged``
(the replay ``chip_smoke.py`` runs on the card) within its bf16-class
tolerance.

Regenerate the file after a deliberate change with
``python tests/test_torch_train_ragged_golden.py --write``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops.packed_table import sgd_rule
from distributed_embeddings_tpu.ops.ragged import RaggedIds
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    make_sparse_train_step,
)

G = port_golden


def _capacity(h: int) -> int:
  return -(-int(1.05 * G.RAGGED_BATCH * (1 + h) / 2) // 8) * 8


def _batches(rng):
  """Per step ``(numerical, one-hot ids by input, ragged (values, splits)
  by input, labels)``."""
  out = []
  for _ in range(G.STEPS):
    onehot, ragged = {}, {}
    for i, v in enumerate(G.RAGGED_VOCAB):
      if i not in G.RAGGED_HOT:
        onehot[i] = rng.integers(0, v, G.RAGGED_BATCH).astype(np.int32)
        continue
      h, cap = G.RAGGED_HOT[i], _capacity(G.RAGGED_HOT[i])
      lengths = rng.integers(1, h + 1, G.RAGGED_BATCH)
      lengths = np.minimum(lengths, np.maximum(
          0, cap - np.concatenate([[0], np.cumsum(lengths)[:-1]])))
      total = int(lengths.sum())
      values = np.zeros(cap, np.int32)
      values[:total] = rng.integers(0, v, total)
      ragged[i] = (values, np.concatenate(
          [[0], np.cumsum(lengths)]).astype(np.int32))
    out.append((rng.standard_normal((G.RAGGED_BATCH, G.RAGGED_NUM))
                .astype(np.float32), onehot, ragged,
                rng.integers(0, 2, G.RAGGED_BATCH).astype(np.float32)))
  return out


def _flat(out, prefix, tree):
  for mlp, layers in tree.items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"{prefix}/{mlp}/{layer}/{leaf}"] = np.asarray(arr)


def make_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(G.RAGGED_SEED)
  plan = G.ragged_plan(TableConfig, DistEmbeddingStrategy)
  model = DLRM(vocab_sizes=list(G.RAGGED_VOCAB), embedding_dim=G.RAGGED_DIM,
               bottom_mlp=G.RAGGED_BOTTOM, top_mlp=G.RAGGED_TOP,
               compute_dtype=jnp.bfloat16)
  dense = model.init(
      jax.random.PRNGKey(G.RAGGED_SEED), jnp.zeros((2, G.RAGGED_NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in G.RAGGED_VOCAB],
      emb_acts=[jnp.zeros((2, G.RAGGED_DIM))
                for _ in G.RAGGED_VOCAB])["params"]
  tables = G.ragged_initial_tables(plan, G.RAGGED_SEED)
  rule, opt = sgd_rule(G.LR), optax.sgd(G.LR)
  state = init_sparse_state(plan, {"embeddings": {
      k: jnp.asarray(v) for k, v in tables.items()}, **dense}, rule, opt)
  batches = _batches(rng)
  out = {"seed": np.int64(G.RAGGED_SEED),
         "numerical": np.stack([b[0] for b in batches]),
         "labels": np.stack([b[3] for b in batches])}
  for i in range(len(G.RAGGED_VOCAB)):
    if i in G.RAGGED_HOT:
      out[f"values/{i}"] = np.stack([b[2][i][0] for b in batches])
      out[f"splits/{i}"] = np.stack([b[2][i][1] for b in batches])
    else:
      out[f"cat/{i}"] = np.stack([b[1][i] for b in batches])
  for name, t in tables.items():
    out[f"ragged_init_sum/{name}"] = np.float64(t.sum(dtype=np.float64))
  _flat(out, "dense0", dense)

  def cats(b):
    return [RaggedIds(jnp.asarray(b[2][i][0]), jnp.asarray(b[2][i][1]))
            if i in G.RAGGED_HOT else jnp.asarray(b[1][i])
            for i in range(len(G.RAGGED_VOCAB))]

  initial = jax.tree_util.tree_map(np.asarray, state)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, None,
                                state, (batches[0][0], cats(batches[0]),
                                        batches[0][3]), donate=False)
  losses = []
  for b in batches:
    state, loss = step(state, jnp.asarray(b[0]), cats(b), jnp.asarray(b[3]))
    losses.append(np.float32(loss))
  out["losses"] = np.asarray(losses, np.float32)
  for part in ("fused", "emb_dense"):
    for name, buf in state[part].items():
      out[f"{part}_moved/{name}"] = np.asarray(buf) - initial[part][name]
  _flat(out, "dense3", state["dense"])
  return out, initial


@pytest.fixture(scope="module")
def committed():
  return port_golden.load(port_golden.RAGGED_PATH)


def test_committed_ragged_golden_is_current(committed):
  assert port_golden.RAGGED_PATH.stat().st_size < 200 * 1024
  fresh, initial = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # the port packs the seeded tables as the JAX package does
  rebuilt, _ = port_golden.ragged_golden_state(committed)
  for part in ("fused", "emb_dense"):
    for name, buf in initial[part].items():
      np.testing.assert_array_equal(rebuilt[part][name], buf, err_msg=name)
  # both kinds of class train in it, and the 24-row ragged table is sparse
  assert any(k.startswith("emb_dense_moved/") for k in fresh)
  assert sum(k.startswith("fused_moved/") for k in fresh) >= 1


def test_port_replays_ragged_golden_on_cpu(committed):
  losses, got = port_golden.replay_ragged(committed, device="cpu")
  assert len(losses) == port_golden.STEPS and np.all(np.isfinite(losses))
  worst = port_golden.compare_ragged(committed, losses, got)
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_train_ragged_golden.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.RAGGED_PATH, **make_golden()[0])
  print(port_golden.RAGGED_PATH, port_golden.RAGGED_PATH.stat().st_size)
