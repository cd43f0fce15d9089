"""The JAX tiered train golden that the port replays on the card.

``tests/data/torch_train_tiered_golden.npz`` is made by :func:`make_golden`
from the JAX package alone: the small f32 DLRM of
``distributed_embeddings_torch/train_golden.py: tiered_plan`` (four D=16
tables, the 4,000-row one host-tier), its tables from a numpy seed packed
by ``tiering.init_tiered_state_from_params``, three guarded steps of the
JAX ``tiering.TieredTrainer`` (Adagrad 0.05 on the sparse classes,
``optax.adagrad(0.05)`` on the dense ones, ``TIERED_CONFIG``: one step
spills, a re-rank after the second) on power-law ids on the CPU. This
test regenerates it and requires the committed file to be identical, then
replays it through the port's ``TieredTrainer`` on the CPU with
``train_golden.replay_tiered`` (the replay ``chip_smoke.py`` runs on the
card): losses and tables within the golden tolerances, hit counters and
spill steps exact.

Regenerate the file after a deliberate change with
``python tests/test_torch_train_tiered_golden.py --write``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_tpu import tiering as jt
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.models.synthetic import power_law_ids
from distributed_embeddings_tpu.ops.packed_table import adagrad_rule

G = port_golden


def _flat(out, prefix, tree):
  for mlp, layers in tree.items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"{prefix}/{mlp}/{layer}/{leaf}"] = np.asarray(arr)


def make_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(G.TIERED_SEED)
  plan = G.tiered_plan(TableConfig, DistEmbeddingStrategy)
  model = DLRM(vocab_sizes=list(G.TIERED_VOCAB), embedding_dim=G.TIERED_DIM,
               bottom_mlp=G.TIERED_BOTTOM, top_mlp=G.TIERED_TOP)
  dense = jax.device_get(model.init(
      jax.random.PRNGKey(G.TIERED_SEED), jnp.zeros((2, G.TIERED_NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in G.TIERED_VOCAB],
      emb_acts=[jnp.zeros((2, G.TIERED_DIM))
                for _ in G.TIERED_VOCAB])["params"])
  tables = G.tiered_initial_tables(plan, G.TIERED_SEED)
  rule, opt = adagrad_rule(G.TIERED_LR), optax.adagrad(G.TIERED_LR)
  tplan = jt.TieringPlan(plan, rule, jt.TieringConfig(**G.TIERED_CONFIG))
  store = jt.HostTierStore(tplan)
  state = jt.init_tiered_state_from_params(tplan, store, rule, {
      "embeddings": {k: jnp.asarray(v) for k, v in tables.items()},
      **dense}, opt)
  batches = []
  for _ in range(G.STEPS):
    cats = [power_law_ids(rng, G.TIERED_BATCH, 1, v,
                          G.TIERED_ALPHA).astype(np.int32)[:, 0]
            for v in G.TIERED_VOCAB]
    batches.append((rng.standard_normal((G.TIERED_BATCH, G.TIERED_NUM))
                    .astype(np.float32), cats,
                    rng.integers(0, 2, G.TIERED_BATCH).astype(np.float32)))
  trainer = jt.TieredTrainer(model, tplan, store, bce_loss, opt, rule, None,
                             state, batches[0], donate=False, guard=True)
  losses = trainer.run(batches)
  trainer.flush()
  final = jt.unpack_tiered_state(tplan, store, rule,
                                 jax.device_get(trainer.state))
  out = {"seed": np.int64(G.TIERED_SEED),
         "numerical": np.stack([b[0] for b in batches]),
         "labels": np.stack([b[2] for b in batches]),
         "losses": np.asarray(losses, np.float32),
         "spill_steps": np.int64(trainer.prefetcher.spill_steps)}
  for i in range(len(G.TIERED_VOCAB)):
    out[f"cat/{i}"] = np.stack([b[1][i] for b in batches])
  for name, t in tables.items():
    out[f"tiered_init_sum/{name}"] = np.float64(t.sum(dtype=np.float64))
    out[f"tables_moved/{name}"] = (np.asarray(final["embeddings"][name])
                                   - t)
  for name, m in trainer.hits.items():
    out[f"hits/{name}"] = np.asarray(m, np.int64)
  _flat(out, "dense0", dense)
  _flat(out, "dense3", {k: v for k, v in final.items()
                        if k != "embeddings"})
  return out, trainer


@pytest.fixture(scope="module")
def committed():
  return port_golden.load(port_golden.TIERED_PATH)


def test_committed_tiered_golden_is_current(committed):
  assert port_golden.TIERED_PATH.stat().st_size < 200 * 1024
  fresh, trainer = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # the run it records spilled, re-ranked and never missed
  assert int(fresh["spill_steps"]) >= 1
  assert trainer.prefetcher.steps_since_rerank == 1  # re-ranked at step 2
  for key in fresh:
    if key.startswith("hits/"):
      hot, staged, missed, total = fresh[key].tolist()
      assert missed == 0 and staged > 0 and hot + staged == total


def test_port_replays_tiered_golden_on_cpu(committed):
  losses, summary, got = port_golden.replay_tiered(committed, device="cpu")
  assert len(losses) == port_golden.STEPS and np.all(np.isfinite(losses))
  worst = port_golden.compare_tiered(committed, losses, summary, got)
  # on the CPU the port's f32 replay is of the f32 class
  np.testing.assert_allclose(losses, committed["losses"], rtol=1e-5,
                             atol=1e-6)
  assert worst["state_max_err_share"] <= 1e-3


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_train_tiered_golden.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.TIERED_PATH, **make_golden()[0])
  print(port_golden.TIERED_PATH, port_golden.TIERED_PATH.stat().st_size)
