"""The JAX train golden that the port replays on the card.

``tests/data/torch_train_golden.npz`` is made by :func:`make_golden`
from the JAX package alone: the small DLRM of the serve golden (8 tables,
D=128, B=256, bf16 compute, dense_row_threshold=32), its state drawn by
``init_sparse_state_direct``, three steps of ``make_sparse_train_step``
(SGD rule, ``optax.sgd``) on the CPU. This test regenerates it and
requires the committed file to be identical, so it cannot go stale, then
replays it through the port on the CPU with
``distributed_embeddings_torch.train_golden``, the same replay that
``chip_smoke.py`` runs on the card, within its bf16-class tolerance.

Regenerate the file after a deliberate change with
``python tests/test_torch_train_golden.py --write``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops.packed_table import sgd_rule
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_train_step,
)

# the serve golden's model (tests/test_torch_golden.py)
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300]
DIM = 128
BOTTOM = (64, 128)
TOP = (64, 32, 1)
NUM = 13
B = 256
DENSE_ROW_THRESHOLD = 32
SEED = 0


def _flat(out, prefix, tree):
  for mlp, layers in tree.items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"{prefix}/{mlp}/{layer}/{leaf}"] = np.asarray(arr)


def _state_entries(out, tag, state):
  for name, buf in state["fused"].items():
    out[f"fused{tag}/{name}"] = np.asarray(buf)
  for name, table in state["emb_dense"].items():
    out[f"emb_dense{tag}/{name}"] = np.asarray(table)
  _flat(out, f"dense{tag}", state["dense"])


def make_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(SEED)
  model = DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=BOTTOM,
               top_mlp=TOP, dense_row_threshold=DENSE_ROW_THRESHOLD,
               compute_dtype=jnp.bfloat16)
  numerical = rng.standard_normal((port_golden.STEPS, B, NUM)) \
      .astype(np.float32)
  cats = np.stack([np.stack([rng.integers(0, v, (B,)) for v in VOCAB])
                   for _ in range(port_golden.STEPS)]).astype(np.int32)
  labels = rng.integers(0, 2, (port_golden.STEPS, B)).astype(np.float32)
  params = model.init(
      jax.random.PRNGKey(SEED), jnp.zeros((2, NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
      emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB])["params"]
  plan = dlrm_embedding_plan(VOCAB, DIM,
                             dense_row_threshold=DENSE_ROW_THRESHOLD)
  rule = sgd_rule(port_golden.LR)
  opt = optax.sgd(port_golden.LR)
  state = init_sparse_state_direct(plan, rule, params, opt,
                                   jax.random.PRNGKey(SEED + 1))
  out = {"vocab": np.asarray(VOCAB, np.int64), "dim": np.int64(DIM),
         "bottom_mlp": np.asarray(BOTTOM, np.int64),
         "top_mlp": np.asarray(TOP, np.int64),
         "dense_row_threshold": np.int64(DENSE_ROW_THRESHOLD),
         "numerical": numerical, "cats": cats, "labels": labels}
  _state_entries(out, "0", state)
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule, None,
                                state, (numerical[0], list(cats[0]),
                                        labels[0]), donate=False)
  losses = []
  for i in range(port_golden.STEPS):
    state, loss = step(state, jnp.asarray(numerical[i]),
                       [jnp.asarray(c) for c in cats[i]],
                       jnp.asarray(labels[i]))
    losses.append(np.float32(loss))
  out["losses"] = np.asarray(losses, np.float32)
  _state_entries(out, "3", state)
  return out


@pytest.fixture(scope="module")
def committed():
  return port_golden.load()


def test_committed_train_golden_is_current(committed):
  assert port_golden.GOLDEN_PATH.stat().st_size < 2 * 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # both kinds of class train in it
  assert any(k.startswith("emb_dense3/") for k in fresh)
  assert any(k.startswith("fused3/") for k in fresh)


def test_port_replays_train_golden_on_cpu(committed):
  losses, got = port_golden.replay(committed, device="cpu")
  assert len(losses) == port_golden.STEPS and np.all(np.isfinite(losses))
  worst = port_golden.compare(committed, losses, got)
  assert worst["state_max_err_share"] <= port_golden.UPDATE_TOL


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_train_golden.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.GOLDEN_PATH, **make_golden())
  print(port_golden.GOLDEN_PATH, port_golden.GOLDEN_PATH.stat().st_size)
