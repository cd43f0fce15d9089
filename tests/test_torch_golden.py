"""The JAX serve golden that the port replays on the card.

``tests/data/torch_serve_golden.npz`` is made by :func:`make_golden`
from the JAX package alone: a small DLRM (8 tables, D=128, B=256, bf16
compute) with an SGD train state, frozen to f32 and int8 images and
served by the JAX serve step on the CPU. This test regenerates it and
requires the committed file to be identical, so it cannot go stale, then
replays it through the port on the CPU with
``distributed_embeddings_torch.serving.golden`` — the same replay that
``chip_smoke.py`` runs on the card: activations bit-equal, predictions
within ``golden.PRED_TOL``.

Regenerate the file after a deliberate change with
``python tests/test_torch_golden.py --write``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_embeddings_torch.serving import golden as port_golden
from distributed_embeddings_tpu.models import DLRM
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops.packed_table import sgd_rule
from distributed_embeddings_tpu.serving import make_serve_step
from distributed_embeddings_tpu.serving.export import (
    freeze,
    frozen_device_state,
)
from distributed_embeddings_tpu.training import init_sparse_state_direct

# ids drawn from a few small vocabularies repeat within a batch, which
# keeps the committed activations compressible (the file stays < 2 MB)
VOCAB = [3, 10, 24, 40, 64, 100, 160, 300]
DIM = 128
BOTTOM = (64, 128)
TOP = (64, 32, 1)
NUM = 13
B = 256
DENSE_ROW_THRESHOLD = 32
SEED = 0


class _ActsModel:
  """JAX model stub: the embedding activations, stacked ``[F, B, D]``."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.stack(list(emb_acts))


def _serve(model, plan, frozen, numerical, cats):
  sstate = frozen_device_state(frozen, plan)
  step = make_serve_step(model, plan, frozen.meta, None, sstate,
                         (numerical, tuple(cats)))
  return np.asarray(step(sstate, jnp.asarray(numerical),
                         tuple(jnp.asarray(c) for c in cats)))


def make_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  rng = np.random.default_rng(SEED)
  model = DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=BOTTOM,
               top_mlp=TOP, dense_row_threshold=DENSE_ROW_THRESHOLD,
               compute_dtype=jnp.bfloat16)
  numerical = rng.standard_normal((B, NUM)).astype(np.float32)
  cats = [rng.integers(0, v, (B,)).astype(np.int32) for v in VOCAB]
  params = model.init(
      jax.random.PRNGKey(SEED), jnp.zeros((2, NUM)),
      [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
      emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB])["params"]
  plan = dlrm_embedding_plan(VOCAB, DIM,
                             dense_row_threshold=DENSE_ROW_THRESHOLD)
  rule = sgd_rule(0.1)
  state = init_sparse_state_direct(plan, rule, params, optax.sgd(0.1),
                                   jax.random.PRNGKey(SEED + 1))
  out = {"vocab": np.asarray(VOCAB, np.int64), "dim": np.int64(DIM),
         "bottom_mlp": np.asarray(BOTTOM, np.int64),
         "top_mlp": np.asarray(TOP, np.int64),
         "dense_row_threshold": np.int64(DENSE_ROW_THRESHOLD),
         "numerical": numerical, "cats": np.stack(cats)}
  for mlp, layers in params.items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"params/{mlp}/{layer}/{leaf}"] = np.asarray(arr)
  for q in port_golden.QUANTIZE:
    frozen = freeze(plan, rule, state, quantize=q)
    for name, blocks in frozen.device_blocks.items():
      (out[f"blocks/{q}/{name}"],) = blocks
    for name, table in frozen.emb_dense.items():
      out[f"emb_dense/{name}"] = np.asarray(table)
    out[f"acts/{q}"] = _serve(_ActsModel(), plan, frozen, numerical, cats)
    out[f"preds/{q}"] = _serve(model, plan, frozen, numerical, cats)
  return out


@pytest.fixture(scope="module")
def committed():
  return port_golden.load()


def test_committed_golden_is_current(committed):
  assert port_golden.GOLDEN_PATH.stat().st_size < 2 * 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # both kinds of class are on the replayed path
  assert any(k.startswith("emb_dense/") for k in fresh)
  assert any(k.startswith("blocks/int8/") for k in fresh)


@pytest.mark.parametrize("quantize", port_golden.QUANTIZE)
def test_port_replays_golden_on_cpu(committed, quantize):
  acts, preds = port_golden.replay(committed, quantize, device="cpu")
  want_acts = committed[f"acts/{quantize}"]
  assert acts.shape == want_acts.shape == (len(VOCAB), B, DIM)
  np.testing.assert_array_equal(acts.view(np.int32),
                                want_acts.view(np.int32))
  want = committed[f"preds/{quantize}"]
  assert preds.shape == want.shape == (B,) and np.all(np.isfinite(preds))
  np.testing.assert_allclose(preds, want, **port_golden.PRED_TOL)


if __name__ == "__main__":
  if sys.argv[1:] != ["--write"]:
    sys.exit("usage: python tests/test_torch_golden.py --write")
  jax.config.update("jax_platforms", "cpu")
  np.savez_compressed(port_golden.GOLDEN_PATH, **make_golden())
  print(port_golden.GOLDEN_PATH, port_golden.GOLDEN_PATH.stat().st_size)
