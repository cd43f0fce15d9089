"""The JAX tiered serve golden that the port replays on the card.

``tests/data/torch_serve_tiered_golden.npz`` is made by :func:`make_golden`
from the JAX package alone: the tiered train golden's run
(``tests/test_torch_train_tiered_golden.py: make_golden``: the small f32
DLRM of ``train_golden.tiered_plan``, three guarded steps of the JAX
``TieredTrainer``, so the store's counts come from traffic), frozen with
``freeze(store=)`` to f32, int8 and fp8, then two power-law requests
through the JAX tiered ``ServeEngine`` under
``serving.golden.TIERED_SERVE_CONFIG`` and the spilling
``TIERED_SPILL_CONFIG``. This test regenerates it and requires the
committed file to be identical, then replays it through the port's
tiered ``ServeEngine`` on the CPU with ``serving.golden.replay_tiered``
(the replay ``chip_smoke.py`` runs on the card): activations bit-equal,
counters and spill dispatches exact, predictions within rtol 1e-5 / atol
1e-6.

Regenerate the file after a deliberate change with
``python tests/test_torch_serve_tiered_golden.py --write``.
"""

import sys

import numpy as np
import pytest

from distributed_embeddings_torch.serving import golden as G
from distributed_embeddings_torch.train_golden import (
    TIERED_ALPHA,
    TIERED_BATCH,
    TIERED_BOTTOM,
    TIERED_DIM,
    TIERED_LR,
    TIERED_NUM,
    TIERED_TOP,
    TIERED_VOCAB,
)
from distributed_embeddings_tpu import serving as js
from distributed_embeddings_tpu.models.synthetic import power_law_ids
from distributed_embeddings_tpu.serving.export import freeze

REQUEST_SEED = 5


class _Acts:
  def apply(self, variables, numerical, cats, emb_acts=None):
    import jax.numpy as jnp
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


def _requests():
  rng = np.random.default_rng(REQUEST_SEED)
  out = []
  for _ in range(2):
    cats = [power_law_ids(rng, TIERED_BATCH, 1, v,
                          TIERED_ALPHA).astype(np.int32)[:, 0]
            for v in TIERED_VOCAB]
    out.append((rng.standard_normal((TIERED_BATCH, TIERED_NUM))
                .astype(np.float32), cats))
  return out


def _bytes(a):
  """An image as the port holds it (fp8 as its int8 bytes)."""
  a = np.asarray(a)
  return a.view(np.int8) if a.dtype.itemsize == 1 else a


def make_golden():
  """The golden's arrays, from the JAX package on the CPU."""
  import jax
  from distributed_embeddings_tpu.models import DLRM
  from distributed_embeddings_tpu.ops.packed_table import adagrad_rule
  from test_torch_train_tiered_golden import make_golden as train_run
  _, trainer = train_run()  # flushed
  plan, store = trainer.tplan.plan, trainer.store
  rule = adagrad_rule(TIERED_LR)
  model = DLRM(vocab_sizes=list(TIERED_VOCAB), embedding_dim=TIERED_DIM,
               bottom_mlp=TIERED_BOTTOM, top_mlp=TIERED_TOP)
  state = jax.device_get(trainer.state)
  out = {"step": np.int64(int(np.asarray(state["step"])))}
  reqs = _requests()
  for i, (numerical, cats) in enumerate(reqs):
    out[f"numerical/{i}"] = numerical
    for t, c in enumerate(cats):
      out[f"cat/{i}/{t}"] = c
  for mlp, layers in state["dense"].items():
    for layer, leaves in layers.items():
      for leaf, arr in leaves.items():
        out[f"params/{mlp}/{layer}/{leaf}"] = np.asarray(arr)
  for name, t in state["emb_dense"].items():
    out[f"emb_dense/{name}"] = np.asarray(t)
  for q in G.TIERED_QUANTIZE:
    frozen = freeze(plan, rule, state, quantize=q, store=store)
    for name, blocks in frozen.device_blocks.items():
      out[f"blocks/{q}/{name}"] = _bytes(blocks[0])
    for name, images in frozen.host_images.items():
      out[f"cold/{q}/{name}"] = _bytes(images[0])
      out[f"ranking/{q}/{name}"] = frozen.ranking[name][0]
      out[f"counts/{q}/{name}"] = frozen.counts[name][0]
    for tag, cfg in (("serve", G.TIERED_SERVE_CONFIG),
                     ("spill", G.TIERED_SPILL_CONFIG)):
      tc = js.ServeTierConfig(**cfg)
      eng = js.ServeEngine(model, plan, frozen, tier_config=tc,
                           with_metrics=True)
      acts = js.ServeEngine(_Acts(), plan, frozen, tier_config=tc)
      for i, req in enumerate(reqs):
        preds, m = eng.predict(*req)
        out[f"preds/{tag}/{q}/{i}"] = np.asarray(preds)
        out[f"acts/{tag}/{q}/{i}"] = np.asarray(acts.predict(*req))
        for name, v in m["tier"].items():
          out[f"tier/{tag}/{q}/{i}/{name}"] = np.asarray(v, np.int64)
      out[f"{tag}_spill_dispatches/{q}"] = np.int64(
          eng.prefetcher.spill_steps)
  return out


@pytest.fixture(scope="module")
def committed():
  return G.load(G.TIERED_PATH)


def test_committed_serve_tiered_golden_is_current(committed):
  assert G.TIERED_PATH.stat().st_size < 1024 * 1024
  fresh = make_golden()
  assert sorted(fresh) == sorted(committed)
  for key, arr in fresh.items():
    assert arr.dtype == committed[key].dtype, key
    np.testing.assert_array_equal(arr, committed[key], err_msg=key)
  # what it records: cold rows staged, some dispatches spilled, no miss
  for q in G.TIERED_QUANTIZE:
    assert int(fresh[f"spill_spill_dispatches/{q}"]) >= 1
    assert int(fresh[f"serve_spill_dispatches/{q}"]) == 0
  for key, v in fresh.items():
    if key.startswith("tier/"):
      hot, staged, missed, valid = v.tolist()
      assert missed == 0 and staged > 0 and hot + staged == valid, key


@pytest.mark.parametrize("q", G.TIERED_QUANTIZE)
def test_port_replays_serve_tiered_golden_on_cpu(committed, q):
  got = G.replay_tiered(committed, q, device="cpu")
  G.compare_tiered(committed, q, got, pred_tol=G.TIERED_CPU_PRED_TOL)


if __name__ == "__main__" and "--write" in sys.argv:
  np.savez_compressed(G.TIERED_PATH, **make_golden())
  print(f"wrote {G.TIERED_PATH} ({G.TIERED_PATH.stat().st_size} bytes)")
