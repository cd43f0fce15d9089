"""The PyTorch port's serving path against the JAX package's, at world 1.

Fixture: the mixed one of ``tests/test_serving.py`` — five tables of
widths 16 and 8, hotness 3/1/3/2/1 with PAD holes, the adagrad rule
(whose aux lanes send the w16 multi-hot classes through
``_combine_masked_order``) — in two forms: all tables sparse, and with
``dense_row_threshold=100`` so that four of them become dense classes.

One JAX train state is frozen by both packages. The frozen images must
be byte-identical, and the serve activations (read through a model stub
that returns them, as ``ActsModel`` does) bit-equal for f32 and int8:
the int8 dequant is one f32 multiply on both sides. The one exception is
a multi-hot dense class, whose JAX one-hot einsum sums the hotness slots
in its own order: those agree within rtol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from distributed_embeddings_torch.layers.embedding import (
    TableConfig as TorchTableConfig,
)
from distributed_embeddings_torch.layers.planner import (
    DistEmbeddingStrategy as TorchStrategy,
)
from distributed_embeddings_torch.ops.packed_table import (
    sparse_rule as torch_sparse_rule,
)
from distributed_embeddings_torch.serving import ServeEngine
from distributed_embeddings_torch.serving import freeze as torch_freeze
from distributed_embeddings_torch.serving import make_serve_step as \
    torch_make_serve_step
from distributed_embeddings_torch.serving.export import (
    dequantize_rows_int8 as torch_dequantize_rows_int8,
)
from distributed_embeddings_torch.serving.export import (
    quantize_rows_int8 as torch_quantize_rows_int8,
)
from distributed_embeddings_tpu.layers.dist_model_parallel import set_weights
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.ops.packed_table import sparse_rule
from distributed_embeddings_tpu.parallel.lookup_engine import PAD_ID
from distributed_embeddings_tpu.serving import (
    make_serve_step,
    quantize_rows_int8,
)
from distributed_embeddings_tpu.serving.export import (
    freeze,
    frozen_device_state,
)
from distributed_embeddings_tpu.training import init_sparse_state

SIZES = [131, 97, 53, 40, 67]
WIDTHS = [16, 16, 8, 8, 16]
HOTNESS = [3, 1, 3, 2, 1]
B = 16


class ActsModel:
  """JAX model stub returning the concatenated embedding activations."""

  def apply(self, variables, numerical, cats, emb_acts=None):
    del variables, numerical, cats
    return jnp.concatenate(list(emb_acts), axis=-1)


class TorchActsModel(nn.Module):
  """The same stub for the port."""

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.cat(list(emb_acts), dim=-1)


def _fixture(combiner, dense_thr, seed=0):
  rng = np.random.default_rng(seed)
  kw = dict(dense_row_threshold=dense_thr, input_hotness=HOTNESS)
  plan = DistEmbeddingStrategy(
      [TableConfig(s, w, combiner=combiner) for s, w in zip(SIZES, WIDTHS)],
      1, "memory_balanced", **kw)
  tplan = TorchStrategy(
      [TorchTableConfig(s, w, combiner=combiner)
       for s, w in zip(SIZES, WIDTHS)], 1, "memory_balanced", **kw)
  weights = [rng.standard_normal((s, w)).astype(np.float32)
             for s, w in zip(SIZES, WIDTHS)]
  params = {"embeddings": {k: jnp.asarray(v)
                           for k, v in set_weights(plan, weights).items()}}
  rule = sparse_rule("adagrad", 0.05)
  state = init_sparse_state(plan, params, rule, optax.sgd(0.01))
  ids = []
  for s, h in zip(SIZES, HOTNESS):
    x = rng.integers(0, s + 3, (B, h)).astype(np.int32)  # a few OOV ids
    x[rng.random(x.shape) < 0.25] = PAD_ID
    ids.append(x)
  numerical = rng.standard_normal((B, 4)).astype(np.float32)
  return plan, tplan, rule, state, numerical, ids


def _np_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "step")}


def _jax_serve(plan, rule, state, numerical, ids, quantize):
  frozen = freeze(plan, rule, state, quantize=quantize)
  sstate = frozen_device_state(frozen, plan)
  step = make_serve_step(ActsModel(), plan, frozen.meta, None, sstate,
                         (numerical, tuple(ids)))
  return frozen, np.asarray(step(sstate, jnp.asarray(numerical),
                                 tuple(jnp.asarray(x) for x in ids)))


@pytest.mark.parametrize("quantize", ["f32", "int8"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dense_thr", [0, 100])
def test_serve_activations_match_jax(dense_thr, combiner, quantize):
  plan, tplan, rule, state, numerical, ids = _fixture(combiner, dense_thr)
  frozen, want = _jax_serve(plan, rule, state, numerical, ids, quantize)

  tfrozen = torch_freeze(tplan, torch_sparse_rule("adagrad", 0.05),
                         _np_state(state), quantize=quantize)
  assert set(tfrozen.device_blocks) == set(frozen.device_blocks)
  for name, blocks in frozen.device_blocks.items():
    assert tfrozen.meta[name].combine_rpp == frozen.meta[name].combine_rpp
    for got, want_b in zip(tfrozen.device_blocks[name], blocks):
      np.testing.assert_array_equal(got.numpy(), want_b)

  eng = ServeEngine(TorchActsModel(), tplan, tfrozen, device="cpu")
  got = eng.predict(numerical, ids)
  assert got.shape == want.shape == (B, sum(WIDTHS))
  multi_hot_dense = {t for t, (s, h) in enumerate(zip(SIZES, HOTNESS))
                     if s <= dense_thr and h > 1}
  assert (dense_thr == 100) == bool(multi_hot_dense)
  off = 0
  for t, w in enumerate(WIDTHS):
    g, e = got[:, off:off + w], want[:, off:off + w]
    if t in multi_hot_dense:
      np.testing.assert_allclose(g, e, rtol=1e-6, atol=0)
    else:
      np.testing.assert_array_equal(g.view(np.int32), e.view(np.int32))
    off += w


def test_int8_codec_bit_equal():
  rng = np.random.default_rng(1)
  table = rng.standard_normal((300, 16)).astype(np.float32) * \
      rng.uniform(0.01, 10.0, (300, 1)).astype(np.float32)
  table[7] = 0.0
  want = quantize_rows_int8(table)
  got = torch_quantize_rows_int8(torch.tensor(table))
  np.testing.assert_array_equal(got.numpy(), want)
  deq = torch_dequantize_rows_int8(got).numpy()
  amax = np.abs(table).max(axis=1, keepdims=True)
  assert np.all(np.abs(deq - table) <= amax / 254.0 + 1e-12)
  np.testing.assert_array_equal(deq[7], 0.0)


@pytest.mark.parametrize("kw", [
    dict(dedup_exchange=True, dedup_capacity=4),
    dict(oov="error"),
    dict(oov="allocate"),
])
def test_plan_refusals(kw):
  tables = [TorchTableConfig(s, w, combiner="sum")
            for s, w in zip(SIZES, WIDTHS)]
  plan = TorchStrategy(tables, 1, "basic", **kw)
  with pytest.raises(ValueError, match="not servable"):
    torch_make_serve_step(TorchActsModel(), plan, {})
