"""The port's op and layer surface against the JAX package's.

- ``ops/embedding_lookup.py``: ``embedding_lookup`` (and through it
  ``csr_lookup`` with its deduplicated backward) for combiners None, sum
  and mean on dense, ``RaggedIds`` and ``SparseIds`` ids, out-of-range
  ids clamped; the forward and the table gradient of a seeded cotangent
  in the f32 class (rtol 1e-5, atol 1e-6: the duplicate sums and the
  means add in their own orders); ``row_to_split`` equal.
- ``layers/embedding.py``: ``Embedding`` (dense N-D, ragged and sparse
  inputs, its table and activity penalties) and ``ConcatOneHotEmbedding``
  on the JAX layers' own weights; the named initializers' ranges; the
  ``TableConfig`` round trip.
- ``layers/dist_model_parallel.py``: ``set_weights`` equal to the JAX
  ``set_weights`` and ``get_weights`` its inverse, bit for bit, at world 1
  and at world 4 (column- and row-sliced tables); ``DistributedEmbedding``
  forward bit-equal to the JAX layer's at f32, with dense and sparse
  classes, one-hot, padded multi-hot sum and mean inputs and
  out-of-vocabulary ids (except a dense class's multi-hot bags, which the
  JAX layer sums inside a one-hot matmul: within an f32 rounding), and
  its OOV counters equal to the JAX layer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.layers import dist_model_parallel as tdmp
from distributed_embeddings_torch.layers import embedding as temb
from distributed_embeddings_torch.layers.planner import (
    DistEmbeddingStrategy as TStrategy,
)
from distributed_embeddings_torch.ops import embedding_lookup as tlookup
from distributed_embeddings_torch.ops import ragged as tragged
from distributed_embeddings_tpu.layers import dist_model_parallel as jdmp
from distributed_embeddings_tpu.layers import embedding as jemb
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.ops.embedding_lookup import (
    embedding_lookup as jax_embedding_lookup,
)
from distributed_embeddings_tpu.ops.embedding_lookup import (
    sparse_dedup_grad as jax_sparse_dedup_grad,
)
from distributed_embeddings_tpu.ops import ragged as jragged

TOL = dict(rtol=1e-5, atol=1e-6)
V, D, B, H = 40, 8, 12, 4


def _ids(rng, shape, vocab=V):
  """ids in [-2, vocab + 3): a few negative and out-of-range ones."""
  return rng.integers(-2, vocab + 3, shape).astype(np.int32)


def _ragged(rng):
  lengths = rng.integers(0, 5, B)
  lengths[3] = 0  # an empty row
  values = _ids(rng, (int(lengths.sum()),))
  splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
  return values, splits


def _jax_ids(kind, arrays):
  if kind == "dense":
    return jnp.asarray(arrays[0])
  if kind == "ragged":
    return jragged.RaggedIds(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
  values, indices = arrays
  return jragged.SparseIds(jnp.asarray(indices), jnp.asarray(values), (B, H))


def _torch_ids(kind, arrays):
  if kind == "dense":
    return torch.tensor(arrays[0])
  if kind == "ragged":
    return tragged.RaggedIds(torch.tensor(arrays[0]), torch.tensor(arrays[1]))
  values, indices = arrays
  return tragged.SparseIds(torch.tensor(indices), torch.tensor(values),
                           (B, H))


def _inputs(kind, seed):
  rng = np.random.default_rng(seed)
  if kind == "dense":
    return (_ids(rng, (B, H)),)
  if kind == "ragged":
    return _ragged(rng)
  values, splits = _ragged(rng)
  rows = np.repeat(np.arange(B), np.diff(splits))
  cols = np.concatenate([np.arange(n) for n in np.diff(splits)])
  return values, np.stack([rows, cols], 1).astype(np.int32)


@pytest.mark.parametrize("combiner", [None, "sum", "mean"])
@pytest.mark.parametrize("kind", ["dense", "ragged", "sparse"])
def test_embedding_lookup_matches_jax(kind, combiner):
  rng = np.random.default_rng(7)
  params = rng.standard_normal((V, D)).astype(np.float32)
  arrays = _inputs(kind, 11)
  jids, tids = _jax_ids(kind, arrays), _torch_ids(kind, arrays)
  want = np.asarray(jax_embedding_lookup(jnp.asarray(params), jids,
                                             combiner))
  cot = rng.standard_normal(want.shape).astype(np.float32)
  want_g = np.asarray(jax.grad(lambda p: jnp.sum(
      jax_embedding_lookup(p, jids, combiner) * cot))(
          jnp.asarray(params)))
  tp = torch.tensor(params, requires_grad=True)
  got = tlookup.embedding_lookup(tp, tids, combiner)
  (got * torch.tensor(cot)).sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  np.testing.assert_allclose(tp.grad.numpy(), want_g, **TOL)


def test_sparse_dedup_grad_and_row_to_split_match_jax():
  rng = np.random.default_rng(3)
  values, splits = _ragged(rng)
  grad = rng.standard_normal((B, D)).astype(np.float32)
  for combiner in ("sum", "mean"):
    want_ids, want_g = jax_sparse_dedup_grad(
        jnp.asarray(values), jnp.asarray(splits), jnp.asarray(grad),
        combiner, V)
    got_ids, got_g = tlookup.sparse_dedup_grad(
        torch.tensor(values), torch.tensor(splits), torch.tensor(grad),
        combiner, V)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
  rows = np.repeat(np.arange(B), np.diff(splits)).astype(np.int32)
  np.testing.assert_array_equal(
      tragged.row_to_split(torch.tensor(rows), B + 2).numpy(),
      np.asarray(jragged.row_to_split(jnp.asarray(rows), B + 2)))


def test_lookup_refusals_match_jax():
  params = torch.zeros((V, D))
  with pytest.raises(ValueError, match="combiner"):
    tlookup.embedding_lookup(params, torch.zeros((2, 2), dtype=torch.int32),
                             "max")
  with pytest.raises(ValueError, match="2D"):
    tlookup.embedding_lookup(params, torch.zeros((2, 2, 2), dtype=torch.int32),
                             "sum")
  with pytest.raises(TypeError):
    tlookup.embedding_lookup(np.zeros((V, D)), torch.zeros((2,)))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_padded_csr_gradient_is_the_forward_derivative(combiner):
  """A capacity-padded CSR input (more ``values`` than ``row_splits[-1]``):
  the forward equals the JAX forward, and the gradient is the derivative
  of that forward, zero on the ids past ``row_splits[-1]``. The oracle is
  a dense one-hot product in torch, not the JAX gradient (which gathers
  the cotangent out of range there and gives NaN)."""
  rng = np.random.default_rng(5)
  params = rng.standard_normal((6, 2)).astype(np.float32)
  values = np.arange(5, dtype=np.int32)
  splits = np.array([0, 2, 3], dtype=np.int32)
  want = np.asarray(jax_embedding_lookup(
      jnp.asarray(params),
      jragged.RaggedIds(jnp.asarray(values), jnp.asarray(splits)), combiner))
  tp = torch.tensor(params, requires_grad=True)
  got = tlookup.csr_lookup(tp, torch.tensor(values), torch.tensor(splits),
                           combiner)
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
  # the forward as a dense product: weights[i, r] for the live elements
  weights = torch.zeros((2, 6), dtype=torch.float64)
  for i in range(2):
    lo, hi = int(splits[i]), int(splits[i + 1])
    for v in values[lo:hi]:
      weights[i, int(v)] += 1.0 / (hi - lo) if combiner == "mean" else 1.0
  dense = torch.tensor(params, dtype=torch.float64, requires_grad=True)
  np.testing.assert_allclose(got.detach().numpy(),
                             (weights @ dense).detach().numpy(), **TOL)
  cot = rng.standard_normal((2, 2))
  (got * torch.tensor(cot, dtype=torch.float32)).sum().backward()
  ((weights @ dense) * torch.tensor(cot)).sum().backward()
  np.testing.assert_allclose(tp.grad.numpy(), dense.grad.numpy(), **TOL)
  assert np.all(tp.grad.numpy()[3:5] == 0.0)  # the padded ids


@pytest.mark.parametrize("shape,combiner", [
    ((B,), None), ((B, H), None), ((B, H), "sum"), ((B, H), "mean"),
    ((3, B, H), None), ((3, B, H), "sum"), ((3, B, H), "mean")])
def test_embedding_layer_matches_jax(shape, combiner):
  """1-D ids with a combiner are refused (tested below)."""
  rng = np.random.default_rng(len(shape) * 10 + (combiner is None))
  kw = dict(input_dim=V, output_dim=D, combiner=combiner,
            embeddings_regularizer="l2", activity_regularizer="l1")
  jlayer = jemb.Embedding(**kw)
  ids = _ids(rng, shape)
  jvars = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(ids))
  # params only: init's own "losses" would seed the activity sum
  want, mut = jlayer.apply({"params": jvars["params"]}, jnp.asarray(ids),
                           mutable=["losses"])
  tlayer = temb.Embedding(**kw, device="cpu")
  with torch.no_grad():
    tlayer.embeddings.copy_(torch.tensor(
        np.asarray(jvars["params"]["embeddings"])))
  got = tlayer(torch.tensor(ids))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
  np.testing.assert_allclose(
      float(temb.collect_regularization_losses(tlayer).detach()),
      float(jemb.collect_regularization_losses(mut)), rtol=1e-5)
  assert not tlayer.losses  # collected: the next forward starts anew


def test_embedding_layer_ragged_sparse_and_penalties_per_call():
  rng = np.random.default_rng(5)
  tlayer = temb.Embedding(V, D, combiner="mean", activity_regularizer="l2",
                          embeddings_regularizer="l1", device="cpu")
  jlayer = jemb.Embedding(V, D, combiner="mean", activity_regularizer="l2",
                          embeddings_regularizer="l1")
  params = {"params": {"embeddings": jnp.asarray(
      tlayer.embeddings.detach().numpy())}}
  for kind in ("ragged", "sparse"):
    arrays = _inputs(kind, 21)
    want = np.asarray(jlayer.apply(params, _jax_ids(kind, arrays)))
    got = tlayer(_torch_ids(kind, arrays)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
  # two calls: the activity penalty sums them, the table penalty counts once
  dense = jnp.asarray(_ids(rng, (B, H)))

  def twice(mdl, x):
    return mdl(x) + mdl(x)

  _, mut = jlayer.apply(params, dense, mutable=["losses"],
                        method=lambda m, x: twice(m, x))
  temb.collect_regularization_losses(tlayer)
  twice(tlayer, torch.tensor(np.asarray(dense)))
  np.testing.assert_allclose(
      float(temb.collect_regularization_losses(tlayer).detach()),
      float(jemb.collect_regularization_losses(mut)), rtol=1e-5)
  with pytest.raises(ValueError, match="ambiguous"):
    tlayer(torch.zeros((B,), dtype=torch.int32))


def test_concat_one_hot_embedding_matches_jax():
  sizes = (5, 9, 3)
  rng = np.random.default_rng(2)
  ids = rng.integers(-1, 11, (B, len(sizes))).astype(np.int32)
  jlayer = jemb.ConcatOneHotEmbedding(sizes, D)
  jvars = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(ids))
  want = np.asarray(jlayer.apply(jvars, jnp.asarray(ids)))
  tlayer = temb.ConcatOneHotEmbedding(sizes, D, device="cpu")
  assert tuple(tlayer.embeddings.shape) == (sum(sizes), D)
  with torch.no_grad():
    tlayer.embeddings.copy_(torch.tensor(
        np.asarray(jvars["params"]["embeddings"])))
  np.testing.assert_array_equal(tlayer(torch.tensor(ids)).detach().numpy(),
                                want)
  with pytest.raises(ValueError, match="features"):
    tlayer(torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("name,lo,hi", [
    ("uniform", -0.05, 0.05), ("glorot_uniform", -np.sqrt(6 / 264),
                               np.sqrt(6 / 264)),
    ("he_uniform", -np.sqrt(6 / 256), np.sqrt(6 / 256)),
    ("glorot_normal", -2 * np.sqrt(2 / 264) / 0.87962566103423978,
     2 * np.sqrt(2 / 264) / 0.87962566103423978)])
def test_initializers_draw_the_jax_ranges(name, lo, hi):
  """The draws' distributions (``jax.random`` bits cannot be
  reproduced): within the JAX initializer's support, spread over it."""
  shape = (256, 8)
  got = temb.resolve_initializer(name)(torch.Generator().manual_seed(0),
                                       shape).numpy()
  want = np.asarray(jemb.resolve_initializer(name)(jax.random.PRNGKey(0),
                                                   shape))
  for x in (got, want):
    assert x.min() >= lo - 1e-7 and x.max() <= hi + 1e-7
  assert abs(got.std() - want.std()) < 0.1 * want.std()
  assert temb.resolve_initializer("zeros")(None, (2, 2)).abs().sum() == 0


def test_resolvers_and_table_config_match_jax():
  w = np.random.default_rng(0).standard_normal((6, D)).astype(np.float32)
  for spec in ("l1", "l2", "l1_l2", {"name": "l2", "factor": 0.3},
               {"name": "l1_l2", "l1": 0.2, "l2": 0.1}):
    np.testing.assert_allclose(
        float(temb.resolve_regularizer(spec)(torch.tensor(w))),
        float(jemb.resolve_regularizer(spec)(jnp.asarray(w))), rtol=1e-6)
    assert temb.l2_decay_factor(spec) == jemb.l2_decay_factor(spec)
  for spec in ("non_neg", "max_norm", "unit_norm"):
    np.testing.assert_allclose(
        temb.resolve_constraint(spec)(torch.tensor(w * 3)).numpy(),
        np.asarray(jemb.resolve_constraint(spec)(jnp.asarray(w * 3))),
        **TOL)
  for bad in (temb.resolve_initializer, temb.resolve_regularizer,
              temb.resolve_constraint):
    with pytest.raises(ValueError):
      bad("nope")
  layer = temb.Embedding(V, D, combiner="sum", embeddings_constraint="max_norm",
                         device="cpu")
  cfg = temb.TableConfig.from_layer(layer)
  assert (cfg.input_dim, cfg.output_dim, cfg.combiner, cfg.constraint) == \
      (V, D, "sum", "max_norm")
  again = temb.Embedding.from_config(layer.get_config(), device="cpu")
  assert again.get_config() == dict(layer.get_config(), name=None)
  assert cfg.to_layer(device="cpu").combiner == "sum"
  with pytest.raises(ValueError, match="activity_regularizer"):
    temb.TableConfig.from_layer(temb.Embedding(V, D, activity_regularizer="l1",
                                               device="cpu"))


# ---------------------------------------------------------------------------
# DistributedEmbedding and the global weights view
# ---------------------------------------------------------------------------

VOCAB = [30, 500, 7, 260, 90, 1200]


def _configs(mod, combiners):
  return [mod(input_dim=v, output_dim=D, combiner=c)
          for v, c in zip(VOCAB, combiners)]


@pytest.mark.parametrize("world,kw", [
    (1, {}), (4, dict(column_slice_threshold=200 * D)),
    (4, dict(row_slice_threshold=300 * D))])
def test_set_and_get_weights_match_jax(world, kw):
  combiners = [None] * len(VOCAB)
  jplan = DistEmbeddingStrategy(_configs(jemb.TableConfig, combiners), world,
                                "memory_balanced", **kw)
  tplan = TStrategy(_configs(temb.TableConfig, combiners), world,
                    "memory_balanced", **kw)
  rng = np.random.default_rng(world)
  weights = [rng.standard_normal((v, D)).astype(np.float32) for v in VOCAB]
  want = jdmp.set_weights(jplan, weights)
  got = tdmp.set_weights(tplan, weights)
  assert sorted(got) == sorted(want)
  for name in want:
    np.testing.assert_array_equal(got[name], np.asarray(want[name]))
  for params in (got, {k: torch.tensor(v) for k, v in got.items()}):
    back = tdmp.get_weights(tplan, params)
    for w, b in zip(weights, back):
      np.testing.assert_array_equal(b, w)
  assert any(sh.row_sliced or sh.col_start for shards in tplan.rank_shards
             for sh in shards) == (world > 1)


def _layer_kw():
  return dict(dense_row_threshold=64, batch_hint=B)


@pytest.mark.parametrize("combiners", [
    [None] * 6, ["sum", None, "mean", "sum", None, "mean"]])
def test_distributed_embedding_forward_matches_jax(combiners):
  rng = np.random.default_rng(len(set(combiners)))
  inputs = []
  for v, c in zip(VOCAB, combiners):
    if c is None:
      ids = rng.integers(0, v, (B,)).astype(np.int32)
      ids[:2] = (v, v + 3)  # out of vocabulary: clipped, and counted
      inputs.append(ids)
    else:
      ids = rng.integers(0, v, (B, 3)).astype(np.int32)
      ids[rng.random((B, 3)) < 0.3] = -1  # padding
      inputs.append(ids)
  jlayer = jdmp.DistributedEmbedding(_configs(jemb.TableConfig, combiners),
                                     **_layer_kw())
  jj = [jnp.asarray(x) for x in inputs]
  jvars = jlayer.init(jax.random.PRNGKey(0), jj)
  want, mut = jlayer.apply(jvars, jj, mutable=["metrics"])
  tlayer = tdmp.DistributedEmbedding(_configs(temb.TableConfig, combiners),
                                     **_layer_kw(), device="cpu")
  kinds = {tlayer.plan.classes[k].kind for k in tlayer.plan.class_keys}
  assert kinds == {"dense", "sparse"}
  sd = {k: torch.tensor(np.asarray(v))
        for k, v in jvars["params"].items()}
  assert set(sd) == set(dict(tlayer.named_parameters()))
  tlayer.load_state_dict(sd)
  got, oov = tlayer([torch.tensor(x) for x in inputs], return_oov=True)
  assert len(got) == len(want)
  plan = tlayer.plan
  for i, (g, w) in enumerate(zip(got, want)):
    dense = any(plan.classes[p.class_key].kind == "dense"
                for p in plan.output_pieces[i])
    if dense and inputs[i].ndim == 2:
      # the JAX dense class sums a bag's rows inside its one-hot matmul,
      # in the product's order: within an f32 rounding of the port's sum
      np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                 rtol=1e-6, atol=1e-8)
    else:
      np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
  want_oov = {k: int(v) for k, v in mut["metrics"].items()}
  assert {k: int(v) for k, v in oov.items()} == want_oov
  assert sum(want_oov.values()) > 0


def test_distributed_embedding_init_layout_and_world4_refusal():
  layer = tdmp.DistributedEmbedding(
      [temb.TableConfig(input_dim=v, output_dim=D, initializer="zeros"
                        if v == 7 else "ones") for v in VOCAB],
      **_layer_kw(), device="cpu")
  for key in layer.plan.class_keys:
    cp = layer.plan.classes[key]
    name = tdmp.class_param_name(*key)
    p = layer.class_params()[name]
    assert tdmp.is_model_parallel_param(f"embeddings.{name}".split("."))
    assert tuple(layer.engine.param_shapes()[name]) == tuple(p.shape)
    # member shards' rows drawn by their own initializer, padding rows zero
    ones = sum(sh.input_dim for sh in cp.shards_per_rank[0]
               if VOCAB[sh.table_id] != 7)
    assert float(p.detach().sum()) == ones * cp.width
  # a world-4 layer without a mesh holds the global buffers (for
  # get_weights / set_weights); its forward needs this rank's mesh (the
  # world-4 forward with one: tests/test_torch_dense_train_world4.py)
  world4 = tdmp.DistributedEmbedding(_configs(temb.TableConfig, [None] * 6),
                                     world_size=4, device="cpu")
  for name, p in world4.class_params().items():
    assert tuple(p.shape) == tuple(world4.engine.param_shapes()[name])
  with pytest.raises(ValueError, match="mesh"):
    world4([torch.zeros((B,), dtype=torch.int32)] * 6)
  # model-parallel inputs (dp_input=False) are ported: the layer builds,
  # and refuses a dict without its packed inputs with the JAX message
  # (tests/test_torch_ragged_engine.py holds the mode to the JAX package)
  mp_layer = tdmp.DistributedEmbedding(_configs(temb.TableConfig, [None] * 6),
                                       dp_input=False, device="cpu")
  with pytest.raises(ValueError, match="packed input .* missing"):
    mp_layer({})


def test_ragged_constructors_match_jax():
  values = np.arange(7, dtype=np.int32)
  lengths = np.array([2, 0, 4, 1], np.int32)
  got = tragged.RaggedIds.from_row_lengths(torch.tensor(values),
                                           torch.tensor(lengths))
  want = jragged.RaggedIds.from_row_lengths(jnp.asarray(values),
                                            jnp.asarray(lengths))
  np.testing.assert_array_equal(got.row_splits.numpy(),
                                np.asarray(want.row_splits))
  np.testing.assert_array_equal(got.row_lengths().numpy(), lengths)
  assert got.nrows == want.nrows == 4 and got.shape == (4, None)
  dense = np.arange(12, dtype=np.int32).reshape(4, 3)
  got = tragged.RaggedIds.from_dense(torch.tensor(dense))
  want = jragged.RaggedIds.from_dense(jnp.asarray(dense))
  np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
  np.testing.assert_array_equal(got.row_splits.numpy(),
                                np.asarray(want.row_splits))
