"""The wire-compression pieces of the port against the JAX package's, on
the same numpy inputs (no ranks):

- ``ops/sparse_grad.py: unique_ids_map`` (random ids, out-of-range ids,
  a capped capacity, ``with_count``) and ``expand_unique_rows`` (forward
  and its backward): bit-exact against the JAX functions, ``jax.vmap``-ed
  over destination blocks as the JAX engine runs them;
- the fp8 block codec (``parallel/wire.py: _fp8_encode`` /
  ``_fp8_decode``): the encoded bytes and the decoded values bit-exact
  against the jitted JAX codec (XLA compiles its ``amax / 448`` to a
  multiply by the f32 reciprocal), on blocks that include an all-zero
  block, a block whose amax maps exactly to 448, subnormal results and
  magnitudes spread over 2^±40; the e4m3 cast itself (round to nearest
  even, NaN past 464 of either sign, never saturating) against
  ``ml_dtypes`` and XLA;
- the builders' refusals of the wire knobs, with the JAX messages:
  ``exact=True`` with an fp8 (and a bf16) wire.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.ops import sparse_grad as tsg
from distributed_embeddings_torch.parallel import wire as twire
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.ops import sparse_grad as jsg
from distributed_embeddings_tpu.parallel import wire as jwire
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_train_step,
)

# (m, sentinel, capacity): the safe bound min(m, sentinel + 1), a
# capacity past it, and capped ones (down to one slot)
UNIQUE_CASES = [(50, 20, 21), (50, 100, 50), (40, 100, 64), (64, 30, 5),
                (7, 3, 1), (1, 9, 1)]


def _ids(m, sentinel, seed, out_of_range):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, sentinel + 1, (4, m))
  if out_of_range:  # negatives and ids past the sentinel clamp to it
    bad = rng.random((4, m)) < 0.3
    ids[bad] = rng.choice([-1, -7, sentinel + 1, sentinel + 50, 2**31 - 1],
                          bad.sum())
  return ids.astype(np.int32)


@pytest.mark.parametrize("with_count", [False, True])
@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("m,sentinel,capacity", UNIQUE_CASES)
def test_unique_ids_map_matches_jax(m, sentinel, capacity, out_of_range,
                                    with_count):
  ids = _ids(m, sentinel, m + sentinel, out_of_range)
  want = jax.vmap(lambda x: jsg.unique_ids_map(
      x, sentinel, capacity, with_count=with_count))(jnp.asarray(ids))
  got = tsg.unique_ids_map(torch.tensor(ids), sentinel, capacity,
                           with_count=with_count)
  assert len(got) == len(want) == (3 if with_count else 2)
  for g, w in zip(got, want):
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  # and each block alone (the 1-D form) gives the same rows
  for b in range(ids.shape[0]):
    one = tsg.unique_ids_map(torch.tensor(ids[b]), sentinel, capacity,
                             with_count=with_count)
    for g, row in zip(one, got):
      np.testing.assert_array_equal(g.numpy(), row[b].numpy())


def test_unique_ids_map_inverse_and_overflow():
  """``uniq[inv]`` rebuilds the clamped ids under a safe capacity; a
  capped one aliases the distinct values past the cap onto its last
  slot, and ``n_distinct - capacity`` is what got no slot."""
  ids = _ids(60, 40, 3, True)
  clean = np.where((ids < 0) | (ids > 40), 40, ids)
  uniq, inv, n = tsg.unique_ids_map(torch.tensor(ids), 40, 41,
                                    with_count=True)
  np.testing.assert_array_equal(np.take_along_axis(
      uniq.numpy(), inv.numpy().astype(np.int64), 1), clean)
  np.testing.assert_array_equal(
      n.numpy(), [np.unique(r).size for r in clean])
  cap = 5
  uniq_c, inv_c, n_c = tsg.unique_ids_map(torch.tensor(ids), 40, cap,
                                          with_count=True)
  np.testing.assert_array_equal(n_c.numpy(), n.numpy())
  for b in range(ids.shape[0]):
    distinct = np.unique(clean[b])
    np.testing.assert_array_equal(uniq_c[b, :cap - 1].numpy(),
                                  distinct[:cap - 1])
    assert int(uniq_c[b, cap - 1]) == distinct[cap - 1]
    assert int(inv_c[b].max()) == cap - 1


def test_expand_unique_rows_matches_jax_both_directions():
  rng = np.random.default_rng(5)
  ids = _ids(48, 30, 6, True)
  inv = np.stack([np.asarray(jsg.unique_ids_map(jnp.asarray(r), 30, 31)[1])
                  for r in ids])
  u = rng.standard_normal((4, 31, 8)).astype(np.float32)
  ct = rng.standard_normal((4, 48, 8)).astype(np.float32)
  y, vjp = jax.vjp(lambda a: jax.vmap(jsg.expand_unique_rows)(
      a, jnp.asarray(inv)), jnp.asarray(u))
  leaf = torch.tensor(u, requires_grad=True)
  got = tsg.expand_unique_rows(leaf, torch.tensor(inv))
  got.backward(torch.tensor(ct))
  np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
  # the backward adds each unique id's occurrences (the cotangent wire's
  # segment sum): the same sums, in the CPU scatter's order
  np.testing.assert_allclose(leaf.grad.numpy(),
                             np.asarray(vjp(jnp.asarray(ct))[0]),
                             rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the fp8 block codec
# ---------------------------------------------------------------------------


def _blocks():
  """Blocks of 257 values: magnitudes spread over 2^±40, an all-zero
  block, a block whose amax maps exactly onto 448, one whose values fall
  in e4m3's subnormals after scaling, one of a single nonzero."""
  rng = np.random.default_rng(11)
  x = (rng.standard_normal((12, 257))
       * np.exp2(rng.uniform(-40, 40, (12, 1)))).astype(np.float32)
  x[1] = 0.0
  x[2] = rng.uniform(-448, 448, 257).astype(np.float32)
  x[2, :3] = [448.0, -448.0, 0.0]
  x[3] = rng.standard_normal(257).astype(np.float32) * 2.0 ** -12
  x[3, 0] = 1.0  # everything else lands in the subnormals
  x[4] = 0.0
  x[4, 100] = -3.5
  return x


@jax.jit
def _jax_encode(x):
  return jwire._fp8_encode(x)


@jax.jit
def _jax_decode(b):
  return jwire._fp8_decode(b, jnp.float32)


def test_fp8_codec_bytes_and_values_match_jax():
  x = _blocks()
  want = np.asarray(_jax_encode(jnp.asarray(x))).view(np.uint8)
  got = twire._fp8_encode(torch.tensor(x))
  assert got.dtype == torch.uint8 and got.shape == (12, 257 + 4)
  np.testing.assert_array_equal(got.numpy(), want)
  # the all-zero block keeps scale 1; the 448 block maps onto scale 1
  assert got[1, -4:].numpy().view(np.float32)[0] == 1.0
  assert got[2, -4:].numpy().view(np.float32)[0] == 1.0
  dec = twire._fp8_decode(got, torch.float32).numpy()
  np.testing.assert_array_equal(
      dec, np.asarray(_jax_decode(jnp.asarray(want.view(jnp.float8_e4m3fn)))))
  # each value within e4m3's half-ulp of its block's amax
  amax = np.abs(x).max(axis=1, keepdims=True)
  assert np.all(np.abs(dec - x) <= 2.0 ** -4 * amax)


def test_fp8_cast_rounds_like_xla_without_saturating():
  """448, the midpoints around it (464 ties to 448, past it is NaN),
  the subnormal midpoints and 0, inf and NaN of both signs."""
  sub = 2.0 ** -9  # e4m3's smallest subnormal
  vals = np.array(
      [0.0, -0.0, 448.0, -448.0, 440.0, 456.0, 463.99, 464.0, -464.0,
       464.01, 480.0, -500.0, 1e6, np.inf, -np.inf, np.nan, -np.nan,
       sub, sub / 2, 1.5 * sub, 2.5 * sub, sub / 2 * 1.0001, 1e-9,
       2.0 ** -6, 1.0625, 1.1875, -1.0625], np.float32)
  got = twire._e4m3_bytes(torch.tensor(vals)).numpy()
  xla = np.asarray(jax.jit(lambda v: v.astype(jnp.float8_e4m3fn))(
      jnp.asarray(vals))).view(np.uint8)
  np.testing.assert_array_equal(got, xla)
  np.testing.assert_array_equal(
      got, vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
  rng = np.random.default_rng(2)
  wide = (rng.standard_normal(4096) * np.exp2(rng.uniform(-14, 10, 4096))
          ).astype(np.float32)
  np.testing.assert_array_equal(
      twire._e4m3_bytes(torch.tensor(wide)).numpy(),
      wide.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

VOCAB = [40, 300, 12]
D = 8


def _jax_state(plan, rule):
  model = DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=(8, D),
               top_mlp=(8, 1))
  dense = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 4)),
                     [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
                     emb_acts=[jnp.zeros((2, D)) for _ in VOCAB])["params"]
  return model, init_sparse_state_direct(plan, rule, dense, optax.sgd(0.1),
                                         jax.random.PRNGKey(1))


@pytest.mark.parametrize("wire_dtype", ["fp8", "bf16"])
def test_exact_rejects_a_narrow_wire_with_the_jax_message(wire_dtype):
  jplan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=D) for v in VOCAB], 1,
      dense_row_threshold=16, wire_dtype=wire_dtype)
  tplan = TStrategy([TTableConfig(input_dim=v, output_dim=D) for v in VOCAB],
                    1, dense_row_threshold=16, wire_dtype=wire_dtype)
  jrule, trule = jpt.adagrad_rule(0.1), tpt.adagrad_rule(0.1)
  model, state = _jax_state(jplan, jrule)
  batch = (np.zeros((8, 4), np.float32),
           [np.zeros(8, np.int32) for _ in VOCAB], np.zeros(8, np.float32))
  with pytest.raises(ValueError, match="wire_dtype='f32'") as ej:
    make_sparse_train_step(model, jplan, bce_loss, optax.sgd(0.1), jrule,
                           None, state, batch, exact=True)
  tmodel = TDLRM(VOCAB, D, bottom_mlp=(8, D), top_mlp=(8, 1),
                 num_numerical=4, tables=False, device="cpu")
  with pytest.raises(ValueError) as et:
    ttr.make_sparse_train_step(tmodel, tplan, torch_bce,
                               lambda ps: torch.optim.SGD(ps, lr=0.1),
                               trule, exact=True)
  assert str(et.value) == str(ej.value)
  # the f32 wire composes with exact=True (and with dedup_exchange)
  f32 = TStrategy([TTableConfig(input_dim=v, output_dim=D) for v in VOCAB],
                  1, dense_row_threshold=16, dedup_exchange=True)
  ttr.make_sparse_train_step(tmodel, f32, torch_bce,
                             lambda ps: torch.optim.SGD(ps, lr=0.1), trule,
                             exact=True)
