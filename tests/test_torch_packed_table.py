"""The PyTorch port's packed table storage against the JAX package's.

``PackedLayout`` geometry and pack/unpack must be identical (the two
packages hand buffers to each other as numpy arrays), and the fused
gathers must be bit-equal, including negative, out-of-range and sentinel
ids and narrow layouts with several logical rows per physical row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu.ops import packed_table as jpt

LAYOUTS = [(rows, w, n_aux) for w in (16, 32, 128) for n_aux in (0, 1)
           for rows in (37,)]


@pytest.mark.parametrize("rows,width,n_aux", LAYOUTS)
def test_layout_geometry_and_pack_unpack(rows, width, n_aux):
  jl = jpt.PackedLayout(rows, width, n_aux)
  tl = tpt.PackedLayout(rows, width, n_aux)
  for attr in ("stride", "rows_per_phys", "phys_width", "phys_rows",
               "shape"):
    assert getattr(tl, attr) == getattr(jl, attr), attr
  rng = np.random.default_rng(rows * width + n_aux)
  table = rng.standard_normal((rows, width)).astype(np.float32)
  aux = [rng.standard_normal((rows, width)).astype(np.float32)
         for _ in range(n_aux)]
  want = jl.pack(table, aux)
  got_t = tl.pack(torch.tensor(table), [torch.tensor(a) for a in aux])
  np.testing.assert_array_equal(got_t.numpy(), want)
  tbl, aux_back = tl.unpack(torch.tensor(want))
  np.testing.assert_array_equal(tbl.numpy(), table)
  for a, b in zip(aux_back, aux):
    np.testing.assert_array_equal(a.numpy(), b)


def _ids(rows, shape, seed):
  rng = np.random.default_rng(seed)
  ids = rng.integers(-3, rows + 5, shape).astype(np.int32)
  ids.reshape(-1)[:4] = [-1, rows, rows + 100, 0]  # PAD, sentinel, OOB
  return ids


@pytest.mark.parametrize("rows,width,n_aux", LAYOUTS)
def test_gather_fused_bit_equal(rows, width, n_aux):
  lay = jpt.PackedLayout(rows, width, n_aux)
  rng = np.random.default_rng(7)
  buf = rng.standard_normal(lay.shape).astype(np.float32)
  ids = _ids(rows, (3, 11, 2), width + n_aux)
  want = np.asarray(jpt.gather_fused(lay, jnp.asarray(buf), jnp.asarray(ids)))
  got = tpt.gather_fused(tpt.PackedLayout(rows, width, n_aux),
                         torch.tensor(buf), torch.tensor(ids)).numpy()
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("width,n_aux", [(16, 1), (128, 0)])
def test_gather_fused_chunked_bit_equal(width, n_aux):
  rows = 53
  lay = jpt.PackedLayout(rows, width, n_aux)
  rng = np.random.default_rng(11)
  buf = rng.standard_normal(lay.shape).astype(np.float32)
  ids = _ids(rows, (5, 9), 3)
  want = np.asarray(jpt.gather_fused_chunked(
      lay, jnp.asarray(buf), jnp.asarray(ids), chunk=8))
  tl = tpt.PackedLayout(rows, width, n_aux)
  for chunk in (8, None):
    got = tpt.gather_fused_chunked(tl, torch.tensor(buf), torch.tensor(ids),
                                   chunk=chunk).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gather_int8_rows_with_lane_padding():
  """An int8 serve image (132 byte lanes -> 256-lane physical rows)."""
  rows = 29
  lay = jpt.PackedLayout(rows, 132, 0)
  rng = np.random.default_rng(5)
  buf = rng.integers(-128, 128, lay.shape).astype(np.int8)
  ids = _ids(rows, (4, 6), 9)
  want = np.asarray(jpt.gather_fused(lay, jnp.asarray(buf), jnp.asarray(ids)))
  got = tpt.gather_fused(tpt.PackedLayout(rows, 132, 0), torch.tensor(buf),
                         torch.tensor(ids)).numpy()
  np.testing.assert_array_equal(got, want)


def test_init_packed_uniform_distribution():
  """Distribution only (torch and jax.random draw different bits): table
  lanes within +-scale, aux lanes at their constant on live rows, padding
  and dead rows zero."""
  lay = tpt.PackedLayout(10, 16, 1)
  scale = np.full((10,), 0.5, np.float32)
  scale[8:] = 0.0  # dead rows (the last physical row, rows 8..9)
  gen = torch.Generator().manual_seed(0)
  buf = tpt.init_packed_uniform(lay, gen, torch.tensor(scale), (0.1,),
                                device="cpu").numpy()
  assert buf.shape == lay.shape
  table, (acc,) = tpt.PackedLayout(10, 16, 1).unpack(torch.tensor(buf))
  assert np.all(np.abs(table[:8].numpy()) <= 0.5)
  assert np.std(table[:8].numpy()) > 0.1
  np.testing.assert_array_equal(table[8:].numpy(), 0.0)
  np.testing.assert_allclose(acc[:8].numpy(), 0.1)
  np.testing.assert_array_equal(acc[8:].numpy(), 0.0)


def test_mxu_operand_dtype_and_rules():
  assert tpt.mxu_operand_dtype(torch.float32, "cpu") == torch.float32
  assert tpt.mxu_operand_dtype(torch.float32, "cuda") == torch.bfloat16
  assert tpt.mxu_operand_dtype(torch.bfloat16, "cuda") == torch.bfloat16
  for name in ("sgd", "adagrad"):
    got, want = tpt.sparse_rule(name, 0.1), jpt.sparse_rule(name, 0.1)
    assert (got.name, got.n_aux, tuple(got.aux_init)) == \
        (want.name, want.n_aux, tuple(want.aux_init))
  rng = np.random.default_rng(2)
  g = rng.standard_normal((5, 16)).astype(np.float32)
  aux = np.abs(rng.standard_normal((5, 1, 16))).astype(np.float32)
  want = np.asarray(jpt.adagrad_rule(0.05).delta(
      jnp.asarray(g), jnp.asarray(aux), jnp.int32(0)))
  got = tpt.adagrad_rule(0.05).delta(torch.tensor(g), torch.tensor(aux), 0)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
