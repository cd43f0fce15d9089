"""K1 (the sparse apply) in the PyTorch port vs the JAX package.

Two levels, on the shared golden streams of ``tests/pallas_goldens.py``
(duplicates, collision chains, out-of-range ids, power-law and uniform
fuzz):

- the K1 wrapper ``ops/cuda_apply.py:apply_rows`` (its plain version on
  the CPU) against the Pallas kernel's sequential twin
  ``ops/pallas_apply_sim.py:apply_rows_cached_sim``, at the kernel's
  128-lane rows, with and without the in-kernel scale;
- the port's ``scatter_add_fused`` against the JAX package's (XLA's
  scatter on the CPU) over packed layouts of widths 128 and 16 (several
  logical rows per physical row) with 0 and 1 optimizer-state slots.

Duplicate ids make both sides sum in their own orders, so the claim is
the f32 tolerance of ``tests/test_pallas_goldens.py``: rtol = atol = 1e-5.
The CUDA kernel computes the same function; ``chip_smoke.py`` holds it
against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import cuda_apply
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.ops.pallas_apply_sim import (
    apply_rows_cached_sim,
)
from pallas_goldens import CASE_NAMES, apply_vectors, golden_ids

TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = -0.375


@pytest.mark.parametrize("scale", [None, SCALE])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_apply_rows_matches_pallas_twin(name, scale):
  buf, ids, delta, slots, _ = apply_vectors(name, width=cuda_apply.LANES)
  rows = delta if scale is None else (np.float32(scale) * delta)
  want = apply_rows_cached_sim(buf, ids.astype(np.int64), rows, slots=slots)
  before = cuda_apply.launches
  got = cuda_apply.apply_rows(torch.tensor(buf),
                              torch.tensor(ids.astype(np.int64)),
                              torch.tensor(delta), scale).numpy()
  assert cuda_apply.launches == before  # CPU tensors: plain version
  np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def _fused_case(name, width, n_aux):
  ids, rows, _, _ = golden_ids(name)
  layout = (rows, width, n_aux)
  jl = jpt.PackedLayout(*layout)
  rng = np.random.default_rng(rows * width + n_aux + len(ids))
  buf = rng.standard_normal(jl.shape).astype(np.float32)
  delta = rng.standard_normal((len(ids), jl.stride)).astype(np.float32)
  return layout, buf, ids, delta


@pytest.mark.parametrize("scale", [None, SCALE])
@pytest.mark.parametrize("width,n_aux", [(128, 0), (128, 1), (16, 0),
                                         (16, 1)])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_scatter_add_fused_matches_jax(name, width, n_aux, scale):
  layout, buf, ids, delta = _fused_case(name, width, n_aux)
  want = np.asarray(jpt.scatter_add_fused(
      jpt.PackedLayout(*layout), jnp.asarray(buf), jnp.asarray(ids),
      jnp.asarray(delta),
      delta_scale=None if scale is None else jnp.float32(scale)))
  tbuf = torch.tensor(buf)
  got = tpt.scatter_add_fused(tpt.PackedLayout(*layout), tbuf,
                              torch.tensor(ids), torch.tensor(delta),
                              delta_scale=scale)
  assert got is tbuf  # in place
  np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


def test_unique_ids_give_the_plain_bits():
  """Without duplicates nothing is summed in another order: the apply is
  one rounded product and one add per cell on either side."""
  layout, buf, _, _ = _fused_case("unique", 16, 1)
  ids = np.array([0, 3, 7, 15, 2, -1, 16], np.int32)
  rng = np.random.default_rng(7)
  delta = rng.standard_normal((len(ids), 32)).astype(np.float32)
  want = np.asarray(jpt.scatter_add_fused(
      jpt.PackedLayout(*layout), jnp.asarray(buf), jnp.asarray(ids),
      jnp.asarray(delta), delta_scale=jnp.float32(SCALE)))
  got = tpt.scatter_add_fused(tpt.PackedLayout(*layout), torch.tensor(buf),
                              torch.tensor(ids), torch.tensor(delta),
                              delta_scale=SCALE)
  np.testing.assert_array_equal(got.numpy(), want)


def test_library_call_coincides_with_plain():
  """The yardstick timed beside K1 on the card, ``index_add_`` with
  ``alpha`` over the valid ids, computes the plain version's function."""
  buf, ids, delta, _, _ = apply_vectors("power_law", width=128)
  ids_t = torch.tensor(ids.astype(np.int64))
  plain = cuda_apply.apply_rows_plain(torch.tensor(buf), ids_t,
                                      torch.tensor(delta), SCALE)
  ok = (ids_t >= 0) & (ids_t < buf.shape[0])
  lib = torch.tensor(buf).index_add_(0, ids_t[ok], torch.tensor(delta)[ok],
                                     alpha=SCALE)
  np.testing.assert_allclose(lib.numpy(), plain.numpy(), **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
  buf = torch.zeros((4, 128))
  ids = torch.zeros((2,), dtype=torch.long)
  with pytest.raises(ValueError):
    cuda_apply.apply_rows(buf, ids, torch.zeros((2, 64)))
  with pytest.raises(TypeError):
    cuda_apply.apply_rows(buf, ids.int(), torch.zeros((2, 128)))
  with pytest.raises(TypeError):
    cuda_apply.apply_rows(buf.double(), ids,
                          torch.zeros((2, 128), dtype=torch.float64))
  with pytest.raises(ValueError):
    cuda_apply.apply_rows(buf, ids[:, None], torch.zeros((2, 128)))
