"""K3 (the DLRM interaction on one flat ``[B, F, D]`` input, forward and
backward) in the port vs the JAX package.

The port's plain versions (``ops/cuda_interact.py:
interact_flat_fwd_plain`` / ``interact_flat_bwd_plain``) are held against
the JAX flat-input Pallas kernels ``interact_fwd`` / ``interact_bwd`` run
in interpret mode and against ``_tril_products``' XLA form (its forward
and its hand-written VJP) at F=9, D=128, B=512, k in {-1, 0}, in K2's
tolerance classes: at least 99.9% of the cells bit-equal and every cell
within one bf16 ulp; backward cells where the F terms cancel within the
f32 summation bound ``F * 2^-24 * sum_q |c_pq x_q|``. They are also the
K2 plain versions' function on the same rows, bit for bit. The CUDA
kernels compute the same functions; ``chip_smoke.py`` holds them against
these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import cuda_interact
from distributed_embeddings_tpu.models.dlrm import (
    _tril_products,
    _tril_select_np,
)
from distributed_embeddings_tpu.ops.pallas_interact import (
    interact_bwd,
    interact_fwd,
)

F, D, B = 9, 128, 512


def _feats(seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((B, F, D)) * 0.3).astype(np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
  _, e = np.frexp(np.abs(x).astype(np.float64))
  return np.ldexp(1.0, e - 8)


def _assert_within(got, want, slack=None):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape
  assert np.mean(got == want) >= 0.999, np.mean(got == want)
  bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
  if slack is not None:
    bound = np.maximum(bound, slack)
  assert np.all(np.abs(got - want) <= bound), \
      float(np.max(np.abs(got - want) / bound))


@pytest.mark.parametrize("k", [-1, 0])
def test_flat_fwd_matches_pallas_interpret_and_tril_products(k):
  feats = _feats(k + 10)
  fj = jnp.asarray(feats, jnp.bfloat16)
  m_np, p = _tril_select_np(F, k)
  want_kernel = np.asarray(interact_fwd(fj, jnp.asarray(m_np, jnp.bfloat16),
                                        interpret=True))
  want_xla = np.asarray(_tril_products(fj.reshape(B, F * D), F, k))
  ft = torch.tensor(feats).to(torch.bfloat16)
  before = cuda_interact.flat_launches
  got = cuda_interact.interact_flat_fwd(ft, k)
  assert cuda_interact.flat_launches == before  # CPU tensors: plain version
  assert tuple(got.shape) == (B, p) and got.dtype == torch.float32
  _assert_within(got.numpy(), want_kernel)
  _assert_within(got.numpy(), want_xla)
  # K2's function on the same rows, bit for bit
  parts = [ft[:, q].contiguous() for q in range(F)]
  np.testing.assert_array_equal(
      got.numpy(), cuda_interact.interact_parts_fwd_plain(parts, k).numpy())


@pytest.mark.parametrize("k", [-1, 0])
def test_flat_bwd_matches_pallas_interpret_and_tril_products(k):
  feats = _feats(k + 20)
  fj = jnp.asarray(feats, jnp.bfloat16)
  m_np, p = _tril_select_np(F, k)
  d_acts = np.random.default_rng(k + 30).standard_normal((B, p)) \
      .astype(np.float32)
  m3t = jnp.asarray(np.swapaxes(m_np, 1, 2), jnp.bfloat16)
  want_kernel = interact_bwd(jnp.asarray(d_acts), fj, m3t, interpret=True)
  _, vjp = jax.vjp(lambda x: _tril_products(x, F, k), fj.reshape(B, F * D))
  (want_xla,) = vjp(jnp.asarray(d_acts))
  ft = torch.tensor(feats).to(torch.bfloat16)
  da = torch.tensor(d_acts)
  before = cuda_interact.flat_bwd_launches
  got = cuda_interact.interact_flat_bwd(da, ft, k)
  assert cuda_interact.flat_bwd_launches == before
  assert tuple(got.shape) == (B, F, D) and got.dtype == torch.bfloat16
  coef = cuda_interact.pair_coefficients(da, F, k).double()
  slack = F * 2.0**-24 * torch.bmm(coef.abs(), ft.double().abs()).numpy()
  g = got.float().numpy()
  _assert_within(g, np.asarray(want_kernel.astype(jnp.float32)), slack)
  _assert_within(g, np.asarray(want_xla.astype(jnp.float32))
                 .reshape(B, F, D), slack)
  parts = [ft[:, q].contiguous() for q in range(F)]
  want_parts = cuda_interact.interact_parts_bwd_plain(da, parts, k)
  np.testing.assert_array_equal(
      g, torch.stack(want_parts, 1).float().numpy())


@pytest.mark.parametrize("k", [-1, 0])
@pytest.mark.parametrize("d", [8, 128])
def test_flat_tensor_core_order_matches_pallas_interpret(d, k):
  """K3-fwd runs K2-fwd's body (``csrc/interact_common.cuh: fwd_kernel``)
  over the flat rows: that body's tile -> pair map and k-step f32 sums,
  emulated (``test_torch_interact.tensor_core_fwd``), hold the forward's
  class against the flat TPU kernel run in interpret mode."""
  from test_torch_interact import _assert_fwd_class, tensor_core_fwd
  b = 256  # one of the TPU kernel's batch blocks
  rng = np.random.default_rng(50 + d - k)
  feats = torch.tensor(rng.standard_normal((b, F, d)) * 0.3,
                       dtype=torch.float32).to(torch.bfloat16)
  m_np, p = _tril_select_np(F, k)
  want = np.asarray(interact_fwd(jnp.asarray(feats.float().numpy(),
                                             jnp.bfloat16),
                                 jnp.asarray(m_np, jnp.bfloat16),
                                 interpret=True))
  x = feats.float().numpy()
  got = tensor_core_fwd(x, k)
  assert got.shape == (b, p)
  rows, cols = cuda_interact.tril_pairs(F, k)
  ax = np.abs(x).astype(np.float64)
  slack = d * 2.0**-24 * np.einsum("bpd,bqd->bpq", ax, ax)[:, rows, cols]
  _assert_fwd_class(got, want, slack)
  _assert_fwd_class(got, cuda_interact.interact_flat_fwd(feats, k).numpy(),
                    slack)


def test_flat_wrappers_refuse_what_the_kernels_do_not_take():
  feats = torch.zeros((4, 3, 16), dtype=torch.bfloat16)
  with pytest.raises(TypeError):
    cuda_interact.interact_flat_fwd(feats.float(), -1)
  with pytest.raises(ValueError, match="contiguous"):
    cuda_interact.interact_flat_fwd(feats.transpose(0, 1), -1)
  with pytest.raises(ValueError, match=r"\[B, F, D\]"):
    cuda_interact.interact_flat_fwd(feats[0], -1)
  with pytest.raises(ValueError, match="features"):
    cuda_interact.interact_flat_fwd(
        torch.zeros((2, 33, 8), dtype=torch.bfloat16), -1)
  with pytest.raises(ValueError, match="k must be"):
    cuda_interact.interact_flat_fwd(feats, 1)
  with pytest.raises(TypeError, match="f32 cotangent"):
    cuda_interact.interact_flat_bwd(torch.zeros((4, 3), dtype=torch.bfloat16),
                                    feats, -1)
  with pytest.raises(ValueError, match="cotangent must be"):
    cuda_interact.interact_flat_bwd(torch.zeros((4, 6)), feats, -1)
  with pytest.raises(ValueError, match="no interaction kernel"):
    cuda_interact.interact_flat_fwd(feats.to("meta"), -1)
