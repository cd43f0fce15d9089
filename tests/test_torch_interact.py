"""K2 (the DLRM pairwise interaction, forward and backward) in the
PyTorch port vs the JAX package.

The port's plain version (``ops/cuda_interact.py:
interact_parts_fwd_plain``) is held against the JAX Pallas kernel
``interact_parts_fwd`` run in interpret mode and against its XLA
reference, at the full DLRM width F=27, D=128. Both sides round the f32
pair dots to bf16; only the order of the f32 summation differs, so at
least 99.9% of the cells must be bit-equal and every cell within one
bf16 ulp. The backward (``interact_parts_bwd_plain``) is held the same
way against the Pallas ``interact_parts_bwd`` in interpret mode: both
round the cotangent to bf16, sum exact bf16 products in f32 and round the
sums to bf16. At least 99.9% of its cells must be bit-equal, and every
cell within one bf16 ulp, or, where the F terms cancel to a value far
below their magnitudes, within the f32 summation bound
``F * 2^-24 * sum_q |c_pq x_q|`` (an order-of-summation error of the
pre-rounding sum is then larger than the result's own ulp). The CUDA kernels compute the same functions; they are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.models.dlrm import (
    _tril_select_np as torch_tril_select_np,
)
from distributed_embeddings_torch.models.dlrm import (
    dot_interact as torch_dot_interact,
)
from distributed_embeddings_torch.ops import cuda_interact
from distributed_embeddings_tpu.models.dlrm import (
    _tril_select_np,
    dot_interact,
)
from distributed_embeddings_tpu.ops.pallas_interact import (
    interact_parts_bwd,
    interact_parts_fwd,
    xla_reference,
)

F, D, B = 27, 128, 512
B_BWD = 256


def _parts(seed, f=F, b=B, d=D):
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((b, d)) * 0.3).astype(np.float32)
          for _ in range(f)]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
  """One bf16 ulp at |x| (the spacing of bf16 values at that magnitude)."""
  _, e = np.frexp(np.abs(x).astype(np.float64))
  return np.ldexp(1.0, e - 8)


def _assert_within_one_ulp(got, want):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape
  equal = np.mean(got == want)
  assert equal >= 0.999, f"only {equal:.6%} of cells bit-equal"
  ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
  assert np.all(np.abs(got - want) <= ulp), \
      float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("k", [-1, 0])
def test_plain_matches_pallas_interpret_and_xla_reference(k):
  parts_np = _parts(0)
  parts_j = [jnp.asarray(p, jnp.bfloat16) for p in parts_np]
  m_np, p = _tril_select_np(F, k)
  want_kernel = np.asarray(interact_parts_fwd(
      parts_j, jnp.asarray(m_np, jnp.bfloat16), interpret=True))
  want_xla = np.asarray(xla_reference(
      jnp.concatenate(parts_j, axis=1), m_np, F))
  parts_t = [torch.tensor(p).to(torch.bfloat16) for p in parts_np]
  before = cuda_interact.launches
  got = cuda_interact.interact_parts_fwd(parts_t, k).numpy()
  assert cuda_interact.launches == before  # CPU tensors: plain version
  assert got.shape == (B, p)
  _assert_within_one_ulp(got, want_kernel)
  _assert_within_one_ulp(got, want_xla)


def test_select_matrix_matches_jax():
  for k in (-1, 0):
    got, p = torch_tril_select_np(F, k)
    want, pw = _tril_select_np(F, k)
    assert p == pw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interact_f32_cpu_matches_jax(self_interaction):
  parts_np = _parts(1, f=7, b=64, d=16)
  want = np.asarray(dot_interact(jnp.asarray(parts_np[0]),
                                 [jnp.asarray(p) for p in parts_np[1:]],
                                 self_interaction=self_interaction))
  got = torch_dot_interact(torch.tensor(parts_np[0]),
                           [torch.tensor(p) for p in parts_np[1:]],
                           self_interaction=self_interaction).numpy()
  # f32 on both sides; the CPU BLAS libraries sum in their own orders,
  # and near-zero pair dots carry that f32 rounding as an absolute error
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
  parts = [torch.zeros((4, 16), dtype=torch.bfloat16) for _ in range(3)]
  with pytest.raises(TypeError):
    cuda_interact.interact_parts_fwd([p.float() for p in parts], -1)
  with pytest.raises(ValueError):
    cuda_interact.interact_parts_fwd(
        [torch.zeros((16, 4), dtype=torch.bfloat16).t() for _ in range(3)],
        -1)
  with pytest.raises(ValueError):
    cuda_interact.interact_parts_fwd(parts * 11, -1)  # 33 > 32 parts
  with pytest.raises(ValueError):
    cuda_interact.samples_per_block(32, 8192)  # one sample > shared memory
  assert cuda_interact.samples_per_block(F, D) == 6


@pytest.mark.parametrize("k", [-1, 0])
def test_bwd_plain_matches_pallas_interpret(k):
  parts_np = _parts(2, b=B_BWD)
  m_np, p = _tril_select_np(F, k)
  rng = np.random.default_rng(3 - k)
  d_acts = rng.standard_normal((B_BWD, p)).astype(np.float32)
  parts_j = [jnp.asarray(x, jnp.bfloat16) for x in parts_np]
  m3t = jnp.asarray(np.swapaxes(m_np, 1, 2), jnp.bfloat16)
  want = interact_parts_bwd(jnp.asarray(d_acts), parts_j, m3t,
                            interpret=True)
  parts_t = [torch.tensor(x).to(torch.bfloat16) for x in parts_np]
  before = cuda_interact.bwd_launches
  got = cuda_interact.interact_parts_bwd(torch.tensor(d_acts), parts_t, k)
  assert cuda_interact.bwd_launches == before  # CPU tensors: plain version
  assert len(got) == len(want) == F
  coef = cuda_interact.pair_coefficients(torch.tensor(d_acts), F, k)
  feats = torch.stack([x.double() for x in parts_t], dim=1)
  abs_sum = torch.bmm(coef.double().abs(), feats.abs()).numpy()
  for q, (g, w) in enumerate(zip(got, want)):
    assert g.dtype == torch.bfloat16 and tuple(g.shape) == (B_BWD, D)
    g = g.float().numpy()
    w = np.asarray(w.astype(jnp.float32))
    assert np.mean(g == w) >= 0.999
    ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
    bound = np.maximum(ulp, F * 2.0**-24 * abs_sum[:, q])
    assert np.all(np.abs(g - w) <= bound), q


@pytest.mark.parametrize("k", [-1, 0])
def test_pair_coefficients_are_twice_the_half_weight_product(k):
  """The kernel's symmetric coefficients equal ``2 * bf16(d_acts) . M``
  (the TPU kernel's ``d_sym`` scaled by its factor 2) exactly."""
  f = 7
  m_np, p = _tril_select_np(f, k)
  d_acts = torch.randn((5, p), generator=torch.Generator().manual_seed(k + 2))
  da = d_acts.to(torch.bfloat16).double()
  want = 2.0 * torch.einsum("bn,pqn->bpq", da, torch.tensor(m_np).double())
  got = cuda_interact.pair_coefficients(d_acts, f, k)
  np.testing.assert_array_equal(got.double().numpy(), want.numpy())


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take():
  parts = [torch.zeros((4, 16), dtype=torch.bfloat16) for _ in range(3)]
  with pytest.raises(TypeError):
    cuda_interact.interact_parts_bwd(torch.zeros((4, 3), dtype=torch.bfloat16),
                                     parts, -1)
  with pytest.raises(ValueError):
    cuda_interact.interact_parts_bwd(torch.zeros((4, 6)), parts, -1)
  with pytest.raises(ValueError):
    cuda_interact.interact_parts_bwd(torch.zeros((3, 4)).t(), parts, -1)
  with pytest.raises(ValueError):
    cuda_interact.bwd_samples_per_block(32, 8192)
  assert cuda_interact.bwd_samples_per_block(F, D) == 4
