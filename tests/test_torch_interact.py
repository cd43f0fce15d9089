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
from hypothesis import given, settings
from hypothesis import strategies as st

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
    cuda_interact.fwd_geometry(F, 12, -1)  # rows of a multiple of 8 lanes
  # the forward's unit: four samples of D=128 at the DLRM width (three at
  # F=32 with self-interaction, whose outputs take more of the stage); a
  # wider D is staged in 128-column k tiles, not refused
  assert cuda_interact.fwd_geometry(F, D, -1).ns == 4
  assert cuda_interact.fwd_geometry(32, 8192, 0)[:4] == (3, 32, 128, 64)


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
  # the backward's unit (samples, columns): four samples of D=128 at the
  # DLRM width; a wider D is taken in 128-column tiles, not refused
  assert cuda_interact.bwd_geometry(F, D) == (4, 128)
  assert cuda_interact.bwd_geometry(32, 8192) == (4, 128)
  assert cuda_interact.bwd_geometry(2, 16) == (8, 16)


@pytest.mark.parametrize("k", [-1, 0])
def test_pair_coefficients_are_exact_in_bf16(k):
  """Every coefficient is a bf16 value or twice one, so the kernel's bf16
  A operand (the coefficients on the tensor cores) loses nothing."""
  f = 27
  p = len(cuda_interact.tril_pairs(f, k)[0])
  rng = np.random.default_rng(11 - k)
  d_acts = torch.tensor((rng.standard_normal((64, p)) *
                         10.0**rng.uniform(-30, 30, (64, p))
                         ).astype(np.float32))
  coef = cuda_interact.pair_coefficients(d_acts, f, k)
  assert torch.equal(coef.to(torch.bfloat16).float(), coef)


# ---------------------------------------------------------------------------
# The forward kernel's geometry and order (csrc/interact_common.cuh:
# fwd_kernel), pinned on the CPU
# ---------------------------------------------------------------------------


def _fwd_layout_bytes(g, ns, npair):
  """The shared memory ``ns`` samples of geometry ``g`` need."""
  x_stage = ns * g.xr * g.re * 2
  return (cuda_interact.FWD_STAGES * x_stage
          + -(-((ns * npair + 4) * 4) // 16) * 16)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.integers(1, 32), st.integers(1, 64), st.sampled_from([-1, 0]))
def test_fwd_geometry_fits_and_its_tiles_cover_every_pair_once(f, d8, k):
  d = 8 * d8
  g = cuda_interact.fwd_geometry(f, d, k)
  rows, cols = cuda_interact.tril_pairs(f, k)
  npair = len(rows)
  # the stage fits a block's shared memory, laid out as the launcher does
  assert g.smem <= cuda_interact.SMEM_MAX
  assert g.smem == _fwd_layout_bytes(g, g.ns, npair)
  assert g.x_stage == g.ns * g.xr * g.re * 2 and g.o_stage % 16 == 0
  # one warp a sample; a multiple of 4 wherever 4 samples fit
  assert 1 <= g.ns <= cuda_interact.MAX_SAMPLES_PER_BLOCK
  four_fit = _fwd_layout_bytes(g, 4, npair) <= cuda_interact.FWD_SMEM_TARGET
  assert g.ns % 4 == 0 if four_fit else g.ns < 4
  # rows padded to the MMA's 16 or 32, k tiles of 16-column steps that
  # cover D, rows an odd number of 16-byte units apart
  assert g.xr in (16, 32) and f <= g.xr and (g.xr == 16) == (f <= 16)
  assert g.kt % 16 == 0 and g.kt <= cuda_interact.FWD_MAX_K_TILE
  assert (g.nkt - 1) * g.kt < d <= g.nkt * g.kt
  assert g.re == g.kt + 8 and (g.re * 2 // 16) % 2 == 1
  # every pair lies in exactly one issued tile; every issued tile holds one
  assert len(set(g.tiles)) == len(g.tiles)
  for m, n in g.tiles:
    assert 0 <= m < g.xr // 16 and 0 <= n < g.xr // 8
  holders = [[(m, n) for m, n in g.tiles
              if m * 16 <= p < m * 16 + 16 and n * 8 <= q < n * 8 + 8]
             for p, q in zip(rows, cols)]
  assert all(len(h) == 1 for h in holders)
  assert {h[0] for h in holders} == set(g.tiles)


def _bf16_round(x: np.ndarray) -> np.ndarray:
  return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float() \
      .numpy()


def tensor_core_fwd(x: np.ndarray, k: int) -> np.ndarray:
  """The forward kernel's order in numpy: ``x`` ``[B, F, D]`` (bf16 values
  as f32) zero-padded to ``xr`` rows and to 16-column k steps; per k step,
  the 16 exact products of each cell summed and added to its f32 sum in
  one rounding (the tensor core's step); only the issued 16 x 8 tiles
  kept; each wanted cell rounded to bf16 and written at the epilogue's
  index ``tri(p) + q``. Asserts that every pair is written exactly once."""
  b, f, d = x.shape
  g = cuda_interact.fwd_geometry(f, d, k)
  dp = -(-d // 16) * 16
  xp = np.zeros((b, g.xr, dp), np.float64)
  xp[:, :f, :d] = x
  acc = np.zeros((b, g.xr, g.xr), np.float32)
  for c in range(0, dp, 16):
    step = np.einsum("bpd,bqd->bpq", xp[..., c:c + 16], xp[..., c:c + 16])
    acc = (acc.astype(np.float64) + step).astype(np.float32)
  npair = len(cuda_interact.tril_pairs(f, k)[0])
  out = np.full((b, npair), np.nan, np.float32)
  written = np.zeros(npair, np.int64)
  for m, n in g.tiles:
    for p in range(m * 16, m * 16 + 16):
      for q in range(n * 8, n * 8 + 8):
        if p < f and q <= p + k:
          idx = (p * (p + 1) // 2 if k == 0 else p * (p - 1) // 2) + q
          out[:, idx] = _bf16_round(acc[:, p, q])
          written[idx] += 1
  assert np.all(written == 1), written
  return out


def _assert_fwd_class(got, want, slack):
  """The forward kernel's class (``chip_smoke.py: fwd_check``): at least
  99.9% of the cells bit-equal, every cell within one bf16 ulp or, where
  its D terms cancel, within the f32 summation bound ``slack = D * 2^-24 *
  sum_d |x_p[d] x_q[d]|``."""
  assert np.mean(got == want) >= 0.999, np.mean(got == want)
  bound = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))), slack)
  assert np.all(np.abs(got - want) <= bound), \
      float(np.max(np.abs(got - want) / bound))


@pytest.mark.parametrize("k", [-1, 0])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("f", [2, 13, 27, 32])
def test_tensor_core_order_matches_pallas_interpret(f, d, k):
  """The kernel's tile -> pair map and its k-step f32 sums, emulated, hold
  the forward's class against the TPU kernel run in interpret mode and
  against the port's plain version. Summed in 16-column steps, a cell
  whose D terms cancel can land more than one bf16 ulp from a sum taken
  in another order (one cell each at F=13 and F=32, D=128, k=-1 here, as
  on the card), so those cells are held to the f32 summation bound."""
  b = 256  # one of the TPU kernel's batch blocks
  parts_np = [_bf16_round(p) for p in _parts(40 + f + d - k, f=f, b=b, d=d)]
  m_np, p = _tril_select_np(f, k)
  want = np.asarray(interact_parts_fwd(
      [jnp.asarray(x, jnp.bfloat16) for x in parts_np],
      jnp.asarray(m_np, jnp.bfloat16), interpret=True))
  x = np.stack(parts_np, axis=1)
  got = tensor_core_fwd(x, k)
  assert got.shape == (b, p)
  rows, cols = cuda_interact.tril_pairs(f, k)
  abs_sum = np.einsum("bpd,bqd->bpq", np.abs(x).astype(np.float64),
                      np.abs(x).astype(np.float64))[:, rows, cols]
  _assert_fwd_class(got, want, d * 2.0**-24 * abs_sum)
  plain = cuda_interact.interact_parts_fwd(
      [torch.tensor(x).to(torch.bfloat16) for x in parts_np], k).numpy()
  _assert_fwd_class(got, plain, d * 2.0**-24 * abs_sum)
