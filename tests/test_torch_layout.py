"""Kernel K7, the layout pin ``row_major``, against the JAX package.

The JAX ``row_major`` is the identity off the TPU; the port's is a copy
into a fresh contiguous tensor. On CPU tensors (the plain version) it is
bit-equal to the JAX function on the same numpy inputs, for strided views
of every rank it takes (transposed, sliced, broadcast), f32 and bf16, and
the lookup engine runs it on each sparse bucket's cotangent only under
``DE_TORCH_COTANGENT_PIN=1``. The kernel runs on the card only
(``chip_smoke.py``: ``kernel row_major``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import cuda_layout
from distributed_embeddings_torch.parallel import lookup_engine
from distributed_embeddings_tpu.ops.pallas_layout import row_major


def _views(base: torch.Tensor):
  """Strided views of ``base`` ([6, 5, 4, 3]) at every rank up to four."""
  return {
      "contiguous": base,
      "transposed_2d": base[0, 0].t(),
      "sliced_3d": base[1:5:2, :, 1:],
      "permuted_4d": base.permute(3, 1, 0, 2),
      "broadcast": base[0, 0, 0][:, None].expand(3, 7),
      "scalar_row": base[2, 3, 1],
  }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_row_major_is_bit_equal_to_jax(dtype):
  rng = np.random.default_rng(0)
  base = torch.tensor(rng.standard_normal((6, 5, 4, 3)).astype(np.float32)
                      ).to(dtype)
  for name, x in _views(base).items():
    got = cuda_layout.row_major(x)
    assert got.is_contiguous() and got.shape == x.shape, name
    assert got.data_ptr() != x.data_ptr(), name  # a fresh tensor
    ref = x.float().numpy()
    if dtype == torch.bfloat16:
      ref = ref.astype(ml_dtypes.bfloat16)
    want = np.asarray(row_major(jnp.asarray(ref)))
    assert want.dtype == ref.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32), err_msg=name)
    assert torch.equal(got, x), name
  assert cuda_layout.launches == 0  # CPU tensors never launch the kernel


def test_row_major_refuses_what_the_kernel_does_not_take():
  with pytest.raises(ValueError, match="up to 4"):
    cuda_layout.row_major(torch.zeros((1, 1, 1, 1, 2)))
  with pytest.raises(TypeError, match="f32 or bf16"):
    cuda_layout.row_major(torch.zeros((2, 2), dtype=torch.int32))


def test_pin_reads_its_switch(monkeypatch):
  monkeypatch.delenv("DE_TORCH_COTANGENT_PIN", raising=False)
  assert not lookup_engine._cotangent_pin()  # off by default
  monkeypatch.setenv("DE_TORCH_COTANGENT_PIN", "1")
  assert lookup_engine._cotangent_pin()
  monkeypatch.setenv("DE_TORCH_COTANGENT_PIN", "0")
  assert not lookup_engine._cotangent_pin()
