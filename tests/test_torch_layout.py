"""Kernel K7, the layout pin ``row_major``, against the JAX package.

The JAX ``row_major`` is the identity off the TPU; the port's is a copy
into a fresh contiguous tensor. On CPU tensors (the plain version) it is
bit-equal to the JAX function on the same numpy inputs, for strided views
of every rank it takes (transposed, sliced, broadcast), f32 and bf16, and
the lookup engine runs it on each sparse bucket's cotangent only under
``DE_TORCH_COTANGENT_PIN=1``. The kernel's copy plan (``plan_copy``, pure
host code) is held here: its coalesced dimensions address exactly the
view's elements in the view's order, and it picks the path the kernel
needs. The kernel runs on the card only (``chip_smoke.py``: ``kernel
row_major``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _offsets(sizes, strides) -> np.ndarray:
  """The element offsets a (sizes, strides) view addresses, in row-major
  order."""
  idx = np.indices(tuple(sizes)).reshape(len(sizes), -1)
  return (np.asarray(strides, dtype=np.int64)[:, None] * idx).sum(0)


@st.composite
def _strided_views(draw):
  """Permuted, sliced, expanded 1-4-dim views with size-1 dimensions."""
  nd = draw(st.integers(1, 4))
  shape = draw(st.lists(st.integers(1, 6), min_size=nd, max_size=nd))
  dtype = draw(st.sampled_from([torch.float32, torch.bfloat16]))
  x = torch.zeros(shape, dtype=dtype).permute(draw(st.permutations(range(nd))))
  x = x[tuple(slice(draw(st.integers(0, n - 1)), None, draw(st.integers(1, 3)))
              for n in x.shape)]
  while x.dim() < 4 and draw(st.booleans()):
    at = draw(st.integers(0, x.dim()))
    x = x.unsqueeze(at)
    if draw(st.booleans()):  # a stride-0 broadcast
      x = x.expand(*x.shape[:at], draw(st.integers(2, 4)),
                   *x.shape[at + 1:])
  return x


@settings(max_examples=400, deadline=None, derandomize=True)
@given(_strided_views(), st.sampled_from([0, 2, 4, 8]))
def test_copy_plan_addresses_the_view_in_order(x, ptr_mod16):
  eb = x.element_size()
  plan = cuda_layout.plan_copy(x.shape, x.stride(), eb, ptr_mod16)
  sizes, strides = plan.sizes, plan.strides
  assert len(sizes) == len(strides) <= max(1, x.dim())
  assert sizes == (1,) or all(n > 1 for n in sizes)  # no size-1 dim left
  np.testing.assert_array_equal(_offsets(sizes, strides),
                                _offsets(x.shape, x.stride()))
  vector = (strides[-1] == 1 and ptr_mod16 == 0
            and (sizes[-1] * eb) % 16 == 0
            and all((s * eb) % 16 == 0 for s in strides[:-1]))
  transpose = strides[-1] != 1 and 1 in strides[:-1]
  want = "vector" if vector else "transpose" if transpose else "general"
  assert plan.path == want
  if plan.path == "transpose":
    assert 0 <= plan.unit_dim < len(sizes) - 1
    assert strides[plan.unit_dim] == 1
  else:
    assert plan.unit_dim == -1


@pytest.mark.parametrize("elem", [4, 2])
def test_copy_plan_paths_of_the_zoo_cotangent(elem):
  """Tiny's one-hot cotangent, [65536, 12, 16].transpose(0, 1), is the
  vector path; a transpose of the last two dimensions the tile path; a
  stride-0 broadcast of the innermost dimension the general one."""
  zoo = cuda_layout.plan_copy((12, 65536, 16), (16, 192, 1), elem, 0)
  assert zoo == ("vector", (12, 65536, 16), (16, 192, 1), -1)
  last2 = cuda_layout.plan_copy((12, 65536, 16), (16 * 65536, 1, 65536),
                                elem, 0)
  assert last2 == ("transpose", (12, 65536, 16), (16 * 65536, 1, 65536), 1)
  bcast = cuda_layout.plan_copy((12, 65536, 16), (16, 192, 0), elem, 0)
  assert bcast.path == "general"
  # a contiguous tensor is one run; an unaligned base takes the general path
  assert cuda_layout.plan_copy((12, 65536, 16), (2**20, 16, 1), elem, 0) \
      == ("vector", (12 * 65536 * 16,), (1,), -1)
  assert cuda_layout.plan_copy((12, 16), (16, 1), elem, 4).path == "general"
