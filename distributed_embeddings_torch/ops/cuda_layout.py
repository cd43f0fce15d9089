"""K7: the layout pin ``row_major`` (CUDA kernel + plain form).

Replaces ``distributed_embeddings_tpu/ops/pallas_layout.py: row_major``,
an identity copy that the JAX engine can put on the sparse cotangent to
force it into XLA's row-major layout (``DE_TPU_COTANGENT_PIN``). The
function is the identity; its counterpart here is a strided-to-contiguous
copy: a fresh contiguous tensor with ``x``'s values, for any f32 or bf16
tensor of up to four dimensions. The lookup engine runs it where the JAX
pin sits, under ``DE_TORCH_COTANGENT_PIN=1`` (off by default,
``parallel/lookup_engine.py: _cotangent_pin``).

:func:`row_major` runs the kernel (``csrc/row_major.cu``) for CUDA tensors
and the plain version :func:`row_major_plain` (an elementwise copy into a
fresh contiguous tensor) for CPU tensors. On CUDA it launches the kernel
or raises: there is no fallback. ``launches`` counts kernel launches. The
library yardstick is ``x.contiguous()`` (which returns ``x`` itself when
it is already contiguous).

Before the launch, :func:`plan_copy` reduces the view to the fewest
dimensions that address the same elements in the same order and picks
one of the kernel's three paths (:data:`PATHS`); the choice is a layout
decision, each path copies any view it is given bit-exactly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

MAX_DIMS = 4
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's paths, in the launcher's numbering
PATHS = ("vector", "transpose", "general")

launches = 0


class CopyPlan(NamedTuple):
  """A view reduced for the copy: ``path`` (one of :data:`PATHS`), the
  coalesced ``sizes`` and element ``strides`` (outermost first, at least
  one dimension) and, for ``"transpose"``, ``unit_dim``, the dimension of
  source stride 1 (-1 otherwise)."""
  path: str
  sizes: Tuple[int, ...]
  strides: Tuple[int, ...]
  unit_dim: int


def coalesce(sizes: Sequence[int], strides: Sequence[int]
             ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
  """Drop size-1 dimensions and merge each adjacent pair ``i, i + 1`` with
  ``stride[i] == size[i + 1] * stride[i + 1]``: the result addresses the
  same elements in the same (row-major) order. A view of one element
  comes back as ``(1,), (1,)``."""
  dims = [(int(n), int(s)) for n, s in zip(sizes, strides) if n != 1]
  out = []
  for n, s in dims:
    if out and out[-1][1] == n * s:
      out[-1] = (out[-1][0] * n, s)
    else:
      out.append((n, s))
  if not out:
    return (1,), (1,)
  return tuple(n for n, _ in out), tuple(s for _, s in out)


def plan_copy(sizes: Sequence[int], strides: Sequence[int], elem_bytes: int,
              ptr_mod16: int) -> CopyPlan:
  """The copy plan of a view of ``sizes`` and element ``strides`` whose
  first element lies at ``ptr_mod16`` bytes past a 16-byte boundary.

  - ``"vector"``: the innermost stride is 1, the innermost run is a
    multiple of 16 bytes, and the base and every outer stride are 16-byte
    aligned: one thread moves one 16-byte vector, the threads walking the
    source in its memory order;
  - ``"transpose"``: the innermost stride is not 1 but another dimension
    has stride 1: tiles of 1,024 elements through shared memory;
  - ``"general"``: anything else (e.g. no unit stride at all, as in a
    stride-0 broadcast of the innermost dimension): one element a thread.
  """
  sz, st = coalesce(sizes, strides)
  if st[-1] == 1:
    if (ptr_mod16 == 0 and (sz[-1] * elem_bytes) % 16 == 0
        and all((s * elem_bytes) % 16 == 0 for s in st[:-1])):
      return CopyPlan("vector", sz, st, -1)
    return CopyPlan("general", sz, st, -1)
  units = [i for i, s in enumerate(st[:-1]) if s == 1]
  if units:
    return CopyPlan("transpose", sz, st, units[-1])
  return CopyPlan("general", sz, st, -1)


def _check(x: torch.Tensor) -> None:
  if x.dim() > MAX_DIMS:
    raise ValueError(f"row_major takes up to {MAX_DIMS} dimensions, got "
                     f"{x.dim()}")
  if x.dtype not in _DTYPES:
    raise TypeError(f"row_major takes f32 or bf16 tensors, got {x.dtype}")


def row_major_plain(x: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version: ``x``'s values in a fresh contiguous tensor."""
  out = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
  out.copy_(x)
  return out


def plan_of(x: torch.Tensor) -> CopyPlan:
  """:func:`plan_copy` of a tensor."""
  return plan_copy(x.shape, x.stride(), x.element_size(),
                   x.data_ptr() % 16)


def _launch(x: torch.Tensor) -> torch.Tensor:
  from ._build import load
  global launches
  out = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
  if x.numel() == 0:
    return out  # nothing to copy: no launch
  plan = plan_of(x)
  nd = len(plan.sizes)
  sizes = (ctypes.c_int64 * nd)(*plan.sizes)
  strides = (ctypes.c_int64 * nd)(*plan.strides)
  lib = load("row_major")
  fn = lib.row_major_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.POINTER(ctypes.c_int64),
                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    err = fn(x.data_ptr(), x.element_size(), PATHS.index(plan.path), nd,
             sizes, strides, plan.unit_dim, out.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f"row_major launch failed: cudaError {err}")
  launches += 1
  return out


def row_major(x: torch.Tensor) -> torch.Tensor:
  """``x``'s values in a fresh contiguous (row-major) tensor. CPU tensors
  take the plain version; CUDA tensors launch the kernel."""
  _check(x)
  if x.device.type == "cpu":
    return row_major_plain(x)
  if x.device.type != "cuda":
    raise ValueError(f"no layout kernel for device {x.device}")
  return _launch(x)
