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
"""

from __future__ import annotations

import ctypes

import torch

MAX_DIMS = 4
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


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


def _launch(x: torch.Tensor) -> torch.Tensor:
  from ._build import load
  global launches
  out = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
  if x.numel() == 0:
    return out  # nothing to copy: no launch
  pad = MAX_DIMS - x.dim()
  sizes = (ctypes.c_int64 * MAX_DIMS)(*([1] * pad + list(x.shape)))
  strides = (ctypes.c_int64 * MAX_DIMS)(*([0] * pad + list(x.stride())))
  lib = load("row_major")
  fn = lib.row_major_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                 ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
                 ctypes.c_void_p]
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(x.device).cuda_stream
  with torch.cuda.device(x.device):
    err = fn(x.data_ptr(), x.element_size(), sizes, strides, out.data_ptr(),
             stream)
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
