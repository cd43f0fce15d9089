"""K1: the sparse apply ``buf[ids] += scale * delta`` (CUDA kernel + plain
form).

Replaces ``distributed_embeddings_tpu/ops/pallas_apply.py:
apply_rows_cached``. The kernel (``csrc/apply_rows.cu``) updates a
``[rows, width]`` f32 buffer in place: for every occurrence ``i`` whose id
lies in ``[0, rows)`` it adds ``fl(scale * delta[i])`` to row ``ids[i]``;
other ids are dropped. Duplicates accumulate per occurrence, exact up to
the f32 summation order (the atomics' order changes from run to run); a
stream of unique ids gives the plain version's bits.

:func:`apply_rows` runs the kernel for CUDA tensors and the plain version
:func:`apply_rows_plain` (a masked ``index_add_``) for CPU tensors. On CUDA
it launches the kernel or raises: there is no fallback. ``launches``
counts kernel launches.

The library yardstick, one ``buf.index_add_(0, ids, delta, alpha=scale)``
over the valid ids, computes the same function as the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

LANES = 128

launches = 0

Scale = Union[None, float, torch.Tensor]


def _valid(buf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  return (ids >= 0) & (ids < buf.shape[0])


def apply_rows_plain(buf: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor, scale: Scale = None
                     ) -> torch.Tensor:
  """Plain PyTorch version: drop the out-of-range ids, round ``scale *
  delta`` once, ``index_add_`` the rows in place. Returns ``buf``."""
  valid = _valid(buf, ids)
  rows = delta[valid]
  if scale is not None:
    rows = rows * torch.as_tensor(scale, dtype=rows.dtype, device=rows.device)
  buf.index_add_(0, ids[valid], rows)
  return buf


def _check(buf: torch.Tensor, ids: torch.Tensor, delta: torch.Tensor):
  if buf.dim() != 2 or delta.dim() != 2 or ids.dim() != 1:
    raise ValueError(f"apply_rows takes buf [rows, width], ids [n] and delta "
                     f"[n, width]; got {tuple(buf.shape)}, "
                     f"{tuple(ids.shape)}, {tuple(delta.shape)}")
  if delta.shape != (ids.shape[0], buf.shape[1]):
    raise ValueError(f"delta shape {tuple(delta.shape)} != "
                     f"({ids.shape[0]}, {buf.shape[1]})")
  if buf.dtype != torch.float32 or delta.dtype != torch.float32:
    raise TypeError(f"apply_rows takes f32 buf and delta, got {buf.dtype} "
                    f"and {delta.dtype}")
  if ids.dtype != torch.int64:
    raise TypeError(f"apply_rows takes int64 ids, got {ids.dtype}")
  if not (ids.device == buf.device == delta.device):
    raise ValueError("buf, ids and delta must lie on one device")


def _launch(buf: torch.Tensor, ids: torch.Tensor, delta: torch.Tensor,
            scale: Scale) -> torch.Tensor:
  from ._build import load
  global launches
  if buf.shape[1] % LANES:
    raise ValueError(f"the kernel takes width % {LANES} == 0, got "
                     f"{buf.shape[1]}")
  if not (buf.is_contiguous() and delta.is_contiguous()
          and ids.is_contiguous()):
    raise ValueError("the kernel takes contiguous buf, ids and delta")
  if buf.data_ptr() % 16 or delta.data_ptr() % 16:
    raise ValueError("the kernel reads and writes 16-byte aligned rows")
  scale_ptr, scale_val = None, 1.0
  if isinstance(scale, torch.Tensor) and scale.device.type == "cuda":
    if scale.numel() != 1 or scale.dtype != torch.float32:
      raise ValueError("a device scale must be one f32 value")
    scale = scale.reshape(1).contiguous()
    scale_ptr = scale.data_ptr()
  elif scale is not None:
    scale_val = float(scale)   # host scalar: no device read
  lib = load("apply_rows")
  fn = lib.apply_rows_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(buf.device).cuda_stream
  with torch.cuda.device(buf.device):
    err = fn(buf.data_ptr(), buf.shape[0], buf.shape[1], ids.data_ptr(),
             delta.data_ptr(), ids.shape[0], scale_ptr, scale_val, stream)
  if err != 0:
    raise RuntimeError(f"apply_rows launch failed: cudaError {err}")
  launches += 1
  return buf


def apply_rows(buf: torch.Tensor, ids: torch.Tensor, delta: torch.Tensor,
               scale: Optional[Scale] = None) -> torch.Tensor:
  """``buf[ids[i]] += scale * delta[i]`` in place (out-of-range ids
  dropped); returns ``buf``. CPU tensors take the plain version; CUDA
  tensors launch the kernel."""
  _check(buf, ids, delta)
  if buf.device.type == "cpu":
    return apply_rows_plain(buf, ids, delta, scale)
  if buf.device.type != "cuda":
    raise ValueError(f"no apply kernel for device {buf.device}")
  return _launch(buf, ids, delta, scale)
