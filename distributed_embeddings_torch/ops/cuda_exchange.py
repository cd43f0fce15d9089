"""K4: the fused exchange's per-round row gather (CUDA kernel + plain form).

Replaces ``distributed_embeddings_tpu/ops/pallas_exchange.py:
gather_rows``. Under ``overlap='fused'`` the lookup engine gathers each
(round, chunk) send block of a sparse class just before its send
(``parallel/lookup_engine.py: _fused_gather``); for plain-row f32
layouts (``rows_per_phys == 1``: one fused row per physical row, whose
``phys_width`` is a multiple of 128 lanes) that gather is this kernel:
``out[j] = buf[ids[j], :stride]``, all-zero rows for ids outside ``[0,
rows)`` (sentinels and other row slices' ids). The ids are int32, as the
wire carries them and as the TPU kernel takes them. Pure data movement:
the kernel is bit-exact against the plain version and against
``packed_table.gather_fused``.

:func:`gather_rows` runs the kernel (``csrc/gather_rows.cu``) for CUDA
tensors and the plain version :func:`gather_rows_plain` (a masked
``index_select``) for CPU tensors. On CUDA it launches the kernel or
raises: there is no fallback. ``launches`` counts kernel launches.

The library yardstick, ``buf.index_select(0, ids.clamp(0, rows - 1))``,
moves the same bytes but does not zero the out-of-range rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LANES = 128

launches = 0


def _validate(layout, buf: torch.Tensor, ids: torch.Tensor) -> None:
  if layout.rows_per_phys != 1:
    raise ValueError(
        f"the gather kernel serves plain-row layouts (rows_per_phys == 1), "
        f"got rows_per_phys={layout.rows_per_phys}: narrow classes' sub-row "
        "windows go through packed_table.gather_fused")
  if buf.dtype != torch.float32:
    raise ValueError(f"buf must be float32, got {buf.dtype}")
  if (buf.dim() != 2 or buf.shape[1] % LANES
      or tuple(buf.shape) != tuple(layout.shape)):
    raise ValueError(
        f"buf must be the layout's [rows, phys_width] with phys_width a "
        f"multiple of {LANES} lanes, got {tuple(buf.shape)} for "
        f"{tuple(layout.shape)}")
  if ids.dtype != torch.int32:
    raise TypeError(f"ids must be int32, got {ids.dtype}")
  if ids.device != buf.device:
    raise ValueError("buf and ids must lie on one device")


def gather_rows_plain(buf: torch.Tensor, ids: torch.Tensor,
                      stride: Optional[int] = None) -> torch.Tensor:
  """Plain PyTorch version: the first ``stride`` lanes (default: all) of
  the rows of ``buf`` at ``ids``, ``[..., stride]``, all-zero where an id
  lies outside ``[0, rows)``."""
  rows = buf.shape[0]
  stride = buf.shape[1] if stride is None else stride
  flat = ids.reshape(-1)
  valid = (flat >= 0) & (flat < rows)
  got = buf[:, :stride].index_select(
      0, torch.where(valid, flat, torch.zeros_like(flat)))
  got = torch.where(valid[:, None], got, torch.zeros_like(got))
  return got.reshape(tuple(ids.shape) + (stride,))


def _launch(buf: torch.Tensor, ids: torch.Tensor,
            stride: int) -> torch.Tensor:
  from ._build import load
  global launches
  if not buf.is_contiguous():
    raise ValueError("the kernel reads a contiguous buf")
  if buf.data_ptr() % 16:
    raise ValueError("the kernel reads 16-byte aligned rows")
  flat = ids.reshape(-1).contiguous()
  out = torch.empty(tuple(ids.shape) + (stride,), dtype=buf.dtype,
                    device=buf.device)
  if flat.numel() == 0:
    return out  # nothing to gather: no launch
  lib = load("gather_rows")
  fn = lib.gather_rows_launch
  fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  stream = torch.cuda.current_stream(buf.device).cuda_stream
  with torch.cuda.device(buf.device):
    err = fn(buf.data_ptr(), buf.shape[0], buf.shape[1], stride,
             flat.data_ptr(), flat.shape[0], out.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f"gather_rows launch failed: cudaError {err}")
  launches += 1
  return out


def gather_rows(layout, buf: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
  """``packed_table.gather_fused(layout, buf, ids)`` for plain-row f32
  layouts: ``ids.shape + (layout.stride,)`` rows, all-zero for
  out-of-range ids. CPU tensors take the plain version; CUDA tensors
  launch the kernel."""
  _validate(layout, buf, ids)
  if buf.device.type == "cpu":
    return gather_rows_plain(buf, ids, layout.stride)
  if buf.device.type != "cuda":
    raise ValueError(f"no gather kernel for device {buf.device}")
  return _launch(buf, ids, layout.stride)
