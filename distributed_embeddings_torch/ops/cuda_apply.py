"""K1: the sparse apply ``buf[ids] += scale * delta`` (CUDA kernel + plain
form).

Replaces ``distributed_embeddings_tpu/ops/pallas_apply.py:
apply_rows_cached``. The kernel (``csrc/apply_rows.cu``) updates a
``[rows, width]`` f32 buffer in place: for every occurrence ``i`` whose id
lies in ``[0, rows)`` it adds ``fl(scale * delta[i])`` to row ``ids[i]``;
other ids are dropped. Duplicates accumulate per occurrence, exact up to
the f32 summation order (the atomics' order changes from run to run); a
stream of unique ids gives the plain version's bits.

Each block of the kernel takes a tile of consecutive occurrences, sorts
it by id on chip (a hash and a counting sort in shared memory) and sums
each run of one id in registers before one float4 atomic per run, so a
row hit by many occurrences takes a few atomics per tile instead of one
per occurrence. :func:`plan_apply` sizes the tile, the hash and the
shared memory; the launcher computes the same plan (``apply_rows_plan``
reads it back on the card).

:func:`apply_rows` runs the kernel for CUDA tensors and the plain version
:func:`apply_rows_plain` (a masked ``index_add_``) for CPU tensors. On CUDA
it launches the kernel or raises: there is no fallback. ``launches``
counts kernel launches.

The library yardstick, one ``buf.index_add_(0, ids, delta, alpha=scale)``
over the valid ids, computes the same function as the plain version.

**The bf16 form** (narrow storage; ``apply_rows_bf16_launch`` of the same
source, counted in ``launches_bf16``) takes a bf16 buffer and bf16
deltas with the JAX package's bf16 arithmetic (XLA's scatter, which the
JAX package uses for non-f32 buffers): the scale rounded to bf16, each
product rounded to bf16, each add rounded to bf16. Its plain version
adds the occurrences one after another in stream order, as XLA's scatter
does, so it gives the JAX package's bits with duplicates too; the kernel
sums a tile's run of one id in f32 and rounds it once, which for a
unique id is the same bits and for a run of ``m`` duplicates differs by
at most ``m`` roundings of ``2^-8`` of the running magnitude. The plan
is the f32 form's (a warp still walks 128 lanes, 4 values a thread).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

LANES = 128
THREADS = 256            # 8 warps a block
TILE_MIN, TILE_MAX = 256, 2048
TILES_PER_SM = 4
SMEM_MAX = 232_448       # a block's shared memory on Hopper (227 KB)
H100_SMS = 132

launches = 0
launches_bf16 = 0

Scale = Union[None, float, torch.Tensor]


class ApplyPlan(NamedTuple):
  """The kernel's launch geometry: ``tile`` occurrences a block, ``slots``
  in its hash, ``smem`` bytes of dynamic shared memory, ``blocks`` in the
  grid."""
  tile: int
  slots: int
  smem: int
  blocks: int


def plan_apply(width: int, n: int, sms: int = H100_SMS) -> ApplyPlan:
  """The tile plan for ``n`` occurrences of ``width``-lane rows on a card
  of ``sms`` SMs (the launcher's ``plan_of``): the largest power-of-two
  tile in ``[TILE_MIN, TILE_MAX]`` that still gives every SM
  ``TILES_PER_SM`` tiles (longer tiles merge more duplicates, more tiles
  fill the card); a hash of twice the tile's slots (load at most 1/2);
  shared memory for the tile's sorted ids and occurrences, the hash's keys
  and counts and the warps' scan totals. Neither the width nor the element
  type (f32 or bf16) sets a size: a warp walks a row 128 lanes at a time,
  4 values a thread."""
  if width <= 0 or width % LANES:
    raise ValueError(f"the kernel takes width % {LANES} == 0, got {width}")
  if n < 0:
    raise ValueError(f"n must be >= 0, got {n}")
  tile = TILE_MAX
  while tile > TILE_MIN and -(-n // tile) < TILES_PER_SM * sms:
    tile //= 2
  slots = 2 * tile
  smem = 4 * (2 * tile + 2 * slots + THREADS // 32 + 1)
  return ApplyPlan(tile, slots, smem, -(-n // tile))


def _valid(buf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  return (ids >= 0) & (ids < buf.shape[0])


def add_in_order(buf: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
                 ) -> torch.Tensor:
  """``buf[ids[i]] += rows[i]`` for i in stream order, each add rounded to
  ``buf``'s dtype (XLA's scatter on a bf16 buffer). The occurrences are
  cut into levels by their rank among equal ids (level k holds every id's
  k-th occurrence), so each ``index_add_`` sees unique ids and rounds
  every add once; ``ids`` must lie in range."""
  n = ids.shape[0]
  if n == 0:
    return buf
  order = torch.sort(ids, stable=True).indices
  sid = ids[order]
  pos = torch.arange(n, device=ids.device)
  first = torch.ones(n, dtype=torch.bool, device=ids.device)
  first[1:] = sid[1:] != sid[:-1]
  rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
  by_rank = torch.sort(rank, stable=True)
  occ = order[by_rank.indices]
  ids_l, rows_l = ids[occ], rows[occ]  # level after level
  lo = 0
  for size in torch.bincount(by_rank.values).tolist():
    buf.index_add_(0, ids_l[lo:lo + size], rows_l[lo:lo + size])
    lo += size
  return buf


def apply_rows_plain(buf: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor, scale: Scale = None
                     ) -> torch.Tensor:
  """Plain PyTorch version: drop the out-of-range ids, round ``scale *
  delta`` once, ``index_add_`` the rows in place. A bf16 buffer takes the
  scale rounded to bf16 and adds the rows one occurrence after another
  (:func:`add_in_order`). Returns ``buf``."""
  valid = _valid(buf, ids)
  rows = delta[valid]
  if scale is not None:
    rows = rows * torch.as_tensor(scale, device=rows.device).to(rows.dtype)
  if buf.dtype == torch.bfloat16:
    return add_in_order(buf, ids[valid], rows)
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
  if buf.dtype not in (torch.float32, torch.bfloat16) \
      or delta.dtype != buf.dtype:
    raise TypeError(f"apply_rows takes f32 or bf16 buf and delta of the "
                    f"same type, got {buf.dtype} and {delta.dtype}")
  if ids.dtype != torch.int64:
    raise TypeError(f"apply_rows takes int64 ids, got {ids.dtype}")
  if not (ids.device == buf.device == delta.device):
    raise ValueError("buf, ids and delta must lie on one device")


def _launch(buf: torch.Tensor, ids: torch.Tensor, delta: torch.Tensor,
            scale: Scale) -> torch.Tensor:
  from ._build import load
  global launches, launches_bf16
  if buf.shape[1] % LANES:
    raise ValueError(f"the kernel takes width % {LANES} == 0, got "
                     f"{buf.shape[1]}")
  if not (buf.is_contiguous() and delta.is_contiguous()
          and ids.is_contiguous()):
    raise ValueError("the kernel takes contiguous buf, ids and delta")
  align = 16 if buf.dtype == torch.float32 else 8
  if buf.data_ptr() % align or delta.data_ptr() % align:
    raise ValueError(f"the kernel reads and writes {align}-byte aligned "
                     "rows")
  scale_ptr, scale_val = None, 1.0
  if isinstance(scale, torch.Tensor) and scale.device.type == "cuda":
    if scale.numel() != 1 or scale.dtype != torch.float32:
      raise ValueError("a device scale must be one f32 value")
    scale = scale.reshape(1).contiguous()
    scale_ptr = scale.data_ptr()
  elif scale is not None:
    scale_val = float(scale)   # host scalar: no device read
  bf16 = buf.dtype == torch.bfloat16
  lib = load("apply_rows")
  fn = lib.apply_rows_bf16_launch if bf16 else lib.apply_rows_launch
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
  if bf16:
    launches_bf16 += 1
  else:
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
