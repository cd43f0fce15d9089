"""K4 and K5: the fused exchange's per-round row gather, and its
gather-and-push form (CUDA kernels + plain forms).

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

**The bf16 form** (narrow storage; ``gather_rows_bf16_launch`` of the same
source, counted in ``launches_bf16``) takes a bf16 plain-row buffer and
moves 2-byte lanes; it is bit-exact like the f32 form.

K5 replaces ``pallas_exchange.py:gather_send_rows``: one rotate-by-k
round of the fused wire, the rows of ``buf`` at ``ids`` (all-zero for ids
outside ``[0, rows)``) pushed into the ``[n, 128]`` receive buffer of the
round's destination, which may lie on another card (``csrc/
gather_send_rows.cu`` stores into a peer pointer). :func:`gather_send_rows`
takes that receive buffer on the receiving device and orders the push
against the receiver with CUDA events, where the TPU kernel has a
ready-to-receive barrier and receive semaphores. A loopback round (the
destination on the sender's own card) is what the JAX interpret twin
models (``ops/pallas_exchange_sim.py:gather_send_rows_sim``). No JAX path
calls the TPU kernel (``lookup_engine._fused_gather`` calls only
``gather_rows``), so the port's wire does not call K5 either.
``send_launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LANES = 128

launches = 0
launches_bf16 = 0
send_launches = 0
# (sender, receiver) card pairs with peer access enabled
_peers = set()


def _validate(layout, buf: torch.Tensor, ids: torch.Tensor) -> None:
  if layout.rows_per_phys != 1:
    raise ValueError(
        f"the gather kernel serves plain-row layouts (rows_per_phys == 1), "
        f"got rows_per_phys={layout.rows_per_phys}: narrow classes' sub-row "
        "windows go through packed_table.gather_fused")
  if buf.dtype not in (torch.float32, torch.bfloat16):
    raise ValueError(f"buf must be float32 or bfloat16, got {buf.dtype}")
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
  global launches, launches_bf16
  if not buf.is_contiguous():
    raise ValueError("the kernel reads a contiguous buf")
  bf16 = buf.dtype == torch.bfloat16
  if buf.data_ptr() % (8 if bf16 else 16):
    raise ValueError("the kernel reads aligned rows (16 bytes for f32, 8 "
                     "for bf16)")
  flat = ids.reshape(-1).contiguous()
  out = torch.empty(tuple(ids.shape) + (stride,), dtype=buf.dtype,
                    device=buf.device)
  if flat.numel() == 0:
    return out  # nothing to gather: no launch
  lib = load("gather_rows")
  fn = lib.gather_rows_bf16_launch if bf16 else lib.gather_rows_launch
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
  if bf16:
    launches_bf16 += 1
  else:
    launches += 1
  return out


def gather_rows(layout, buf: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
  """``packed_table.gather_fused(layout, buf, ids)`` for plain-row f32
  or bf16 layouts: ``ids.shape + (layout.stride,)`` rows, all-zero for
  out-of-range ids. CPU tensors take the plain version; CUDA tensors
  launch the kernel."""
  _validate(layout, buf, ids)
  if buf.device.type == "cpu":
    return gather_rows_plain(buf, ids, layout.stride)
  if buf.device.type != "cuda":
    raise ValueError(f"no gather kernel for device {buf.device}")
  return _launch(buf, ids, layout.stride)


# ---------------------------------------------------------------------------
# K5: gather and push into a receive buffer, possibly on a peer card
# ---------------------------------------------------------------------------


def _validate_send(buf: torch.Tensor, ids: torch.Tensor,
                   dst: torch.Tensor) -> None:
  if buf.dtype != torch.float32 or buf.dim() != 2 or buf.shape[1] != LANES:
    raise ValueError(f"buf must be [rows, {LANES}] float32, got "
                     f"{tuple(buf.shape)} {buf.dtype}")
  if ids.dtype != torch.int32:
    raise TypeError(f"ids must be int32, got {ids.dtype}")
  if ids.device != buf.device:
    raise ValueError("buf and ids must lie on one device")
  n = ids.numel()
  if (dst.dtype != torch.float32 or tuple(dst.shape) != (n, LANES)
      or not dst.is_contiguous()):
    raise ValueError(f"the receive buffer must be a contiguous [{n}, "
                     f"{LANES}] float32 tensor, got {tuple(dst.shape)} "
                     f"{dst.dtype}")


def gather_send_rows_plain(buf: torch.Tensor, ids: torch.Tensor,
                           device=None) -> torch.Tensor:
  """Plain PyTorch version of K5: the rows of ``buf`` at ``ids`` (``[n,
  128]``, all-zero where an id lies outside ``[0, rows)``), moved to
  ``device`` (default: ``buf``'s)."""
  got = gather_rows_plain(buf, ids.reshape(-1))
  return got if device is None else got.to(device)


def _enable_peer(lib, src: torch.device, dst: torch.device) -> None:
  """Let ``src`` write into ``dst``'s memory; once per pair of cards."""
  if (src.index, dst.index) in _peers:
    return
  fn = lib.gather_send_enable_peer
  fn.argtypes = [ctypes.c_int, ctypes.c_int]
  fn.restype = ctypes.c_int
  err = fn(src.index, dst.index)
  if err == -1:
    raise RuntimeError(
        f"{src} cannot write into {dst}'s memory (no peer access between "
        "the two cards): the gather-and-push round needs it")
  if err != 0:
    raise RuntimeError(f"enabling peer access {src} -> {dst} failed: "
                       f"cudaError {err}")
  _peers.add((src.index, dst.index))


def _launch_send(buf: torch.Tensor, ids: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
  from ._build import load
  global send_launches
  if not buf.is_contiguous():
    raise ValueError("the kernel reads a contiguous buf")
  if buf.data_ptr() % 16 or dst.data_ptr() % 16:
    raise ValueError("the kernel moves 16-byte aligned rows")
  flat = ids.reshape(-1).contiguous()
  if flat.numel() == 0:
    return dst  # nothing to push: no launch
  lib = load("gather_send_rows")
  src_dev, dst_dev = buf.device, dst.device
  remote = dst_dev != src_dev
  send_stream = torch.cuda.current_stream(src_dev)
  fn = lib.gather_send_rows_launch
  fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p]
  fn.restype = ctypes.c_int
  with torch.cuda.device(src_dev):
    if remote:
      _enable_peer(lib, src_dev, dst_dev)
      # the receiver's earlier work on its buffer comes first (the TPU
      # kernel's ready-to-receive barrier)
      ready = torch.cuda.Event()
      ready.record(torch.cuda.current_stream(dst_dev))
      send_stream.wait_event(ready)
    err = fn(src_dev.index, buf.data_ptr(), buf.shape[0], flat.data_ptr(),
             flat.shape[0], dst.data_ptr(), send_stream.cuda_stream)
  if err != 0:
    raise RuntimeError(f"gather_send_rows launch failed: cudaError {err}")
  send_launches += 1
  if remote:
    # the receiver reads its buffer only after the push (the TPU kernel's
    # receive semaphores)
    done = torch.cuda.Event()
    done.record(send_stream)
    torch.cuda.current_stream(dst_dev).wait_event(done)
  return dst


def gather_send_rows(buf: torch.Tensor, ids: torch.Tensor,
                     dst: Optional[torch.Tensor] = None) -> torch.Tensor:
  """One round of the fused exchange: the rows of ``buf`` (``[rows, 128]``
  f32) at the int32 ``ids``, all-zero for ids outside ``[0, rows)``,
  written into ``dst``, the ``[n, 128]`` f32 receive buffer of the round's
  destination, on this card (loopback) or on a peer card. ``dst=None``
  allocates a loopback buffer. Returns ``dst``. CPU tensors take the plain
  version; CUDA tensors launch the kernel, and a receive buffer on another
  card needs peer access to it (raises without)."""
  if dst is None:
    dst = torch.empty((ids.numel(), LANES), dtype=torch.float32,
                      device=buf.device)
  _validate_send(buf, ids, dst)
  if buf.device.type == "cpu":
    if dst.device.type != "cpu":
      raise ValueError("CPU rows push into a CPU receive buffer only")
    return dst.copy_(gather_send_rows_plain(buf, ids))
  if buf.device.type != "cuda" or dst.device.type != "cuda":
    raise ValueError(f"no gather-and-push kernel from {buf.device} to "
                     f"{dst.device}")
  return _launch_send(buf, ids, dst)
